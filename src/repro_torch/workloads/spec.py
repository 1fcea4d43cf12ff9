"""Workload scenario specs: named, seeded, composable access-pattern regimes.

Copied from ``src/repro/workloads/spec.py`` (NumPy and stdlib only): the
port imports nothing of the JAX package, so it keeps its own copy.

The paper's headline numbers come from *diverse, shifting* production
traffic (RecShard shows per-table access CDFs differ wildly and drift over
time; SDM evaluates against production traffic mixes).  This module is the
single entry point every serving/bench/test path uses to get such traffic:

    spec  = scenario("diurnal", n_accesses=50_000, seed=3)
    trace = make_trace(spec)                  # a repro_torch.core.trace.Trace
    for ids in iter_batches(spec, 256):       # flat global-id batches
        store.lookup(ids)

A :class:`WorkloadSpec` is a frozen, hashable value: ``(regime, scale,
seed, regime params)``.  Two equal specs always produce byte-identical
traces (asserted in ``tests/test_workloads.py``), which is what lets the
scenario regression matrix pin golden metrics per scenario.

Regime generators live in :mod:`repro_torch.workloads.regimes` and register
themselves into :data:`REGIMES`; the ``replay`` adapter
(:mod:`repro_torch.workloads.replay`) serves external ``.npz``/``.csv`` traces
through the same API.  :data:`SCENARIOS` is the named catalog (one entry
per taxonomy row in docs/architecture.md) consumed by the test matrix,
``bench_e2e`` and ``launch/serve.py --workload``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.core.trace import Trace

# regime name -> generator(spec, rng) -> (table_id int32, row_id int64)
REGIMES: Dict[str, Callable] = {}
# regime name -> the param keys its generator reads (typo guard).
REGIME_PARAMS: Dict[str, frozenset] = {}


def register(name: str, params: Tuple[str, ...] = ()):
    """Decorator: register a regime generator under ``name``.  ``params``
    declares the regime knobs it reads; ``make_trace`` rejects specs
    carrying any other key, so a typo'd CLI knob fails loudly instead of
    silently serving the default."""
    def deco(fn):
        REGIMES[name] = fn
        REGIME_PARAMS[name] = frozenset(params) | {"table_zipf_a"}
        return fn
    return deco


@dataclass(frozen=True)
class WorkloadSpec:
    """One named, seeded access-pattern regime at a given scale.

    ``params`` holds the regime-specific knobs as a sorted tuple of
    ``(key, value)`` pairs so the spec stays hashable; use :meth:`param`
    to read them and :func:`make_spec` / :meth:`with_` to build them from
    keyword arguments.
    """

    regime: str
    n_tables: int = 8
    rows_per_table: int = 2048
    n_accesses: int = 60_000
    seed: int = 0
    params: Tuple[Tuple[str, object], ...] = field(default_factory=tuple)

    def param(self, key: str, default=None):
        for k, v in self.params:
            if k == key:
                return v
        return default

    def with_(self, **kw) -> "WorkloadSpec":
        """Copy with scale fields and/or regime params overridden."""
        fields = {k: kw.pop(k) for k in
                  ("regime", "n_tables", "rows_per_table", "n_accesses",
                   "seed") if k in kw}
        if kw:
            merged = dict(self.params)
            merged.update(kw)
            fields["params"] = tuple(sorted(merged.items()))
        return replace(self, **fields)

    @property
    def n_vectors(self) -> int:
        return self.n_tables * self.rows_per_table


def make_spec(regime: str, *, n_tables: int = 8, rows_per_table: int = 2048,
              n_accesses: int = 60_000, seed: int = 0,
              **params) -> WorkloadSpec:
    """Build a spec; unknown keywords become regime params."""
    return WorkloadSpec(regime, n_tables, rows_per_table, n_accesses, seed,
                        tuple(sorted(params.items())))


def make_trace(spec: WorkloadSpec) -> Trace:
    """Generate the full trace for a spec (seeded, deterministic).

    The ``replay`` regime loads its file instead of generating (the
    file's table geometry is authoritative — see
    :mod:`repro_torch.workloads.replay`)."""
    if spec.regime not in REGIMES:
        raise KeyError(f"unknown workload regime {spec.regime!r} "
                       f"(known: {sorted(REGIMES)})")
    allowed = REGIME_PARAMS[spec.regime]
    unknown = sorted(k for k, _ in spec.params if k not in allowed)
    if unknown:
        raise KeyError(f"regime {spec.regime!r} does not read params "
                       f"{unknown} (it reads: {sorted(allowed)})")
    if spec.regime == "replay":
        from repro_torch.workloads.replay import make_replay_trace

        return make_replay_trace(spec)
    rng = np.random.default_rng(spec.seed)
    table_id, row_id = REGIMES[spec.regime](spec, rng)
    table_id = np.asarray(table_id, np.int32).ravel()[: spec.n_accesses]
    row_id = np.asarray(row_id, np.int64).ravel()[: spec.n_accesses]
    if len(table_id) != spec.n_accesses or len(row_id) != spec.n_accesses:
        raise ValueError(
            f"regime {spec.regime!r} produced {len(row_id)} accesses, "
            f"spec asked for {spec.n_accesses}")
    rows_per_table = np.full(spec.n_tables, spec.rows_per_table, np.int64)
    return Trace(table_id, row_id, rows_per_table)


def iter_batches(spec: WorkloadSpec, batch: int,
                 trace: Optional[Trace] = None) -> Iterator[np.ndarray]:
    """Yield the spec's access stream as flat global-id batches of exactly
    ``batch`` ids each (``n_accesses // batch`` batches; the remainder is
    dropped, mirroring the serving loops).  Pass ``trace`` to reuse an
    already-generated trace."""
    if batch < 1:
        raise ValueError("batch must be >= 1")
    if trace is None:
        trace = make_trace(spec)
    gid = trace.global_id
    for b in range(len(gid) // batch):
        yield gid[b * batch: (b + 1) * batch]


# ---------------------------------------------------------------------------
# Named scenario catalog (the taxonomy table in docs/architecture.md)
# ---------------------------------------------------------------------------

# name -> (regime, default params).  Scale fields (n_tables/rows/accesses/
# seed) are supplied by the caller via scenario(**overrides).
SCENARIOS: Dict[str, Tuple[str, Dict[str, object]]] = {
    # Stationary zipf family at three skews: the paper's steady-state
    # power-law regime (~20% of vectors take ~80% of accesses at the
    # mid/high skews).
    "zipf_low": ("stationary", {"zipf_a": 0.8}),
    "zipf_mid": ("stationary", {"zipf_a": 1.05}),
    "zipf_hot": ("stationary", {"zipf_a": 1.4}),
    # Diurnal hot-set rotation: the working set moves wholesale every
    # period (day/night traffic mix shifting which users are active).
    "diurnal": ("diurnal", {"n_phases": 4, "hot_frac": 0.05,
                            "p_hot": 0.9}),
    # Flash crowd: a burst of traffic lands on previously-cold rows
    # (viral item) and then subsides.
    "flash_crowd": ("flash_crowd", {"onset": 0.5, "duration": 0.3,
                                    "p_burst": 0.85, "burst_frac": 0.03}),
    # Multi-tenant interleave: several per-tenant zipfs over disjoint hot
    # sets, scheduled in coarse blocks (one model server, many traffic
    # sources).
    "multi_tenant": ("multi_tenant", {"n_tenants": 4, "block": 512,
                                      "zipf_a": 1.2}),
    # Popularity-decay churn: the hot set drifts continuously instead of
    # switching (items go stale, new items warm up).
    "churn": ("churn", {"zipf_a": 1.1, "churn_per_k": 24.0}),
}

# The regimes whose steady distribution the paper's skew claims target —
# the scenario matrix asserts recmg's on-demand fetches <= LRU's here.
PAPER_TARGET_SCENARIOS = ("zipf_low", "zipf_mid", "zipf_hot", "churn")
# Regimes with a distribution switch mid-trace — the drift-adaptation
# acceptance criterion applies to these.
DRIFT_SCENARIOS = ("diurnal", "flash_crowd")


def scenario(name: str, **overrides) -> WorkloadSpec:
    """Instantiate a named catalog scenario; ``overrides`` may set scale
    fields (``n_tables``...) and/or regime params."""
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r} "
                       f"(known: {sorted(SCENARIOS)})")
    regime, params = SCENARIOS[name]
    spec = make_spec(regime, **params)
    return spec.with_(**overrides) if overrides else spec


def parse_workload(text: str) -> WorkloadSpec:
    """Parse a CLI workload argument: ``name`` or ``name:key=val,...``.

    ``name`` is a catalog scenario or a bare regime name; values parse as
    int, then float, then string (``replay:path=trace.npz``).  A replay
    workload defaults to the *whole file* (``n_accesses=0``) rather than
    the spec default — pass ``replay:path=...,n_accesses=N`` to truncate
    to a prefix."""
    name, _, rest = text.partition(":")
    kw: Dict[str, object] = {}
    for item in filter(None, rest.split(",")):
        k, _, v = item.partition("=")
        for cast in (int, float):
            try:
                kw[k] = cast(v)
                break
            except ValueError:
                continue
        else:
            kw[k] = v
    if name == "replay":
        kw.setdefault("n_accesses", 0)
    if name in SCENARIOS:
        return scenario(name, **kw)
    if name in REGIMES:
        return make_spec(name, **kw)
    raise KeyError(f"unknown workload {text!r} (scenarios: "
                   f"{sorted(SCENARIOS)}; regimes: {sorted(REGIMES)})")
