"""Sustained-overload serving harness: offered load as a multiple of
modeled compute capacity, replayed through the admission-controlled
:class:`~repro_torch.runtime.pipeline.PipelinedRuntime` on the deterministic
VirtualClock.

Ported from ``src/repro/workloads/overload.py``, a copy with one change:
the store lives on ``device`` (``"cuda"`` by default; it raises when CUDA
is absent), so an over-deadline request's degraded read runs the store's
gather kernel there.

Capacity is the modeled dense-forward rate: one batch of ``batch``
queries per ``compute_us``, so offered load ``load_x`` maps to an
open-loop arrival process with::

    interarrival_us = compute_us / (batch * load_x)

At ``load_x < 1`` the admission queue stays shallow and everything is
served; past 1x the queue saturates at its bound, the excess is shed
lowest-priority-first, over-deadline stragglers take the degraded
(stale/default-row) path, and prefetch issue is suppressed under
backpressure.  **Goodput** counts full-quality served requests per
modeled second — the smooth-degradation gate in
``scripts/check_bench_regression.py`` asserts goodput at 4x offered load
stays within 0.7x of goodput at 1x (no congestion collapse).

Everything here is deterministic: equal specs + equal knobs give
byte-identical shed/degrade/served counts (asserted in
``tests/test_admission.py``), and the ``adm.*`` /  ``rt.*`` / ``store.*``
namespaces reconcile exactly (``scripts/check_accounting.py``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import MetricsRegistry
from repro_torch.obs.reconcile import reconcile
from repro_torch.runtime.admission import AdmissionConfig
from repro_torch.runtime.pipeline import PipelinedRuntime, RuntimeConfig
from repro_torch.workloads.harness import build_store
from repro_torch.workloads.spec import WorkloadSpec, make_spec, make_trace

_EMPTY = np.empty(0, np.int64)

# Fate / goodput keys a regression test may pin (all deterministic).
OVERLOAD_KEYS = ("load_x", "offered_rps", "goodput_rps", "admitted",
                 "served", "shed", "degraded")


def default_priority_mix(n_classes: int = 3) -> Tuple[float, ...]:
    """Traffic mix over priority classes, most-important first: a small
    gold slice, a moderate silver slice, the bronze bulk."""
    if n_classes == 1:
        return (1.0,)
    if n_classes == 2:
        return (0.3, 0.7)
    rest = (1.0 - 0.5) / max(n_classes - 2, 1)
    return (0.2, 0.3) + (rest,) * (n_classes - 2)


def replay_overload(spec: Optional[WorkloadSpec] = None, *,
                    load_x: float = 1.0, policy: str = "lru",
                    batch: int = 64, per_query: int = 8,
                    compute_us: float = 500.0,
                    queue_bound: Optional[int] = None,
                    class_deadline_us: Optional[Sequence[float]] = None,
                    priority_mix: Optional[Sequence[float]] = None,
                    capacity_frac: float = 0.12,
                    capacity: Optional[int] = None,
                    shards: int = 0, placement: str = "table",
                    pipeline_depth: int = 2, emb_dim: int = 8,
                    degrade: bool = True, prefetch: bool = True,
                    check: bool = True, device="cuda") -> Dict:
    """Serve one overload scenario end to end; returns the fate counters,
    goodput, tail latency and the full metrics snapshot.

    ``spec`` defaults to the ``sustained_overload`` regime; a ``load_x``
    param riding on the spec (``parse_workload("sustained_overload:
    load_x=4")``) overrides the keyword.  ``queue_bound`` defaults to 4
    batches of headroom; ``class_deadline_us`` defaults to (4, 16, 64)
    batch times — tight enough that EDF and the degraded path both
    matter at saturation.  ``prefetch=True`` stages each batch's unique
    ids as a prefetch set, so backpressure suppression has traffic to
    act on.
    """
    if spec is None:
        spec = make_spec("sustained_overload", n_accesses=48_000)
    load_x = float(spec.param("load_x", load_x))
    if not load_x > 0:
        raise ValueError(f"load_x must be > 0, got {load_x}")
    trace = make_trace(spec)
    cap = int(capacity) if capacity else max(
        4, int(capacity_frac * trace.unique_count()))
    host = np.random.default_rng(0).normal(
        size=(trace.n_vectors, emb_dim)).astype(np.float32)
    store = build_store(host, trace.rows_per_table, cap, policy,
                        shards=shards, placement=placement,
                        warmup_batch=batch * per_query, device=device)

    if class_deadline_us is None:
        class_deadline_us = (4 * compute_us, 16 * compute_us,
                             64 * compute_us)
    adm = AdmissionConfig(
        queue_bound=int(queue_bound) if queue_bound else 4 * batch,
        class_deadline_us=tuple(float(d) for d in class_deadline_us),
        degrade=degrade)
    if priority_mix is None:
        priority_mix = default_priority_mix(adm.n_classes)
    mix = np.asarray(priority_mix, np.float64)
    if mix.size != adm.n_classes or mix.min() < 0 or mix.sum() <= 0:
        raise ValueError(f"priority_mix needs {adm.n_classes} non-negative "
                         f"weights, got {priority_mix!r}")
    mix = mix / mix.sum()

    interarrival_us = compute_us / (batch * load_x)
    rt = PipelinedRuntime(store, RuntimeConfig(
        max_batch=batch, pipeline_depth=pipeline_depth,
        interarrival_us=interarrival_us, compute_us=compute_us,
        admission=adm))

    # Queries: consecutive ``per_query``-id slices of the trace, each
    # tagged with a deterministically drawn priority class.
    gid = trace.global_id
    n_q = len(gid) // per_query
    pri = np.random.default_rng(spec.seed + 1).choice(
        adm.n_classes, size=n_q, p=mix)
    stream = ((gid[q * per_query: (q + 1) * per_query], int(pri[q]))
              for q in range(n_q))

    if prefetch:
        # Model-free prefetch stream: each batch's unique ids go back in
        # as a prefetch set (hot rows recur, and under backpressure this
        # is exactly the traffic that gets suppressed).  The batch hook
        # receives the batch ids the step function never sees.
        def batch_hook(ids, hits, b):
            return [(_EMPTY, _EMPTY, np.unique(ids))]
        rt._batch_hook = batch_hook

    # The dense forward is the configured modeled constant; the step
    # function itself does no work and stages nothing.
    rt.run(stream, lambda b, emb: (0.0, []))

    st = rt.admission_stats
    tel = rt.telemetry
    modeled_s = max(rt.clock.now() * 1e-6, 1e-12)
    lat_ms = np.asarray([u * 1e-3 for u in tel.latencies_us], np.float64)
    res = {
        "regime": spec.regime, "policy": policy, "shards": shards,
        "load_x": load_x,
        "offered_rps": round(1e6 / interarrival_us, 3),
        "goodput_rps": round(st.total_served / modeled_s, 3),
        "served_rps": round((st.total_served + st.total_degraded)
                            / modeled_s, 3),
        "modeled_s": round(modeled_s, 6),
        "batches": tel.batches,
        "queue_bound": adm.queue_bound,
        "pf_suppressed": tel.pf_suppressed,
        "p99_ms": round(float(np.percentile(lat_ms, 99)), 3)
        if lat_ms.size else 0.0,
        "p999_ms": round(float(np.percentile(lat_ms, 99.9)), 3)
        if lat_ms.size else 0.0,
    }
    res.update(st.as_dict(adm))
    st.check()

    reg = MetricsRegistry()
    rt.publish(reg)
    store.publish_metrics(reg)
    if check:
        reconcile(metrics=reg.as_dict(), strict=True)
    res["metrics"] = reg.snapshot()
    return res


def overload_sweep(loads: Sequence[float] = (0.5, 1.0, 2.0, 4.0),
                   **kw) -> Dict[float, Dict]:
    """Replay the same scenario at each offered load (fresh store and
    runtime per point — the sweep compares steady states, not history).
    Returns ``{load_x: replay_overload result}``."""
    return {float(x): replay_overload(load_x=float(x), **kw)
            for x in loads}


def degradation_ratio(sweep: Dict[float, Dict], hi: float = 4.0,
                      lo: float = 1.0) -> float:
    """The smooth-degradation figure of merit: goodput at ``hi``x offered
    load over goodput at ``lo``x (1.0 == perfectly flat; collapse pulls
    it toward 0)."""
    return (sweep[hi]["goodput_rps"]
            / max(sweep[lo]["goodput_rps"], 1e-12))
