"""The port's workload scenarios against the JAX package's.

Workload generation is NumPy on both sides: an equal ``WorkloadSpec``
gives byte-identical traces, batches and DLRM query streams.  The port's
``replay_scenario`` serves on its own store (on the CPU here) and must
reproduce the heuristic scenario goldens ``tests/golden/scenario_*_{lru,
recmg}_n1.json`` exactly; this file only reads them.  The sharded cells
(``shards > 0``) raise until ROADMAP A10.
"""
import json
from pathlib import Path

import numpy as np
import pytest

from repro.core.trace import save_trace as jax_save_trace
from repro.data.dlrm_data import DLRMDataConfig as JaxDataConfig
from repro.data.dlrm_data import query_batches as jax_query_batches
from repro.workloads import REGIMES as JAX_REGIMES
from repro.workloads import SCENARIOS as JAX_SCENARIOS
from repro.workloads import iter_batches as jax_iter_batches
from repro.workloads import make_spec as jax_make_spec
from repro.workloads import make_trace as jax_make_trace
from repro.workloads import parse_workload as jax_parse_workload
from repro.workloads import replay_scenario as jax_replay_scenario
from repro.workloads import scenario as jax_scenario
from repro_torch.core.trace import TraceGenConfig, generate_trace, save_trace
from repro_torch.data.dlrm_data import DLRMDataConfig, query_batches
from repro_torch.workloads import (DRIFT_SCENARIOS, REGIMES, SCENARIOS,
                                   build_store, golden_metrics, iter_batches,
                                   make_spec, make_trace, parse_workload,
                                   phase_steady_hit_rates, replay_overload,
                                   replay_scenario, scenario)

GOLDEN_DIR = Path(__file__).parent / "golden"
# The scenario matrix's scale (tests/test_scenario_matrix.py).
SCALE = dict(n_tables=4, rows_per_table=512, n_accesses=8192, seed=0)
BATCH = 256
CAP_FRAC = 0.12
TRACE_FIELDS = ("table_id", "row_id", "rows_per_table", "query_id")


def _same_trace(got, want):
    for f in TRACE_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if a is None or b is None:  # no query grouping in this trace
            assert a is None and b is None, f
            continue
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_registries_equal_jax():
    assert sorted(REGIMES) == sorted(JAX_REGIMES)
    assert SCENARIOS == JAX_SCENARIOS


@pytest.mark.parametrize("regime", sorted(set(JAX_REGIMES) - {"replay"}))
@pytest.mark.parametrize("seed", [0, 7])
def test_every_regime_trace_byte_identical(regime, seed):
    kw = dict(n_tables=5, rows_per_table=300, n_accesses=4000, seed=seed)
    _same_trace(make_trace(make_spec(regime, **kw)),
                jax_make_trace(jax_make_spec(regime, **kw)))


@pytest.mark.parametrize("name", sorted(JAX_SCENARIOS))
def test_every_scenario_trace_byte_identical(name):
    got = make_trace(scenario(name, **SCALE))
    _same_trace(got, jax_make_trace(jax_scenario(name, **SCALE)))
    batches = list(iter_batches(scenario(name, **SCALE), 1000, trace=got))
    want = list(jax_iter_batches(jax_scenario(name, **SCALE), 1000))
    assert len(batches) == len(want) == 8
    for a, b in zip(batches, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("text", [
    "zipf_hot", "diurnal:n_phases=6,hot_frac=0.1,seed=3",
    "stationary:zipf_a=1.3", "churn:churn_per_k=12.5",
    "sustained_overload:load_x=4", "replay:path=x.npz",
    "replay:path=x.npz,n_accesses=100"])
def test_parse_workload_equals_jax(text):
    got, want = parse_workload(text), jax_parse_workload(text)
    assert (got.regime, got.n_tables, got.rows_per_table, got.n_accesses,
            got.seed, got.params) == \
        (want.regime, want.n_tables, want.rows_per_table, want.n_accesses,
         want.seed, want.params)


def test_bad_workloads_raise_like_jax():
    with pytest.raises(KeyError):
        parse_workload("no_such_workload")
    with pytest.raises(KeyError, match="n_phase"):
        make_trace(make_spec("diurnal", n_phase=6, n_accesses=100))
    with pytest.raises(KeyError):
        make_trace(make_spec("not_a_regime"))
    with pytest.raises(ValueError):
        list(iter_batches(scenario("zipf_mid"), 0))


@pytest.mark.parametrize("fmt", ["npz", "csv"])
def test_replay_round_trip(tmp_path, fmt):
    """A trace saved by either package replays byte-identically through
    the port's workload API, whole or truncated to a prefix."""
    tr = generate_trace(TraceGenConfig(n_tables=3, rows_per_table=50,
                                       n_accesses=700, seed=4))
    for saver, path in ((save_trace, tmp_path / f"port.{fmt}"),
                        (jax_save_trace, tmp_path / f"jax.{fmt}")):
        saver(tr, path)
        _same_trace(make_trace(parse_workload(f"replay:path={path}")), tr)
        spec = make_spec("replay", path=str(path), n_accesses=120)
        np.testing.assert_array_equal(make_trace(spec).global_id,
                                      tr.global_id[:120])
        bs = list(iter_batches(parse_workload(f"replay:path={path}"), 64))
        np.testing.assert_array_equal(np.concatenate(bs),
                                      tr.global_id[: len(bs) * 64])


@pytest.mark.parametrize("source", ["trace", "workload", "default"])
def test_query_batches_equal_jax(source):
    kw = dict(n_tables=2, rows_per_table=64, multi_hot=2, batch=4, seed=3)
    extra = {}
    if source == "trace":
        tr = generate_trace(TraceGenConfig(n_tables=2, rows_per_table=64,
                                           n_accesses=100, seed=1))
        extra, jextra = dict(trace=tr), dict(trace=tr)
    elif source == "workload":
        extra, jextra = (dict(workload=scenario("zipf_hot")),
                         dict(workload=jax_scenario("zipf_hot")))
    else:
        jextra = {}
    got = list(query_batches(DLRMDataConfig(**kw), n_batches=5, **extra))
    want = list(jax_query_batches(JaxDataConfig(**kw), n_batches=5,
                                  **jextra))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def _golden_cells():
    return [(n, p) for n in sorted(SCENARIOS) for p in ("lru", "recmg")]


@pytest.mark.parametrize("name,policy", _golden_cells())
def test_replay_scenario_matches_heuristic_golden(name, policy):
    """The scenario matrix's n=1 heuristic cells, served by the port,
    give exactly the committed golden metrics (read only)."""
    res = replay_scenario(scenario(name, **SCALE), policy=policy,
                          capacity_frac=CAP_FRAC, batch=BATCH, device="cpu")
    want = json.loads(
        (GOLDEN_DIR / f"scenario_{name}_{policy}_n1.json").read_text())
    assert golden_metrics(res) == want
    assert res["hits"] + res["misses"] == res["lookups"]


@pytest.mark.parametrize("name", sorted(DRIFT_SCENARIOS))
def test_replay_scenario_adapt_equals_jax(name):
    kw = dict(policy="recmg", capacity_frac=CAP_FRAC, batch=BATCH,
              profile_frac=0.25, adapt=True)
    got = replay_scenario(scenario(name, **SCALE), device="cpu", **kw)
    want = jax_replay_scenario(jax_scenario(name, **SCALE), **kw)
    assert golden_metrics(got) == golden_metrics(want)
    assert got["drift"] == want["drift"]
    assert got["batch_hit_rates"] == want["batch_hit_rates"]
    np.testing.assert_array_equal(phase_steady_hit_rates(got, 2),
                                  phase_steady_hit_rates(want, 2))
    assert got["drift"]["triggers"] >= 1


def test_replay_scenario_quantized_byte_budget_equals_jax():
    kw = dict(policy="lru", batch=BATCH, byte_budget=200 * 8 * 4,
              quantize=True, row_format="fp8")
    got = replay_scenario(scenario("zipf_mid", **SCALE), device="cpu", **kw)
    want = jax_replay_scenario(jax_scenario("zipf_mid", **SCALE), **kw)
    assert golden_metrics(got) == golden_metrics(want)
    assert got["capacity"] == want["capacity"] == 200 * 32 // 12


@pytest.mark.parametrize("call", ["replay_scenario", "build_store",
                                  "replay_overload"])
def test_shards_raise_naming_a10(call):
    calls = {
        "replay_scenario": lambda: replay_scenario(
            scenario("zipf_mid", **SCALE), shards=2, device="cpu"),
        "build_store": lambda: build_store(
            np.zeros((8, 4), np.float32), np.array([8]), 4, "lru", shards=2,
            device="cpu"),
        "replay_overload": lambda: replay_overload(
            make_spec("sustained_overload", n_accesses=1000), shards=2,
            device="cpu"),
    }
    with pytest.raises(NotImplementedError, match="A10"):
        calls[call]()
