"""The port's MultiTableTieredStore against the JAX package's, and
``serve_trace`` with ``multi_table`` / ``quantize`` against the JAX
``serve_trace``.

Capacities, byte budgets and every counter must be equal.  Rows: fp32 rows
are copies, so bit-exact; quantized rows are ``code * scale`` with equal
codes and scales within one ulp (the JAX store's jitted quantizer rounds
the scale division differently from its jnp reference, the port's matches
the reference), so fp32 rtol 2.4e-7.
"""
import dataclasses
from functools import lru_cache

import numpy as np
import pytest
import torch

from repro.core.serving import MultiTableTieredStore as JaxMultiStore
from repro.obs import MetricsRegistry as JaxRegistry
from repro_torch.configs import get_config
from repro_torch.core.recmg import frequency_outputs
from repro_torch.core.serving import MultiTableTieredStore
from repro_torch.core.trace import TraceGenConfig, generate_trace
from repro_torch.launch.serve import serve_trace
from repro_torch.models.dlrm import init_dlrm
from repro_torch.obs import MetricsRegistry

COUNTERS = ("batches", "lookups", "hits", "misses", "prefetch_hits",
            "on_demand_rows", "evictions", "modeled_fetch_s")
SERVE_KEYS = ("policy", "batches", "lookups", "hits", "misses", "hit_rate",
              "prefetch_hits", "on_demand_rows", "evictions",
              "on_demand_stall_ms", "modeled_fetch_ms_per_batch")
ROW_RTOL = {None: 0.0, "int8": 2.4e-7, "fp8": 2.4e-7}


def _tables(sizes, d=8, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, d)).astype(dtype) for n in sizes]


def _quant_kw(row_format):
    return {} if row_format is None else {"quantize": True,
                                          "row_format": row_format}


@pytest.mark.parametrize("sizes,kw", [
    ((100, 50, 200), dict(capacity=70)),
    ((100, 50, 200), dict(capacity=10_000)),
    ((100, 50, 200), dict(byte_budget=70 * 8 * 4)),
    ((100, 50, 200), dict(byte_budget=70 * 8 * 4, quantize=True)),
    ((100, 50, 200), dict(byte_budget=70 * 8 * 4, quantize=True,
                          row_format="fp8")),
    ((500, 6, 6, 6, 6), dict(capacity=30, min_capacity=4)),
    ((6,) * 10, dict(byte_budget=12 * 8 * 4, min_capacity=4)),
    ((6,) * 9, dict(capacity=13, min_capacity=4)),
    ((200, 200, 200), dict(byte_budget=50 * 8 * 4, quantize=True)),
])
def test_budget_split_matches_jax(sizes, kw):
    tables = _tables(sizes)
    got = MultiTableTieredStore(tables, device="cpu", **kw)
    want = JaxMultiStore(tables, **kw)
    assert [s.capacity for s in got.stores] == \
        [s.capacity for s in want.stores]
    assert (got.capacity, got.byte_budget, got.row_bytes) == \
        (want.capacity, want.byte_budget, want.row_bytes)
    np.testing.assert_array_equal(got.row_bytes_per_table,
                                  want.row_bytes_per_table)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert all(s.quantize == kw.get("quantize", False) for s in got.stores)


def test_budget_below_one_row_per_table_raises():
    with pytest.raises(ValueError, match="one row each"):
        MultiTableTieredStore(_tables((6,) * 10), capacity=5, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        MultiTableTieredStore(_tables((6,)), device="cpu")


@pytest.mark.parametrize("row_format", [None, "int8", "fp8"])
@pytest.mark.parametrize("policy", ["lru", "recmg"])
def test_facade_matches_jax(policy, row_format):
    """A trace through both facades, model outputs staged per batch and
    routed per table: rows, counters, per-table hit rates, residency and
    the degraded read agree after every batch."""
    trace = generate_trace(TraceGenConfig(
        n_tables=3, rows_per_table=400, n_accesses=3600, seed=1,
        drift_every=10**9))
    tables = _tables(trace.rows_per_table.tolist(), d=16, seed=2)
    kw = dict(capacity=150, policy=policy, **_quant_kw(row_format))
    got = MultiTableTieredStore(tables, device="cpu", warmup_batch=16, **kw)
    want = JaxMultiStore(tables, **kw)
    outs = frequency_outputs(trace, 150)
    host = np.concatenate(tables)
    probe = np.random.default_rng(3).integers(0, host.shape[0], 64)
    per_batch = 300
    for b in range(len(trace) // per_batch):
        ids = trace.global_id[b * per_batch: (b + 1) * per_batch]
        rows = got.lookup(ids)
        assert isinstance(rows, torch.Tensor) and rows.dtype == torch.float32
        np.testing.assert_allclose(rows.numpy(), np.asarray(want.lookup(ids)),
                                   rtol=ROW_RTOL[row_format], atol=0)
        c = b % len(outs.chunk_starts)
        item = (ids[-15:], outs.caching_bits[c], outs.prefetch_ids[c])
        got.stage_model_outputs(*item)
        want.stage_model_outputs(*item)
        got.flush_staged()
        want.flush_staged()
        for k in COUNTERS:
            assert getattr(got.stats, k) == getattr(want.stats, k), k
        assert got.per_table_hit_rates() == want.per_table_hit_rates()
        np.testing.assert_array_equal(got.resident_mask(probe),
                                      want.resident_mask(probe))
        r, n = got.lookup_resident(probe)
        r_jax, n_jax = want.lookup_resident(probe)
        assert n == n_jax
        np.testing.assert_allclose(r, r_jax, rtol=ROW_RTOL[row_format],
                                   atol=0)
        for s in got.stores:
            s.check_invariants()
    assert got.stats.hits > 0 and got.stats.evictions > 0
    if policy == "recmg":
        assert got.stats.prefetch_hits > 0


def test_apply_model_outputs_routes_per_table():
    tables = _tables((100, 50, 200))
    got = MultiTableTieredStore(tables, capacity=64, device="cpu")
    want = JaxMultiStore(tables, capacity=64)
    for ms in (got, want):
        ms.apply_model_outputs(np.array([3, 120]), np.array([1, 0]),
                               np.array([5, 120, 349]))
    assert [s.n_resident for s in got.stores] == \
        [s.n_resident for s in want.stores] == [1, 1, 1]
    snap = got.publish_metrics(MetricsRegistry()).snapshot()
    jsnap = want.publish_metrics(JaxRegistry()).snapshot()
    assert sorted(snap["counters"]) == sorted(jsnap["counters"])
    assert snap["gauges"]["tables.n_tables"] == 3


def _counts(res):
    """The run's published counters, less the measured seconds."""
    return {k: v for k, v in res["metrics"]["counters"].items()
            if not k.endswith("_s")}


@lru_cache(maxsize=1)
def _fixture():
    """The golden-trace fixture of ``tests/test_torch_serve.py``."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models.dlrm import init_dlrm as jax_init_dlrm

    cfg = dataclasses.replace(get_config("dlrm-recmg").reduced(),
                              n_tables=4, rows_per_table=1024, multi_hot=2,
                              emb_dim=16)
    jcfg = dataclasses.replace(jax_get_config("dlrm-recmg").reduced(),
                               n_tables=4, rows_per_table=1024, multi_hot=2,
                               emb_dim=16)
    trace = generate_trace(TraceGenConfig(
        n_tables=cfg.n_tables, rows_per_table=cfg.rows_per_table,
        n_accesses=8000, seed=0, drift_every=10**9))
    return (cfg, init_dlrm(cfg, seed=0, device="cpu"), jcfg,
            jax_init_dlrm(jax.random.PRNGKey(0), jcfg), trace)


@pytest.mark.parametrize("kw", [
    dict(multi_table=True),
    dict(quantize=True),
    dict(quantize=True, row_format="fp8"),
    dict(multi_table=True, quantize=True),
], ids=["multi_table", "int8", "fp8", "multi_table-int8"])
@pytest.mark.parametrize("policy", ["lru", "recmg"])
def test_serve_trace_matches_jax(policy, kw):
    from repro.core.recmg import frequency_outputs as jax_frequency_outputs
    from repro.launch.serve import serve_trace as jax_serve_trace

    cfg, params, jcfg, jparams, trace = _fixture()
    cap = int(0.15 * trace.unique_count())
    rec = policy == "recmg"
    got = serve_trace(cfg, params, trace, cap, policy,
                      frequency_outputs(trace, cap) if rec else None,
                      batch_queries=8, device="cpu", collect_logits=True,
                      **kw)
    want = jax_serve_trace(jcfg, jparams, trace, cap, policy,
                           jax_frequency_outputs(trace, cap) if rec else None,
                           batch_queries=8, **kw)
    assert {k: got[k] for k in SERVE_KEYS} == {k: want[k] for k in SERVE_KEYS}
    assert got.get("per_table_hit_rates") == want.get("per_table_hit_rates")
    assert ("per_table_hit_rates" in got) == bool(kw.get("multi_table"))
    assert _counts(got) == _counts(want)
    assert got["logits"].shape == (got["batches"], 8)
    assert np.isfinite(got["logits"]).all()
