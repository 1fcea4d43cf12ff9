"""The port's sharded multi-worker store driven side by side with the JAX
package's, on the CPU.

Both stores take the same plan inputs, the same id batches and the same
model outputs.  Per batch: the counters (wall-clock seconds aside) and
``shard_telemetry`` are equal, and the rows are bit-equal for fp32 and
within fp32 rtol 2.4e-7 for int8 (the JAX store's jitted quantizer can
differ from the jnp reference, which the port reproduces, by one ulp of a
scale: ROADMAP C).  The port's store, its pipelined runtime and the
``serve_trace`` / ``replay_scenario`` paths must reproduce the sharded
goldens ``tests/golden/serve_lru_sharded_table2.json`` and the 14
heuristic ``scenario_*_{lru,recmg}_n2.json``; this file only reads them.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.sharded_serving import ShardedTieredStore as JaxSharded
from repro.runtime import PipelinedRuntime as JaxRuntime
from repro.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.sharding.embedding_shard import make_plan as jax_make_plan
from repro_torch.configs import get_config
from repro_torch.core.sharded_serving import ShardedTieredStore
from repro_torch.core.tiered import TieredEmbeddingStore
from repro_torch.core.trace import TraceGenConfig, generate_trace
from repro_torch.launch.serve import serve_trace
from repro_torch.models.dlrm import init_dlrm
from repro_torch.obs import MetricsRegistry, reconcile
from repro_torch.runtime import PipelinedRuntime, RuntimeConfig
from repro_torch.sharding.embedding_shard import make_plan
from repro_torch.workloads import (SCENARIOS, golden_metrics,
                                   replay_scenario, scenario)

GOLDEN_DIR = Path(__file__).parent / "golden"
EMPTY = np.empty(0, np.int64)
ROWS = [100, 50, 200, 70]
N_VEC = sum(ROWS)
WALL = ("fetch_s", "gather_s", "model_s")
COUNTERS = ("batches", "lookups", "hits", "prefetch_hits",
            "on_demand_rows", "evictions")
# The scenario matrix's scale (tests/test_scenario_matrix.py).
SCALE = dict(n_tables=4, rows_per_table=512, n_accesses=8192, seed=0)


def _host(n=N_VEC, d=8, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _ids(n_acc=2000, seed=0):
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(1.15, size=n_acc), N_VEC) - 1
    return rng.permutation(N_VEC)[ranks].astype(np.int64)


def _counters(store):
    d = store.stats.as_dict()
    for k in WALL:
        d.pop(k)
    return d


def _pair(placement, policy, quantize=False, n_shards=4, capacity=56,
          **kw):
    freq = np.random.default_rng(5).zipf(1.3, size=N_VEC)
    host = _host()
    plan_kw = dict(frequencies=freq, replicate_hot=kw.pop("replicate_hot",
                                                          0))
    q = dict(quantize=True, row_format="int8") if quantize else {}
    jax_store = JaxSharded(host, jax_make_plan(ROWS, n_shards, capacity,
                                               placement, **plan_kw),
                           policy=policy, **q, **kw)
    store = ShardedTieredStore(host, make_plan(ROWS, n_shards, capacity,
                                               placement, **plan_kw),
                               policy=policy, device="cpu", **q, **kw)
    return host, jax_store, store


def _same_rows(got, want, quantize):
    assert got.dtype == torch.float32
    if quantize:
        np.testing.assert_allclose(got.numpy(), want, rtol=2.4e-7, atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("placement", ["table", "row", "hash", "freq"])
@pytest.mark.parametrize("policy", ["lru", "recmg"])
@pytest.mark.parametrize("rows", ["fp32", "int8"])
def test_per_batch_counters_telemetry_and_rows_equal_jax(placement, policy,
                                                         rows):
    quantize = rows == "int8"
    host, jax_store, store = _pair(placement, policy, quantize)
    ids = _ids(1200, seed=4)
    for b in range(12):
        batch = ids[b * 100: (b + 1) * 100]
        want = np.asarray(jax_store.lookup(batch))
        got = store.lookup(batch)
        _same_rows(got, want, quantize)
        if not quantize:
            np.testing.assert_array_equal(got.numpy(), host[batch])
        item = (ids[b * 100: b * 100 + 8], np.ones(8, np.int64),
                np.unique(ids[b * 3: b * 3 + 4]))
        jax_store.apply_model_outputs(*item)
        store.apply_model_outputs(*item)
        assert _counters(store) == _counters(jax_store), b
        assert store.shard_telemetry() == jax_store.shard_telemetry(), b
        for st in store.stores:
            st.check_invariants()
    probe = _ids(300, seed=9)
    np.testing.assert_array_equal(store.resident_mask(probe),
                                  jax_store.resident_mask(probe))
    rows_r, nd = store.lookup_resident(probe)
    want_r, want_nd = jax_store.lookup_resident(probe)
    assert nd == want_nd
    np.testing.assert_allclose(rows_r, want_r,
                               rtol=2.4e-7 if quantize else 0, atol=0)
    dev_rows, dev_nd = store.lookup_resident_device(probe)
    assert dev_nd == nd
    np.testing.assert_array_equal(dev_rows.numpy(), rows_r)
    assert store.critical_batch_ms() == jax_store.critical_batch_ms()
    assert store.modeled_batch_ms() == jax_store.modeled_batch_ms()
    assert store.per_shard_hit_rates() == jax_store.per_shard_hit_rates()


def test_metrics_layout_equals_jax_and_reconciles():
    _, jax_store, store = _pair("freq", "recmg", replicate_hot=24)
    ids = _ids(800, seed=2)
    for b in range(8):
        for s in (jax_store, store):
            s.lookup(ids[b * 100: (b + 1) * 100])
            s.apply_model_outputs(EMPTY, EMPTY, np.unique(ids[b * 100:
                                                              b * 100 + 9]))
    reg, jreg = MetricsRegistry(), MetricsRegistry()
    store.publish_metrics(reg)
    jax_store.publish_metrics(jreg)
    got, want = reg.as_dict(), jreg.as_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if not k.endswith(WALL):
            assert got[k] == v, k
    assert reconcile(metrics=got, strict=False) == []


@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
def test_build_byte_budget_equals_jax(quantize):
    host = _host()
    kw = dict(byte_budget=60 * 8 * 4, quantize=quantize, with_engines=False)
    got = ShardedTieredStore.build(host, ROWS, 2, device="cpu", **kw)
    want = JaxSharded.build(host, ROWS, 2, **kw)
    assert [s.capacity for s in got.stores] == \
        [s.capacity for s in want.stores]
    out = got.lookup(_ids(64))
    assert out.shape == (64, 8) and out.dtype == torch.float32
    with pytest.raises(ValueError, match="at most one"):
        ShardedTieredStore.build(host, ROWS, 2, capacity=10,
                                 byte_budget=100, device="cpu")
    with pytest.raises(ValueError, match="capacity .* required"):
        ShardedTieredStore.build(host, ROWS, 2, "row", device="cpu")
    with pytest.raises(ValueError, match="plan covers"):
        ShardedTieredStore(_host(N_VEC - 1), make_plan(ROWS, 2, 64),
                           device="cpu")


@pytest.mark.parametrize("placement", ["row", "hash"])
def test_engines_off_matches_engines_on_and_jax(placement):
    ids = _ids(1200, seed=4)
    runs = []
    for with_engines in (True, False):
        _, jax_store, store = _pair(placement, "recmg", capacity=48,
                                    with_engines=with_engines)
        for b in range(12):
            for s in (jax_store, store):
                s.lookup(ids[b * 100: (b + 1) * 100])
                s.apply_model_outputs(ids[b * 100: b * 100 + 8],
                                      np.ones(8, np.int64),
                                      np.unique(ids[b * 3: b * 3 + 4]))
        assert _counters(store) == _counters(jax_store)
        runs.append(_counters(store))
    assert runs[0] == runs[1]


def test_staged_outputs_land_at_next_lookup_like_jax():
    _, jax_store, store = _pair("table", "lru", n_shards=2, capacity=64)
    for s in (jax_store, store):
        s.stage_model_outputs(EMPTY, EMPTY, np.array([3, 260]))
        assert s.stats.on_demand_rows == 0  # nothing applied yet
        s.lookup(np.array([3, 260]))
        assert s.stats.prefetch_hits == 2
        s.stage_model_outputs(EMPTY, EMPTY, np.array([7]))
        s.flush_staged()
        assert s.resident_mask(np.array([7])).all()
    assert _counters(store) == _counters(jax_store)
    assert store.shard_telemetry() == jax_store.shard_telemetry()


def _staged(ids, batch, b):
    return [(EMPTY, EMPTY,
             np.unique(ids[(b + 1) * batch: (b + 1) * batch + 6]))]


def test_pipelined_runtime_over_sharded_store_equals_sync_and_jax():
    """The inline runtime over the sharded store gives the synchronous
    sharded replay's counters, and the JAX runtime's counters and modeled
    timeline."""
    ids = _ids(2400, seed=6)
    batch = 48
    n = len(ids) // batch

    def build():
        return ShardedTieredStore(_host(), make_plan(ROWS, 4, 56, "row"),
                                  policy="lru", device="cpu")

    sync = build()
    for b in range(n):
        sync.lookup(ids[b * batch: (b + 1) * batch])
        for item in _staged(ids, batch, b):
            sync.stage_model_outputs(*item)
        sync.flush_staged()

    store = build()
    embs = {}

    def step(b, emb):
        embs[b] = emb.numpy().copy()
        return 0.0, _staged(ids, batch, b)

    rt = PipelinedRuntime(store, RuntimeConfig(
        max_batch=1, pipeline_depth=2, compute_us=500.0))
    rt.run((ids[i * batch: (i + 1) * batch] for i in range(n)), step)
    jstore = JaxSharded(_host(), jax_make_plan(ROWS, 4, 56, "row"),
                        policy="lru")
    jrt = JaxRuntime(jstore, JaxRuntimeConfig(
        max_batch=1, pipeline_depth=2, compute_us=500.0))
    jrt.run((ids[i * batch: (i + 1) * batch] for i in range(n)),
            lambda b, emb: (0.0, _staged(ids, batch, b)))
    for c in COUNTERS:
        assert getattr(store.stats, c) == getattr(sync.stats, c), c
        assert getattr(store.stats, c) == getattr(jstore.stats, c), c
    assert store.stats.prefetch_hits > 0
    assert rt.telemetry.stall_ms < rt.telemetry.demand_fetch_ms
    assert rt.telemetry.stall_ms == jrt.telemetry.stall_ms
    assert store.shard_telemetry() == jstore.shard_telemetry()
    for b, emb in embs.items():
        np.testing.assert_array_equal(emb, _host()[ids[b * batch:
                                                       (b + 1) * batch]])


def test_one_shard_collapses_to_the_single_store():
    ids = _ids(1000, seed=1)
    one = ShardedTieredStore.build(_host(), ROWS, 1, "hash", capacity=40,
                                   device="cpu")
    single = TieredEmbeddingStore(_host(), 40, device="cpu")
    for b in range(10):
        np.testing.assert_array_equal(
            one.lookup(ids[b * 100: (b + 1) * 100]).numpy(),
            single.lookup(ids[b * 100: (b + 1) * 100]).numpy())
    for c in COUNTERS:
        assert getattr(one.stats, c) == getattr(single.stats, c), c


@pytest.mark.parametrize("placement", ["table", "freq"])
def test_serve_trace_sharded_equals_golden_or_jax(placement):
    """The golden fixture of ``tests/test_golden_trace.py`` served by the
    port's ``serve_trace``: ``table`` against
    ``serve_lru_sharded_table2.json``, ``freq`` against the JAX
    ``serve_trace``'s shard telemetry."""
    cfg = dataclasses.replace(get_config("dlrm-recmg").reduced(),
                              n_tables=4, rows_per_table=1024, multi_hot=2,
                              emb_dim=16)
    trace = generate_trace(TraceGenConfig(
        n_tables=cfg.n_tables, rows_per_table=cfg.rows_per_table,
        n_accesses=8000, seed=0, drift_every=10**9))
    cap = int(0.15 * trace.unique_count())
    res = serve_trace(cfg, init_dlrm(cfg, seed=0, device="cpu"), trace, cap,
                      "lru", None, batch_queries=8, shards=2,
                      placement=placement, device="cpu")
    assert res["shard_load_imbalance"] == res["shard"]["load_imbalance"]
    if placement == "table":
        want = json.loads(
            (GOLDEN_DIR / "serve_lru_sharded_table2.json").read_text())
        got = {k: res[k] for k in want if k != "shard"}
        got["shard"] = {k: res["shard"][k] for k in want["shard"]}
        assert got == want
        return
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.core.trace import TraceGenConfig as JaxTraceGenConfig
    from repro.core.trace import generate_trace as jax_generate_trace
    from repro.launch.serve import serve_trace as jax_serve_trace
    from repro.models.dlrm import init_dlrm as jax_init_dlrm

    jcfg = dataclasses.replace(jax_get_config("dlrm-recmg").reduced(),
                               n_tables=4, rows_per_table=1024, multi_hot=2,
                               emb_dim=16)
    jtrace = jax_generate_trace(JaxTraceGenConfig(
        n_tables=4, rows_per_table=1024, n_accesses=8000, seed=0,
        drift_every=10**9))
    want = jax_serve_trace(jcfg, jax_init_dlrm(jax.random.PRNGKey(0), jcfg),
                           jtrace, cap, "lru", None, batch_queries=8,
                           shards=2, placement=placement)
    assert res["shard"] == want["shard"]
    for k in COUNTERS + ("modeled_fetch_ms_per_batch", "on_demand_stall_ms"):
        assert res[k] == want[k], k


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("policy", ["lru", "recmg"])
def test_scenario_n2_golden(name, policy):
    res = replay_scenario(scenario(name, **SCALE), policy=policy,
                          capacity_frac=0.12, batch=256, shards=2,
                          device="cpu")
    metrics = golden_metrics(res)
    sh = res["shard"]
    metrics["shard"] = {k: sh[k] for k in
                        ("n_shards", "per_shard_lookups",
                         "per_shard_hit_rate", "per_shard_evictions")}
    want = json.loads(
        (GOLDEN_DIR / f"scenario_{name}_{policy}_n2.json").read_text())
    assert metrics == want
