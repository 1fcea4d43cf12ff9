"""The port's TieredEmbeddingStore driven side by side with the JAX store.

Both stores take the same ``generate_trace`` batches and the same
frequency-model outputs, staged through ``stage_model_outputs`` /
``flush_staged``.  Per batch: the counters are equal, the fp32 rows of
``lookup`` are bit-exact, both pass ``check_invariants``, and
``lookup_resident`` agrees.  The small capacity forces overflow (a batch's
unique working set larger than the buffer).
"""
import numpy as np
import pytest
import torch

from repro.core.tiered import TieredEmbeddingStore as JaxStore
from repro_torch.core.recmg import frequency_outputs
from repro_torch.core.tiered import TieredEmbeddingStore, fast_row_bytes
from repro_torch.core.trace import TraceGenConfig, generate_trace
from repro_torch.obs import MetricsRegistry

COUNTERS = ("batches", "lookups", "hits", "misses", "prefetch_hits",
            "on_demand_rows", "evictions", "modeled_fetch_s")


@pytest.fixture(scope="module")
def trace():
    return generate_trace(TraceGenConfig(
        n_tables=4, rows_per_table=600, n_accesses=4800, seed=0,
        drift_every=10**9))


@pytest.mark.parametrize("capacity", [60, 400])
@pytest.mark.parametrize("policy", ["lru", "recmg"])
def test_store_matches_jax_store(trace, policy, capacity):
    per_batch = 240  # unique ids per batch exceed 60 rows: overflow
    host = np.random.default_rng(0).normal(
        size=(int(trace.rows_per_table.sum()), 16)).astype(np.float32)
    jax_store = JaxStore(host, capacity, policy=policy)
    store = TieredEmbeddingStore(host, capacity, policy=policy, device="cpu")
    outs = frequency_outputs(trace, capacity)
    gid = trace.global_id
    probe = np.random.default_rng(1).integers(0, host.shape[0], 64)
    overflowed = False
    for b in range(len(gid) // per_batch):
        ids = gid[b * per_batch: (b + 1) * per_batch]
        overflowed |= np.unique(ids).size > capacity
        want = np.asarray(jax_store.lookup(ids))
        got = store.lookup(ids)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), host[ids])
        # Stage this batch's chunk outputs, as serve_trace does.
        for c in np.flatnonzero((outs.chunk_starts >= b * per_batch)
                                & (outs.chunk_starts < (b + 1) * per_batch)):
            s = int(outs.chunk_starts[c])
            item = (gid[max(0, s - 15): s], outs.caching_bits[c],
                    outs.prefetch_ids[c])
            jax_store.stage_model_outputs(*item)
            store.stage_model_outputs(*item)
        jax_store.flush_staged()
        store.flush_staged()
        for k in COUNTERS:
            assert getattr(store.stats, k) == getattr(jax_store.stats, k), k
        jax_store.check_invariants()
        store.check_invariants()
        np.testing.assert_array_equal(store._slot_map, jax_store._slot_map)
        r_jax, n_jax = jax_store.lookup_resident(probe)
        r, n = store.lookup_resident(probe)
        assert n == n_jax
        np.testing.assert_array_equal(r, r_jax)
        np.testing.assert_array_equal(store.resident_mask(probe),
                                      jax_store.resident_mask(probe))
    assert overflowed == (capacity == 60)


def test_lookup_host_and_metrics(trace):
    host = np.random.default_rng(0).normal(
        size=(int(trace.rows_per_table.sum()), 16)).astype(np.float32)
    store = TieredEmbeddingStore(host, 100, device="cpu", warmup_batch=32)
    ids = trace.global_id[:200]
    rows = store.lookup_host(ids)
    assert isinstance(rows, np.ndarray)
    np.testing.assert_array_equal(rows, host[ids])
    snap = store.publish_metrics(MetricsRegistry()).snapshot()
    assert snap["counters"]["store.lookups"] == 200
    assert fast_row_bytes(16, np.float32, False) == 64
    assert fast_row_bytes(16, np.float32, True, "fp8") == 20


def test_quantized_store_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="A7"):
        TieredEmbeddingStore(np.zeros((8, 16), np.float32), 4,
                             quantize=True, device="cpu")


@pytest.mark.parametrize("cfg", [
    dict(n_tables=4, rows_per_table=600, n_accesses=4800, seed=0,
         drift_every=10**9),
    dict(n_tables=3, rows_per_table=2000, n_accesses=9000, seed=3,
         drift_every=2000),
])
def test_generate_trace_is_byte_identical(cfg):
    from repro.core.trace import TraceGenConfig as JaxTraceGenConfig
    from repro.core.trace import generate_trace as jax_generate_trace

    got = generate_trace(TraceGenConfig(**cfg))
    want = jax_generate_trace(JaxTraceGenConfig(**cfg))
    for f in ("table_id", "row_id", "rows_per_table", "query_id"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
