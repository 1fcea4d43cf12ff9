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


def _codes(buf):
    """A code buffer (JAX or torch) as its bytes."""
    if isinstance(buf, torch.Tensor):
        return buf.view(torch.uint8).numpy()
    return np.asarray(buf).view(np.uint8)


@pytest.mark.parametrize("row_format", ["int8", "fp8"])
@pytest.mark.parametrize("policy", ["lru", "recmg"])
def test_quantized_store_matches_jax_store(trace, policy, row_format):
    """The quantized store side by side with the JAX one, through batches
    that overflow the buffer.  Counters and residency are equal; the codes
    at every resident slot are equal; the scales differ by at most one
    ulp (the JAX store's jitted quantizer rounds its scale division
    differently from the jnp reference, which the port's matches), so the
    fp32 rows agree within rtol 2.4e-7 (two ulps)."""
    capacity, per_batch = 60, 240
    host = np.random.default_rng(0).normal(
        size=(int(trace.rows_per_table.sum()), 16)).astype(np.float32)
    kw = dict(policy=policy, quantize=True, row_format=row_format)
    jax_store = JaxStore(host, capacity, warmup_batch=per_batch, **kw)
    store = TieredEmbeddingStore(host, capacity, warmup_batch=per_batch,
                                 device="cpu", **kw)
    assert store.buffer.dtype == (torch.int8 if row_format == "int8"
                                  else torch.float8_e4m3fn)
    outs = frequency_outputs(trace, capacity)
    gid = trace.global_id
    probe = np.random.default_rng(1).integers(0, host.shape[0], 64)
    bound = {"int8": 1 / 127, "fp8": 1 / 16}[row_format]
    for b in range(len(gid) // per_batch):
        ids = gid[b * per_batch: (b + 1) * per_batch]
        assert np.unique(ids).size > capacity  # every batch overflows
        want = np.asarray(jax_store.lookup(ids))
        got = store.lookup(ids)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=2.4e-7, atol=0)
        amax = np.abs(host[ids]).max(axis=1)
        assert (np.abs(got.numpy() - host[ids]).max(axis=1)
                <= amax * bound + 1e-6).all()
        c = b % len(outs.chunk_starts)
        item = (gid[max(0, b * per_batch - 15): b * per_batch],
                outs.caching_bits[c], outs.prefetch_ids[c])
        jax_store.stage_model_outputs(*item)
        store.stage_model_outputs(*item)
        jax_store.flush_staged()
        store.flush_staged()
        for k in COUNTERS:
            assert getattr(store.stats, k) == getattr(jax_store.stats, k), k
        store.check_invariants()
        np.testing.assert_array_equal(store._slot_map, jax_store._slot_map)
        res = np.flatnonzero(store._slot_key >= 0)
        np.testing.assert_array_equal(_codes(store.buffer)[res],
                                      _codes(jax_store.buffer)[res])
        np.testing.assert_allclose(store.scales.numpy()[res],
                                   np.asarray(jax_store.scales)[res],
                                   rtol=2e-7, atol=0)
        r_jax, n_jax = jax_store.lookup_resident(probe)
        r, n = store.lookup_resident(probe)
        assert n == n_jax and r.dtype == np.float32
        np.testing.assert_allclose(r, r_jax, rtol=2.4e-7, atol=0)
    # Warm-up changes no stored value and no counter.
    ids = gid[:per_batch]
    codes, scales = store.buffer.clone(), store.scales.clone()
    before, n_before = store.lookup_resident(ids)
    stats = store.stats.as_dict()
    store.warmup(1024)
    assert torch.equal(store.buffer.view(torch.uint8),
                       codes.view(torch.uint8))
    assert torch.equal(store.scales, scales)
    after, n_after = store.lookup_resident(ids)
    np.testing.assert_array_equal(after, before)
    assert n_after == n_before and store.stats.as_dict() == stats


def test_quantized_store_arguments():
    host = np.zeros((8, 16), np.float32)
    with pytest.raises(ValueError, match="requires quantize=True"):
        TieredEmbeddingStore(host, 4, row_format="fp8", device="cpu")
    with pytest.raises(ValueError, match="unknown row_format"):
        TieredEmbeddingStore(host, 4, quantize=True, row_format="int4",
                             device="cpu")
    st = TieredEmbeddingStore(host, 4, quantize=True, device="cpu")
    assert st.row_format == "int8" and st.scales.shape == (4,)
    assert st.lookup_host(np.arange(3)).dtype == np.float32


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
