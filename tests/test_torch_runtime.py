"""The port's pipelined serving runtime against the JAX package's.

The inline scheduler on a ``VirtualClock`` makes the runtime deterministic:
the store sees the synchronous loop's operations, so the counters of the
pipelined and the synchronous run are byte-equal in the port, and the
port's ``PipelinedRuntime.results()`` equal JAX's on the same stream (the
keys are modeled time and counts; no wall clock enters them when
``compute_us`` pins the modeled forward).  The micro-batcher, the prefetch
engine (dedup, cancel, coalesce, timeliness) and
``heuristic_prediction_stream`` are held against the JAX classes on equal
inputs, exactly.
"""
import numpy as np
import pytest

from repro.core.prefetchers import make_prefetcher as jax_make_prefetcher
from repro.core.serving import MultiTableTieredStore as JaxMultiStore
from repro.core.tiered import TieredEmbeddingStore as JaxStore
from repro.runtime import MicroBatcher as JaxMicroBatcher
from repro.runtime import PipelinedRuntime as JaxRuntime
from repro.runtime import PrefetchEngine as JaxEngine
from repro.runtime import Request as JaxRequest
from repro.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.runtime import RuntimeTelemetry as JaxTelemetry
from repro.runtime import heuristic_prediction_stream as jax_stream
from repro_torch.core.prefetchers import make_prefetcher
from repro_torch.core.serving import MultiTableTieredStore
from repro_torch.core.tiered import TieredEmbeddingStore
from repro_torch.runtime import (MicroBatcher, PipelinedRuntime,
                                 PrefetchEngine, Request, RuntimeConfig,
                                 RuntimeTelemetry, VirtualClock,
                                 heuristic_prediction_stream)

EMPTY = np.empty(0, np.int64)
COUNTERS = ("batches", "lookups", "hits", "misses", "prefetch_hits",
            "on_demand_rows", "evictions", "modeled_fetch_s")
WALL = ("fetch_s", "gather_s", "model_s")


def _host(n=400, d=8, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _trace(n_rows, n_acc, seed=0):
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(1.2, size=n_acc), n_rows) - 1
    return rng.permutation(n_rows)[ranks].astype(np.int64)


def _staged_fn(ids, batch, n_rows):
    """The JAX runtime tests' deterministic model-output stream: rank the
    just-served chunk with pseudo-bits every other batch, prefetch the next
    batch's first keys every batch."""
    bits_tbl = np.random.default_rng(7).random(4096) < 0.5

    def staged(b):
        items = []
        lo, hi = b * batch, (b + 1) * batch
        if b % 2 == 0:
            trunk = ids[lo: lo + 12]
            items.append((trunk, bits_tbl[:len(trunk)].astype(np.int64),
                          EMPTY))
        items.append((EMPTY, EMPTY, np.unique(ids[hi: hi + 8]) % n_rows))
        return items

    return staged


def _run_sync(store, ids, batch, staged):
    for b in range(len(ids) // batch):
        store.lookup(ids[b * batch: (b + 1) * batch])
        for item in staged(b):
            store.stage_model_outputs(*item)
        store.flush_staged()


def _run_async(runtime_cls, cfg_cls, store, ids, batch, staged, depth=2,
               max_batch=1, **kw):
    rt = runtime_cls(store, cfg_cls(max_batch=max_batch,
                                    pipeline_depth=depth, compute_us=500.0,
                                    **kw))
    n_b = len(ids) // batch
    per_req = batch // max_batch
    stream = (ids[i * per_req: (i + 1) * per_req]
              for i in range(n_b * max_batch))
    rt.run(stream, lambda b, emb: (0.0, staged(b)))
    return rt


def _stats(store):
    d = store.stats.as_dict()
    for k in WALL:
        d.pop(k)
    return d


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("policy", ["lru", "recmg"])
def test_pipelined_counters_equal_sync(policy, depth):
    """Inline scheduler: the pipelined run's counters equal the synchronous
    run's byte for byte; the modeled demand fetch is the store's, all of
    it stalls at depth 1 and strictly less at depth >= 2.  The JAX runtime
    on the same stream gives the same counters and results."""
    host, ids = _host(400), _trace(400, 6000)
    staged = _staged_fn(ids, 48, 400)
    sync = TieredEmbeddingStore(host, 64, policy=policy, device="cpu")
    _run_sync(sync, ids, 48, staged)
    pipe = TieredEmbeddingStore(host, 64, policy=policy, device="cpu")
    rt = _run_async(PipelinedRuntime, RuntimeConfig, pipe, ids, 48, staged,
                    depth=depth)
    assert _stats(pipe) == _stats(sync)
    assert pipe.stats.prefetch_hits > 0
    tel = rt.telemetry
    assert tel.demand_fetch_ms == pytest.approx(
        sync.stats.modeled_fetch_s * 1e3, rel=1e-9)
    if depth == 1:
        assert tel.stall_ms == pytest.approx(tel.demand_fetch_ms)
    else:
        assert tel.stall_ms < tel.demand_fetch_ms
    jstore = JaxStore(host, 64, policy=policy)
    jrt = _run_async(JaxRuntime, JaxRuntimeConfig, jstore, ids, 48, staged,
                     depth=depth)
    assert _stats(pipe) == _stats(jstore)
    assert rt.results() == jrt.results()


@pytest.mark.parametrize("policy", ["lru", "recmg"])
def test_pipelined_counters_equal_sync_multi_table(policy):
    tables = [_host(160, seed=i) for i in range(3)]
    n = sum(t.shape[0] for t in tables)
    ids = _trace(n, 4000, seed=3)
    staged = _staged_fn(ids, 40, n)
    sync = MultiTableTieredStore(tables, capacity=72, policy=policy,
                                 device="cpu")
    _run_sync(sync, ids, 40, staged)
    pipe = MultiTableTieredStore(tables, capacity=72, policy=policy,
                                 device="cpu")
    rt = _run_async(PipelinedRuntime, RuntimeConfig, pipe, ids, 40, staged)
    assert _stats(pipe) == _stats(sync)
    assert rt.telemetry.stall_ms < rt.telemetry.demand_fetch_ms
    jstore = JaxMultiStore(tables, capacity=72, policy=policy)
    jrt = _run_async(JaxRuntime, JaxRuntimeConfig, jstore, ids, 40, staged)
    assert _stats(pipe) == _stats(jstore)
    assert rt.results() == jrt.results()


@pytest.mark.parametrize("kw", [
    dict(max_batch=4),
    dict(max_batch=6, deadline_us=100.0, interarrival_us=80.0),
    dict(max_batch=3, interarrival_us=40.0, depth=3),
], ids=["size", "deadline", "open-loop"])
def test_results_equal_jax(kw):
    """``results()`` (telemetry, latency percentiles on the modeled
    timeline) equal JAX's on the same request stream and config."""
    kw = dict(kw)
    depth = kw.pop("depth", 2)
    host, ids = _host(300, seed=2), _trace(300, 3000, seed=2)
    staged = _staged_fn(ids, 24, 300)
    got = _run_async(PipelinedRuntime, RuntimeConfig,
                     TieredEmbeddingStore(host, 48, policy="recmg",
                                          device="cpu"),
                     ids, 24, staged, depth=depth, **kw)
    want = _run_async(JaxRuntime, JaxRuntimeConfig,
                      JaxStore(host, 48, policy="recmg"),
                      ids, 24, staged, depth=depth, **kw)
    assert got.results() == want.results()
    assert got.results()["batches"] > 0


@pytest.mark.parametrize("deadline", [float("inf"), 0.0, 100.0, 250.0])
def test_microbatcher_equals_jax(deadline):
    """Push/ready/pop/flush on a seeded arrival stream: the same batches
    close at the same times."""
    rng = np.random.default_rng(5)
    arrivals = np.cumsum(rng.exponential(60.0, size=60))
    got, want = MicroBatcher(4, deadline), JaxMicroBatcher(4, deadline)
    log = {id(got): [], id(want): []}
    for i, t in enumerate(arrivals.tolist()):
        for mb, req_cls in ((got, Request), (want, JaxRequest)):
            while mb.ready(t):
                reqs, close = mb.pop()
                log[id(mb)].append(([r.rid for r in reqs], close))
            mb.push(req_cls(i, np.array([i]), t))
    for mb in (got, want):
        while len(mb):
            reqs, close = mb.flush(arrivals[-1])
            log[id(mb)].append(([r.rid for r in reqs], close))
    assert log[id(got)] == log[id(want)]
    assert got.flush(7.0) == ([], 7.0) == want.flush(7.0)


def _engine_script(engine_cls, tel_cls, store, ids_fn):
    """One engine session: demand fetches, overlapping prefetch submits
    (dedup), a submit of resident ids (cancel), consecutive prefetch-only
    items (coalesce), a rank item with evicted ids, timeliness probes."""
    tel = tel_cls()
    eng = engine_cls(store, telemetry=tel, fetch_us_per_row=10.0,
                     fetch_us_fixed=30.0, coalesce_rows=12)
    store.lookup(np.array([5, 6, 40]))
    eng.submit(EMPTY, EMPTY, np.array([7, 8]), now_us=0.0)
    eng.submit(EMPTY, EMPTY, np.array([8, 9, 5, 9]), now_us=5.0)
    for lo in (10, 15, 20, 25):
        eng.submit(EMPTY, EMPTY, np.arange(lo, lo + 5), now_us=10.0)
    eng.submit(np.array([5, 6, 200, 201]), np.array([1, 0, 1, 1]),
               np.array([30, 31]), now_us=12.0)
    eng.drain()
    eng.observe_demand(np.array([7, 8]), now_us=40.0)
    eng.observe_demand(np.array([9, 10, 11]), now_us=400.0)
    store.lookup(np.array([9, 10, 11, 99]))
    eng.submit(EMPTY, EMPTY, np.array([99, 100]), now_us=450.0)
    eng.close()
    return tel, ids_fn(store)


@pytest.mark.parametrize("policy", ["lru", "recmg"])
def test_prefetch_engine_equals_jax(policy):
    """Dedup, cancel-before-issue, coalescing and timeliness counters, and
    the resulting residency, equal JAX's."""
    host = _host(300, seed=4)
    got, got_res = _engine_script(
        PrefetchEngine, RuntimeTelemetry,
        TieredEmbeddingStore(host, 24, policy=policy, device="cpu"),
        lambda s: s.slot_of)
    want, want_res = _engine_script(
        JaxEngine, JaxTelemetry, JaxStore(host, 24, policy=policy),
        lambda s: s.slot_of)
    assert got.as_dict() == want.as_dict()
    assert got_res == want_res
    assert got.pf_deduped > 0 and got.pf_cancelled_resident > 0
    assert got.pf_populate_calls < 6  # coalesced
    assert got.pf_timely > 0 and got.pf_late > 0


@pytest.mark.parametrize("name", ["none", "domino", "bingo", "bop", "berti",
                                  "mab"])
def test_heuristic_prediction_stream_equals_jax(name):
    keys = np.concatenate([np.arange(600) % 300,
                           _trace(300, 1500, seed=6)]).astype(np.int64)
    got = heuristic_prediction_stream(keys, make_prefetcher(name), chunk=15,
                                      max_per_chunk=4, sim_capacity=64)
    want = jax_stream(keys, jax_make_prefetcher(name), chunk=15,
                      max_per_chunk=4, sim_capacity=64)
    np.testing.assert_array_equal(got.chunk_starts, want.chunk_starts)
    assert got.caching_bits is None and want.caching_bits is None
    assert len(got.prefetch_ids) == len(want.prefetch_ids)
    for a, b in zip(got.prefetch_ids, want.prefetch_ids):
        np.testing.assert_array_equal(a, b)


def test_thread_scheduler_consistency():
    """Thread scheduler: the worker applies under the shared lock (and, on
    the card, the store's device and stream); drain is a flush barrier, so
    drained residency equals the inline engine's; close is idempotent."""
    host = _host()
    stores = {}
    for sched in ("inline", "thread"):
        store = TieredEmbeddingStore(host, 128, device="cpu")
        eng = PrefetchEngine(store, scheduler=sched, max_queue=8)
        for lo in range(0, 60, 5):
            eng.submit(EMPTY, EMPTY, np.arange(lo, lo + 5))
        eng.drain()
        store.check_invariants()
        eng.close()
        eng.close()
        with pytest.raises(RuntimeError, match="closed"):
            eng.submit(EMPTY, EMPTY, np.array([1]))
        stores[sched] = store
    assert stores["thread"].n_resident == 60
    assert stores["thread"].slot_of == stores["inline"].slot_of


def test_thread_scheduler_pipelined_identities():
    """Through the pipelined runtime the thread worker's apply timing is
    scheduler-dependent, but the accounting identities hold: every lookup
    is a hit or a miss, the demand fetch is the store's, the stall never
    exceeds it."""
    host, ids = _host(400), _trace(400, 6000)
    staged = _staged_fn(ids, 48, 400)
    store = TieredEmbeddingStore(host, 64, policy="recmg", device="cpu")
    rt = _run_async(PipelinedRuntime, RuntimeConfig, store, ids, 48, staged,
                    scheduler="thread")
    st, tel = store.stats, rt.telemetry
    assert st.hits + st.misses == st.lookups == len(ids) // 48 * 48
    assert tel.batches == st.batches == len(ids) // 48
    assert tel.demand_fetch_ms == pytest.approx(st.modeled_fetch_s * 1e3,
                                                rel=1e-9)
    assert tel.stall_ms <= tel.demand_fetch_ms
    assert tel.pf_issued > 0
    store.check_invariants()


def test_thread_worker_failure_surfaces_not_hangs():
    """A failing apply (a refused kernel launch raises the same way) is
    recorded by the worker and raised at the next barrier instead of
    deadlocking it; the engine still closes."""
    store = TieredEmbeddingStore(_host(100, seed=11), 16, device="cpu")

    def poisoned_apply(trunk, bits, pf):
        raise RuntimeError("quantize_scatter launch failed: CUDA error 1")

    store.apply_model_outputs = poisoned_apply
    eng = PrefetchEngine(store, scheduler="thread", max_queue=8)
    eng.submit(EMPTY, EMPTY, np.array([1, 2]))
    with pytest.raises(RuntimeError, match="prefetch worker failed") as ei:
        eng.drain()
    assert "CUDA error" in str(ei.value.__cause__)
    eng.close()
    assert not eng._worker.is_alive()


def test_virtual_clock_and_telemetry_merge():
    c = VirtualClock()
    c.advance(5.0)
    c.advance_to(3.0)  # monotone
    assert c.now() == 5.0
    with pytest.raises(ValueError):
        c.advance(-1.0)
    a = RuntimeTelemetry(batches=2, requests=10, pf_issued=5, stall_ms=1.5,
                         demand_fetch_ms=4.0, latencies_us=[100.0])
    b = RuntimeTelemetry(batches=3, requests=6, pf_issued=2, stall_ms=0.5,
                         demand_fetch_ms=1.0, latencies_us=[300.0])
    ja = JaxTelemetry(batches=2, requests=10, pf_issued=5, stall_ms=1.5,
                      demand_fetch_ms=4.0, latencies_us=[100.0])
    jb = JaxTelemetry(batches=3, requests=6, pf_issued=2, stall_ms=0.5,
                      demand_fetch_ms=1.0, latencies_us=[300.0])
    assert a.merge(b).as_dict() == ja.merge(jb).as_dict()
    assert a.stall_reduction == pytest.approx(0.6)
