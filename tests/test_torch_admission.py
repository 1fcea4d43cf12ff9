"""The port's admission / overload path against the JAX package's.

Everything runs on the deterministic VirtualClock, so shed, degrade and
serve decisions, goodput and modeled tail latency are equal to JAX's
exactly.  Degraded batches are assembled on the store's device in the port
(the store's own gather kernel, one concatenation) and in NumPy in JAX;
fp32 rows are copies, so bit-exact, and quantized rows are ``code *
scale`` with equal codes and scales within one ulp (the JAX store's jitted
quantizer rounds the scale division differently from the jnp reference the
port matches), so fp32 rtol 2.4e-7, the existing store tolerance.
"""
import numpy as np
import pytest
import torch

from repro.core.serving import MultiTableTieredStore as JaxMultiStore
from repro.core.tiered import TieredEmbeddingStore as JaxStore
from repro.runtime import AdmissionConfig as JaxAdmissionConfig
from repro.runtime import AdmissionQueue as JaxAdmissionQueue
from repro.runtime import PipelinedRuntime as JaxRuntime
from repro.runtime import Request as JaxRequest
from repro.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.workloads import make_spec as jax_make_spec
from repro.workloads import replay_overload as jax_replay_overload
from repro_torch.core.serving import MultiTableTieredStore
from repro_torch.core.tiered import TieredEmbeddingStore
from repro_torch.obs.reconcile import check_admission
from repro_torch.runtime import (AdmissionConfig, AdmissionQueue,
                                 PipelinedRuntime, Request, RuntimeConfig)
from repro_torch.workloads import make_spec, overload_sweep, replay_overload

EMPTY = np.empty(0, np.int64)
ROW_RTOL = {None: 0.0, "int8": 2.4e-7, "fp8": 2.4e-7}
WALL_COUNTERS = ("store.time.fetch_s", "store.time.gather_s",
                 "store.time.model_s")


def _host(n=200, d=8, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _no_wall(res):
    res = dict(res)
    snap = res.pop("metrics")
    counters = {k: v for k, v in snap["counters"].items()
                if k not in WALL_COUNTERS}
    return res, counters, snap["gauges"]


@pytest.mark.parametrize("kw", [
    dict(load_x=0.5),
    dict(load_x=2.0),
    dict(load_x=4.0, policy="recmg"),
    dict(load_x=4.0, pipeline_depth=1, prefetch=False),
    dict(load_x=3.0, degrade=False),
], ids=["0.5x", "2x", "4x-recmg", "4x-sync", "3x-no-degrade"])
def test_replay_overload_equals_jax(kw):
    """Fate counters, goodput, modeled tail latency and every metric of
    the run equal JAX's (the store's wall-clock counters dropped)."""
    n = 4000
    got = replay_overload(make_spec("sustained_overload", n_accesses=n),
                          device="cpu", **kw)
    want = jax_replay_overload(
        jax_make_spec("sustained_overload", n_accesses=n), **kw)
    assert _no_wall(got) == _no_wall(want)
    assert got["admitted"] == got["served"] + got["shed"] + got["degraded"]
    assert check_admission(got["metrics"]["counters"]) == []
    if kw["load_x"] >= 2.0 and kw.get("degrade", True):
        assert got["degraded"] > 0


def test_overload_sweep_passes_device():
    sweep = overload_sweep((1.0, 2.0), spec=make_spec(
        "sustained_overload", n_accesses=2000), device="cpu")
    assert sorted(sweep) == [1.0, 2.0]
    assert sweep[2.0]["shed"] >= sweep[1.0]["shed"]


def _stores(kind, row_format, n=200):
    """A port store on the CPU and the JAX store over the same tables."""
    qkw = {} if row_format is None else dict(quantize=True,
                                             row_format=row_format)
    if kind == "multi_table":
        tables = [_host(120, seed=3), _host(80, seed=4)]
        return (MultiTableTieredStore(tables, capacity=40, device="cpu",
                                      fetch_us_fixed=200.0, **qkw),
                JaxMultiStore(tables, capacity=40, fetch_us_fixed=200.0,
                              **qkw))
    host = _host(n, seed=6)
    kw = dict(fetch_us_fixed=200.0, fetch_us_per_row=20.0, **qkw)
    return (TieredEmbeddingStore(host, 32, device="cpu", **kw),
            JaxStore(host, 32, **kw))


def _overload_run(runtime_cls, cfg_cls, adm_cls, store, stream):
    adm = adm_cls(queue_bound=8, class_deadline_us=(50.0, 200.0, 800.0))
    rt = runtime_cls(store, cfg_cls(max_batch=4, pipeline_depth=2,
                                    interarrival_us=10.0, compute_us=400.0,
                                    admission=adm))
    embs = []

    def step(b, emb):
        embs.append(emb.numpy() if isinstance(emb, torch.Tensor)
                    else np.asarray(emb))
        return 0.0, [(EMPTY, EMPTY, np.arange(b, b + 4) % 200)]

    rt.run(iter(stream), step)
    return rt, embs


@pytest.mark.parametrize("row_format", [None, "int8", "fp8"])
@pytest.mark.parametrize("kind", ["single", "multi_table"])
def test_degraded_batches_equal_jax(kind, row_format):
    """Saturating arrivals with tight deadlines: every batch the forward
    sees, degraded rows included, equals JAX's ``_assemble_degraded``
    (fp32 exact, quantized within rtol 2.4e-7), and so do the fates."""
    rng = np.random.default_rng(0)
    # Ids mostly from a hot range the buffer can hold, so degraded reads
    # find stale resident rows as well as misses.
    stream = [(np.where(rng.random(3) < 0.8, rng.integers(0, 24, size=3),
                        rng.integers(0, 200, size=3)).astype(np.int64),
               int(p)) for p in rng.integers(0, 3, size=80)]
    store, jstore = _stores(kind, row_format)
    rt, embs = _overload_run(PipelinedRuntime, RuntimeConfig,
                             AdmissionConfig, store, stream)
    jrt, jembs = _overload_run(JaxRuntime, JaxRuntimeConfig,
                               JaxAdmissionConfig, jstore, stream)
    assert rt.results() == jrt.results()
    st = rt.admission_stats
    assert st.total_degraded > 0 and st.degraded_rows_stale > 0
    assert st.degraded_rows_default > 0
    assert len(embs) == len(jembs)
    for got, want in zip(embs, jembs):
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=ROW_RTOL[row_format],
                                   atol=0)


@pytest.mark.parametrize("row_format", [None, "int8"])
@pytest.mark.parametrize("kind", ["single", "multi_table"])
def test_lookup_resident_device_contract(kind, row_format):
    """The device-side degraded read: resident rows equal the full lookup's,
    misses are zero default rows, no stats move, and the NumPy
    ``lookup_resident`` is the same read copied to the host."""
    store, _ = _stores(kind, row_format)
    ids = np.array([0, 1, 2, 1, 120, 121], np.int64)
    full = store.lookup(ids).numpy()
    before = store.stats.as_dict()
    rows, n_def = store.lookup_resident_device(ids)
    assert isinstance(rows, torch.Tensor) and rows.device == store.device
    assert n_def == 0
    np.testing.assert_array_equal(rows.numpy(), full)
    cold = np.array([150, 2, 151, 150], np.int64)
    rows, n_def = store.lookup_resident_device(cold)
    assert n_def == 3 and not rows[[0, 2, 3]].any()
    host_rows, host_n = store.lookup_resident(cold)
    np.testing.assert_array_equal(host_rows, rows.numpy())
    assert host_n == n_def
    empty, n0 = store.lookup_resident_device(EMPTY)
    assert empty.shape == (0, 8) and n0 == 0
    assert store.stats.as_dict() == before


@pytest.mark.parametrize("kw", [
    dict(queue_bound=0),
    dict(class_deadline_us=()),
    dict(class_deadline_us=(float("nan"),)),
    dict(class_deadline_us=(-1.0,)),
    dict(backpressure_hi=1.5),
    dict(backpressure_lo=0.9, backpressure_hi=0.5),
    dict(backpressure_lo=float("nan")),
])
def test_admission_config_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError):
        JaxAdmissionConfig(**kw)
    with pytest.raises(ValueError):
        AdmissionConfig(**kw)


def test_admission_config_deadlines_equal_jax():
    for dl in ((10.0, 40.0), (50.0, 200.0, 800.0, 1e4), (float("inf"),)):
        got, want = AdmissionConfig(class_deadline_us=dl), \
            JaxAdmissionConfig(class_deadline_us=dl)
        assert got == AdmissionConfig(**{
            f: getattr(want, f) for f in ("queue_bound", "class_deadline_us",
                                          "degrade", "backpressure_hi",
                                          "backpressure_lo")})
        for c in range(got.n_classes):
            assert got.class_name(c) == want.class_name(c)
            assert got.deadline_for(c, 100.0) == want.deadline_for(c, 100.0)
        with pytest.raises(ValueError):
            got.deadline_for(got.n_classes, 0.0)


def test_admission_queue_equals_jax():
    """Offer/pop on a seeded stream through a tight bound: the same
    requests shed and the same batches in EDF order."""
    rng = np.random.default_rng(3)
    cfg_kw = dict(queue_bound=6, class_deadline_us=(50.0, 200.0, 800.0))
    got = AdmissionQueue(AdmissionConfig(**cfg_kw))
    want = JaxAdmissionQueue(JaxAdmissionConfig(**cfg_kw))
    pops = {id(got): [], id(want): []}
    for i in range(90):
        pri, t = int(rng.integers(0, 3)), float(i * 7)
        for q, cls in ((got, Request), (want, JaxRequest)):
            accepted = q.offer(cls(i, np.array([i]), t, priority=pri,
                                   deadline_us=q.cfg.deadline_for(pri, t)))
            pops[id(q)].append(accepted)
            if i % 4 == 3:
                pops[id(q)].append([r.rid for r in q.pop(3)])
    for q in (got, want):
        pops[id(q)].append([r.rid for r in q.drain()])
    assert pops[id(got)] == pops[id(want)]
    assert got.stats.as_dict() == want.stats.as_dict()
    assert got.stats.total_shed > 0
