"""The port's fault layer on the sharded store against the JAX package's.

``replay_chaos`` under each of ``chaos_sweep``'s five plans, at
``tests/test_faults.py``'s small spec: the ``CHAOS_KEYS``, the ``ft.*``
fates and the whole metrics snapshot (wall-clock seconds aside) equal the
JAX run's, and the lockstep clean-shadow audit counts 0 wrong rows.  The
failover contract also holds through the pipelined runtime (with and
without admission) beside the JAX runtime.  ``retry_step`` is a copy;
``quantize_int8`` (torch) gives the jnp codes exactly and the scale within
one ulp.
"""
import numpy as np
import pytest
import torch

from repro.core.sharded_serving import ShardedTieredStore as JaxSharded
from repro.distributed import compression as JC
from repro.distributed import fault_tolerance as JFT
from repro.runtime.admission import AdmissionConfig as JaxAdmissionConfig
from repro.runtime.pipeline import PipelinedRuntime as JaxRuntime
from repro.runtime.pipeline import RuntimeConfig as JaxRuntimeConfig
from repro.workloads import chaos_sweep as jax_chaos_sweep
from repro.workloads import make_spec as jax_make_spec
from repro_torch.core.sharded_serving import ShardedTieredStore
from repro_torch.distributed import fault_tolerance as TFT
from repro_torch.distributed.compression import (dequantize_int8,
                                                 quantize_int8)
from repro_torch.obs import MetricsRegistry, reconcile
from repro_torch.runtime.admission import AdmissionConfig
from repro_torch.runtime.pipeline import PipelinedRuntime, RuntimeConfig
from repro_torch.workloads import (CHAOS_KEYS, DEFAULT_FAULT_PLAN,
                                   chaos_sweep, failover_goodput, make_spec)

EMPTY = np.empty(0, np.int64)
ROWS = [96, 64, 96, 64]
N_VEC = sum(ROWS)
PLANS = ("", DEFAULT_FAULT_PLAN, "kill:1@mid", "flaky:2x0.4@25%..75%",
         "slow:0x4@25%..75%")
WALL = ("fetch_s", "gather_s", "model_s")


def _small(mod):
    return mod("shard_failure", n_accesses=10_240, n_tables=4,
               rows_per_table=256)


_SWEEPS = {}


def _sweeps():
    """Both packages' sweeps, run once for the five plans."""
    if not _SWEEPS:
        kw = dict(batch=128, shards=4)
        _SWEEPS["port"] = chaos_sweep(spec=_small(make_spec), device="cpu",
                                      **kw)
        _SWEEPS["jax"] = jax_chaos_sweep(spec=_small(jax_make_spec), **kw)
    return _SWEEPS["port"], _SWEEPS["jax"]


def _no_wall(flat):
    return {k: v for k, v in flat.items()
            if not k.endswith(WALL) and k != "ts"}


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: p or "clean")
def test_chaos_plan_equals_jax_with_zero_wrong_rows(plan):
    port, jax = _sweeps()
    got, want = port[plan], jax[plan]
    assert {k: got[k] for k in CHAOS_KEYS} == {k: want[k] for k in CHAOS_KEYS}
    assert got["wrong_rows"] == 0
    assert {k: v for k, v in got.items() if k != "metrics"} == \
        {k: v for k, v in want.items() if k != "metrics"}
    for section in ("counters", "gauges"):
        g = _no_wall(got["metrics"][section])
        w = _no_wall(want["metrics"][section])
        assert g == w, section
        ft = {k: v for k, v in g.items() if k.startswith("ft.")}
        assert ft == {k: v for k, v in w.items() if k.startswith("ft.")}
        if plan:
            assert ft, section


def test_failover_goodput_equals_jax():
    port, jax = _sweeps()
    assert failover_goodput(port) == failover_goodput(jax)
    assert 0.0 < failover_goodput(port) <= 1.0


def _host(n=N_VEC, d=8, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _ids(n_acc=3072, seed=0):
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(1.15, size=n_acc), N_VEC) - 1
    return rng.permutation(N_VEC)[ranks].astype(np.int64)


def _drive_runtime(cls, rt_cls, cfg_cls, admission, fault_plan, **kw):
    """``tests/test_faults.py``'s runtime drive: a faulted sharded store
    through the pipelined runtime; returns per-batch ids and rows."""
    n_q, per_query = 96, 8
    gid = _ids(n_q * per_query)
    store = cls.build(_host(), ROWS, 4, "row", capacity=64, policy="lru",
                      profile_ids=gid[: len(gid) // 4], replicate_hot=32,
                      warmup_batch=32, **kw)
    store.arm_faults(fault_plan, horizon_batches=n_q * per_query // 32)
    rt = rt_cls(store, cfg_cls(max_batch=4, pipeline_depth=2,
                               interarrival_us=30.0, compute_us=200.0,
                               admission=admission))
    embs, idss = {}, {}

    def hook(ids, hits, b):
        idss[b] = np.asarray(ids).copy()
        return [(EMPTY, EMPTY, np.unique(ids))]

    rt._batch_hook = hook

    def step(b, emb):
        embs[b] = (emb.numpy() if isinstance(emb, torch.Tensor)
                   else np.asarray(emb)).copy()
        return 0.0, []

    if admission is not None:
        pri = np.random.default_rng(1).integers(0, admission.n_classes,
                                                size=n_q)
        stream = ((gid[q * per_query: (q + 1) * per_query], int(pri[q]))
                  for q in range(n_q))
    else:
        stream = (gid[q * per_query: (q + 1) * per_query]
                  for q in range(n_q))
    rt.run(stream, step)
    return store, rt, idss, embs


@pytest.mark.parametrize("admission", [False, True],
                         ids=["pipelined", "admission"])
def test_failover_on_runtime_surface_equals_jax(admission):
    deadlines = (2e3, 8e3, 3.2e4)
    plan = "kill:1@6,recover:1@14"
    store, rt, idss, embs = _drive_runtime(
        ShardedTieredStore, PipelinedRuntime, RuntimeConfig,
        AdmissionConfig(queue_bound=16, class_deadline_us=deadlines)
        if admission else None, plan, device="cpu")
    jstore, jrt, jidss, jembs = _drive_runtime(
        JaxSharded, JaxRuntime, JaxRuntimeConfig,
        JaxAdmissionConfig(queue_bound=16, class_deadline_us=deadlines)
        if admission else None, plan)
    assert sorted(embs) == sorted(jembs)
    host = _host()
    for b in embs:
        np.testing.assert_array_equal(idss[b], jidss[b])
        np.testing.assert_array_equal(embs[b], jembs[b])
        eq = np.all(embs[b] == host[idss[b]], axis=-1)
        zero = np.all(embs[b] == 0.0, axis=-1)
        assert not np.any(~(eq | zero)), f"wrong rows, batch {b}"
    ft = store.ft_stats
    ft.check()
    assert ft.as_dict() == jstore.ft_stats.as_dict()
    assert ft.kills == 1 and ft.recoveries == 1 and ft.failover_replica > 0
    assert rt.clock.now() == jrt.clock.now()
    reg = MetricsRegistry()
    rt.publish(reg)
    store.publish_metrics(reg)
    assert reconcile(metrics=reg.as_dict(), strict=False) == []


def test_recovery_streams_lost_rows_back_like_jax():
    gid = _ids(2048, seed=2)
    stores = []
    for cls, kw in ((ShardedTieredStore, dict(device="cpu")),
                    (JaxSharded, {})):
        st = cls.build(_host(), ROWS, 2, "row", capacity=80, policy="lru",
                       warmup_batch=64, **kw)
        st.arm_faults("kill:1@4,recover:1@6")
        for b in range(16):
            st.lookup(gid[b * 128: (b + 1) * 128])
        stores.append(st)
    port, jax = stores
    ft = port.ft_stats
    ft.check()
    assert ft.as_dict() == jax.ft_stats.as_dict()
    assert ft.recovery_rows > 0 and ft.recovery_bytes < ft.recovery_bytes_raw
    assert port._recovery == {} and port.stores[1].n_resident > 0
    assert port.stores[1].device == port.device
    assert port._engines[1].store is port.stores[1]
    assert port.shard_telemetry() == jax.shard_telemetry()


def test_kill_drops_staged_outputs_for_dead_shard_like_jax():
    for cls, kw in ((ShardedTieredStore, dict(device="cpu")),
                    (JaxSharded, {})):
        store = cls.build(_host(), ROWS, 2, "row", capacity=80,
                          warmup_batch=64, **kw)
        store.arm_faults("kill:1@1")
        store.lookup(_ids(128))
        store.stores[1].stage_model_outputs(EMPTY, EMPTY,
                                            np.array([0, 1, 2], np.int64))
        store.lookup(_ids(128))
        assert store.ft_stats.staged_dropped == 3
        store.ft_stats.check()


class _Flaky(Exception):
    pass


@pytest.mark.parametrize("fails,retries,deadline", [
    (0, 3, None), (2, 3, None), (4, 3, None), (2, 3, 0.25), (5, 6, 10.0)])
def test_retry_step_equals_jax(fails, retries, deadline):
    def run(mod):
        clock, log = [0.0], []

        def fn(x):
            if len(log) < fails:
                log.append("fail")
                raise _Flaky("transient")
            return x * 2

        try:
            out = mod.retry_step(
                fn, 21, retries=retries, backoff_s=0.1, retryable=(_Flaky,),
                sleep=lambda s: clock.__setitem__(0, clock[0] + s),
                now=lambda: clock[0], deadline_s=deadline,
                on_retry=lambda a, e: log.append(a))
        except (_Flaky, mod.RetryDeadlineExceeded) as e:
            out = type(e).__name__
        return out, log, round(clock[0], 12)

    assert run(TFT) == run(JFT)


def test_retry_step_lets_other_errors_through():
    calls = []

    def boom():
        calls.append(1)
        raise KeyError("a logic bug")

    with pytest.raises(KeyError):
        TFT.retry_step(boom, retryable=(_Flaky,), sleep=lambda s: None)
    assert calls == [1]
    assert issubclass(TFT.RetryDeadlineExceeded, TimeoutError)


@pytest.mark.parametrize("shape,scale", [((64, 8), 1.0), ((3, 128), 40.0),
                                         ((1000,), 1e-3), ((5, 5), 0.0)])
def test_quantize_int8_equals_jax(shape, scale):
    import jax.numpy as jnp

    x = (np.random.default_rng(7).normal(size=shape) * scale).astype(
        np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = JC.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    ulp = np.spacing(np.float32(js))
    assert abs(float(s) - float(js)) <= ulp
    np.testing.assert_allclose(dequantize_int8(q, s).numpy(),
                               np.asarray(JC.dequantize_int8(jq, js)),
                               rtol=2.4e-7, atol=0)
