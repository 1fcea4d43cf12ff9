"""The port's drift detection and online adaptation against the JAX
package's.

The detector and the heuristic controller are NumPy on both sides, so
their decisions, refresh items and telemetry are equal exactly, and so
are the counters of ``serve_trace(adapt=True)`` (synchronous and inline
pipelined).  The learned controller fine-tunes the caching model: from
parameters carried by ``params_from_jax`` both packages take the same
refreshes and fine-tune steps on the same windows, and the parameters
after them agree within fp32 abs 1e-5 (the learned path's precedent; the
two frameworks sum the gradients in different orders).
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core.model_runtime import LearnedController as JaxController
from repro.core.model_runtime import LearnedModelConfig as JaxLearnedCfg
from repro.core.model_runtime import LearnedRecMGModel as JaxLearned
from repro.core.model_runtime import OutputsRef as JaxOutputsRef
from repro.core.tiered import TieredEmbeddingStore as JaxStore
from repro.runtime.drift import AdaptiveController as JaxAdaptive
from repro.runtime.drift import DriftConfig as JaxDriftConfig
from repro.runtime.drift import DriftDetector as JaxDetector
from repro_torch.configs import get_config
from repro_torch.core.caching_model import CachingModel
from repro_torch.core.lstm import params_from_jax
from repro_torch.core.model_runtime import (LearnedController,
                                            LearnedModelConfig,
                                            LearnedRecMGModel, OutputsRef)
from repro_torch.core.prefetch_model import PrefetchModel
from repro_torch.core.recmg import frequency_outputs
from repro_torch.core.tiered import TieredEmbeddingStore
from repro_torch.launch.serve import serve_trace
from repro_torch.models.dlrm import init_dlrm
from repro_torch.runtime.drift import (AdaptiveController, DriftConfig,
                                       DriftDetector)
from repro_torch.workloads import make_trace, scenario

CFG = dict(window=100, hot_k=10, jaccard_min=0.35, hitrate_drop=0.12,
           warmup_windows=2, cooldown_windows=1)
PARAM_ATOL = 1e-5


def _streams():
    rng = np.random.default_rng(0)
    stationary = np.tile(np.arange(10), 80)
    step = np.concatenate([np.tile(np.arange(10), 40),
                           np.tile(np.arange(100, 110), 40)])
    churn = np.concatenate([np.tile(np.arange(w, w + 10), 10)
                            for w in range(8)])
    noisy = rng.zipf(1.3, size=2000) % 300
    return {"stationary": (stationary, lambda b: 0.9),
            "step": (step, lambda b: 0.9),
            "churn": (churn, lambda b: 0.9),
            "hitrate_drop": (stationary, lambda b: 0.9 if b < 20 else 0.5),
            "noisy": (noisy, lambda b: 0.3 + 0.4 * ((b // 15) % 2))}


@pytest.mark.parametrize("name", sorted(_streams()))
def test_detector_decisions_equal_jax(name):
    ids, hit_rate = _streams()[name]
    got, want = DriftDetector(DriftConfig(**CFG)), \
        JaxDetector(JaxDriftConfig(**CFG))
    fired = {id(got): [], id(want): []}
    for b in range(len(ids) // 20):
        chunk = ids[b * 20: (b + 1) * 20]
        hits = int(round(hit_rate(b) * len(chunk)))
        for det in (got, want):
            fired[id(det)].append(det.observe(chunk, hits))
    assert fired[id(got)] == fired[id(want)]
    assert got.as_dict() == want.as_dict()
    if name in ("step", "hitrate_drop"):
        assert got.triggers >= 1


def _drift_trace():
    return make_trace(scenario("diurnal", n_tables=4, rows_per_table=512,
                               n_accesses=8192, seed=0, n_phases=2))


def _lockstep(got_ctl, want_ctl, store, jstore, trace, batch=256):
    """Serve ``trace`` through both stores in lockstep with no model
    outputs, feeding each controller its own store's hits; every batch's
    adaptation items must be equal and are staged into both stores."""
    gid = trace.global_id
    for b in range(len(gid) // batch):
        ids = gid[b * batch: (b + 1) * batch]
        h0, jh0 = store.stats.hits, jstore.stats.hits
        store.lookup(ids)
        jstore.lookup(ids)
        hits, jhits = store.stats.hits - h0, jstore.stats.hits - jh0
        assert hits == jhits
        items = got_ctl.on_batch(ids, hits, b)
        jitems = want_ctl.on_batch(ids, jhits, b)
        assert len(items) == len(jitems)
        for item, jitem in zip(items, jitems):
            for a, w in zip(item, jitem):
                np.testing.assert_array_equal(a, w)
            store.stage_model_outputs(*item)
            jstore.stage_model_outputs(*jitem)
        store.flush_staged()
        jstore.flush_staged()


@pytest.mark.parametrize("policy", ["lru", "recmg"])
def test_adaptive_controller_items_equal_jax(policy):
    trace = _drift_trace()
    cap = 200
    host = np.random.default_rng(0).normal(
        size=(trace.n_vectors, 8)).astype(np.float32)
    store = TieredEmbeddingStore(host, cap, policy=policy, device="cpu")
    jstore = JaxStore(host, cap, policy=policy)
    cfg = dict(window=1024, hot_k=128)
    got = AdaptiveController(store, cap, DriftConfig(**cfg))
    want = JaxAdaptive(jstore, cap, JaxDriftConfig(**cfg))
    _lockstep(got, want, store, jstore, trace)
    assert got.as_dict() == want.as_dict()
    assert got.refreshes >= 1 and got.rerank_rows > 0
    keys = ("lookups", "hits", "prefetch_hits", "on_demand_rows",
            "evictions")
    assert {k: getattr(store.stats, k) for k in keys} == \
        {k: getattr(jstore.stats, k) for k in keys}


def _serve_fixture():
    cfg = dataclasses.replace(get_config("dlrm-recmg").reduced(),
                              n_tables=4, rows_per_table=1024, multi_hot=2,
                              emb_dim=16)
    trace = make_trace(scenario("diurnal", n_tables=4, rows_per_table=1024,
                                n_accesses=16000, seed=0, n_phases=4))
    return cfg, trace


@pytest.mark.parametrize("async_prefetch", [False, True],
                         ids=["sync", "pipelined"])
@pytest.mark.parametrize("policy", ["lru", "recmg"])
def test_serve_trace_adapt_counters_equal_jax(policy, async_prefetch):
    from repro.configs import get_config as jax_get_config
    from repro.core.recmg import frequency_outputs as jax_frequency_outputs
    from repro.launch.serve import serve_trace as jax_serve_trace
    from repro.models.dlrm import init_dlrm as jax_init_dlrm

    cfg, trace = _serve_fixture()
    cap = int(0.15 * trace.unique_count())
    kw = dict(batch_queries=8, adapt=True, async_prefetch=async_prefetch,
              compute_us=500.0 if async_prefetch else None)
    outputs = frequency_outputs(trace, cap) if policy == "recmg" else None
    got = serve_trace(cfg, init_dlrm(cfg, seed=0, device="cpu"), trace, cap,
                      policy, outputs, device="cpu", **kw)
    jcfg = dataclasses.replace(jax_get_config("dlrm-recmg").reduced(),
                               n_tables=4, rows_per_table=1024, multi_hot=2,
                               emb_dim=16)
    jout = jax_frequency_outputs(trace, cap) if policy == "recmg" else None
    want = jax_serve_trace(jcfg, jax_init_dlrm(jax.random.PRNGKey(0), jcfg),
                           trace, cap, policy, jout, **kw)
    keys = ("batches", "lookups", "hits", "misses", "prefetch_hits",
            "on_demand_rows", "evictions", "on_demand_stall_ms", "drift")
    if async_prefetch:
        keys += ("runtime", "pf_accuracy", "pf_coverage")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["drift"]["refreshes"] >= 1
    for ns in ("drift.", "rt.") if async_prefetch else ("drift.",):
        mine = {k: v for k, v in got["metrics"]["counters"].items()
                if k.startswith(ns)}
        theirs = {k: v for k, v in want["metrics"]["counters"].items()
                  if k.startswith(ns)}
        assert mine == theirs and mine


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_learned_controller_equals_jax():
    """Both packages' learned controllers, from the same carried
    parameters, refresh and fine-tune on the same batches and windows; the
    caching model's parameters after every fine-tune agree within fp32
    abs 1e-5, and so does the refreshed candidate pool (exactly)."""
    trace = _drift_trace()
    cap = 200
    kw = dict(hidden=16, caching_epochs=1, prefetch_epochs=1,
              train_stride=8)
    jm = JaxLearned.train_from_trace(trace, cap, JaxLearnedCfg(**kw))
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tm = LearnedRecMGModel(
        LearnedModelConfig(**kw), jm.mcfg, jm.pcfg,
        params_from_jax(CachingModel(jm.mcfg), tree(jm.cparams)),
        params_from_jax(PrefetchModel(jm.pcfg), tree(jm.pparams)),
        jm.cand_ids, cap, trace)
    host = np.random.default_rng(0).normal(
        size=(trace.n_vectors, 8)).astype(np.float32)
    store = TieredEmbeddingStore(host, cap, policy="recmg", device="cpu")
    jstore = JaxStore(host, cap, policy="recmg")
    cfg = dict(window=1024, hot_k=128)
    oref, joref = OutputsRef(None), JaxOutputsRef(None)
    got = LearnedController(store, cap, tm, oref, trace, DriftConfig(**cfg))
    want = JaxController(jstore, cap, jm, joref, trace,
                         JaxDriftConfig(**cfg))
    _lockstep(got, want, store, jstore, trace)
    assert got.as_dict() == want.as_dict()
    assert tm.finetunes == jm.finetunes >= 1
    assert tm.finetune_steps_run == jm.finetune_steps_run > 0
    np.testing.assert_array_equal(tm.cand_ids, jm.cand_ids)
    state = {k: v.detach().numpy() for k, v in tm.cmodel.state_dict().items()}
    jflat = _flat(tree(jm.cparams))
    assert sorted(state) == sorted(jflat)
    for k in state:
        np.testing.assert_allclose(state[k], jflat[k], rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    # The swapped-in outputs cover the same chunk grid.
    np.testing.assert_array_equal(oref.outputs.chunk_starts,
                                  joref.outputs.chunk_starts)
    assert oref.outputs.caching_bits.shape == \
        joref.outputs.caching_bits.shape
