"""The port's learned RecMG models against the JAX package's, on the CPU.

Parameters are drawn by the JAX package (``init_caching_model``,
``init_prefetch_model``, ``init_voyager``) and carried into the port's
modules by ``params_from_jax``, so both packages compute the same function
on the same NumPy windows.  Tolerances: caching logits, prefetch points and
Voyager logits within fp32 abs 1e-5 (matrix products sum in another order
in each framework); keep bits and decoded ids equal (the fixture asserts
it has no logit and no nearest-candidate margin under 1e-4, so rounding
cannot flip a decision); losses and their gradients within rtol 1e-5 /
atol 1e-6; three AdamW steps within 1e-6.  Windows, online statistics,
Belady labels and prefetch targets are NumPy copies: byte-equal.  Replays
of equal outputs give equal counters.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import caching_model as CM
from repro_torch.core import prefetch_model as PM
from repro_torch.core import voyager as VY
from repro_torch.core.belady import belady_labels
from repro_torch.core.features import (access_stats, make_windows,
                                       split_train_eval)
from repro_torch.core.lstm import params_from_jax
from repro_torch.core.model_runtime import (LearnedModelConfig,
                                            LearnedRecMGModel)
from repro_torch.core.recmg import (RecMGOutputs, frequency_outputs,
                                    precompute_outputs, run_lru_pf,
                                    run_recmg)
from repro_torch.core.trace import TraceGenConfig, generate_trace
from repro_torch.optim.adamw import AdamW, OptConfig

HID = 16
CAP = 48
KEYS = ("xt", "xr1", "xr2", "xn", "xf", "xrc")


@lru_cache(maxsize=None)
def _trace():
    return generate_trace(TraceGenConfig(
        n_tables=3, rows_per_table=64, n_accesses=3000, seed=0,
        drift_every=10**9))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@lru_cache(maxsize=None)
def _carried():
    """JAX-drawn parameters of the three models and the port's modules
    carrying them."""
    from repro.core import caching_model as JCM
    from repro.core import prefetch_model as JPM
    from repro.core import voyager as JVY

    tr = _trace()
    mcfg = CM.CachingModelConfig(n_tables=tr.n_tables, hidden=HID)
    pcfg = PM.PrefetchModelConfig(n_tables=tr.n_tables, hidden=HID)
    vcfg = VY.VoyagerConfig(n_vectors=tr.n_vectors, page_size=16, hidden=HID)
    jc = JCM.init_caching_model(jax.random.PRNGKey(34), JCM.CachingModelConfig(
        n_tables=tr.n_tables, hidden=HID))
    jp = JPM.init_prefetch_model(jax.random.PRNGKey(6),
                                 JPM.PrefetchModelConfig(n_tables=tr.n_tables,
                                                         hidden=HID))
    jv = JVY.init_voyager(jax.random.PRNGKey(3), JVY.VoyagerConfig(
        n_vectors=tr.n_vectors, page_size=16, hidden=HID), tr.n_tables)
    tc = params_from_jax(CM.CachingModel(mcfg), _np_tree(jc))
    tp = params_from_jax(PM.PrefetchModel(pcfg), _np_tree(jp))
    tv = params_from_jax(VY.Voyager(vcfg, tr.n_tables), _np_tree(jv))
    return (mcfg, jc, tc), (pcfg, jp, tp), (vcfg, jv, tv)


@lru_cache(maxsize=None)
def _windows():
    return make_windows(_trace(), in_len=15, out_window=5, stride=15)


def _jax_inputs(data):
    return [jnp.asarray(getattr(data, f)) for f in
            ("x_table", "x_row1", "x_row2", "x_norm", "x_freq", "x_rec")]


def _grads(module):
    return {k: p.grad.numpy() for k, p in module.named_parameters()}


def _flat(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_params_from_jax_maps_every_key():
    (_, jc, tc), (_, jp, tp), (_, jv, tv) = _carried()
    for tree, mod in ((jc, tc), (jp, tp), (jv, tv)):
        flat = _flat(_np_tree(tree))
        sd = mod.state_dict()
        assert sorted(flat) == sorted(sd)
        for k, v in flat.items():
            np.testing.assert_array_equal(sd[k].numpy(), v)


def test_port_init_draws_the_jax_shapes():
    (mcfg, jc, _), (pcfg, jp, _), _ = _carried()
    tcfg, jt, _ = _carried_transformer()
    for tree, mod in ((jc, CM.CachingModel(mcfg, seed=5)),
                      (jp, PM.PrefetchModel(pcfg, seed=5)),
                      (jt, PM.PrefetchModel(tcfg, seed=5))):
        shapes = {k: v.shape for k, v in _flat(_np_tree(tree)).items()}
        assert shapes == {k: tuple(v.shape)
                          for k, v in mod.state_dict().items()}
    with pytest.raises(ValueError, match="backbone"):
        PM.PrefetchModel(PM.PrefetchModelConfig(backbone="gru"))


@lru_cache(maxsize=None)
def _carried_transformer():
    """JAX-drawn parameters of the transformer-backbone prefetch model and
    the port's module carrying them (``tblocks`` is a list in JAX, an
    ``nn.ModuleList`` in the port)."""
    from repro.core import prefetch_model as JPM

    tr = _trace()
    kw = dict(n_tables=tr.n_tables, hidden=HID, backbone="transformer")
    jt = JPM.init_prefetch_model(jax.random.PRNGKey(8),
                                 JPM.PrefetchModelConfig(**kw))
    cfg = PM.PrefetchModelConfig(**kw)
    return cfg, jt, params_from_jax(PM.PrefetchModel(cfg), _np_tree(jt))


def test_transformer_prefetch_points_and_ids_match_jax():
    from repro.core import prefetch_model as JPM

    cfg, jt, tt = _carried_transformer()
    tr, data = _trace(), _windows()
    jcfg = JPM.PrefetchModelConfig(n_tables=tr.n_tables, hidden=HID,
                                   backbone="transformer")
    want = np.asarray(JPM.prefetch_predict_batch(jt, jcfg,
                                                 *_jax_inputs(data)))
    got = PM.predict_sequences(tt, cfg, data, batch_size=64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    cand = np.sort(np.unique(tr.global_id))[::3]
    np.testing.assert_array_equal(
        PM.decode_to_ids(tt, cfg, got, cand, tr),
        JPM.decode_to_ids(jt, jcfg, want, cand, tr))


def test_caching_logits_and_bits_match_jax():
    from repro.core import caching_model as JCM

    (_, jc, tc), _, _ = _carried()
    data = _windows()
    want = np.asarray(JCM.caching_logits_batch(jc, *_jax_inputs(data)))
    got = CM.logits_for(tc, data, batch_size=64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(want).min() >= 1e-4  # no decision within rounding
    np.testing.assert_array_equal(CM.predict_bits(tc, data),
                                  JCM.predict_bits(jc, data))


def test_prefetch_points_and_decoded_ids_match_jax():
    from repro.core import prefetch_model as JPM

    _, (pcfg, jp, tp), _ = _carried()
    tr, data = _trace(), _windows()
    want = np.asarray(JPM.prefetch_predict_batch(
        jp, JPM.PrefetchModelConfig(n_tables=tr.n_tables, hidden=HID),
        *_jax_inputs(data)))
    got = PM.predict_sequences(tp, pcfg, data, batch_size=64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    cand = np.sort(np.unique(tr.global_id))[::3]
    jcfg = JPM.PrefetchModelConfig(n_tables=tr.n_tables, hidden=HID)
    want_ids = JPM.decode_to_ids(jp, jcfg, want, cand, tr)
    np.testing.assert_array_equal(
        PM.decode_to_ids(tp, pcfg, got, cand, tr), want_ids)
    # No decision within rounding: the nearest candidate leads the second
    # by at least 1e-4 everywhere.
    cr = np.asarray(JPM.candidate_reps(jp, jcfg, cand, tr), np.float64)
    d = ((want.reshape(-1, 1, want.shape[-1]) - cr[None]) ** 2).sum(-1)
    two = np.sort(d, axis=1)[:, :2]
    assert (two[:, 1] - two[:, 0]).min() >= 1e-4


def test_voyager_logits_and_next_ids_match_jax():
    from repro.core import voyager as JVY

    _, _, (vcfg, jv, tv) = _carried()
    tr, data = _trace(), _windows()
    jcfg = JVY.VoyagerConfig(n_vectors=tr.n_vectors, page_size=16,
                             hidden=HID)
    jpl, jol = JVY.voyager_logits_batch(jv, jcfg, *_jax_inputs(data)[:4])
    b = CM.window_tensors(data, "cpu", with_labels=False)
    with torch.no_grad():
        pl, ol = VY.voyager_logits(tv, vcfg, b["xt"], b["xr1"], b["xr2"],
                                   b["xn"])
    np.testing.assert_allclose(pl.numpy(), np.asarray(jpl), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ol.numpy(), np.asarray(jol), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(VY.predict_next(tv, vcfg, data),
                                  JVY.predict_next(jv, jcfg, data))


def _caching_batch(n=24):
    tr = _trace()
    labels, _, _ = belady_labels(tr.global_id, CAP)
    data = make_windows(tr, in_len=15, labels=labels, stride=7)
    b = data.batch(np.arange(n))
    t = CM.window_tensors(b, "cpu")
    j = dict(zip(KEYS, _jax_inputs(b)), y=jnp.asarray(b.y_keep))
    return t, j


def _assert_grads_match(module, jgrads):
    want = _flat(_np_tree(jgrads))
    got = _grads(module)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_bce_loss_and_grads_match_jax():
    from repro.core import caching_model as JCM

    (_, jc, tc), _, _ = _carried()
    t, j = _caching_batch()
    tc.zero_grad()
    loss = CM.bce_loss(tc, t)
    loss.backward()
    jl, jg = jax.value_and_grad(JCM.bce_loss)(jc, j)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5, atol=1e-6)
    _assert_grads_match(tc, jg)


@pytest.mark.parametrize("loss_kind", ["chamfer", "l2"])
def test_prefetch_loss_and_grads_match_jax(loss_kind):
    from repro.core import prefetch_model as JPM

    _, (pcfg, jp, tp), _ = _carried()
    tr = _trace()
    pdata = PM.make_prefetch_data(tr, stride=5)
    idx = np.arange(0, 96, 3)
    t = pdata.batch_dict(idx)
    jpdata = JPM.make_prefetch_data(tr, stride=5)
    j = jpdata.batch_dict(idx)
    cfg = PM.PrefetchModelConfig(n_tables=tr.n_tables, hidden=HID,
                                 loss=loss_kind)
    jcfg = JPM.PrefetchModelConfig(n_tables=tr.n_tables, hidden=HID,
                                   loss=loss_kind)
    tp.zero_grad()
    loss = PM.prefetch_loss(tp, cfg, t)
    loss.backward()
    jl, jg = jax.value_and_grad(
        lambda p: JPM.prefetch_loss(p, jcfg, j))(jp)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5, atol=1e-6)
    _assert_grads_match(tp, jg)
    del pcfg


@pytest.mark.parametrize("loss_kind", ["chamfer", "l2"])
def test_transformer_prefetch_loss_and_grads_match_jax(loss_kind):
    from repro.core import prefetch_model as JPM

    _, jt, _ = _carried_transformer()
    tr = _trace()
    kw = dict(n_tables=tr.n_tables, hidden=HID, backbone="transformer",
              loss=loss_kind)
    cfg, jcfg = PM.PrefetchModelConfig(**kw), JPM.PrefetchModelConfig(**kw)
    tt = params_from_jax(PM.PrefetchModel(cfg), _np_tree(jt))
    idx = np.arange(0, 96, 3)
    t = PM.make_prefetch_data(tr, stride=5).batch_dict(idx)
    j = JPM.make_prefetch_data(tr, stride=5).batch_dict(idx)
    loss = PM.prefetch_loss(tt, cfg, t)
    loss.backward()
    jl, jg = jax.value_and_grad(
        lambda p: JPM.prefetch_loss(p, jcfg, j))(jt)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5, atol=1e-6)
    _assert_grads_match(tt, jg)


def test_transformer_backbone_trains_with_falling_loss():
    tr = _trace()
    cfg = PM.PrefetchModelConfig(n_tables=tr.n_tables, hidden=HID,
                                 backbone="transformer")
    m, losses = PM.train_prefetch_model(
        PM.make_prefetch_data(tr, stride=5), cfg, epochs=2, batch_size=64,
        device="cpu")
    assert m.tblocks is not None and m.enc1 is None
    assert np.isfinite(losses).all() and len(losses) >= 8
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


@pytest.mark.parametrize("grad_scale", [1e-2, 10.0],
                         ids=["unclipped", "clipped"])
def test_adamw_three_steps_match_apply_updates(grad_scale):
    from repro.optim.adamw import OptConfig as JOptConfig
    from repro.optim.adamw import apply_updates, init_opt

    rng = np.random.default_rng(0)
    shapes = {"a": (5, 4), "b": (7,), "c": ()}
    p0 = {k: np.asarray(rng.normal(size=s), np.float32)
          for k, s in shapes.items()}
    grads = [{k: np.asarray(rng.normal(size=s) * grad_scale, np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    kw = dict(lr=3e-3, weight_decay=0.1, warmup_steps=2, total_steps=10)
    jcfg = JOptConfig(**kw)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jopt = init_opt(jcfg, jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in p0.items()}
    opt = AdamW(list(tparams.values()), OptConfig(**kw))
    for g in grads:
        jparams, jopt, _ = apply_updates(
            jcfg, jparams, jopt, {k: jnp.asarray(v) for k, v in g.items()})
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), rtol=0,
                                       atol=1e-6, err_msg=k)
    assert opt.count == int(jopt["count"]) == 3


def test_windows_stats_labels_and_prefetch_data_byte_equal():
    from repro.core.belady import belady_labels as j_belady
    from repro.core.features import access_stats as j_stats
    from repro.core.features import make_windows as j_windows
    from repro.core.prefetch_model import make_prefetch_data as j_pdata

    tr = _trace()
    gid = tr.global_id
    for a, b in zip(access_stats(gid), j_stats(gid)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(belady_labels(gid, CAP), j_belady(gid, CAP)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    fields = ("x_table", "x_row1", "x_row2", "x_norm", "x_freq", "x_rec",
              "y_keep", "y_window")
    for kw in (dict(stride=15, out_window=5), dict(stride=4, capacity=CAP)):
        got, want = make_windows(tr, **kw), j_windows(tr, **kw)
        for f in fields:
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), f
    miss = ~belady_labels(gid, CAP)[1]
    for mask in (None, miss):
        got, want = (PM.make_prefetch_data(tr, stride=5, miss_mask=mask),
                     j_pdata(tr, stride=5, miss_mask=mask))
        assert len(got) == len(want)
        for f in fields[:6]:
            assert np.array_equal(getattr(got.base, f),
                                  getattr(want.base, f)), f
        assert sorted(got.w_feats) == sorted(want.w_feats)
        for k, v in want.w_feats.items():
            assert got.w_feats[k].dtype == v.dtype
            assert np.array_equal(got.w_feats[k], v), k



def test_split_accuracy_and_sequence_metrics_match_jax():
    from repro.core.caching_model import evaluate_caching_model as j_eval
    from repro.core.features import make_windows as j_windows
    from repro.core.features import split_train_eval as j_split
    from repro.core.prefetch_model import sequence_metrics as j_metrics

    (_, jc, tc), _, _ = _carried()
    tr = _trace()
    got = split_train_eval(make_windows(tr, stride=4, capacity=CAP), 0.25)
    want = j_split(j_windows(tr, stride=4, capacity=CAP), 0.25)
    for g, w in zip(got, want):
        assert np.array_equal(g.x_table, w.x_table)
        assert np.array_equal(g.y_keep, w.y_keep)
    assert CM.evaluate_caching_model(tc, got[1], batch_size=64) == \
        pytest.approx(j_eval(jc, want[1], batch_size=64), abs=0)
    rng = np.random.default_rng(2)
    po = rng.integers(0, 40, (30, 5))
    gt = rng.integers(0, 40, (30, 15))
    assert PM.sequence_metrics(po, gt) == j_metrics(po, gt)


@lru_cache(maxsize=None)
def _learned_outputs():
    """Outputs of the carried models on the serving grid, from both
    packages' ``precompute_outputs``."""
    from repro.core.recmg import precompute_outputs as j_precompute

    (mcfg, jc, tc), (pcfg, jp, tp), _ = _carried()
    tr = _trace()
    got = precompute_outputs(tr, (tc, mcfg), (tp, pcfg), n_candidates=60)
    from repro.core.caching_model import CachingModelConfig as JMC
    from repro.core.prefetch_model import PrefetchModelConfig as JPC

    want = j_precompute(tr, (jc, JMC(n_tables=tr.n_tables, hidden=HID)),
                        (jp, JPC(n_tables=tr.n_tables, hidden=HID)),
                        n_candidates=60)
    return got, want


def test_precompute_outputs_match_jax():
    got, want = _learned_outputs()
    for f in ("chunk_starts", "caching_bits", "prefetch_ids"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("outputs", ["frequency", "learned"])
def test_run_recmg_and_lru_pf_counters_match_jax(outputs):
    from repro.core.recmg import RecMGOutputs as JOutputs
    from repro.core.recmg import run_lru_pf as j_lru_pf
    from repro.core.recmg import run_recmg as j_recmg

    tr = _trace()
    out = (frequency_outputs(tr, CAP) if outputs == "frequency"
           else _learned_outputs()[0])
    jout = JOutputs(out.chunk_starts, out.caching_bits, out.prefetch_ids)
    for kw in ({}, dict(pipelined=False), dict(use_prefetch=False)):
        got = run_recmg(tr, CAP, out, **kw).as_dict()
        assert got == j_recmg(tr, CAP, jout, **kw).as_dict()
    got = run_lru_pf(tr, CAP, out).as_dict()
    assert got == j_lru_pf(tr, CAP, jout).as_dict()
    assert got["prefetch_issued"] > 0


@lru_cache(maxsize=None)
def _trained():
    cfg = LearnedModelConfig(hidden=HID, caching_epochs=1, prefetch_epochs=1,
                             batch_size=32, train_stride=2, infer_batch=64)
    return LearnedRecMGModel.train_from_trace(_trace(), CAP, cfg,
                                              device="cpu")


def test_train_from_trace_losses_fall_and_grid_matches_frequency():
    model = _trained()
    for losses in (model.caching_losses, model.prefetch_losses):
        assert len(losses) >= 40 and np.isfinite(losses).all()
        assert np.mean(losses[-10:]) < np.mean(losses[:10])
    tr = _trace()
    out = model.outputs_for(tr)
    freq = frequency_outputs(tr, CAP)
    np.testing.assert_array_equal(out.chunk_starts, freq.chunk_starts)
    assert out.caching_bits.shape == freq.caching_bits.shape
    assert out.caching_bits.dtype == bool
    assert out.prefetch_ids.shape == freq.prefetch_ids.shape
    assert np.isin(out.prefetch_ids, model.cand_ids).all()
    assert set(model.timings) == {"belady_s", "caching_train_s",
                                  "prefetch_train_s"}
    tel = model.telemetry()
    assert tel["n_candidates"] == CAP and tel["finetunes"] == 0


def test_outputs_for_equals_its_parts_and_margins():
    """``outputs_for`` = bits of the logits + decode of the points, and the
    decode's margins are the gap to the second-nearest candidate."""
    model = _trained()
    data, starts = model.serving_windows(_trace())
    out = model.outputs_for(_trace())
    np.testing.assert_array_equal(out.chunk_starts, starts)
    np.testing.assert_array_equal(out.caching_bits,
                                  model.predict_logits(data) > 0)
    pts = model.predict_points(data)
    ids, gaps = model.decode_points(pts, return_margins=True)
    np.testing.assert_array_equal(out.prefetch_ids, ids)
    assert gaps.shape == ids.shape and (gaps >= 0).all()
    # Batch size does not change a decision.
    one = LearnedRecMGModel(
        LearnedModelConfig(hidden=HID, infer_batch=7), model.mcfg,
        model.pcfg, model.cmodel, model.pmodel, model.cand_ids, CAP,
        model.geom).outputs_for(_trace())
    np.testing.assert_array_equal(one.caching_bits, out.caching_bits)
    np.testing.assert_array_equal(one.prefetch_ids, out.prefetch_ids)


def test_finetune_steps_and_refreshes_the_pool():
    model = _trained().to("cpu")
    before = {k: v.clone() for k, v in model.cmodel.state_dict().items()}
    recent = _trace().global_id
    steps = model.finetune(recent)
    assert steps == model.cfg.finetune_steps == model.finetune_steps_run
    assert any(not torch.equal(before[k], v)
               for k, v in model.cmodel.state_dict().items())
    assert len(model.cand_ids) == CAP
    assert model.telemetry()["finetunes"] == 1
    # The copy made by ``to`` left the trained model untouched.
    orig = _trained().cmodel.state_dict()
    assert all(torch.equal(before[k], orig[k]) for k in orig)


def test_recmg_oracle_grid_and_empty_outputs():
    tr = _trace()
    out = precompute_outputs(tr)
    assert out.caching_bits is None and out.prefetch_ids is None
    np.testing.assert_array_equal(out.chunk_starts,
                                  frequency_outputs(tr, CAP).chunk_starts)
    assert isinstance(out, RecMGOutputs)
