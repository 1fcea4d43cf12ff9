"""The port's encoder-decoder LM (whisper-large-v3) against the JAX
package's, on the CPU, and the unmasked attention its encoder runs.

``params_from_jax(init_encdec(PRNGKey(0), cfg))`` gives both packages the
same weights; tokens, audio frames and upstream gradients are numpy draws.
The reduced config (2 + 2 layers, d_model 64, 4/4 heads of 16, 16
frames) runs in fp32 and in a bf16 copy.  Tolerances, as in
``tests/test_torch_lm.py``: fp32 rtol/atol 1e-5 elementwise (sums in
another order), every fp32 gradient within 1e-5 x max |JAX gradient| of
its leaf; bf16 within 2e-2 of each tensor's largest magnitude (JAX rounds
p to bf16 before the p v product of the encoder's attention and computes
the GELU op by op in bf16; the port keeps p in fp32 there and rounds the
GELU once).  On the CPU the encoder's attention and its backward are the
kernels' plain versions (``causal_attention_ref(causal=False)``,
``flash_attention_bwd_ref(causal=False)``), held here to JAX's
``plain_attention(causal=False)`` and its ``jax.vjp``.
"""
import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import LM_SHAPES as JAX_LM_SHAPES
from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_get_config
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import encdec as JED
from repro.models import layers as JL
from repro.models import model_api as JMA
from repro.optim.adamw import OptConfig as JaxOptConfig
from repro.optim.adamw import init_opt as jax_init_opt
from repro_torch.configs import LM_SHAPES, NOT_PORTED, RunConfig, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.launch.steps import make_train_step
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models.model_api import build
from repro_torch.optim.adamw import OptConfig, init_opt
from repro_torch.tree import named_leaves

ARCH = "whisper-large-v3"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
S = 12  # decoder tokens; the reduced encoder reads 16 frames


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    """fp32: elementwise; bf16: within ``tol`` of the largest magnitude."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if tol == TOL["float32"]:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        err, scale = np.abs(got - want).max(), np.abs(want).max()
        assert err <= tol * scale, f"max abs err {err} > {tol} * {scale}"


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _cfgs(dtype="float32"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(get_config(ARCH).reduced(), **kw),
            dataclasses.replace(jax_get_config(ARCH).reduced(), **kw))


@lru_cache(maxsize=None)
def _both(dtype="float32"):
    """(cfg, JAX cfg, JAX params, the port's model on them)."""
    cfg, jcfg = _cfgs(dtype)
    jp = JED.init_encdec(jax.random.PRNGKey(0), jcfg)
    model = ED.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                               device="cpu")
    return cfg, jcfg, jp, model


def _batch(cfg, b=2, s=S, seed=0):
    """Tokens, labels (a fifth masked, the last position -1) and frames."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -1, np.int32)],
                            axis=1)
    labels[rng.random((b, s)) < 0.2] = -1
    frames = rng.normal(size=(b, cfg.enc_len, cfg.d_model)).astype(
        np.float32)
    return {"tokens": tokens, "labels": labels, "frontend": frames}


def _frames(cfg, batch):
    return torch.from_numpy(batch["frontend"]).to(getattr(
        torch, cfg.compute_dtype))


def _jframes(jcfg, batch):
    return jnp.asarray(batch["frontend"], jnp.dtype(jcfg.compute_dtype))


def _jax_named(tree):
    """{port leaf name: array}: the stacked L axes of ``enc_blocks`` and
    ``dec_blocks`` unrolled."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [str(p.key) for p in path]
        if names[0] in ("enc_blocks", "dec_blocks"):
            for i in range(leaf.shape[0]):
                out[".".join([names[0], str(i)] + names[1:])] = (
                    jax.ShapeDtypeStruct(leaf.shape[1:], leaf.dtype)
                    if isinstance(leaf, jax.ShapeDtypeStruct)
                    else np.asarray(leaf)[i])
        else:
            out[".".join(names)] = leaf
    return out


# ---------------------------------------------------------------------------
# Config, parameters, bundle
# ---------------------------------------------------------------------------


def test_config_and_reduced_config_match_jax():
    assert ARCH not in NOT_PORTED
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_get_config(ARCH))
    assert dataclasses.asdict(get_config(ARCH).reduced()) == \
        dataclasses.asdict(jax_get_config(ARCH).reduced())


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_params_from_jax_keeps_every_bit(dtype):
    _, _, jp, model = _both(dtype)
    want = _jax_named(jp)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        t, a = got[name], np.asarray(a)
        assert str(t.dtype).split(".")[-1] == a.dtype.name, name
        assert np.array_equal(_np(t), a.astype(np.float32)), name


def test_port_init_draws_the_jax_shapes():
    """Encoder and decoder self-attention with the config's (absent) biases
    and norms, the cross-attention without, ungated MLPs; seeded."""
    cfg, jcfg = _cfgs()
    want = _jax_named(jax.eval_shape(
        lambda: JED.init_encdec(jax.random.PRNGKey(0), jcfg)))
    model = ED.init_encdec(cfg, seed=0, device="cpu")
    got = model.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert "dec_blocks.0.xattn.wq" in got and "enc_blocks.1.mlp.w3" not in got
    assert not any(p.requires_grad for p in model.parameters())
    again = ED.init_encdec(cfg, seed=0, device="cpu").state_dict()
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_n_params_and_batch_struct_match_jax():
    """At full size: 1,600,990,720 parameters, JAX's count; every shape
    cell's batch (the audio frames (B, enc_len, d_model) in the compute
    dtype) as JAX's ``batch_struct`` gives it."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    bundle, jbundle = build(cfg, device="cpu"), JMA.build(jcfg)
    assert bundle.n_params() == jbundle.n_params() == 1_600_990_720
    assert bundle.n_active_params() == jbundle.n_active_params()
    for name, shape in LM_SHAPES.items():
        got = bundle.batch_struct(shape)
        want = jbundle.batch_struct(JAX_LM_SHAPES[name])
        assert {k: (s, str(d).split(".")[-1]) for k, (s, d) in got.items()} \
            == {k: (tuple(v.shape), v.dtype.name) for k, v in want.items()}
    small = build(_cfgs()[0], device="cpu")
    assert sum(p.numel() for p in small.init(seed=1).parameters()) == \
        small.n_params()


# ---------------------------------------------------------------------------
# The unmasked attention (the encoder's) and the new layers
# ---------------------------------------------------------------------------

# (B, S, H, K, hd): whisper's 4/4 reduced heads, and a GQA layout.
ATTN_SHAPES = [(2, 16, 4, 4, 16), (2, 21, 6, 2, 16)]


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_unmasked_plain_attention_and_lse_match_jax(shape, dtype):
    """``causal_attention_ref(causal=False)`` (the kernel's plain version)
    and its log-sum-exp against JAX's ``plain_attention(causal=False)``
    and the log-sum-exp of JAX's scaled scores."""
    b, s, h, n_kv, hd = shape
    q, k, v = (_normal((b, s, n, hd), i) for i, n in enumerate(
        (h, n_kv, n_kv)))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    want = JL.plain_attention(jq, jk, jv, causal=False)
    _close(ref.causal_attention_ref(tq, tk, tv, causal=False), want,
           TOL[dtype])
    o, lse = ref.causal_attention_lse_ref(tq, tk, tv, causal=False)
    _close(o, want, TOL[dtype])
    scores = JL._gqa_scores(jq.reshape(b, s, n_kv, h // n_kv, hd), jk,
                            1.0 / np.sqrt(hd))
    _close(lse, jax.nn.logsumexp(scores, axis=-1).reshape(b, h, s), 1e-5)
    # The mask matters: the causal result differs.
    assert not np.allclose(_np(o), _np(ref.causal_attention_ref(tq, tk, tv)),
                           atol=1e-3)


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_unmasked_attention_grads_match_jax(shape):
    """``ops.flash_attention(causal=False)`` under autograd (on the CPU the
    plain forward with its log-sum-exp, then
    ``flash_attention_bwd_ref(causal=False)``) against ``jax.vjp`` of
    ``plain_attention(causal=False)``: within 1e-5 x max(1, max |JAX
    gradient|), the causal backward's bound."""
    b, s, h, n_kv, hd = shape
    q, k, v, do = (_normal((b, s, n, hd), 10 + i) for i, n in enumerate(
        (h, n_kv, n_kv, h)))
    _, vjp = jax.vjp(lambda *a: JL.plain_attention(*a, causal=False),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, causal=False)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    o2, lse = ref.causal_attention_lse_ref(*(t.detach() for t in
                                             (tq, tk, tv)), causal=False)
    direct = ref.flash_attention_bwd_ref(tq.detach(), tk.detach(),
                                         tv.detach(), o2, torch.from_numpy(
                                             do), lse, causal=False)
    for name, g, w, d in zip("qkv", got, want, direct):
        w = np.asarray(w)
        bound = 1e-5 * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g.numpy() - w).max()) <= bound, f"d{name}"
        assert torch.equal(g, d), f"d{name}"


def test_unmasked_attention_takes_no_window():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="window"):
        ref.causal_attention_ref(q, q, q, 4, causal=False)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, 4, causal=False)
    with pytest.raises(ValueError, match="window"):
        fa._window(4, 8, False, "flash_attention")
    assert fa._window(0, 8, False, "flash_attention") == 0
    assert fa._window(20, 8, True, "flash_attention") == 8


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("sq", [12, 1])
def test_plain_attention_matches_jax(sq, dtype):
    """Unmasked, queries and keys of different lengths: the
    cross-attention's 12 against 16, and one query, decode's; p rounded to
    v's dtype for the p v product."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    q = _normal((2, sq, 6, 16), 20)
    k, v = (_normal((2, 16, 2, 16), 21 + i) for i in range(2))
    _close(L.plain_attention(*(torch.from_numpy(a).to(tdt)
                               for a in (q, k, v))),
           JL.plain_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                              causal=False), TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_cross_attention_and_gelu_mlp_match_jax(dtype):
    cfg, jcfg, jp, model = _both(dtype)
    tdt = getattr(torch, dtype)
    blk = model.dec_blocks[1]
    lp = jax.tree_util.tree_map(lambda a: a[1], jp["dec_blocks"])
    enc = _normal((2, cfg.enc_len, cfg.d_model), 30)
    x = _normal((2, 5, cfg.d_model), 31)
    jenc, jx = (jnp.asarray(a, jnp.dtype(dtype)) for a in (enc, x))
    tenc, tx = (torch.from_numpy(a).to(tdt) for a in (enc, x))
    wk, wv = JL.cross_kv(lp["xattn"], jcfg, jenc)
    k, v = L.cross_kv(blk.xattn, cfg, tenc)
    _close(k, wk, TOL[dtype])
    _close(v, wv, TOL[dtype])
    _close(L.cross_attn_block(blk.xattn, cfg, tx, k, v),
           JL.cross_attn_block(lp["xattn"], jcfg, jx, wk, wv), TOL[dtype])
    _close(L.mlp_block(blk.mlp, tx), JL.mlp_block(lp["mlp"], jx),
           TOL[dtype])


# ---------------------------------------------------------------------------
# The model: encode, decode_forward, the loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_encode_decode_forward_and_loss_match_jax(dtype):
    cfg, jcfg, jp, model = _both(dtype)
    batch = _batch(cfg, seed=1)
    jrun, run = JaxRunConfig(), RunConfig()
    want_enc = JED.encode(jp, jcfg, jrun, _jframes(jcfg, batch))
    got_enc = ED.encode(model, cfg, run, _frames(cfg, batch))
    _close(got_enc, want_enc, TOL[dtype])
    tokens = torch.from_numpy(batch["tokens"]).long()
    want_x, _ = JED.decode_forward(jp, jcfg, jrun,
                                   jnp.asarray(batch["tokens"]), want_enc)
    got_x, caches = ED.decode_forward(model, cfg, run, tokens, got_enc)
    assert caches is None
    _close(got_x, want_x, TOL[dtype])
    want = JED.encdec_loss(jp, jcfg, jrun, jnp.asarray(batch["tokens"]),
                           jnp.asarray(batch["labels"]),
                           _jframes(jcfg, batch))
    got = ED.encdec_loss(model, cfg, run, tokens,
                         torch.from_numpy(batch["labels"]).long(),
                         _frames(cfg, batch))
    assert got.dtype == torch.float32
    _close(got, want, TOL[dtype])


@lru_cache(maxsize=None)
def _jax_grads():
    """(batch, JAX loss, {leaf: JAX gradient}) of the fp32 reduced model."""
    cfg, jcfg, jp, _ = _both()
    batch = _batch(cfg, seed=2)
    loss, grads = jax.value_and_grad(lambda p: JED.encdec_loss(
        p, jcfg, JaxRunConfig(remat="none"), jnp.asarray(batch["tokens"]),
        jnp.asarray(batch["labels"]), _jframes(jcfg, batch)))(jp)
    return batch, float(loss), _jax_named(grads)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_encdec_grads_match_jax(remat):
    """Every leaf's gradient of ``encdec_loss`` against ``jax.grad`` of
    JAX's, within 1e-5 x its largest magnitude; the loss within rtol
    1e-5."""
    cfg, _, jp, _ = _both()
    batch, jloss, jgrads = _jax_grads()
    model = ED.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                               device="cpu").requires_grad_(True)
    loss = ED.encdec_loss(model, cfg, RunConfig(remat=remat),
                          torch.from_numpy(batch["tokens"]).long(),
                          torch.from_numpy(batch["labels"]).long(),
                          _frames(cfg, batch))
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    names, ps = zip(*named_leaves(model))
    assert sorted(names) == sorted(jgrads)
    for name, g in zip(names, torch.autograd.grad(loss, ps)):
        w = np.asarray(jgrads[name], np.float32)
        err, scale = float(np.abs(_np(g) - w).max()), float(np.abs(w).max())
        assert err <= 1e-5 * scale, f"{name}: {err} > 1e-5 * {scale}"


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    """One ``make_train_step`` on the bundle's loss (the frames a batch
    entry like the tokens) against JAX's: loss and gradient norm within
    rtol 1e-5, every parameter within 1e-5 after the update."""
    cfg, jcfg, jp, _ = _both()
    batch = _batch(cfg, b=4, seed=3)
    jopt_cfg = JaxOptConfig(lr=1e-3)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    jstep = jax.jit(jax_make_train_step(
        JMA.build(jcfg, JaxRunConfig(remat="none")), jopt_cfg, microbatches))
    jparams, _, jm = jstep(jparams, jax_init_opt(jopt_cfg, jparams),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    model = ED.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                               device="cpu")
    opt = init_opt(OptConfig(lr=1e-3), [p for _, p in named_leaves(model)])
    m = make_train_step(build(cfg, device="cpu"), microbatches)(model, opt,
                                                                batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    got = dict(named_leaves(model))
    for name, w in _jax_named(jparams).items():
        np.testing.assert_allclose(_np(got[name]), w, rtol=0, atol=1e-5,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# Serving: prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cache_len", [None, 20], ids=["at_S", "above_S"])
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_prefill_and_three_decode_steps_match_jax(dtype, cache_len):
    """Through both bundles: the last token's logits and every cache
    tensor (``k``/``v`` padded to ``cache_len``, ``xk``/``xv`` over the 16
    frames), then three decode steps; at S the ring's first slot is
    overwritten by the first step, as in JAX."""
    cfg, jcfg, jp, model = _both(dtype)
    tol = TOL[dtype]
    batch = _batch(cfg, seed=4)
    inputs = {"tokens": batch["tokens"], "frontend": batch["frontend"]}
    jb, pb = JMA.build(jcfg), build(cfg, device="cpu")
    wl, wc = jb.prefill(jp, {"tokens": jnp.asarray(batch["tokens"]),
                             "frontend": _jframes(jcfg, batch)},
                        cache_len=cache_len)
    gl, gc = pb.prefill(model, inputs, cache_len=cache_len)
    assert gl.dtype == torch.float32 and gl.shape == (2, cfg.vocab)
    assert gc["pos"] == int(wc["pos"]) == S
    _close(gl, wl, tol)
    for key in ("k", "v", "xk", "xv"):
        assert tuple(gc[key].shape) == wc[key].shape, key
        _close(gc[key], wc[key], tol)
    for step, tok in enumerate(_normal((3, 2, 1), 5)):
        tok = (np.abs(tok) * 100).astype(np.int64) % cfg.vocab
        wl, wc = jb.decode(jp, jnp.asarray(tok), wc)
        gl, gc = pb.decode(model, tok, gc)
        assert gc["pos"] == int(wc["pos"]) == S + step + 1
        _close(gl, wl, tol)
        for key in ("k", "v", "xk", "xv"):
            _close(gc[key], wc[key], tol)
