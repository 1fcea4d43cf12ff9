"""The port's MoE and VLM LMs against the JAX package's, on the CPU.

Parameters are JAX's (``init_moe``/``init_lm`` of a ``PRNGKey``) carried
over by ``params_from_jax`` or as NumPy arrays; activations, tokens and
frontend embeddings are numpy draws handed to both.  Tolerances are fp32
1e-5: outputs, aux losses and logits within rtol/atol 1e-5 (the sums run
in another order); gradients within 1e-5 x max(1, max |JAX grad|).
Selections are exact: top-K sets, keep masks and the choice among tied
router probabilities equal JAX's (``lax.top_k`` takes the lower index on
ties).
"""
import dataclasses
import math
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_get_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models import layers as JL
from repro.models import model_api as JMA
from repro.models import transformer as JT
from repro_torch.configs import LM_SHAPES, RunConfig, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model_api import build
from repro_torch.tree import named_leaves

TOL = 1e-5
MOE_ARCHS = ["granite-moe-1b-a400m", "grok-1-314b"]
JRUN = JaxRunConfig(remat="none")


def _moe_cfgs(cf, n_experts=4, top_k=2):
    """(port, JAX) one-layer MoE configs of test_layers.py's widths."""
    kw = dict(name="t", family="moe", n_layers=1, d_model=16, d_ff=32,
              vocab=64, n_experts=n_experts, top_k=top_k, moe_d_ff=32,
              capacity_factor=cf, param_dtype="float32",
              compute_dtype="float32")
    return ModelConfig(**kw), JaxModelConfig(**kw)


def _moe_params(jcfg, seed=0):
    """(JAX moe params, the port's dict of the same tensors)."""
    jp = JL.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _capacity(cfg, t):
    return max(1, math.ceil(cfg.capacity_factor * t * cfg.top_k
                            / cfg.n_experts))


def _jax_keep(jp, jcfg, xf):
    """JAX's top-K experts and keep masks, by the lines of
    ``_moe_dispatch_ffn`` that make them."""
    e, k = jcfg.n_experts, jcfg.top_k
    t = xf.shape[0]
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xf, jp["router"]), -1)
    _, top_e = jax.lax.top_k(probs, k)
    c = max(1, int(math.ceil(jcfg.capacity_factor * t * k / e)))
    flat_e = top_e.reshape(-1)
    pos = jnp.cumsum(jax.nn.one_hot(flat_e, e, dtype=jnp.int32), 0) - 1
    pos = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    return np.asarray(top_e), np.asarray(pos < c)


# ---------------------------------------------------------------------------
# The MoE block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,cf,s", [(2, 1.25, 32), (4, 0.25, 32),
                                    (2, 8.0, 10), (4, 1.25, 15)])
def test_local_dispatch_shards_on_one_rank(n, cf, s):
    """``local_dispatch`` in a scope on an (n, 1) stand-in mesh whose rows
    lie on no axis: one process dispatches JAX's ``n`` shards of the
    tokens (``_moe_dispatch_ffn_sharded``), outputs, aux and the input's
    gradient; where n does not divide the 2 s tokens (s 15 at n 4), JAX's
    fallback to the global dispatch."""
    from repro_torch.distributed import mesh as M

    cfg, jcfg = _moe_cfgs(cf)
    jp, tp = _moe_params(jcfg)
    x = _normal((2, s, cfg.d_model), 2)
    xf = jnp.asarray(x.reshape(-1, cfg.d_model))
    if xf.shape[0] % n:
        jfn = lambda xf_: JL._moe_dispatch_ffn(jp, jcfg, xf_)  # noqa: E731
    else:
        jfn = lambda xf_: JL._moe_dispatch_ffn_sharded(  # noqa: E731
            jp, jcfg, xf_, n)
    jy, jaux = jax.jit(jfn)(xf)
    jgrad = jax.jit(jax.grad(
        lambda xf_: (lambda o: o[0].sum() + o[1])(jfn(xf_))))(xf)
    tx = torch.from_numpy(x).requires_grad_(True)
    with M.activation_sharding(M.Mesh(n, 1, 0), "fsdp_tp", rows=()):
        y, aux = L.moe_block(tp, cfg, tx, local_dispatch=True)
    (y.sum() + aux).backward()
    _close(y.reshape(-1, cfg.d_model), jy)
    _close(aux, jaux)
    _close(tx.grad.reshape(-1, cfg.d_model), jgrad)


@pytest.mark.parametrize("cf,s", [(8.0, 10), (16.0, 10), (0.25, 32),
                                  (1.25, 32)])
def test_moe_block_matches_jax(cf, s):
    """Capacity dispatch (droppless at cf 8 and 16, dropping at 0.25 and
    1.25) and dense routing: outputs, aux and keep masks."""
    cfg, jcfg = _moe_cfgs(cf)
    jp, tp = _moe_params(jcfg)
    x = _normal((2, s, cfg.d_model), 1)
    jy, jaux = JL.moe_block(jp, jcfg, jnp.asarray(x))
    y, aux = L.moe_block(tp, cfg, torch.from_numpy(x))
    _close(y, jy)
    _close(aux, jaux)
    jyd, jauxd = JL.moe_block(jp, jcfg, jnp.asarray(x), dense_route=True)
    yd, auxd = L.moe_block(tp, cfg, torch.from_numpy(x), dense_route=True)
    _close(yd, jyd)
    assert float(auxd) == float(jauxd) == 0.0

    xf = x.reshape(-1, cfg.d_model)
    want_e, want_keep = _jax_keep(jp, jcfg, jnp.asarray(xf))
    _, _, top_e = L._route(tp, cfg, torch.from_numpy(xf))
    e, c = cfg.n_experts, _capacity(cfg, xf.shape[0])
    slot, keep = L._capacity_slots(top_e.reshape(-1), e, c)
    assert np.array_equal(top_e.numpy(), want_e)
    assert np.array_equal(keep.numpy(), want_keep)
    assert int((slot == e * c).sum()) == int((~keep).sum())
    if cf >= 8.0:
        assert keep.all()
    elif cf == 0.25:
        assert not keep.all()


def test_moe_capacity_vs_dense_when_droppless():
    """Mirror of ``tests/test_layers.py``: with no token dropped, the
    capacity dispatch equals dense routing."""
    cfg, jcfg = _moe_cfgs(16.0)
    _, tp = _moe_params(jcfg)
    x = torch.from_numpy(_normal((2, 10, 16), 1))
    y_cap, aux = L.moe_block(tp, cfg, x)
    y_dense, _ = L.moe_block(tp, cfg, x, dense_route=True)
    torch.testing.assert_close(y_cap, y_dense, rtol=1e-4, atol=1e-5)
    assert float(aux) > 0


def test_moe_capacity_drops_gracefully():
    """Mirror of ``tests/test_layers.py``: at cf 0.25 tokens are dropped,
    the output stays finite, and a token all of whose assignments were
    dropped gets a zero output."""
    cfg, jcfg = _moe_cfgs(0.25)
    _, tp = _moe_params(jcfg)
    x = torch.from_numpy(_normal((2, 32, 16), 1))
    y, _ = L.moe_block(tp, cfg, x)
    assert torch.isfinite(y).all()
    xf = x.reshape(-1, 16)
    _, _, top_e = L._route(tp, cfg, xf)
    _, keep = L._capacity_slots(top_e.reshape(-1), 4, _capacity(cfg, 64))
    none_kept = ~keep.view(-1, 2).any(dim=1)
    assert none_kept.any()
    assert (y.reshape(-1, 16)[none_kept] == 0).all()


def test_top_k_takes_the_lower_index_on_ties():
    """Probabilities with exact ties, against ``lax.top_k``."""
    rng = np.random.default_rng(2)
    levels = np.array([0.05, 0.1, 0.2, 0.3], np.float32)
    probs = levels[rng.integers(0, 4, (64, 8))]
    probs[0] = 0.125  # all eight tied
    for k in (1, 2, 3, 5, 8):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = L._top_k(torch.from_numpy(probs), k)
        assert np.array_equal(gi.numpy(), np.asarray(wi)), k
        assert np.array_equal(gv.numpy(), np.asarray(wv)), k


@pytest.mark.parametrize("dense_route", [False, True])
def test_tied_router_selects_as_jax(dense_route):
    """Zero tokens give every expert the same probability; two tokens whose
    router logits tie on experts 1 and 3 (equal router columns): both
    frameworks pick the lower indices."""
    cfg, jcfg = _moe_cfgs(8.0, n_experts=8, top_k=3)
    jp, tp = _moe_params(jcfg)
    router = np.array(jp["router"])
    router[:, 3] = router[:, 1]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = np.zeros((1, 4, 16), np.float32)
    x[0, 2, 0] = 1.0  # logits = router's first row: columns 1 and 3 tie
    x[0, 3, 5] = -2.0
    want_e, _ = _jax_keep(jp, jcfg, jnp.asarray(x[0]))
    _, _, top_e = L._route(tp, cfg, torch.from_numpy(x[0]))
    assert np.array_equal(top_e.numpy(), want_e)
    assert list(want_e[0]) == [0, 1, 2]
    jy, _ = JL.moe_block(jp, jcfg, jnp.asarray(x), dense_route=dense_route)
    y, _ = L.moe_block(tp, cfg, torch.from_numpy(x), dense_route=dense_route)
    _close(y, jy)


def test_moe_dropped_assignments_get_no_gradient():
    """The drop slot's row is discarded: a token whose assignments were
    all dropped gets no gradient through the experts, as JAX's scatter
    transpose gives (the router still gets one through aux)."""
    cfg, jcfg = _moe_cfgs(0.25)
    jp, tp = _moe_params(jcfg)
    x = _normal((1, 32, 16), 3)
    jgrad = jax.grad(lambda x_: JL.moe_block(jp, jcfg, x_)[0].sum())(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    L.moe_block(tp, cfg, tx)[0].sum().backward()
    _close(tx.grad, jgrad)
    _, _, top_e = L._route(tp, cfg, torch.from_numpy(x[0]))
    _, keep = L._capacity_slots(top_e.reshape(-1), 4, _capacity(cfg, 32))
    none_kept = ~keep.view(-1, 2).any(dim=1)
    assert none_kept.any()
    assert (tx.grad[0][none_kept] == 0).all()


# ---------------------------------------------------------------------------
# The MoE and VLM LMs
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _lm(arch, cf=None):
    """(port cfg, JAX cfg, JAX params as numpy) of the reduced arch, at
    capacity factor ``cf`` when given."""
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    jp = jax.tree_util.tree_map(np.asarray,
                                JT.init_lm(jax.random.PRNGKey(0), jcfg))
    return cfg, jcfg, jp


def _jax_named(tree):
    """{key path: array} of a JAX tree with the stacked L axis unrolled,
    named as the port's leaves."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [str(p.key) for p in path]
        leaf = np.asarray(leaf)
        if names[0] == "blocks":
            for i in range(leaf.shape[0]):
                out[".".join([names[0], str(i)] + names[1:])] = leaf[i]
        else:
            out[".".join(names)] = leaf
    return out


def _batch(cfg, b, s, seed, frontend):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -1, np.int32)],
                            axis=1)
    labels[rng.random((b, s)) < 0.2] = -1
    batch = {"tokens": tokens, "labels": labels}
    if frontend:
        batch["frontend"] = rng.normal(size=(
            b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch,cf,remat", [
    ("granite-moe-1b-a400m", None, "none"),
    ("granite-moe-1b-a400m", 0.5, "full"),
    ("grok-1-314b", None, "full"),
    ("grok-1-314b", 0.5, "none"),
    ("internvl2-26b", None, "full"),
])
def test_lm_loss_and_grads_match_jax(arch, cf, remat):
    """``lm_loss`` (the aux term included) and every gradient against
    ``jax.grad``: the reduced MoE configs droppless (cf 8) and dropping
    (cf 0.5), the VLM with a frontend; under ``remat`` full and none."""
    cfg, jcfg, jp = _lm(arch, cf)
    batch = _batch(cfg, 2, 32, seed=4, frontend=bool(cfg.frontend))
    jloss, jgrads = jax.value_and_grad(
        lambda p: JMA.build(jcfg, JRUN).loss(
            p, {k: jnp.asarray(v) for k, v in batch.items()}))(
        jax.tree_util.tree_map(jnp.asarray, jp))
    model = T.params_from_jax(jp, cfg, device="cpu").requires_grad_(True)
    loss = build(cfg, device="cpu", run=RunConfig(remat=remat)).loss(
        model, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    names, ps = zip(*named_leaves(model))
    got = dict(zip(names, torch.autograd.grad(loss, ps)))
    want = _jax_named(jgrads)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        bound = TOL * max(1.0, float(np.abs(w).max()))
        err = float(np.abs(got[name].numpy() - w).max())
        assert err <= bound, f"{name}: max abs err {err} > {bound}"
    if cfg.n_experts:
        assert float(np.abs(want["blocks.0.moe.router"]).max()) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_aux_is_the_mean_of_the_layers(arch):
    """``backbone``'s aux is the layers' mean, and ``lm_loss`` adds 0.01 of
    it to the cross-entropy: against JAX's ``backbone``."""
    cfg, jcfg, jp = _lm(arch)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (2, 24))
    positions = jnp.arange(24)[None, :]
    x = JT._embed(jp, jcfg, jnp.asarray(tokens))
    _, jaux, _ = JT.backbone(jax.tree_util.tree_map(jnp.asarray, jp), jcfg,
                             JRUN, x, positions)
    model = T.params_from_jax(jp, cfg, device="cpu")
    tt = torch.from_numpy(tokens)
    _, aux = T.backbone(model, cfg, RunConfig(remat="none"),
                        T._embed(model, cfg, tt), torch.arange(24)[None, :])
    _close(aux, jaux)
    assert float(aux) > 0


@pytest.mark.parametrize("cache_len", [None, 20])
def test_vlm_prefill_and_decode_match_jax(cache_len):
    """The VLM's prefill with and without a frontend, then two decode
    steps, against JAX; the frontend changes the output."""
    cfg, jcfg, jp = _lm("internvl2-26b")
    model = T.params_from_jax(jp, cfg, device="cpu")
    jb, pb = JMA.build(jcfg, JRUN), build(cfg, device="cpu")
    batch = _batch(cfg, 2, 16, seed=6, frontend=True)
    out = {}
    for with_fe in (True, False):
        b = batch if with_fe else {"tokens": batch["tokens"]}
        wl, wc = jb.prefill(jp, {k: jnp.asarray(v) for k, v in b.items()},
                            cache_len=cache_len)
        gl, gc = pb.prefill(model, b, cache_len=cache_len)
        _close(gl, wl)
        for key in ("k", "v"):
            _close(gc[key], wc[key])
        tok = np.random.default_rng(7).integers(0, cfg.vocab, (2, 1))
        for _ in range(2):
            wl, wc = jb.decode(jp, jnp.asarray(tok), wc)
            gl, gc = pb.decode(model, tok, gc)
            _close(gl, wl)
        out[with_fe] = gl
    assert float((out[True] - out[False]).abs().max()) > 1e-3


def test_vlm_frontend_changes_output():
    """Mirror of ``tests/test_models.py``: zero and one frontends give
    different losses, as in JAX."""
    cfg = get_config("internvl2-26b").reduced()
    bundle = build(cfg, device="cpu")
    params = bundle.init(seed=0)
    toks = np.ones((1, 16), np.int32)
    losses = [float(bundle.loss(params, {
        "tokens": toks, "labels": toks,
        "frontend": np.full((1, cfg.n_frontend_tokens, cfg.d_model), v,
                            np.float32)})) for v in (0.0, 1.0)]
    assert abs(losses[0] - losses[1]) > 1e-6


def test_frontend_splice_refuses_a_short_sequence():
    cfg, _, jp = _lm("internvl2-26b")
    model = T.params_from_jax(jp, cfg, device="cpu")
    fe = torch.zeros((1, cfg.n_frontend_tokens, cfg.d_model))
    with pytest.raises(ValueError, match="frontend positions"):
        T._embed(model, cfg, torch.zeros((1, cfg.n_frontend_tokens - 1),
                                         dtype=torch.int64), fe)
    with pytest.raises(ValueError, match="frontend_embeds"):
        T._embed(model, cfg, torch.zeros((2, 16), dtype=torch.int64), fe)
    # A dense config has no frontend: the embeddings are ignored, as in JAX.
    dense = dataclasses.replace(cfg, family="dense", n_frontend_tokens=0,
                                frontend="")
    x = T._embed(model, dense, torch.zeros((1, 16), dtype=torch.int64), fe)
    assert torch.equal(x, model.embed[torch.zeros((1, 16), dtype=torch.int64)])


@pytest.mark.parametrize("arch", MOE_ARCHS + ["internvl2-26b"])
def test_n_active_params_matches_jax_at_full_size(arch):
    jb = JMA.build(jax_get_config(arch))
    pb = build(get_config(arch), device="cpu")
    assert pb.n_active_params() == jb.n_active_params()
    if arch != "internvl2-26b":
        assert pb.n_active_params() < pb.n_params()


@pytest.mark.parametrize("shape", sorted(LM_SHAPES))
@pytest.mark.parametrize("arch", MOE_ARCHS + ["internvl2-26b"])
def test_batch_struct_matches_jax(arch, shape):
    jb = JMA.build(jax_get_config(arch))
    pb = build(get_config(arch), device="cpu")
    from repro.configs import LM_SHAPES as JAX_LM_SHAPES
    want = jb.batch_struct(JAX_LM_SHAPES[shape])
    got = pb.batch_struct(LM_SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k][0] == tuple(w.shape), k
        assert str(got[k][1]).split(".")[-1] == w.dtype.name, k


def test_moe_router_stays_fp32_in_a_bf16_model():
    """``init_lm`` draws the router in fp32 whatever the parameter dtype,
    as JAX's ``init_moe`` does, and the experts in the parameter dtype."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    jb = JMA.build(jax_get_config("granite-moe-1b-a400m").reduced())
    jp = jax.eval_shape(jb.init, jax.random.PRNGKey(0))["blocks"]["moe"]
    moe = build(cfg, device="cpu").init(seed=1).blocks[0].moe
    assert moe["router"].dtype == torch.float32
    assert jp["router"].dtype == jnp.float32
    for k in ("w1", "w2", "w3"):
        assert moe[k].dtype == torch.bfloat16
        assert tuple(moe[k].shape) == jp[k].shape[1:]
