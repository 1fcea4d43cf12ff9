"""The port's SSM and hybrid LMs (falcon-mamba-7b, hymba-1.5b) and the
sliding-window attention against the JAX package's, on the CPU.

Parameters go through ``params_from_jax``; inputs are numpy draws.
Tolerances: at fp32, rtol/atol 2e-4 elementwise, the tolerance of JAX's
own chunked-vs-sequential scan test (``tests/test_layers.py:76-87``): the
port's scan is the sequential recurrence, JAX's associates the same
products in chunks.  At bf16, max |port - JAX| <= 2e-2 max |JAX| over the
tensor (the two frameworks round to bf16 at other points, as in
``tests/test_torch_lm.py``).  The windowed attention's plain version
against JAX's at rtol/atol 1e-5 (S <= 64, one product order apart) and
3e-4 at S = 4,096 (JAX's blocked path, its own test's bound).
"""
import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_get_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core.tiered import TieredEmbeddingStore as JaxStore
from repro.models import layers as JL
from repro.models import model_api as JMA
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.tiered import TieredEmbeddingStore
from repro_torch.kernels import ops, ref
from repro_torch.launch.serve_lm import STORE_KEYS, main, serve_lm_tiered
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model_api import build

ARCHS = ["falcon-mamba-7b", "hymba-1.5b"]
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
JRUN = JaxRunConfig()
# hymba's reduced config keeps the 1,024-token window; the model tests cut
# it to 4 so that a 12-token prompt is windowed and the cache ring wraps.
WINDOW = 4


def _cfgs(arch, dtype="float32", window=WINDOW):
    """(port cfg, JAX cfg): the reduced config in ``dtype``, a sliding
    window cut to ``window``."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    if cfg.attn_type == "sliding":
        kw["window"] = window
    return dataclasses.replace(cfg, **kw), dataclasses.replace(jcfg, **kw)


@lru_cache(maxsize=None)
def _both(arch, dtype="float32"):
    """(port cfg, JAX cfg, JAX params, the port's model on them)."""
    cfg, jcfg = _cfgs(arch, dtype)
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    model = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                              device="cpu")
    return cfg, jcfg, jp, model


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    """fp32: elementwise rtol/atol ``tol``; bf16 (2e-2): relative to the
    tensor's largest magnitude."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if tol != TOL["bfloat16"]:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        err, scale = np.abs(got - want).max(), np.abs(want).max()
        assert err <= tol * scale, f"max abs err {err} > {tol} * {scale}"


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


def _clone(cache):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in cache.items()}


# ---------------------------------------------------------------------------
# Configs, parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.inner, cfg.dtrank) == (jcfg.inner, jcfg.dtrank)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())


def test_widths_of_the_full_configs():
    falcon, hymba = get_config("falcon-mamba-7b"), get_config("hymba-1.5b")
    assert (falcon.inner, falcon.dtrank) == (8192, 256)
    assert (hymba.inner, hymba.dtrank) == (3200, 100)
    assert (hymba.attn_type, hymba.window) == ("sliding", 1024)


def _jax_leaves(tree):
    """{'blocks.3.ssm.in_proj': array, 'embed': array, ...}: the stacked L
    axis of ``blocks`` unrolled, named like the port's state_dict."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [str(p.key) for p in path]
        if names[0] == "blocks":
            for i in range(leaf.shape[0]):
                out[".".join([names[0], str(i)] + names[1:])] = (
                    jax.ShapeDtypeStruct(leaf.shape[1:], leaf.dtype)
                    if isinstance(leaf, jax.ShapeDtypeStruct)
                    else np.asarray(leaf)[i])
        else:
            out[".".join(names)] = leaf
    return out


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_maps_every_key(arch, dtype):
    _, _, jp, model = _both(arch, dtype)
    want = _jax_leaves(jp)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        t, a = got[name], np.asarray(a)
        assert str(t.dtype).split(".")[-1] == a.dtype.name, name
        assert np.array_equal(_np(t), a.astype(np.float32)), name


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_draws_the_jax_shapes_and_dtypes(arch):
    cfg, jcfg = _cfgs(arch, "bfloat16")
    want = _jax_leaves(jax.eval_shape(
        lambda: JT.init_lm(jax.random.PRNGKey(0), jcfg)))
    model = T.init_lm(cfg, seed=0, device="cpu")
    got = model.state_dict()
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == \
        {k: (tuple(v.shape), v.dtype.name) for k, v in want.items()}
    assert not any(p.requires_grad for p in model.parameters())
    again = T.init_lm(cfg, seed=0, device="cpu").state_dict()
    assert all(torch.equal(got[k], again[k]) for k in got)
    # The leaves JAX makes without a draw are JAX's values (A_log = log(1..N)
    # to the ulp: XLA's log and PyTorch's round log(7) apart).
    _, _, jp, _ = _both(arch, "bfloat16")
    jl = _jax_leaves(jp)
    for name in ("dt_bias", "D_skip", "conv_b"):
        key = f"blocks.1.ssm.{name}"
        assert np.array_equal(_np(got[key]), np.asarray(jl[key], np.float32))
    np.testing.assert_allclose(_np(got["blocks.1.ssm.A_log"]),
                               np.asarray(jl["blocks.1.ssm.A_log"]),
                               rtol=2 ** -23, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_n_params_matches_jax_at_full_size(arch):
    want = {"falcon-mamba-7b": 7_272_665_088, "hymba-1.5b": 1_662_161_600}
    got = build(get_config(arch), device="cpu").n_params()
    assert got == JMA.build(jax_get_config(arch)).n_params() == want[arch]
    assert build(get_config(arch), device="cpu").n_active_params() == got


@pytest.mark.parametrize("arch", ARCHS)
def test_n_params_counts_the_built_model(arch):
    cfg, _ = _cfgs(arch)
    model = build(cfg, device="cpu").init(seed=1)
    assert sum(p.numel() for p in model.parameters()) == \
        build(cfg, device="cpu").n_params()


# ---------------------------------------------------------------------------
# The mamba-1 block
# ---------------------------------------------------------------------------


def _layer(arch="falcon-mamba-7b", dtype="float32", i=0):
    """(cfg, jcfg, JAX layer params, the port's mamba params) of layer i."""
    cfg, jcfg, jp, model = _both(arch, dtype)
    lp = jax.tree_util.tree_map(lambda a: a[i], jp["blocks"])
    return cfg, jcfg, lp, model.blocks[i]


def _scan_cfgs(chunk=16, dtype="float32"):
    """JAX's own scan-test config (``tests/test_layers.py:77-80``) in both
    packages, in ``dtype``."""
    kw = dict(name="t", family="ssm", n_layers=1, d_model=32, vocab=64,
              ssm_state=8, d_inner=64, dt_rank=4, ssm_chunk=chunk,
              param_dtype=dtype, compute_dtype=dtype)
    return ModelConfig(**kw), JaxModelConfig(**kw)


@lru_cache(maxsize=None)
def _scan_params(chunk=16, dtype="float32"):
    cfg, jcfg = _scan_cfgs(chunk, dtype)
    jp = JL.init_mamba(jax.random.PRNGKey(0), jcfg)
    p = {k: torch.from_numpy(np.array(v, np.float32)).to(
        getattr(torch, v.dtype.name)) for k, v in jp.items()}
    return cfg, jcfg, jp, p


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_causal_conv_matches_jax(dtype):
    cfg, _, lp, blk = _layer(dtype=dtype)
    jdt = jnp.dtype(dtype)
    x = _normal((2, 9, cfg.inner), 1)
    got = L._causal_conv(torch.from_numpy(x).to(getattr(torch, dtype)),
                         blk.ssm["conv_w"], blk.ssm["conv_b"])
    want = JL._causal_conv(jnp.asarray(x, jdt), lp["ssm"]["conv_w"],
                           lp["ssm"]["conv_b"])
    assert str(got.dtype).split(".")[-1] == want.dtype.name
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_ssm_params_match_jax(dtype):
    cfg, jcfg, lp, blk = _layer(dtype=dtype)
    xc = _normal((2, 7, cfg.inner), 2)
    got = L._ssm_params(blk.ssm, cfg,
                        torch.from_numpy(xc).to(getattr(torch, dtype)))
    want = JL._ssm_params(lp["ssm"], jcfg, jnp.asarray(xc, jnp.dtype(dtype)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        _close(g, w, TOL[dtype])


@pytest.mark.parametrize("with_h0", [False, True])
def test_selective_scan_matches_jax_on_a_ragged_sequence(with_h0):
    """S = 50 with chunks of 16: JAX pads two steps with identities; the
    port runs 50 steps; y and the last state agree."""
    cfg, jcfg, jp, p = _scan_params()
    xc, z = _normal((2, 50, 64), 3), _normal((2, 50, 64), 4)
    h0 = _normal((2, 64, 8), 5) if with_h0 else None
    y, h = L.selective_scan(p, cfg, torch.from_numpy(xc),
                            torch.from_numpy(z),
                            None if h0 is None else torch.from_numpy(h0))
    wy, wh = JL.selective_scan(jp, jcfg, jnp.asarray(xc), jnp.asarray(z),
                               None if h0 is None else jnp.asarray(h0))
    assert y.dtype == torch.float32 and h.shape == (2, 64, 8)
    _close(y, wy, TOL["float32"])
    _close(h, wh, TOL["float32"])


def test_selective_scan_at_bf16_matches_jax():
    cfg, jcfg, jp, p = _scan_params(dtype="bfloat16")
    xc, z = _normal((2, 40, 64), 6), _normal((2, 40, 64), 7)
    y, h = L.selective_scan(p, cfg, torch.from_numpy(xc).bfloat16(),
                            torch.from_numpy(z).bfloat16())
    wy, wh = JL.selective_scan(jp, jcfg, jnp.asarray(xc, jnp.bfloat16),
                               jnp.asarray(z, jnp.bfloat16))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    _close(y, wy, TOL["bfloat16"])
    _close(h, wh, TOL["bfloat16"])


@pytest.mark.parametrize("s", [1, 17, 50])
def test_selective_scan_ref_matches_jax(s):
    """The kernel's plain version from JAX's own dt, Bm, Cm and A, with an
    initial state, against JAX's chunked scan."""
    cfg, jcfg, jp, _ = _scan_params()
    xc, z, h0 = (_normal((2, s, 64), 8), _normal((2, s, 64), 9),
                 _normal((2, 64, 8), 10))
    dt, bm, cm = (torch.from_numpy(np.array(a)) for a in JL._ssm_params(
        jp, jcfg, jnp.asarray(xc)))
    a = torch.from_numpy(-np.exp(np.asarray(jp["A_log"])))
    y, h = ref.selective_scan_ref(torch.from_numpy(xc), torch.from_numpy(z),
                                  dt, a, bm, cm,
                                  torch.from_numpy(np.array(jp["D_skip"])),
                                  torch.from_numpy(h0))
    wy, wh = JL.selective_scan(jp, jcfg, jnp.asarray(xc), jnp.asarray(z),
                               jnp.asarray(h0))
    _close(y, wy, TOL["float32"])
    _close(h, wh, TOL["float32"])


def test_selective_scan_ref_matches_jax_where_the_state_decays_away():
    """dt up to ~20 (dt_bias up to 20) from a large h0: exp(dt A) reaches
    2^-126 and below, so a state keeps only its new input; the kernel's
    plain version and JAX's chunked scan agree there too."""
    cfg, jcfg, jp, _ = _scan_params()
    jp = dict(jp, dt_bias=jnp.linspace(0.0, 20.0, 64, dtype=jnp.float32))
    xc, z = _normal((2, 37, 64), 12), _normal((2, 37, 64), 13)
    h0 = 100.0 * _normal((2, 64, 8), 14)
    dt, bm, cm = (torch.from_numpy(np.array(a)) for a in JL._ssm_params(
        jp, jcfg, jnp.asarray(xc)))
    a = torch.from_numpy(-np.exp(np.asarray(jp["A_log"])))
    assert float(dt.max()) > 19.0
    assert float((dt[..., None] * a).min()) < -126.0 / np.log2(np.e)
    y, h = ref.selective_scan_ref(torch.from_numpy(xc), torch.from_numpy(z),
                                  dt, a, bm, cm,
                                  torch.from_numpy(np.array(jp["D_skip"])),
                                  torch.from_numpy(h0))
    wy, wh = JL.selective_scan(jp, jcfg, jnp.asarray(xc), jnp.asarray(z),
                               jnp.asarray(h0))
    _close(y, wy, TOL["float32"])
    _close(h, wh, TOL["float32"])


def test_selective_scan_dt_zero_keeps_the_state_exactly():
    _, _, _, p = _scan_params()
    rng = np.random.default_rng(11)
    xc, z = (torch.from_numpy(rng.normal(size=(2, 9, 64)).astype(np.float32))
             for _ in range(2))
    bm, cm = (torch.from_numpy(rng.normal(size=(2, 9, 8)).astype(np.float32))
              for _ in range(2))
    h0 = torch.from_numpy(rng.normal(size=(2, 64, 8)).astype(np.float32))
    _, h = ops.selective_scan(xc, z, torch.zeros((2, 9, 64)),
                              -torch.exp(p["A_log"]), bm, cm, p["D_skip"],
                              h0)
    assert torch.equal(h, h0)


@pytest.mark.parametrize("s", [12, 2, 3])
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_mamba_block_matches_jax(dtype, s):
    """S = 2 < W - 1 = 3 left-pads the conv tail; S = 3 fills it."""
    cfg, jcfg, lp, blk = _layer(dtype=dtype)
    x = _normal((2, s, cfg.d_model), 12)
    out, (tail, h) = L.mamba_block(
        blk.ssm, cfg, torch.from_numpy(x).to(getattr(torch, dtype)))
    wout, (wtail, wh) = JL.mamba_block(lp["ssm"], jcfg,
                                       jnp.asarray(x, jnp.dtype(dtype)))
    assert tail.shape == (2, cfg.conv_width - 1, cfg.inner)
    for g, w in ((out, wout), (tail, wtail), (h, wh)):
        _close(g, w, TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_mamba_decode_block_matches_jax(dtype):
    cfg, jcfg, lp, blk = _layer("hymba-1.5b", dtype)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    x = _normal((2, 1, cfg.d_model), 13)
    conv = _normal((2, cfg.conv_width - 1, cfg.inner), 14)
    h = _normal((2, cfg.inner, cfg.ssm_state), 15)
    got = L.mamba_decode_block(blk.ssm, cfg, torch.from_numpy(x).to(tdt),
                               torch.from_numpy(conv).to(tdt),
                               torch.from_numpy(h))
    want = JL.mamba_decode_block(lp["ssm"], jcfg, jnp.asarray(x, jdt),
                                 jnp.asarray(conv, jdt), jnp.asarray(h))
    for g, w in zip(got, want):
        _close(g, w, TOL[dtype])


def test_mamba_decode_steps_equal_the_full_block():
    """JAX's ``test_mamba_decode_matches_full`` on the port: stepping one
    token at a time from zero states gives the block's outputs and last
    state (rtol/atol 3e-4, JAX's bound)."""
    cfg, _, _, p = _scan_params(chunk=8)
    x = torch.from_numpy(_normal((2, 12, 32), 16))
    full, (tail, h) = L.mamba_block(p, cfg, x)
    conv = torch.zeros((2, cfg.conv_width - 1, 64))
    hs = torch.zeros((2, 64, 8))
    outs = []
    for t in range(12):
        o, conv, hs = L.mamba_decode_block(p, cfg, x[:, t:t + 1], conv, hs)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, dim=1), full, rtol=3e-4,
                               atol=3e-4)
    torch.testing.assert_close(hs, h, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(conv, tail, rtol=3e-4, atol=3e-4)


# ---------------------------------------------------------------------------
# The sliding window
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [1, 5, 16, 64])
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_windowed_attention_ref_matches_plain_attention(dtype, window):
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    q, k, v = (_normal(s, 20 + i) for i, s in enumerate(
        [(2, 40, 6, 16), (2, 40, 2, 16), (2, 40, 2, 16)]))
    want = JL.plain_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                              causal=True, window=window)
    got = ref.causal_attention_ref(*(torch.from_numpy(a).to(tdt)
                                     for a in (q, k, v)), window=window)
    _close(got, want, 1e-5 if dtype == "float32" else TOL[dtype])
    # The layer's entry point is the same function on the CPU.
    _close(L.blocked_causal_attention(*(torch.from_numpy(a).to(tdt)
                                        for a in (q, k, v)), window),
           want, 1e-5 if dtype == "float32" else TOL[dtype])


def test_windowed_attention_matches_jax_blocked_at_long_s():
    """JAX's ``test_sliding_window_attention`` (S = 4,096, W = 256, its
    blocked path) against the port's plain version."""
    s, w = 4096, 256
    q, k, v = (_normal((1, s, 2, 32), 30 + i) for i in range(3))
    want = JL.blocked_causal_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                       window=w, bq=512, bk=512)
    got = ref.causal_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                   window=w)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=3e-4,
                               atol=3e-4)


def test_window_at_or_above_s_is_causal():
    q, k, v = (torch.from_numpy(_normal((1, 30, 4, 16), 40 + i)[
        :, :, :(4 if i == 0 else 2)]) for i in range(3))
    causal = ref.causal_attention_ref(q, k, v)
    for w in (30, 31, 10 ** 9):
        assert torch.equal(ref.causal_attention_ref(q, k, v, window=w),
                           causal)


def test_sliding_attn_block_matches_jax():
    cfg, jcfg, lp, blk = _layer("hymba-1.5b")
    x = _normal((2, 12, cfg.d_model), 41)
    pos = np.arange(12)[None, :]
    want, (wk, wv) = JL.attn_block(lp["attn"], jcfg, JRUN, jnp.asarray(x),
                                   jnp.asarray(pos))
    got, (k, v) = L.attn_block(blk.attn, cfg, torch.from_numpy(x),
                               torch.from_numpy(pos))
    for a, b in ((got, want), (k, wk), (v, wv)):
        _close(a, b, 1e-5)
    full = dataclasses.replace(cfg, attn_type="full")
    assert not torch.allclose(L.attn_block(blk.attn, full,
                                           torch.from_numpy(x),
                                           torch.from_numpy(pos))[0], got)


# ---------------------------------------------------------------------------
# The model: prefill and decode
# ---------------------------------------------------------------------------


def _close_state(got, want, tol):
    """The fp32 SSM state: elementwise at fp32; at bf16 (its inputs are
    bf16) normwise, ||got - want|| <= tol ||want||.  JAX's jitted layer
    fuses its bf16 chains (the x_proj product and its cast, the conv, the
    silu) and skips roundings that an op-by-op evaluation makes; a state
    element summing terms of both signs then moves by several percent of
    the largest one (4.4% at one element of the reduced falcon), while the
    state as a whole agrees within 1%.  Against JAX run op by op the port
    agrees to 1e-5 (:func:`test_bf16_ssm_matches_jax_run_op_by_op`)."""
    if tol != TOL["bfloat16"]:
        _close(got, want, tol)
        return
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err, scale = np.linalg.norm(got - want), np.linalg.norm(want)
    assert err <= tol * scale, f"normwise err {err} > {tol} * {scale}"


@pytest.mark.parametrize("cache_len", [None, 16, 8],
                         ids=["at_S", "above_S", "below_S"])
@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype, cache_len):
    """S = 12 prompt, then three decode steps, against
    ``repro.models.model_api.build``: hymba's window of 4 caps the key
    cache at 4 slots and the decode wraps that ring; every state (keys,
    values, conv tails, SSM states) and the logits agree (the SSM state
    at bf16 normwise: :func:`_close_state`)."""
    cfg, jcfg, jp, model = _both(arch, dtype)
    jb = JMA.build(jcfg)
    pb = build(cfg, device="cpu")
    tol = TOL[dtype]
    prompt = _tokens(cfg, (2, 12), 7)
    wl, wc = jb.prefill(jp, {"tokens": jnp.asarray(prompt)},
                        cache_len=cache_len)
    gl, gc = pb.prefill(model, {"tokens": prompt}, cache_len=cache_len)
    assert gl.dtype == torch.float32 and gl.shape == (2, cfg.vocab)
    assert gc["pos"] == int(wc["pos"]) == 12
    keys = sorted(k for k in wc if k != "pos")
    assert sorted(k for k in gc if k != "pos") == keys
    if cfg.family == "hybrid":
        assert gc["k"].shape[2] == WINDOW
    for key in keys:
        assert tuple(gc[key].shape) == wc[key].shape
        assert str(gc[key].dtype).split(".")[-1] == wc[key].dtype.name
        (_close_state if key == "h" else _close)(gc[key], wc[key], tol)
    _close(gl, wl, tol)
    for tok in _tokens(cfg, (3, 2, 1), 8):
        wl, wc = jb.decode(jp, jnp.asarray(tok), wc)
        gl, gc = pb.decode(model, tok, gc)
        assert gc["pos"] == int(wc["pos"])
        _close(gl, wl, tol)
        for key in keys:
            (_close_state if key == "h" else _close)(gc[key], wc[key], tol)


def test_bf16_ssm_matches_jax_run_op_by_op():
    """The reduced bf16 falcon-mamba against JAX with jit disabled, each
    operation rounding to bf16 as the port's do: prefill and three decode
    steps agree to 1e-5 of the largest magnitude (logits, SSM states) and
    the bf16 conv tails to one bf16 ulp of it, 2^-8."""
    cfg, jcfg, jp, model = _both("falcon-mamba-7b", "bfloat16")
    prompt = _tokens(cfg, (2, 12), 7)
    pb = build(cfg, device="cpu")

    def check(gl, gc, wl, wc):
        for got, want, tol in ((gl, wl, 1e-5), (gc["h"], wc["h"], 1e-5),
                               (gc["conv"], wc["conv"], 2 ** -8)):
            got, want = _np(got), _np(want)
            assert np.abs(got - want).max() <= tol * np.abs(want).max()

    with jax.disable_jit():
        jb = JMA.build(jcfg)
        wl, wc = jb.prefill(jp, {"tokens": jnp.asarray(prompt)})
        gl, gc = pb.prefill(model, {"tokens": prompt})
        check(gl, gc, wl, wc)
        for tok in _tokens(cfg, (3, 2, 1), 8):
            wl, wc = jb.decode(jp, jnp.asarray(tok), wc)
            gl, gc = pb.decode(model, tok, gc)
            check(gl, gc, wl, wc)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_embeds_on_cast_store_rows_is_decode_step_at_bf16(arch):
    cfg, jcfg, jp, model = _both(arch, "bfloat16")
    prompt = _tokens(cfg, (2, 6), 9)
    _, cache = T.prefill(model, cfg, torch.from_numpy(prompt), 10)
    store = TieredEmbeddingStore(model.embed.float().numpy(), 16,
                                 device="cpu")
    tok = _tokens(cfg, (2,), 10)
    rows = store.lookup(tok).to(torch.bfloat16)[:, None, :]
    got, gc = T.decode_step_embeds(model, cfg, rows, _clone(cache))
    want, wc = T.decode_step(model, cfg, torch.from_numpy(tok)[:, None],
                             _clone(cache))
    assert torch.equal(got, want)
    assert all(torch.equal(gc[k], wc[k]) for k in gc if k != "pos")
    _, jc = JMA.build(jcfg).prefill(jp, {"tokens": jnp.asarray(prompt)},
                                    cache_len=10)
    jl, _ = JT.decode_step(jp, jcfg, JRUN, jnp.asarray(tok)[:, None], jc)
    _close(got, jl, TOL["bfloat16"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_writes_every_state_in_place(arch):
    cfg, _, _, model = _both(arch)
    _, cache = T.prefill(model, cfg, torch.from_numpy(_tokens(cfg, (2, 6),
                                                              17)), 10)
    before = _clone(cache)
    _, after = T.decode_step(model, cfg, torch.from_numpy(
        _tokens(cfg, (2, 1), 18)), cache)
    for k in ("conv", "h"):
        assert after[k] is cache[k]
        assert not torch.equal(after[k], before[k])
    assert after["pos"] == before["pos"] + 1


# ---------------------------------------------------------------------------
# Tiered LM serving
# ---------------------------------------------------------------------------


def _jax_serve(jcfg, jp, prompt, forced, cap):
    """The loop of ``examples/serve_lm_tiered.py``, teacher-forced."""
    store = JaxStore(np.asarray(jp["embed"], np.float32), cap, policy="lru")
    _, cache = JMA.build(jcfg, JRUN).prefill(
        jp, {"tokens": jnp.asarray(prompt)},
        cache_len=prompt.shape[1] + len(forced))
    step = jax.jit(lambda p, x, c: JT.decode_step_embeds(p, jcfg, JRUN, x, c))
    tok, logits = prompt[:, -1:], []
    for f in forced:
        rows = store.lookup(np.asarray(tok[:, 0]))
        lg, cache = step(jp, jnp.asarray(rows)[:, None, :], cache)
        logits.append(np.asarray(lg))
        tok = f[:, None]
    return store.stats, np.stack(logits)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_tiered_serve_matches_jax(arch):
    cfg, jcfg, jp, model = _both(arch)
    prompt = _tokens(cfg, (4, 8), 13)
    forced = np.random.default_rng(14).zipf(1.3, (16, 4)) % cfg.vocab
    jstats, jlogits = _jax_serve(jcfg, jp, prompt, forced, 25)
    res = serve_lm_tiered(cfg, capacity_frac=0.05, device="cpu",
                          model=model, prompt=prompt, forced=forced,
                          steps=len(forced), collect_logits=True)
    assert res["capacity"] == 25
    assert {k: res[k] for k in STORE_KEYS} == \
        {k: getattr(jstats, k) for k in STORE_KEYS}
    assert 0 < res["hits"] < res["lookups"] and res["evictions"] > 0
    _close(res["logits"], jlogits, TOL["float32"])
    assert np.array_equal(res["tokens"], jlogits.argmax(-1))
    assert res["launches"] == {"flash_attention": 0, "selective_scan": 0,
                               "gather_rows_expand": 0}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_cli_serves_the_ssm_and_hybrid_on_the_cpu(arch, capsys):
    res = main(["--device", "cpu", "--reduced", "--arch", arch,
                "--steps", "6"])
    out = capsys.readouterr().out
    cfg = get_config(arch).reduced()
    assert f"{arch}: vocab {cfg.vocab} rows on host tier" in out
    assert "decoded 6 steps x 8 streams" in out
    assert res["lookups"] == 48 and res["tokens"].shape == (6, 8)
    assert np.isfinite(res["prefill_ms"])
