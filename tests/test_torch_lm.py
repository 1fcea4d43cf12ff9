"""The port's dense LM against the JAX package's, on JAX's parameters.

``params_from_jax(init_lm(PRNGKey(0), cfg))`` gives both packages the same
weights; tokens and activations are numpy draws.  Tolerances: at fp32 (the
``reduced()`` configs) rtol/atol 1e-5 elementwise, the sums running in
another order.  At a bf16 copy of each reduced config, max |port - JAX| <=
2e-2 max |JAX| over the tensor: the two frameworks round to bf16 at other
points (JAX's attention rounds p to bf16 before the p v product, the
port's keeps p in fp32; a product's bf16 output can round the other way),
so keys and logits of magnitude ~4 differ by one or two bf16 ulps
(0.016-0.03), and rope's rotation can leave such a difference on an
element near zero, which an elementwise relative bound would refuse.
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
from repro.core.tiered import TieredEmbeddingStore as JaxStore
from repro.models import layers as JL
from repro.models import model_api as JMA
from repro.models import transformer as JT
from repro.models.dlrm import dlrm_forward as jax_dlrm_forward
from repro.models.dlrm import init_dlrm as jax_init_dlrm
from repro_torch.configs import LM_SHAPES, RunConfig, get_config
from repro_torch.core.tiered import TieredEmbeddingStore
from repro_torch.kernels import ref
from repro_torch.launch.serve_lm import STORE_KEYS, main, serve_lm_tiered
from repro_torch.models import dlrm as D
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model_api import build

ARCHS = ["smollm-135m", "smollm-360m", "qwen2.5-3b", "qwen3-14b",
         "granite-moe-1b-a400m", "grok-1-314b", "internvl2-26b",
         "whisper-large-v3"]
# The decoder-only LMs of ARCHS (whisper's decoder reads an encoder).
DECODER_ARCHS = [a for a in ARCHS if a != "whisper-large-v3"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JRUN = JaxRunConfig()


def _cfgs(arch, dtype="float32"):
    """(port cfg, JAX cfg): the reduced config in ``dtype``."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(get_config(arch).reduced(), **kw),
            dataclasses.replace(jax_get_config(arch).reduced(), **kw))


@lru_cache(maxsize=None)
def _both(arch, dtype="float32"):
    """(port cfg, JAX cfg, JAX params, the port's model on them)."""
    cfg, jcfg = _cfgs(arch, dtype)
    jp = JMA.build(jcfg).init(jax.random.PRNGKey(0))
    model = (ED if cfg.enc_dec else T).params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    return cfg, jcfg, jp, model


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    """fp32 (tol 1e-5): elementwise; bf16 (tol 2e-2): relative to the
    tensor's largest magnitude (see the module docstring)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if tol == TOL["float32"]:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        err, scale = np.abs(got - want).max(), np.abs(want).max()
        assert err <= tol * scale, f"max abs err {err} > {tol} * {scale}"


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


def _with_frontend(cfg, batch, seed):
    """``batch`` plus the encoder-decoder LM's audio frames (B, enc_len,
    d_model), fp32 (both encoders cast them to the compute dtype)."""
    if cfg.frontend != "audio":
        return batch
    b = batch["tokens"].shape[0]
    return {**batch,
            "frontend": _normal((b, cfg.enc_len, cfg.d_model), seed)}


def _clone(cache):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in cache.items()}


# ---------------------------------------------------------------------------
# Configs, registry, parameters
# ---------------------------------------------------------------------------


def test_configs_match_jax():
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_get_config(arch))
    assert {k: dataclasses.asdict(v) for k, v in LM_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_LM_SHAPES.items()}


def test_unknown_arch_is_a_key_error():
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def _jax_leaves(tree):
    """{'blocks.3.attn.wq': array, 'embed': array, ...} with the stacked L
    axis of ``blocks`` (``enc_blocks`` and ``dec_blocks``) unrolled, named
    like the port's state_dict."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [str(p.key) for p in path]
        if names[0] in ("blocks", "enc_blocks", "dec_blocks"):
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
def test_port_init_draws_the_jax_shapes(arch):
    cfg, jcfg = _cfgs(arch)
    want = _jax_leaves(jax.eval_shape(
        lambda: JMA.build(jcfg).init(jax.random.PRNGKey(0))))
    model = build(cfg, device="cpu").init(seed=0)
    got = model.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in got.values())
    assert not any(p.requires_grad for p in model.parameters())
    # Port init is seeded: same seed, same numbers.
    again = build(cfg, device="cpu").init(seed=0).state_dict()
    assert all(torch.equal(got[k], again[k]) for k in got)


@pytest.mark.parametrize("arch", ARCHS + ["dlrm-recmg"])
def test_n_params_matches_jax_at_full_size(arch):
    assert build(get_config(arch), device="cpu").n_params() == \
        JMA.build(jax_get_config(arch)).n_params()


def test_n_params_counts_the_built_model():
    for arch in ARCHS:
        cfg, _ = _cfgs(arch)
        model = build(cfg, device="cpu").init(seed=1)
        assert sum(p.numel() for p in model.parameters()) == \
            build(cfg, device="cpu").n_params()


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("theta", [1e6, 1e4])
def test_rms_norm_and_rope_match_jax(theta):
    x = _normal((2, 7, 4, 16), 0)
    w = _normal((16,), 1)
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5), 1e-5)
    pos = np.arange(3, 10)[None, :]
    _close(L.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), theta), 1e-5)


def test_rope_is_half_split():
    """Dims d and d + hd/2 rotate together (not interleaved pairs)."""
    x = torch.zeros((1, 1, 1, 8))
    x[..., 0] = 1.0
    out = L.rope(x, torch.tensor([[1]]), 10000.0)[0, 0, 0]
    assert out[0] == pytest.approx(np.cos(1.0), abs=1e-6)
    assert out[4] == pytest.approx(np.sin(1.0), abs=1e-6)
    assert out[1] == 0 and out[5] == 0


def _layer_params(arch, i=0):
    """(cfg, jcfg, JAX layer params, port block) of layer ``i``."""
    cfg, jcfg, jp, model = _both(arch)
    lp = jax.tree_util.tree_map(lambda a: a[i], jp["blocks"])
    return cfg, jcfg, lp, model.blocks[i]


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2.5-3b", "qwen3-14b"])
def test_attn_block_matches_jax(arch):
    cfg, jcfg, lp, blk = _layer_params(arch)
    x = _normal((2, 12, cfg.d_model), 2)
    pos = np.arange(12)[None, :]
    want, (wk, wv) = JL.attn_block(lp["attn"], jcfg, JRUN, jnp.asarray(x),
                                   jnp.asarray(pos))
    got, (k, v) = L.attn_block(blk.attn, cfg, torch.from_numpy(x),
                               torch.from_numpy(pos))
    for a, b in ((got, want), (k, wk), (v, wv)):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("pos", [3, 8, 11])
@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2.5-3b", "qwen3-14b"])
def test_attn_decode_block_matches_jax(arch, pos):
    """Cache of 8 slots: pos 3 writes slot 3, pos 8 and 11 wrap the ring
    (slot = pos % 8) and see all 8 slots."""
    cfg, jcfg, lp, blk = _layer_params(arch)
    x = _normal((2, 1, cfg.d_model), 3)
    kc = _normal((2, 8, cfg.kv_heads, cfg.hd), 4)
    vc = _normal((2, 8, cfg.kv_heads, cfg.hd), 5)
    want, wk, wv = JL.attn_decode_block(lp["attn"], jcfg, jnp.asarray(x),
                                        jnp.asarray(kc), jnp.asarray(vc),
                                        jnp.asarray(pos, jnp.int32))
    got, k, v = L.attn_decode_block(blk.attn, cfg, torch.from_numpy(x),
                                    torch.from_numpy(kc),
                                    torch.from_numpy(vc), pos)
    for a, b in ((got, want), (k, wk), (v, wv)):
        _close(a, b, 1e-5)


def test_mlp_block_matches_jax():
    cfg, _, lp, blk = _layer_params("smollm-135m")
    x = _normal((2, 5, cfg.d_model), 6)
    _close(L.mlp_block(blk.mlp, torch.from_numpy(x)),
           JL.mlp_block(lp["mlp"], jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_plain_and_decode_attention_match_jax(dtype):
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    q, k, v = (_normal(s, i) for i, s in enumerate(
        [(2, 9, 4, 16), (2, 9, 2, 16), (2, 9, 2, 16)]))
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    # The port's plain causal attention is the kernel's plain version.
    _close(ref.causal_attention_ref(tq, tk, tv),
           JL.plain_attention(jq, jk, jv, causal=True), TOL[dtype])
    for pos in (4, 9, 30):
        _close(L.decode_attention(tq[:, :1], tk, tv, pos),
               JL.decode_attention(jq[:, :1], jk, jv,
                                   jnp.asarray(pos, jnp.int32)), TOL[dtype])


# ---------------------------------------------------------------------------
# The model: prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cache_len", [None, 16, 8],
                         ids=["at_S", "above_S", "below_S"])
@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype, cache_len):
    """S=12 prompt, cache of 12, 16 or 8 slots (below S the cache keeps
    the last 8 keys rotated, and decode wraps the ring), then three decode
    steps, against ``repro.models.model_api.build``; whisper's batch adds
    its audio frames, and its cache keeps S slots below S, as JAX's does."""
    cfg, jcfg, jp, model = _both(arch, dtype)
    jb = JMA.build(jcfg)
    pb = build(cfg, device="cpu")
    tol = TOL[dtype]
    batch = _with_frontend(cfg, {"tokens": _tokens(cfg, (2, 12), 7)}, 17)
    wl, wc = jb.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                        cache_len=cache_len)
    gl, gc = pb.prefill(model, batch, cache_len=cache_len)
    assert gl.dtype == torch.float32 and gl.shape == (2, cfg.vocab)
    assert gc["pos"] == int(wc["pos"]) == 12
    assert gc["k"].shape == wc["k"].shape
    keys = [k for k in ("k", "v", "xk", "xv") if k in wc]
    for key in keys:
        _close(gc[key], wc[key], tol)
    _close(gl, wl, tol)
    steps = _tokens(cfg, (3, 2, 1), 8)
    for tok in steps:
        wl, wc = jb.decode(jp, jnp.asarray(tok), wc)
        gl, gc = pb.decode(model, tok, gc)
        assert gc["pos"] == int(wc["pos"])
        _close(gl, wl, tol)
        for key in keys:
            _close(gc[key], wc[key], tol)


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_decode_step_embeds_on_cast_store_rows_is_decode_step_at_bf16(arch):
    """At bf16 the store's fp32 host copy of ``embed`` holds bf16 values,
    so its rows cast back to bf16 are the token's embedding: the step
    equals ``decode_step`` bit for bit, and matches JAX's token path."""
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
    assert all(torch.equal(gc[k], wc[k]) for k in ("k", "v"))
    _, jc = JMA.build(jcfg).prefill(jp, {"tokens": jnp.asarray(prompt)},
                                    cache_len=10)
    jl, _ = JT.decode_step(jp, jcfg, JRUN, jnp.asarray(tok)[:, None], jc)
    _close(got, jl, TOL["bfloat16"])
    with pytest.raises(TypeError, match="compute dtype"):
        T.decode_step_embeds(model, cfg, rows.float(), _clone(cache))


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2.5-3b"])
def test_decode_step_embeds_matches_jax_at_fp32(arch):
    cfg, jcfg, jp, model = _both(arch)
    prompt = _tokens(cfg, (2, 6), 11)
    _, cache = T.prefill(model, cfg, torch.from_numpy(prompt), 9)
    _, jc = JMA.build(jcfg).prefill(jp, {"tokens": jnp.asarray(prompt)},
                                    cache_len=9)
    for step in range(3):
        x = _normal((2, 1, cfg.d_model), 12 + step)
        got, cache = T.decode_step_embeds(model, cfg, torch.from_numpy(x),
                                          cache)
        want, jc = JT.decode_step_embeds(jp, jcfg, JRUN, jnp.asarray(x), jc)
        _close(got, want, 1e-5)
        _close(cache["k"], jc["k"], 1e-5)


# ---------------------------------------------------------------------------
# Tiered LM serving
# ---------------------------------------------------------------------------


def _jax_serve(jcfg, jp, prompt, forced, cap):
    """The loop of ``examples/serve_lm_tiered.py``, teacher-forced."""
    store = JaxStore(np.asarray(jp["embed"], np.float32), cap, policy="lru")
    run = JaxRunConfig(attn_block_q=32, attn_block_kv=32)
    _, cache = JMA.build(jcfg, run).prefill(
        jp, {"tokens": jnp.asarray(prompt)},
        cache_len=prompt.shape[1] + len(forced))
    step = jax.jit(lambda p, x, c: JT.decode_step_embeds(p, jcfg, run, x, c))
    tok, logits = prompt[:, -1:], []
    for f in forced:
        rows = store.lookup(np.asarray(tok[:, 0]))
        lg, cache = step(jp, jnp.asarray(rows)[:, None, :], cache)
        logits.append(np.asarray(lg))
        tok = f[:, None]
    return store.stats, np.stack(logits)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2.5-3b",
                                  "granite-moe-1b-a400m"])
def test_teacher_forced_tiered_serve_matches_jax(arch):
    cfg, jcfg, jp, model = _both(arch)
    prompt = _tokens(cfg, (4, 8), 13)
    # A skewed token stream, so the 25-row buffer both hits and evicts.
    forced = np.random.default_rng(14).zipf(1.3, (16, 4)) % cfg.vocab
    jstats, jlogits = _jax_serve(jcfg, jp, prompt, forced, 25)
    res = serve_lm_tiered(cfg, capacity_frac=0.05, device="cpu",
                          model=model, prompt=prompt, forced=forced,
                          steps=len(forced), collect_logits=True)
    assert res["capacity"] == 25
    assert {k: res[k] for k in STORE_KEYS} == \
        {k: getattr(jstats, k) for k in STORE_KEYS}
    assert 0 < res["hits"] < res["lookups"] and res["evictions"] > 0
    _close(res["logits"], jlogits, 1e-5)
    assert np.array_equal(res["tokens"], jlogits.argmax(-1))


def test_serve_lm_cli_on_the_cpu(capsys):
    res = main(["--device", "cpu", "--reduced", "--steps", "8"])
    out = capsys.readouterr().out
    assert "smollm-135m: vocab 512 rows on host tier, 51-row device buffer" \
        in out
    assert "decoded 8 steps x 8 streams" in out
    assert "vocab-buffer hit rate" in out
    assert res["lookups"] == 64 and res["hits"] + res["misses"] == 64
    assert res["tokens"].shape == (8, 8)
    assert res["launches"] == {"flash_attention": 0, "selective_scan": 0,
                               "gather_rows_expand": 0}


# ---------------------------------------------------------------------------
# model_api
# ---------------------------------------------------------------------------


def test_build_dlrm_prefill_is_the_forward():
    cfg = get_config("dlrm-recmg").reduced()
    jp = jax_init_dlrm(jax.random.PRNGKey(0),
                       jax_get_config("dlrm-recmg").reduced())
    params = D.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    rng = np.random.default_rng(15)
    dense = rng.normal(size=(4, cfg.dense_features)).astype(np.float32)
    sparse = rng.integers(0, cfg.rows_per_table,
                          (4, cfg.n_tables, cfg.multi_hot)).astype(np.int32)
    bundle = build(cfg, device="cpu")
    got = bundle.prefill(params, {"dense": dense, "sparse": sparse})
    assert bundle.decode is None
    _close(got, jax_dlrm_forward(jp, jax_get_config("dlrm-recmg").reduced(),
                                 jnp.asarray(dense), jnp.asarray(sparse)),
           1e-5)


def test_build_refuses_unported_families_and_losses():
    """Every family builds; the LM and DLRM losses are ported
    (``tests/test_torch_train.py``), but not the XLA remat policy their
    ``RunConfig`` could ask for."""
    cfg, _ = _cfgs("smollm-135m")
    assert callable(build(cfg, device="cpu").loss)
    whisper = build(get_config("whisper-large-v3"), device="cpu")
    assert all(callable(f) for f in (whisper.loss, whisper.prefill,
                                     whisper.decode))
    with pytest.raises(NotImplementedError, match="XLA"):
        build(cfg, device="cpu", run=RunConfig(remat="dots"))
