"""Training the port's SSM and hybrid LMs (falcon-mamba-7b, hymba-1.5b)
against the JAX package's, on the CPU: the selective scan's backward, the
sliding-window attention's backward, ``lm_loss``'s gradients, the bundle's
loss and the launcher.

Parameters go through ``params_from_jax``; inputs are numpy draws handed
to both packages.  Tolerances start from the forward's (2e-4 of each
tensor's largest magnitude, ``tests/test_torch_ssm.py``): every fp32
gradient within 2e-4 x max |JAX gradient| of its tensor (the port's scan
is the sequential recurrence and its backward the reverse one, JAX's
gradient goes through its chunked associative scan); with bf16 x and z,
2e-2 of the largest magnitude (bf16 LM parity's bound).  The windowed
attention's gradients within 1e-5 x max(1, max |JAX gradient|), the
causal backward's bound in ``tests/test_torch_train.py``.  A float64
``gradcheck`` holds the scan's autograd Function to its numerical
Jacobian, and the plain backward is held to autograd through the plain
forward at float64 (1e-10), where dt reaches 20 and exp(dt a)
underflows.  A resumed launcher run's losses are bit-equal to the
uninterrupted run's.
"""
import dataclasses
import shutil
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
from repro.models import transformer as JT
from repro_torch.configs import RunConfig, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.lm_data import LMDataConfig, batch_at
from repro_torch.kernels import ops, ref
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import main as train_main
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model_api import build
from repro_torch.optim.adamw import OptConfig, init_opt
from repro_torch.tree import named_leaves

ARCHS = ["falcon-mamba-7b", "hymba-1.5b"]
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# hymba's window cut to 8 so that S = 24 is windowed (3 windows).
WINDOW, S = 8, 24


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _assert_grad_close(name, got, want, tol):
    """``got`` within ``tol`` x max |want| of ``want`` (exact where want is
    all zeros)."""
    got = np.zeros(want.shape, np.float32) if got is None else \
        got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, f"{name}: max abs err {err} > {tol} * {scale}"


# ---------------------------------------------------------------------------
# The scan's backward
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _scan_params(dtype="float32"):
    """JAX's own scan-test config (``tests/test_layers.py:77-80``, chunks of
    16) in both packages, with JAX's ``init_mamba`` parameters."""
    kw = dict(name="t", family="ssm", n_layers=1, d_model=32, vocab=64,
              ssm_state=8, d_inner=64, dt_rank=4, ssm_chunk=16,
              param_dtype=dtype, compute_dtype=dtype)
    cfg, jcfg = ModelConfig(**kw), JaxModelConfig(**kw)
    jp = JL.init_mamba(jax.random.PRNGKey(0), jcfg)
    return cfg, jcfg, jp


# S = 32 (two whole chunks); S = 50 (JAX pads it to 64 with identity
# steps) from an h0 with a gradient on h_last; half the channels with
# dt_bias -1e4, so softplus gives dt = 0 at all their steps; bf16 x and z.
SCAN_CASES = {"fp32": dict(s=32),
              "ragged_h0_dh_last": dict(s=50, h0=True, dh_last=True),
              "dt_zero_steps": dict(s=20, h0=True, dt_zero=True),
              "bf16_x_z": dict(s=40, dtype="bfloat16")}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_grads_match_jax(case):
    """``L.selective_scan`` (its backward the plain ``selective_scan_bwd_ref``
    on the CPU) against ``jax.grad`` of JAX's ``layers.selective_scan``:
    the gradients of ``sum(y dy) + sum(h_last dh_last)`` in xc, z, h0 and,
    through ``_ssm_params``, x_proj, dt_proj, dt_bias, A_log and D_skip."""
    kw = SCAN_CASES[case]
    s, dtype = kw["s"], kw.get("dtype", "float32")
    cfg, jcfg, jp = _scan_params(dtype)
    if kw.get("dt_zero"):
        bias = np.full(64, -2.0, np.float32)
        bias[::2] = -1e4
        jp = dict(jp, dt_bias=jnp.asarray(bias))
    xc, z, dy = (_normal((2, s, 64), i) for i in (3, 4, 6))
    h0 = _normal((2, 64, 8), 5) if kw.get("h0") else None
    dh = _normal((2, 64, 8), 7) if kw.get("dh_last") else \
        np.zeros((2, 64, 8), np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def jloss(p, xc_, z_, h0_):
        y, h = JL.selective_scan(p, jcfg, xc_, z_, h0_)
        return (y.astype(jnp.float32) * dy).sum() + (h * dh).sum()

    argnums = (0, 1, 2, 3) if h0 is not None else (0, 1, 2)
    jg = jax.grad(jloss, argnums)(jp, jnp.asarray(xc, jdt),
                                  jnp.asarray(z, jdt),
                                  None if h0 is None else jnp.asarray(h0))
    p = {k: torch.from_numpy(np.array(v, np.float32)).to(
        getattr(torch, v.dtype.name)).requires_grad_() for k, v in jp.items()}
    tx, tz = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (xc, z))
    th = None if h0 is None else torch.from_numpy(h0).requires_grad_()
    if kw.get("dt_zero"):
        dt, _, _ = L._ssm_params(p, cfg, tx)
        assert torch.equal(dt[..., ::2], torch.zeros_like(dt[..., ::2]))
    y, h = L.selective_scan(p, cfg, tx, tz, th)
    assert y.grad_fn is not None
    loss = (y.float() * torch.from_numpy(dy)).sum() \
        + (h * torch.from_numpy(dh)).sum()
    names = sorted(p)
    ins = [p[k] for k in names] + [tx, tz] + ([th] if h0 is not None else [])
    got = torch.autograd.grad(loss, ins, allow_unused=True)
    want = [jg[0][k] for k in names] + list(jg[1:])
    for name, g, w in zip(names + ["xc", "z", "h0"], got, want):
        _assert_grad_close(name, g, w, TOL[dtype])


def _scan_inputs64(b, s, di, n, seed, big_dt=False):
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy(rng.normal(size=shape))

    dt = (torch.from_numpy(rng.uniform(0.0, 20.0, (b, s, di))) if big_dt
          else torch.nn.functional.softplus(f(b, s, di) - 2.0))
    dt[:, ::3] = 0.0  # identity steps
    a = -torch.arange(1, n + 1, dtype=torch.float64).repeat(di, 1) \
        * torch.exp(0.1 * f(di, n))
    return (f(b, s, di), f(b, s, di), dt, a, f(b, s, n), f(b, s, n),
            f(di), f(b, di, n))


@pytest.mark.parametrize("big_dt", [False, True])
def test_selective_scan_bwd_ref_is_the_gradient_of_the_plain_scan(big_dt):
    """The reverse recurrence, called directly, against autograd through
    ``selective_scan_ref`` at float64, with dt = 0 every third step and,
    with ``big_dt``, dt up to 20 from a large h0 (exp(dt a) below 1e-100):
    the gradient is never taken by inverting the recurrence."""
    ins = _scan_inputs64(2, 23, 12, 8, seed=1 + big_dt, big_dt=big_dt)
    if big_dt:
        ins = ins[:7] + (1e3 * ins[7],)
    dy = torch.from_numpy(_normal((2, 23, 12), 9)).double()
    dh = torch.from_numpy(_normal((2, 12, 8), 10)).double()
    leaves = [t.clone().requires_grad_() for t in ins]
    y, h = ref.selective_scan_ref(*leaves)
    want = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), leaves)
    got = ref.selective_scan_bwd_ref(*ins, dy, dh)
    names = ("dx", "dz", "ddt", "da", "dbm", "dcm", "dd", "dh0")
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape, name
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10, msg=name)


def test_selective_scan_function_gradcheck_float64():
    """``ops.selective_scan``'s autograd Function (y and h_last, every input
    h0 included) against its numerical Jacobian.  One thread: the check
    runs many tiny forwards."""
    ins = [t.requires_grad_() for t in _scan_inputs64(1, 5, 3, 2, seed=4)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert torch.autograd.gradcheck(ops.selective_scan, tuple(ins))
    finally:
        torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The sliding window's backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [1, 5, 16])
@pytest.mark.parametrize("fn", ["plain", "blocked"])
def test_windowed_attention_grads_match_jax(fn, window):
    """``ops.flash_attention(window=)`` under autograd (on the CPU the plain
    forward with its log-sum-exp and ``flash_attention_bwd_ref(window=)``)
    against ``jax.vjp`` of JAX's ``plain_attention(window=)`` and
    ``blocked_causal_attention(window=)`` (blocks of 16, so S = 40 crosses
    block edges), 6 query heads on 2 KV heads."""
    q, k, v, do = (_normal(shape, 50 + i) for i, shape in enumerate(
        [(2, 40, 6, 16), (2, 40, 2, 16), (2, 40, 2, 16), (2, 40, 6, 16)]))
    if fn == "plain":
        def jf(*a):
            return JL.plain_attention(*a, causal=True, window=window)
    else:
        def jf(*a):
            return JL.blocked_causal_attention(*a, window=window, bq=16,
                                               bk=16)
    _, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, window=window)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        bound = 1e-5 * max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g.numpy() - w).max())
        assert err <= bound, f"d{name}: {err} > {bound}"


def test_windowed_backward_at_or_above_s_is_the_causal_backward():
    q, k, v, do = (torch.from_numpy(_normal(shape, 60 + i)) for i, shape in
                   enumerate([(1, 30, 4, 16), (1, 30, 2, 16),
                              (1, 30, 2, 16), (1, 30, 4, 16)]))
    o, lse = ref.causal_attention_lse_ref(q, k, v)
    causal = ref.flash_attention_bwd_ref(q, k, v, o, do, lse)
    for w in (30, 31, 10 ** 9):
        ow, lw = ref.causal_attention_lse_ref(q, k, v, w)
        assert torch.equal(ow, o) and torch.equal(lw, lse)
        for a, b in zip(ref.flash_attention_bwd_ref(q, k, v, o, do, lse, w),
                        causal):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The whole model: lm_loss, the bundle's loss, a train step, the launcher
# ---------------------------------------------------------------------------


def _cfgs(arch):
    """(port cfg, JAX cfg): the reduced fp32 config, hymba's window cut to
    ``WINDOW``."""
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    if cfg.attn_type == "sliding":
        cfg = dataclasses.replace(cfg, window=WINDOW)
        jcfg = dataclasses.replace(jcfg, window=WINDOW)
    return cfg, jcfg


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -1, np.int32)],
                            axis=1)
    labels[rng.random((b, s)) < 0.2] = -1
    return {"tokens": tokens, "labels": labels}


def _jax_named(tree):
    """{name: array} of a JAX LM tree, the stacked L axis of ``blocks``
    unrolled into the port's leaf names."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        leaf = np.asarray(leaf)
        if names[0] == "blocks":
            for i in range(leaf.shape[0]):
                out[".".join([names[0], str(i)] + names[1:])] = leaf[i]
        else:
            out[".".join(names)] = leaf
    return out


@lru_cache(maxsize=None)
def _jax_lm(arch):
    """(cfg, JAX params as numpy, batch, JAX loss, {leaf: JAX gradient}):
    one ``jax.value_and_grad`` of JAX's ``lm_loss`` per config, shared by
    the tests below."""
    cfg, jcfg = _cfgs(arch)
    jp = jax.tree_util.tree_map(np.asarray,
                                JT.init_lm(jax.random.PRNGKey(0), jcfg))
    batch = _batch(cfg, 2, S, seed=5)
    loss, grads = jax.value_and_grad(lambda p: JT.lm_loss(
        p, jcfg, JaxRunConfig(remat="none"), jnp.asarray(batch["tokens"]),
        jnp.asarray(batch["labels"])))(jax.tree_util.tree_map(jnp.asarray,
                                                              jp))
    return cfg, jp, batch, float(loss), _jax_named(grads)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_grads_match_jax(arch, remat):
    """Every leaf's gradient of ``lm_loss`` (B = 2, S = 24, hymba windowed
    at 8) against ``jax.grad`` of JAX's, from the same parameters; the loss
    within rtol 1e-5."""
    cfg, jp, batch, jloss, jgrads = _jax_lm(arch)
    model = T.params_from_jax(jp, cfg, device="cpu").requires_grad_(True)
    loss = T.lm_loss(model, cfg, RunConfig(remat=remat),
                     torch.from_numpy(batch["tokens"]).long(),
                     torch.from_numpy(batch["labels"]).long())
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    names, ps = zip(*named_leaves(model))
    assert sorted(names) == sorted(jgrads)
    for name, g in zip(names, torch.autograd.grad(loss, ps)):
        _assert_grad_close(name, g, jgrads[name], TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_build_loss_trains_the_ssm_and_hybrid_families(arch):
    """``build(cfg).loss`` is ``lm_loss`` (JAX's value) and one
    ``make_train_step`` at 2 microbatches moves every parameter that has a
    gradient, to finite values."""
    cfg, jp, batch, jloss, jgrads = _jax_lm(arch)
    bundle = build(cfg, device="cpu", run=RunConfig(remat="full"))
    model = T.params_from_jax(jp, cfg, device="cpu")
    np.testing.assert_allclose(float(bundle.loss(model, batch)), jloss,
                               rtol=1e-5)
    before = {n: p.detach().clone() for n, p in named_leaves(model)}
    opt = init_opt(OptConfig(lr=1e-3), list(model.parameters()))
    m = make_train_step(bundle, 2)(model, opt, batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    for name, p in named_leaves(model):
        assert torch.isfinite(p).all(), name
        if np.abs(jgrads[name]).max() > 0:
            assert not torch.equal(p, before[name]), name


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_trains_and_resumes_bit_equal(arch, tmp_path, capsys):
    """The launcher trains the reduced SSM and hybrid LMs from LM data with
    two microbatches under ``--remat full`` (the reduced hymba keeps its
    1,024-token window, which S = 32 does not reach: the window's
    gradients are held to JAX's above), and a run resumed from step 2
    gives the last two losses bit for bit."""
    argv = ["--device", "cpu", "--reduced", "--arch", arch, "--steps", "4",
            "--seq-len", "32", "--batch", "2", "--microbatches", "2",
            "--remat", "full", "--log-every", "1"]
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    run_a = train_main(argv + ["--ckpt", str(a_dir), "--ckpt-every", "2"])
    assert len(run_a) == 4 and all(np.isfinite(run_a))
    b_dir.mkdir()
    shutil.copytree(a_dir / "step_00000002", b_dir / "step_00000002")
    run_b = train_main(argv + ["--ckpt", str(b_dir)])
    assert run_b == run_a[2:]
    out = capsys.readouterr().out
    assert f"restored step 2 from {b_dir}" in out
    assert "step     3 loss" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_takes_a_config_from_python(arch):
    """A Python caller's ``cfg`` stands in for ``--arch``'s (a depth cut,
    which the command line cannot name): the first loss is the cut model's
    at the launcher's seed-0 parameters and first batch."""
    cut = dataclasses.replace(get_config(arch).reduced(), n_layers=1,
                              window=WINDOW)
    argv = ["--device", "cpu", "--arch", arch, "--steps", "1", "--seq-len",
            str(S), "--batch", "2", "--log-every", "1"]
    (loss,) = train_main(argv, cfg=cut)
    bundle = build(cut, device="cpu")
    data = LMDataConfig(vocab=cut.vocab, seq_len=S, global_batch=2)
    with torch.no_grad():
        want = float(bundle.loss(bundle.init(seed=0), batch_at(data, 0)))
    np.testing.assert_allclose(loss, want, rtol=1e-6)
    (full_depth,) = train_main(argv + ["--reduced"])
    assert full_depth != loss

def test_the_scan_and_the_windowed_attention_train():
    """Under autograd both ops build a graph and give every input a
    gradient; without it they return plain tensors, the serve path."""
    ins = [t.float() for t in _scan_inputs64(1, 9, 64, 8, seed=7)]
    grad_ins = [t.clone().requires_grad_() for t in ins]
    y, h = ops.selective_scan(*grad_ins)
    assert y.grad_fn is not None and h.grad_fn is not None
    grads = torch.autograd.grad(y.sum() + h.sum(), grad_ins)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    with torch.no_grad():
        y0, h0 = ops.selective_scan(*grad_ins)
    assert y0.grad_fn is None and torch.equal(y0, y.detach())
    assert torch.equal(h0, h.detach())
    q = torch.zeros((1, 6, 4, 16), requires_grad=True)
    kv = torch.zeros((1, 6, 2, 16), requires_grad=True)
    o = ops.flash_attention(q, kv, kv, window=2)
    assert o.grad_fn is not None
    assert all(g is not None for g in torch.autograd.grad(
        o.sum(), (q, kv)))
    with torch.no_grad():
        assert ops.flash_attention(q, kv, kv, window=2).grad_fn is None
