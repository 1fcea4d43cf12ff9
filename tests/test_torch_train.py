"""The port's training path against the JAX package's, on the CPU.

Parameters are JAX's (``init_lm``/``init_dlrm`` of ``PRNGKey(0)``) carried
over by ``params_from_jax``; tokens, labels and features are numpy draws
handed to both.  Tolerances: the attention backward within 1e-5 x max(1,
max |JAX grad|) (fp32, the sums run in another order); ``lm_loss`` and
``dlrm_loss`` within rtol 1e-5 and every gradient within 1e-5 x max(1,
max |JAX grad|); one ``make_train_step`` within 1e-5 on the loss and 1e-5
abs on every parameter after the step; three launcher steps within rtol
1e-4 on the losses (the differences compound over the steps).  The
launcher's data (``batch_at``) is byte-equal, and a resumed CPU run's
losses are bit-equal to the uninterrupted run's.  The launcher's retry
never runs an update twice: a failure inside the update surfaces at once,
and a retried failure before it gives one clean step, bit for bit.
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
from repro.data import lm_data as jax_lm_data
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import dlrm as JD
from repro.models import layers as JL
from repro.models import model_api as JMA
from repro.models import transformer as JT
from repro.optim.adamw import OptConfig as JaxOptConfig
from repro.optim.adamw import init_opt as jax_init_opt
from repro_torch.configs import RunConfig, get_config
from repro_torch.data import lm_data
from repro_torch.distributed import mesh as M
from repro_torch.distributed.compression import (init_error,
                                                 make_compressed_dp_grads)
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import run_step
from repro_torch.models import dlrm as D
from repro_torch.models import transformer as T
from repro_torch.models.model_api import build
from repro_torch.optim.adamw import AdamW, OptConfig, init_opt
from repro_torch.tree import named_leaves

TOL = 1e-5


@lru_cache(maxsize=None)
def _lm():
    """(port cfg, JAX cfg, JAX params as numpy) of smollm-135m reduced."""
    jcfg = jax_get_config("smollm-135m").reduced()
    jp = jax.tree_util.tree_map(np.asarray,
                                JT.init_lm(jax.random.PRNGKey(0), jcfg))
    return get_config("smollm-135m").reduced(), jcfg, jp


@lru_cache(maxsize=None)
def _dlrm():
    jcfg = jax_get_config("dlrm-recmg").reduced()
    jp = jax.tree_util.tree_map(np.asarray,
                                JD.init_dlrm(jax.random.PRNGKey(0), jcfg))
    return get_config("dlrm-recmg").reduced(), jcfg, jp


def _port_params(arch):
    cfg, _, jp = _lm() if arch == "lm" else _dlrm()
    if arch == "lm":
        return T.params_from_jax(jp, cfg, device="cpu")
    return D.params_from_jax(jp, device="cpu")


def _jax_named(tree):
    """{key path: array} of a JAX tree, named as the port's leaves: the
    stacked L axis of an LM's ``blocks`` unrolled."""
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


def _assert_grads_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name].detach().float().numpy()
        bound = TOL * max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g - w).max())
        assert err <= bound, f"{name}: max abs err {err} > {bound}"


def _lm_batch(cfg, b, s, seed, masked=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -1, np.int32)],
                            axis=1)
    if masked:
        labels[rng.random((b, s)) < 0.2] = -1
    return {"tokens": tokens, "labels": labels}


def _dlrm_batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return {"dense": rng.normal(size=(b, cfg.dense_features)).astype(
                np.float32),
            "sparse": rng.integers(0, cfg.rows_per_table,
                                   (b, cfg.n_tables, cfg.multi_hot)).astype(
                np.int32),
            "label": (rng.random(b) < 0.5).astype(np.float32)}


# ---------------------------------------------------------------------------
# Attention backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,n_kv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("s", [64, 100])
def test_attention_backward_matches_jax_grad(s, h, n_kv):
    b, hd = 2, 16
    rng = np.random.default_rng(s + n_kv)
    q, k, v, do = (rng.normal(size=shape).astype(np.float32) for shape in (
        (b, s, h, hd), (b, s, n_kv, hd), (b, s, n_kv, hd), (b, s, h, hd)))
    _, vjp = jax.vjp(lambda *a: JL.blocked_causal_attention(*a),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        bound = TOL * max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g.numpy() - w).max())
        assert err <= bound, f"d{name}: {err} > {bound}"


def test_attention_function_gradcheck_float64():
    """Two query heads on one KV head, a ragged S.  One thread: the
    numerical Jacobian takes ~900 tiny forwards, which a busy machine's
    thread pool would slow a hundredfold."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=shape)).requires_grad_()
               for shape in ((1, 7, 2, 16), (1, 7, 1, 16), (1, 7, 1, 16)))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert torch.autograd.gradcheck(ops.flash_attention, (q, k, v))
    finally:
        torch.set_num_threads(threads)


def test_gather_pool_gives_the_table_a_gradient():
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.normal(size=(40, 8))).requires_grad_()
    idx = torch.from_numpy(rng.integers(0, 40, (6, 3)).astype(np.int32))
    dout = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32))
    ops.gather_pool(table, idx).backward(dout)
    want = np.zeros((40, 8))
    for i in range(6):
        for p in range(3):
            want[idx[i, p]] += dout[i].numpy()
    np.testing.assert_allclose(table.grad.numpy(), want, rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [0, 16])
def test_lm_loss_and_grads_match_jax(chunk):
    cfg, jcfg, jp = _lm()
    batch = _lm_batch(cfg, 2, 64, seed=3)
    jrun = JaxRunConfig(remat="none", logits_chunk=chunk)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JT.lm_loss(p, jcfg, jrun, jnp.asarray(batch["tokens"]),
                             jnp.asarray(batch["labels"])))(
        jax.tree_util.tree_map(jnp.asarray, jp))
    model = _port_params("lm").requires_grad_(True)
    loss = T.lm_loss(model, cfg, RunConfig(remat="none", logits_chunk=chunk),
                     torch.from_numpy(batch["tokens"]).long(),
                     torch.from_numpy(batch["labels"]).long())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    names, ps = zip(*named_leaves(model))
    grads = torch.autograd.grad(loss, ps)
    _assert_grads_close(dict(zip(names, grads)), _jax_named(jgrads))


def test_lm_remat_full_and_none_give_equal_grads():
    cfg, _, _ = _lm()
    batch = _lm_batch(cfg, 2, 64, seed=4)
    out = {}
    for remat in ("full", "none"):
        model = _port_params("lm").requires_grad_(True)
        loss = T.lm_loss(model, cfg, RunConfig(remat=remat),
                         torch.from_numpy(batch["tokens"]).long(),
                         torch.from_numpy(batch["labels"]).long())
        out[remat] = (loss.detach(), torch.autograd.grad(
            loss, list(model.parameters())))
    assert torch.equal(out["full"][0], out["none"][0])
    for a, b in zip(out["full"][1], out["none"][1]):
        assert torch.equal(a, b)


def test_remat_dots_is_refused():
    with pytest.raises(NotImplementedError, match="XLA"):
        RunConfig(remat="dots")
    with pytest.raises(ValueError, match="remat"):
        RunConfig(remat="some")


def test_dlrm_loss_and_grads_match_jax():
    cfg, jcfg, jp = _dlrm()
    batch = _dlrm_batch(cfg, 16, seed=5)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JD.dlrm_loss(p, jcfg, *(jnp.asarray(batch[k]) for k in (
            "dense", "sparse", "label"))))(
        jax.tree_util.tree_map(jnp.asarray, jp))
    params = _port_params("dlrm")
    names, ps = zip(*named_leaves(params))
    for p in ps:
        p.requires_grad_(True)
    loss = D.dlrm_loss(params, cfg, *(torch.from_numpy(batch[k]) for k in (
        "dense", "sparse", "label")))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    grads = dict(zip(names, torch.autograd.grad(loss, ps)))
    assert float(grads["emb"].abs().sum()) > 0
    _assert_grads_close(grads, _jax_named(jgrads))


def test_bundle_losses_are_the_model_losses():
    cfg, _, _ = _dlrm()
    batch = _dlrm_batch(cfg, 8, seed=6)
    params = _port_params("dlrm")
    got = build(cfg, device="cpu").loss(params, batch)
    want = D.dlrm_loss(params, cfg, *(torch.from_numpy(batch[k]) for k in (
        "dense", "sparse", "label")))
    assert torch.equal(got, want)
    lcfg, _, _ = _lm()
    lb = _lm_batch(lcfg, 2, 16, seed=7)
    model = _port_params("lm")
    run = RunConfig(remat="none")
    assert torch.equal(
        build(lcfg, device="cpu", run=run).loss(model, lb),
        T.lm_loss(model, lcfg, run, torch.from_numpy(lb["tokens"]).long(),
                  torch.from_numpy(lb["labels"]).long()))


# ---------------------------------------------------------------------------
# The train step and the launcher's loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 4])
@pytest.mark.parametrize("arch", ["lm", "dlrm"])
def test_train_step_matches_jax(arch, microbatches):
    cfg, jcfg, jp = _lm() if arch == "lm" else _dlrm()
    batch = (_lm_batch(cfg, 4, 32, seed=8) if arch == "lm"
             else _dlrm_batch(cfg, 16, seed=8))
    jbundle = JMA.build(jcfg, JaxRunConfig(remat="none"))
    jopt_cfg = JaxOptConfig(lr=1e-3)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    jstep = jax.jit(jax_make_train_step(jbundle, jopt_cfg, microbatches))
    jparams, _, jm = jstep(jparams, jax_init_opt(jopt_cfg, jparams),
                           {k: jnp.asarray(v) for k, v in batch.items()})

    params = _port_params(arch)
    bundle = build(cfg, device="cpu", run=RunConfig(remat="none"))
    opt = init_opt(OptConfig(lr=1e-3), [p for _, p in named_leaves(params)])
    m = make_train_step(bundle, microbatches)(params, opt, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=TOL)
    assert opt.count == 1
    want = _jax_named(jparams)
    got = dict(named_leaves(params))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w, rtol=0,
                                   atol=TOL, err_msg=name)


def test_microbatches_accumulate_in_fp32_for_bf16_parameters():
    """bf16 parameters: each microbatch's gradient goes into an fp32 sum,
    so four microbatches of one repeated batch give the one-batch step."""
    cfg, _, _ = _lm()
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    one = _lm_batch(cfg, 1, 16, seed=9)
    four = {k: np.repeat(v, 4, axis=0) for k, v in one.items()}
    bundle = build(cfg, device="cpu", run=RunConfig(remat="none"))
    out = []
    for batch, mb in ((one, 1), (four, 4)):
        model = T.init_lm(cfg, seed=0, device="cpu")
        opt = init_opt(OptConfig(lr=1e-3), list(model.parameters()))
        m = make_train_step(bundle, mb)(model, opt, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(out[1], out[0], rtol=1e-6)


def test_launcher_loop_matches_jax_loop():
    """The launcher's loop (``make_train_step`` over ``batch_at`` with
    ``OptConfig(lr, total_steps=steps)``) for 3 steps, against the same
    loop in JAX from the same carried parameters."""
    cfg, jcfg, jp = _lm()
    steps = 3
    data = lm_data.LMDataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2)
    jdata = jax_lm_data.LMDataConfig(vocab=cfg.vocab, seq_len=32,
                                     global_batch=2)
    jopt_cfg = JaxOptConfig(lr=3e-4, total_steps=steps)
    jstep = jax.jit(jax_make_train_step(
        JMA.build(jcfg, JaxRunConfig(remat="none")), jopt_cfg, 1))
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    jopt = jax_init_opt(jopt_cfg, jparams)
    jlosses = []
    for step in range(steps):
        batch = {k: jnp.asarray(v)
                 for k, v in jax_lm_data.batch_at(jdata, step).items()}
        jparams, jopt, m = jstep(jparams, jopt, batch)
        jlosses.append(float(m["loss"]))

    model = _port_params("lm")
    opt = init_opt(OptConfig(lr=3e-4, total_steps=steps),
                   list(model.parameters()))
    step_fn = make_train_step(build(cfg, device="cpu",
                                    run=RunConfig(remat="none")), 1)
    losses = [float(step_fn(model, opt, lm_data.batch_at(data, s))["loss"])
              for s in range(steps)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


@pytest.mark.parametrize("step", [0, 1, 7])
def test_batch_at_is_byte_equal_to_jax(step):
    kw = dict(vocab=512, seq_len=48, global_batch=3)
    got = lm_data.batch_at(lm_data.LMDataConfig(**kw), step)
    want = jax_lm_data.batch_at(jax_lm_data.LMDataConfig(**kw), step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def _counted_lm_step(bundle):
    """(the launcher's step over the reduced LM's carried parameters, its
    call count, the parameters, their optimizer, a batch)."""
    params = _port_params("lm")
    opt = init_opt(OptConfig(lr=1e-3), list(params.parameters()))
    step_fn = make_train_step(bundle, 1)
    calls = []

    def counted(*a):
        calls.append(1)
        return step_fn(*a)

    cfg, _, _ = _lm()
    return counted, calls, params, opt, _lm_batch(cfg, 2, 16, seed=12)


def test_launcher_does_not_retry_a_half_applied_update(monkeypatch):
    """The second leaf's update raises: the step is not retried (a retry
    would apply the update again), the error surfaces, and the count moved
    by exactly one."""
    cfg, _, _ = _lm()
    bundle = build(cfg, device="cpu", run=RunConfig(remat="none"))
    step_fn, calls, params, opt, batch = _counted_lm_step(bundle)
    leaf_update = AdamW._update_leaf
    leaves_done = []

    def second_leaf_fails(self, *a):
        if len(leaves_done) == 1:
            raise RuntimeError("out of memory in the second leaf's update")
        leaves_done.append(1)
        return leaf_update(self, *a)

    monkeypatch.setattr(AdamW, "_update_leaf", second_leaf_fails)
    with pytest.raises(RuntimeError, match="second leaf"):
        run_step(step_fn, params, opt, batch, sleep=lambda s: None)
    assert len(calls) == 1
    assert opt.count == 1


def test_launcher_retries_a_failure_before_the_update():
    """The loss raises once: the retried step's parameters, moments and
    count equal one clean step's, bit for bit."""
    cfg, _, _ = _lm()
    bundle = build(cfg, device="cpu", run=RunConfig(remat="none"))
    failed = []

    def flaky_loss(params, batch):
        if not failed:
            failed.append(1)
            raise RuntimeError("transient failure in the loss")
        return bundle.loss(params, batch)

    flaky = dataclasses.replace(bundle, loss=flaky_loss)
    step_fn, calls, params, opt, batch = _counted_lm_step(flaky)
    retries = []
    run_step(step_fn, params, opt, batch, sleep=lambda s: None,
             on_retry=lambda attempt, e: retries.append(attempt))
    assert len(calls) == 2 and retries == [1] and failed == [1]

    clean_fn, _, clean, clean_opt, _ = _counted_lm_step(bundle)
    clean_fn(clean, clean_opt, batch)
    assert opt.count == clean_opt.count == 1
    for (name, p), (_, c) in zip(named_leaves(params), named_leaves(clean)):
        assert torch.equal(p, c), name
    for key in ("m", "v"):
        for a, b in zip(opt.state_dict()[key], clean_opt.state_dict()[key]):
            assert torch.equal(a, b), key

ARGS = ["--device", "cpu", "--reduced", "--steps", "6", "--seq-len", "32",
        "--batch", "2", "--log-every", "1"]


def test_launcher_resumes_bit_equal(tmp_path, capsys):
    """Run A: 6 steps, checkpoints every 3.  Run B: A's step-3 checkpoint
    alone in a fresh directory, run to 6: it restores step 3 and its
    losses are A's steps 3-5, bit for bit."""
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    run_a = train_main(ARGS + ["--ckpt", str(a_dir), "--ckpt-every", "3"])
    assert len(run_a) == 6 and all(np.isfinite(run_a))
    assert (a_dir / "step_00000003").is_dir()
    assert (a_dir / "heartbeat.json").exists()
    b_dir.mkdir()
    shutil.copytree(a_dir / "step_00000003", b_dir / "step_00000003")
    run_b = train_main(ARGS + ["--ckpt", str(b_dir)])
    assert run_b == run_a[3:]
    out = capsys.readouterr().out
    assert "device: cpu" in out
    assert f"restored step 3 from {b_dir}" in out
    assert "step     5 loss" in out and "done: loss" in out


def test_launcher_rerun_after_the_last_step_trains_nothing(tmp_path,
                                                          capsys):
    """A second run of a finished run's command restores step 6, trains no
    step and says so (it raised IndexError on the empty loss list)."""
    argv = ARGS + ["--ckpt", str(tmp_path)]
    assert len(train_main(argv)) == 6
    assert train_main(argv) == []
    out = capsys.readouterr().out
    assert f"restored step 6 from {tmp_path}" in out
    assert "done: no step to run (restored step 6 of 6)" in out


@pytest.mark.parametrize("argv,match", [
    (["--arch", "dlrm-recmg"], "LM data"),
    (["--arch", "whisper-large-v3"], "frontend"),
    (["--remat", "dots"], "XLA"),
])
def test_launcher_refuses_what_it_does_not_port(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        train_main(ARGS + argv)


def test_launcher_model_parallel_without_a_process_group(capsys):
    """``--model-parallel 2`` in one process: the mesh is this process, (1,
    1), as JAX's over one device, and the run is the plain run bit for
    bit (the multi-rank runs: ``test_torch_distributed_train.py``)."""
    want = train_main(ARGS)
    assert train_main(ARGS + ["--model-parallel", "2"]) == want
    assert "device: cpu" in capsys.readouterr().out


def test_launcher_int8_ef_without_a_process_group():
    """``--grad-compression int8_ef`` in one process: one data rank, so
    each step's gradient is ``dequant(quant(g + err))`` with the error
    carried between steps; the launcher's losses equal that loop's."""
    steps = 3
    argv = ARGS[:3] + ["--steps", str(steps)] + ARGS[5:]
    got = train_main(argv + ["--grad-compression", "int8_ef"])
    cfg = get_config("smollm-135m").reduced()
    bundle = build(cfg, device="cpu", run=RunConfig(remat="none"))
    model = bundle.init(seed=0)
    opt = init_opt(OptConfig(lr=3e-4, total_steps=steps),
                   list(model.parameters()))
    grads_fn = make_compressed_dp_grads(bundle.loss, M.make_host_mesh())
    err = init_error(model)
    data = lm_data.LMDataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2)
    want = []
    for step in range(steps):
        loss, grads, err = grads_fn(model, err, lm_data.batch_at(data, step))
        opt.apply(grads)
        want.append(float(loss))
    assert got == want
    assert got != train_main(argv)


def test_launcher_has_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--reduced", "--steps", "1", "--seq-len", "8",
                    "--batch", "1"])


# ---------------------------------------------------------------------------
# AdamW's knobs: bf16 moments and the fp32 master copy
# ---------------------------------------------------------------------------

KNOBS = [("bfloat16", False), ("float32", True), ("bfloat16", True)]


@pytest.mark.parametrize("moment_dtype,master_fp32", KNOBS)
def test_adamw_knobs_match_apply_updates_on_bf16_params(moment_dtype,
                                                        master_fp32):
    """Three steps on bf16 parameters against JAX's ``apply_updates`` with
    the same knobs: parameters, moments (in their stored dtype) and the
    master copy within 1e-6."""
    from repro.optim.adamw import apply_updates

    rng = np.random.default_rng(3)
    shapes = {"a": (6, 5), "b": (9,), "c": ()}
    p0 = {k: np.asarray(rng.normal(size=s), np.float32)
          for k, s in shapes.items()}
    grads = [{k: np.asarray(rng.normal(size=s), np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    kw = dict(lr=3e-3, weight_decay=0.1, warmup_steps=2, total_steps=10,
              moment_dtype=moment_dtype, master_fp32=master_fp32)
    jcfg = JaxOptConfig(**kw)
    jparams = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p0.items()}
    jopt = jax_init_opt(jcfg, jparams)
    params = [torch.from_numpy(v).to(torch.bfloat16) for v in p0.values()]
    opt = init_opt(OptConfig(**kw), params)
    for g in grads:
        jparams, jopt, _ = apply_updates(
            jcfg, jparams, jopt, {k: jnp.asarray(v) for k, v in g.items()})
        opt.apply([torch.from_numpy(v) for v in g.values()])
        sd = opt.state_dict()
        for i, k in enumerate(shapes):
            assert params[i].dtype == torch.bfloat16
            pairs = [(params[i], jparams[k]), (sd["m"][i], jopt["m"][k]),
                     (sd["v"][i], jopt["v"][k])]
            if master_fp32:
                pairs.append((sd["master"][i], jopt["master"][k]))
            for got, want in pairs:
                assert str(got.dtype).split(".")[-1] == want.dtype.name, k
                np.testing.assert_allclose(
                    got.float().numpy(), np.asarray(want, np.float32),
                    rtol=0, atol=1e-6, err_msg=k)
    assert opt.count == int(jopt["count"]) == 3
    assert ("master" in opt.state_dict()) == master_fp32


def test_adamw_refuses_unknown_moment_dtypes_and_mismatched_state():
    with pytest.raises(ValueError, match="moment_dtype"):
        OptConfig(moment_dtype="float16")
    p = [torch.zeros(3)]
    plain = init_opt(OptConfig(), p)
    mastered = init_opt(OptConfig(master_fp32=True), [torch.zeros(3)])
    with pytest.raises(ValueError, match="master"):
        mastered.load_state_dict(plain.state_dict())
    with pytest.raises(ValueError, match="master"):
        plain.load_state_dict(mastered.state_dict())


def _bf16_lm():
    cfg, _, _ = _lm()
    return dataclasses.replace(cfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16")


@pytest.mark.parametrize("moment_dtype,master_fp32", KNOBS)
def test_checkpoint_keeps_master_and_bf16_moments_and_resumes_bit_equal(
        tmp_path, moment_dtype, master_fp32):
    """Four steps of reduced bf16 smollm with the knobs; a checkpoint after
    step 2 restored into a fresh model and optimizer keeps every leaf's
    dtype and bits (the master copy and bf16 moments included), and steps
    3-4 from it give the uninterrupted run's losses and state bit for
    bit."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch.train import _restore

    cfg = _bf16_lm()
    ocfg = OptConfig(lr=1e-3, moment_dtype=moment_dtype,
                     master_fp32=master_fp32)
    bundle = build(cfg, device="cpu", run=RunConfig(remat="none"))
    step_fn = make_train_step(bundle, 2)
    batches = [_lm_batch(cfg, 2, 16, seed=20 + i) for i in range(4)]

    def fresh():
        model = T.init_lm(cfg, seed=0, device="cpu")
        return model, init_opt(ocfg, list(model.parameters()))

    model, opt = fresh()
    losses = []
    for i, batch in enumerate(batches):
        losses.append(float(step_fn(model, opt, batch)["loss"]))
        if i == 1:
            ckpt.save(str(tmp_path), 2, {"params": model,
                                         "opt": opt.state_dict()})
    model_b, opt_b = fresh()
    assert _restore(str(tmp_path), model_b, opt_b) == 2
    assert opt_b.count == 2
    saved = ckpt.restore(str(tmp_path), {"params": model_b,
                                         "opt": opt_b.state_dict()})[0]
    for (name, a), (_, b) in zip(named_leaves(saved["opt"]),
                                 named_leaves(opt_b.state_dict())):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    want_mdt = torch.bfloat16 if moment_dtype == "bfloat16" else \
        torch.float32
    assert all(m.dtype == want_mdt for m in opt_b.state_dict()["m"])
    if master_fp32:
        assert all(m.dtype == torch.float32
                   for m in opt_b.state_dict()["master"])
    resumed = [float(step_fn(model_b, opt_b, b)["loss"])
               for b in batches[2:]]
    assert resumed == losses[2:]
    for (name, a), (_, b) in zip(named_leaves(model), named_leaves(model_b)):
        assert torch.equal(a, b), name
    for key, ts in opt.state_dict().items():
        if key != "count":
            for a, b in zip(ts, opt_b.state_dict()[key]):
                assert torch.equal(a, b), key


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "internvl2-26b"])
def test_launcher_trains_and_resumes_moe_and_vlm(tmp_path, capsys, arch):
    """The launcher trains the reduced MoE and VLM from LM data (the VLM
    on its text alone, as JAX's launcher does) with two microbatches, and a
    run resumed from step 3 gives the last three losses bit for bit."""
    argv = ["--device", "cpu", "--reduced", "--arch", arch, "--steps", "6",
            "--seq-len", "32", "--batch", "2", "--microbatches", "2",
            "--remat", "full", "--log-every", "1"]
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    run_a = train_main(argv + ["--ckpt", str(a_dir), "--ckpt-every", "3"])
    assert len(run_a) == 6 and all(np.isfinite(run_a))
    b_dir.mkdir()
    shutil.copytree(a_dir / "step_00000003", b_dir / "step_00000003")
    run_b = train_main(argv + ["--ckpt", str(b_dir)])
    assert run_b == run_a[3:]
    assert f"restored step 3 from {b_dir}" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "internvl2-26b"])
def test_moe_and_vlm_train_step_matches_jax(arch):
    """One ``make_train_step`` of the reduced MoE (its aux term in the loss)
    and VLM at 2 microbatches against JAX's, from the same parameters."""
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jp = jax.tree_util.tree_map(np.asarray,
                                JT.init_lm(jax.random.PRNGKey(0), jcfg))
    batch = _lm_batch(cfg, 4, 32, seed=30)
    jopt_cfg = JaxOptConfig(lr=1e-3)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    jstep = jax.jit(jax_make_train_step(
        JMA.build(jcfg, JaxRunConfig(remat="none")), jopt_cfg, 2))
    jparams, _, jm = jstep(jparams, jax_init_opt(jopt_cfg, jparams),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    model = T.params_from_jax(jp, cfg, device="cpu")
    opt = init_opt(OptConfig(lr=1e-3), list(model.parameters()))
    m = make_train_step(build(cfg, device="cpu",
                              run=RunConfig(remat="full")), 2)(
        model, opt, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=TOL)
    want = _jax_named(jparams)
    for name, p in named_leaves(model):
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=TOL, err_msg=name)
