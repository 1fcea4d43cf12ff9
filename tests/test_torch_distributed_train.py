"""The port's training across the ranks of a mesh against the JAX
package's, on the CPU.

The multi-device references run in one subprocess of their own with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(``tests/jax_dist_train_ref.py``); the port runs as four ``gloo``
processes on a ``file://`` store (``tests/torch_dist_train_ranks.py``),
and both run once for every case here.  Parameters are JAX's
(``PRNGKey(0)``), carried to the ranks as arrays or as the launcher's
step-0 checkpoint; batches are numpy draws or ``batch_at``'s.  Cases:

- reduced dlrm-recmg, fp32, trained two steps on a (2, 2) mesh through
  the row-sharded lookup with two microbatches, ids over [-2, R + 2) (the
  lookup drops those no shard owns): each step's loss, gradients and
  parameters after it, each rank's table shard against its rows of JAX's
  tables;
- ``compress_tree`` and ``psum_int8`` over four data ranks: codes and
  errors bit-equal, scales within 1 ulp;
- reduced smollm-135m through the launcher with ``--grad-compression
  int8_ef`` on a (4, 1) mesh against JAX's ``make_compressed_dp_grads``
  and ``apply_updates``: losses and parameters (a code may differ by one
  where ``x / scale`` sits within 1e-4 of a half, which the 1e-5 bound on
  the parameters absorbs at this size);
- ``moe_block`` over four data ranks, global dispatch against JAX's
  single-device ``moe_block`` on all T tokens, and ``local_dispatch``
  against ``_moe_dispatch_ffn_sharded(p, cfg, xf, 4)``, in a case where
  the capacity drops tokens and the two dispatches differ: outputs, aux,
  and the router's and experts' gradients of a loss that uses the aux;
- reduced granite-moe through the launcher with ``--model-parallel 2`` (a
  (2, 2) mesh, two microbatches) against a JAX loop of ``make_train_step``
  over ``batch_at`` (JAX's launcher fails on its own mesh: ROADMAP C), and
  its resume from the step-2 checkpoint on two ranks.

Tolerances: fp32 1e-5 (losses rtol, gradients and parameters 1e-5 x
max(1, the JAX tensor's largest magnitude)).  The shard window's backward
is also held against a numpy loop, and the one-process paths against the
single-device step, in this process.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_train_ranks as ranks
from jax_dist_train_ref import named as _named
from repro.configs import get_config as jax_get_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models import dlrm as JD
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import RunConfig, get_config
from repro_torch.distributed import collectives as C
from repro_torch.distributed import mesh as M
from repro_torch.distributed.compression import (dequantize_int8,
                                                 init_error,
                                                 make_compressed_dp_grads,
                                                 quantize_int8)
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_grads_fn, make_train_step
from repro_torch.models import dlrm as D
from repro_torch.models import transformer as T
from repro_torch.models.model_api import build
from repro_torch.optim.adamw import OptConfig, init_opt
from repro_torch.tree import named_leaves

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
LR = 1e-3
DLRM_B, DLRM_STEPS, DLRM_MB = 8, 2, 2
CMP_SHAPES = ((5, 7), (11,), (3, 4, 2))
LAUNCH = {"int8": dict(arch="smollm-135m", steps=2, seq=32, batch=4),
          "plain": dict(arch="granite-moe-1b-a400m", steps=3, seq=16,
                        batch=4, microbatches=2)}
# One MoE layer at test_torch_moe.py's widths; capacity factor 0.5 drops
# tokens, with capacity 8 over the 32 tokens and 2 over a rank's 8.
MOE_KW = dict(name="t", family="moe", n_layers=1, d_model=16, d_ff=32,
              vocab=64, n_experts=4, top_k=2, moe_d_ff=32,
              capacity_factor=0.5, param_dtype="float32",
              compute_dtype="float32")
MOE_X = (8, 4)  # (B, S): 8 tokens a rank


def _lm_params(arch):
    cfg = get_config(arch).reduced()
    jp = JT.init_lm(jax.random.PRNGKey(0), jax_get_config(arch).reduced())
    return cfg, T.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                  cfg, device="cpu")


def _step0_checkpoint(path, arch, steps):
    """The launcher's starting point: JAX's parameters and a fresh AdamW
    state as the checkpoint of step 0."""
    _, model = _lm_params(arch)
    opt = init_opt(OptConfig(lr=LR, total_steps=steps),
                   list(model.parameters()))
    ckpt.save(str(path), 0, {"params": model, "opt": opt.state_dict()})


def _moe_jax(data):
    """JAX's MoE on all the tokens: ``{mode: (out, aux, grads)}`` of the
    ranks' loss ``sum(out * w) + AUX_WEIGHT * aux``, global (``moe_block``)
    and data-local (``_moe_dispatch_ffn_sharded`` over 4 shards)."""
    cfg = JaxModelConfig(**MOE_KW)
    x, w = jnp.asarray(data["moe/x"]), jnp.asarray(data["moe/w"])
    p = {k: jnp.asarray(data[f"moe/p/{k}"])
         for k in ("router", "w1", "w3", "w2")}

    def run(mode, p):
        if mode == "global":
            out, aux = JL.moe_block(p, cfg, x)
        else:
            out, aux = JL._moe_dispatch_ffn_sharded(
                p, cfg, x.reshape(-1, x.shape[-1]), 4)
            out = out.reshape(x.shape)
        return (out * w).sum() + ranks.AUX_WEIGHT * aux, (out, aux)

    res = {}
    for mode in ranks.MOE_MODES:
        (_, (out, aux)), g = jax.value_and_grad(
            lambda q: run(mode, q), has_aux=True)(p)
        res[mode] = (np.asarray(out), float(aux),
                     {k: np.asarray(v) for k, v in g.items()})
    return res


def _inputs(work):
    """Writes ``inputs.npz`` and the launcher's step-0 checkpoints."""
    rng = np.random.default_rng(29)
    cfg = ranks.dlrm_cfg()
    jtree = JD.init_dlrm(jax.random.PRNGKey(0),
                         jax_get_config("dlrm-recmg").reduced())
    data = {"lr": np.array(LR), "dlrm/microbatches": np.array(DLRM_MB),
            "dlrm/steps": np.array(DLRM_STEPS), "cmp/n": np.array(
                len(CMP_SHAPES))}
    data.update({f"dlrm/init/{k}": v for k, v in _named(jtree).items()})
    r = cfg.rows_per_table
    for s in range(DLRM_STEPS):
        data[f"dlrm/{s}/dense"] = rng.normal(
            size=(DLRM_B, cfg.dense_features)).astype(np.float32)
        data[f"dlrm/{s}/sparse"] = rng.integers(
            -2, r + 2, (DLRM_B, cfg.n_tables, cfg.multi_hot)).astype(
                np.int32)
        data[f"dlrm/{s}/label"] = (rng.random(DLRM_B) < 0.5).astype(
            np.float32)
    for i, shape in enumerate(CMP_SHAPES):
        data[f"cmp/g{i}"] = rng.normal(size=(4,) + shape).astype(np.float32)
        data[f"cmp/e{i}"] = (0.01 * rng.normal(size=(4,) + shape)).astype(
            np.float32)
    for key, kw in LAUNCH.items():
        for k, v in kw.items():
            if k != "arch":
                data[f"{key}/{k}"] = np.array(v)
        _step0_checkpoint(work / key, kw["arch"], kw["steps"])
    data.update({f"moe/cfg/{k}": np.array(v) for k, v in MOE_KW.items()})
    jp = JL.init_moe(jax.random.PRNGKey(3), JaxModelConfig(**MOE_KW))
    data.update({f"moe/p/{k}": np.asarray(v) for k, v in jp.items()})
    x_shape = MOE_X + (MOE_KW["d_model"],)
    data["moe/x"] = rng.normal(size=x_shape).astype(np.float32)
    data["moe/w"] = rng.normal(size=x_shape).astype(np.float32)
    np.savez(work / "inputs.npz", **data)
    return data


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One run of each side: ``(JAX's results, every rank's results, the
    MoE references, the work directory)``.  JAX's subprocess runs while
    the ranks do."""
    work = tmp_path_factory.mktemp("dist_train")
    data = _inputs(work)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "jax_dist_train_ref.py"),
         str(work / "inputs.npz"), str(work / "jax.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # A rank that raises fails the spawn, and with it every test here.
    mp.spawn(ranks.rank_main, args=(4, str(work)), nprocs=4, join=True)
    moe = _moe_jax(data)
    log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log
    return (dict(np.load(work / "jax.npz")),
            [dict(np.load(work / f"rank{r}.npz")) for r in range(4)], moe,
            work)


def _close(got, want, what, tol=TOL):
    got = np.asarray(got, np.float32)
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape, what
    assert err <= bound, f"{what}: max abs err {err} > {bound}"


def _jax_tree(jx, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in jx.items() if k.startswith(prefix + "/")}


# ---------------------------------------------------------------------------
# Row-sharded DLRM on (2, 2).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", range(DLRM_STEPS))
def test_sharded_dlrm_losses_match_jax(four_ranks, step):
    jx, by_rank, _, _ = four_ranks
    want = float(jx[f"dlrm/{step}/loss"])
    for res in by_rank:
        grads_loss, step_loss = res[f"dlrm/{step}/loss"]
        np.testing.assert_allclose([grads_loss, step_loss], [want, want],
                                   rtol=TOL)


@pytest.mark.parametrize("what", ["grad", "param"])
@pytest.mark.parametrize("step", range(DLRM_STEPS))
def test_sharded_dlrm_shards_match_jax(four_ranks, step, what):
    """Every rank's gradients (before the step) and parameters (after it):
    its table shard against its rows of JAX's, the MLPs whole."""
    jx, by_rank, _, _ = four_ranks
    want = _jax_tree(jx, f"dlrm/{step}/{what}")
    for r, res in enumerate(by_rank):
        lo, hi = res["dlrm/rows"]
        got = _jax_tree(res, f"dlrm/{step}/{what}")
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            _close(got[name], w[:, lo:hi] if name == "emb" else w,
                   f"rank {r} {what} {name}")


def test_sharded_dlrm_drops_ids_no_shard_owns(four_ranks):
    """The batches hold ids outside [0, R): JAX's row-sharded gradient
    differs from the dense lookup's (which clamps and wraps them), so the
    ranks' agreement above covers the dropped ids."""
    jx, _, _, work = four_ranks
    data = np.load(work / "inputs.npz")
    cfg = ranks.dlrm_cfg()
    params = ranks.tree_from(data, "dlrm/init", D.init_dlrm(cfg,
                                                            device="cpu"))
    emb = params["emb"].requires_grad_(True)
    batch = {k: torch.from_numpy(data[f"dlrm/0/{k}"])
             for k in ("dense", "sparse", "label")}
    loss = D.dlrm_loss({**params, "emb": emb}, cfg, batch["dense"],
                       batch["sparse"], batch["label"])
    (dense_grad,) = torch.autograd.grad(loss, [emb])
    sharded = jx["dlrm/0/grad/emb"]  # two microbatches: the same mean
    assert float(np.abs(dense_grad.numpy() - sharded).max()) > 100 * TOL


# ---------------------------------------------------------------------------
# int8 with error feedback.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("leaf", range(len(CMP_SHAPES)))
def test_compress_and_psum_int8_match_jax(four_ranks, leaf):
    """Codes and errors bit-equal, scales within 1 ulp, the all-reduced
    sums within 1e-6 of each rank's."""
    jx, by_rank, _, _ = four_ranks
    for r, res in enumerate(by_rank):
        np.testing.assert_array_equal(res[f"cmp/q{leaf}"],
                                      jx[f"cmp/q{leaf}"][r])
        np.testing.assert_array_equal(res[f"cmp/e{leaf}"],
                                      jx[f"cmp/e{leaf}"][r])
        ulps = abs(int(res[f"cmp/s{leaf}"].view(np.int32))
                   - int(jx[f"cmp/s{leaf}"][r].view(np.int32)))
        assert ulps <= 1
        np.testing.assert_allclose(res[f"cmp/sum{leaf}"],
                                   jx[f"cmp/sum{leaf}"][r], rtol=1e-6,
                                   atol=1e-6)


def test_int8_ef_launcher_matches_jax(four_ranks):
    """``--grad-compression int8_ef`` over four ranks: every rank's losses
    and the parameters rank 0 checkpointed, against JAX's two steps."""
    jx, by_rank, _, work = four_ranks
    for res in by_rank:
        np.testing.assert_allclose(res["int8/losses"], jx["int8/loss"],
                                   rtol=TOL)
    _assert_checkpoint(work / "int8", "int8", jx, LAUNCH["int8"]["steps"])
    out = str(by_rank[0]["int8/stdout"])
    assert "mesh: {'data': 4, 'model': 1} devices=4" in out
    assert "--microbatches 2 does not apply" in out


def _assert_checkpoint(path, key, jx, step):
    arch = LAUNCH[key]["arch"]
    cfg = get_config(arch).reduced()
    like = T.init_lm(cfg, device="cpu")
    opt = init_opt(OptConfig(lr=LR), list(like.parameters()))
    tree, got_step = ckpt.restore(str(path), {"params": like,
                                              "opt": opt.state_dict()})
    assert got_step == step
    want = _jax_tree(jx, f"{key}/param")
    got = dict(named_leaves(tree["params"]))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        _close(got[name].numpy(), w, f"{key} {name}")


# ---------------------------------------------------------------------------
# The MoE over four data ranks.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ranks.MOE_MODES)
def test_moe_dispatch_over_data_ranks_matches_jax(four_ranks, mode):
    """Outputs (gathered over data), aux, and the router's and experts'
    gradients meaned over the ranks: with an identity backward on the aux
    statistics the router's aux gradient would be 4 times too small."""
    _, by_rank, moe, _ = four_ranks
    out, aux, grads = moe[mode]
    for r, res in enumerate(by_rank):
        _close(res[f"moe/{mode}/out"], out, f"rank {r} out")
        np.testing.assert_allclose(res[f"moe/{mode}/aux"], aux, rtol=TOL)
        for k, g in grads.items():
            _close(res[f"moe/{mode}/grad/{k}"], g, f"rank {r} d{k}")


def test_moe_case_tells_the_dispatches_apart(four_ranks):
    """The capacity drops tokens, and the global and data-local
    dispatches differ in output and aux: the test above could not pass
    with the one dispatch in place of the other."""
    _, _, moe, _ = four_ranks
    (g_out, g_aux, _), (l_out, l_aux, _) = moe["global"], moe["local"]
    assert float(np.abs(g_out - l_out).max()) > 1e-2
    assert abs(g_aux - l_aux) > 1e-4


# ---------------------------------------------------------------------------
# The launcher over a (2, 2) mesh, and its resume on two ranks.
# ---------------------------------------------------------------------------

def test_model_parallel_launcher_matches_jax_loop(four_ranks):
    jx, by_rank, _, work = four_ranks
    for res in by_rank:
        np.testing.assert_allclose(res["plain/losses"], jx["plain/loss"],
                                   rtol=TOL)
    _assert_checkpoint(work / "plain", "plain", jx,
                       LAUNCH["plain"]["steps"])
    out = str(by_rank[0]["plain/stdout"])
    assert "mesh: {'data': 2, 'model': 2} devices=4" in out
    assert f"restored step 0 from {work / 'plain'}" in out


def test_resume_on_fewer_ranks_matches_jax_loop(four_ranks):
    """Ranks 0 and 1 restart from the four ranks' step-2 checkpoint:
    ``ElasticMesh(2)`` re-factors the mesh to (1, 2), the global batch of
    step 2 is the same, and the loss and parameters are JAX's."""
    jx, by_rank, _, work = four_ranks
    for res in by_rank[:2]:
        np.testing.assert_allclose(res["resume/losses"], jx["plain/loss"][2:],
                                   rtol=TOL)
    assert "resume/losses" not in by_rank[2]
    out = str(by_rank[0]["resume/stdout"])
    assert "mesh: {'data': 1, 'model': 2} devices=2" in out
    assert f"restored step 2 from {work / 'resume'}" in out
    _assert_checkpoint(work / "resume", "plain", jx,
                       LAUNCH["plain"]["steps"])


def test_only_rank_0_writes_and_prints(four_ranks):
    _, by_rank, _, work = four_ranks
    for key in ("plain", "int8"):
        for res in by_rank[1:]:
            assert str(res[f"{key}/stdout"]) == ""
        assert (work / key / "heartbeat.json").exists()
        steps = sorted(p.name for p in (work / key).iterdir()
                       if p.name.startswith("step_"))
        assert not any(s.endswith(".tmp") for s in steps)
    assert sorted(p.name for p in (work / "plain").glob("step_*")) == [
        "step_00000000", "step_00000002", "step_00000003"]


# ---------------------------------------------------------------------------
# One process: the shard window's backward, the step's layout, the
# collectives and the paths without a process group.
# ---------------------------------------------------------------------------

def _window_inputs(dtype, seed=6):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(23, 5)).astype(np.float32)) \
        .to(dtype)
    idx = rng.integers(-3, 23, (9, 4)).astype(np.int32)
    idx[2] = -1  # a row whose ids this shard owns none of
    dout = rng.normal(size=(9, 5)).astype(np.float32)
    return table, idx, dout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_backward_matches_a_numpy_loop(dtype):
    table, idx, dout = _window_inputs(dtype)
    want = np.zeros((23, 5), np.float32)
    for b in range(9):
        for p in range(4):
            if idx[b, p] >= 0:
                want[idx[b, p]] += dout[b]
    t = table.clone().requires_grad_(True)
    out = ops.gather_pool_shard(t, torch.from_numpy(idx))
    np.testing.assert_array_equal(
        out.detach().numpy(), ops.gather_pool_shard(
            table, torch.from_numpy(idx)).numpy())
    (grad,) = torch.autograd.grad(out, [t], torch.from_numpy(dout))
    assert grad.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(grad.float().numpy(), want, rtol=tol,
                               atol=tol)


def test_window_backward_adds_no_foreign_row_into_row_0():
    """Every id is -1 but one: clamping -1 to row 0 would give row 0 the
    whole pooled gradient of every row."""
    table = torch.ones((4, 3), requires_grad=True)
    idx = torch.tensor([[-1, -1], [-1, 2]], dtype=torch.int32)
    out = ops.gather_pool_shard(table, idx)
    (grad,) = torch.autograd.grad(out.sum(), [table])
    assert grad.tolist() == [[0.0] * 3, [0.0] * 3, [1.0] * 3, [0.0] * 3]


def test_window_backward_in_range_is_gather_pools_bit_for_bit():
    table, idx, dout = _window_inputs(torch.float32)
    idx = torch.from_numpy(np.abs(idx))
    grads = []
    for fn in (ops.gather_pool, ops.gather_pool_shard):
        t = table.clone().requires_grad_(True)
        grads += torch.autograd.grad(fn(t, idx), [t],
                                     torch.from_numpy(dout))
    assert torch.equal(grads[0], grads[1])


def test_microbatch_shard_cuts_the_microbatches_first():
    """Rank r's rows of microbatch i are ``i B/mb + r B/(mb n) ...``: with B
    = 8, 2 microbatches and 2 data ranks, rank 1 holds rows 2-3 and 6-7."""
    x = torch.arange(8)
    mesh = M.Mesh(data=2, model=2, rank=3)
    assert [M.microbatch_shard(x, 2, i, mesh).tolist() for i in (0, 1)] \
        == [[2, 3], [6, 7]]
    assert M.microbatch_shard(x, 2, 1).tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="microbatches"):
        M.microbatch_shard(x, 3, 0, mesh)


@pytest.mark.parametrize("n,variant,want", [
    (8, "fsdp_tp", [[4, 5, 6, 7], [4, 5, 6, 7]]),
    (1, "fsdp_tp", [[0], [0]]),  # replicated over data
    (2, "fsdp", [[1], [1]]),  # over data, replicated over model
    (4, "fsdp", [[2], [3]]),  # over both axes
    (3, "fsdp", [[0, 1, 2], [0, 1, 2]]),
])
def test_batch_shard_takes_the_fitted_rows(n, variant, want):
    """Ranks (1, 0) and (1, 1) of a (2, 2) mesh: their rows by JAX's fitted
    batch spec, the whole batch over an axis that does not divide it; a
    microbatch that one data rank cannot split is whole on both."""
    x = torch.arange(n)
    got = [M.batch_shard(x, M.Mesh(2, 2, r), variant).tolist()
           for r in (2, 3)]
    assert got == want
    mesh = M.Mesh(2, 2, 3)
    assert [M.microbatch_shard(torch.arange(2), 2, i, mesh).tolist()
            for i in (0, 1)] == [[0], [1]]


def test_seq_split_drops_what_model_does_not_divide():
    """Inside an fsdp_seq scope on a (2, 2) mesh, 16 positions split at
    offset 8 on model rank 1 with the rows' axes of the scope; 15 are not
    split (None), as JAX's ``fit_spec`` drops the entry."""
    mesh = M.Mesh(2, 2, 3)
    with M.activation_sharding(mesh, "fsdp_seq"):
        assert M.seq_split(15) is None
        sp = M.seq_split(16)
        assert (sp.offset, sp.length, sp.rows) == (8, 8, ("data",))
        assert M.token_axes() == ("data", "model")
    with M.activation_sharding(mesh, "fsdp_seq", rows=()):
        assert M.seq_split(16).rows == () and M.token_axes() == ("model",)
    with M.activation_sharding(mesh, "fsdp", split_seq=False,
                               rows=("data",)):
        bm = M.batch_mesh(mesh)
        assert (bm.data, bm.model, bm.data_rank) == (2, 1, 1)
        assert M.token_axes() == ("data",)
    assert M.row_axes() == () and M.batch_mesh(mesh, ()).data == 1


@pytest.mark.parametrize("axes,want", [
    (("data", "model"), ("W",)), (("model", "data"), ("W",)),
    (("data",), ("D",)), (("model",), ("Mo",)), ((), ())])
def test_mesh_groups_cover_the_axes(axes, want):
    """One group whose all-reduce covers the axes (the world for both),
    from any iterable of them, a generator included; axes_group's size and
    index in JAX's order of a tuple of axes."""
    mesh = M.Mesh(2, 2, 3, "D", "Mo", "W")
    assert mesh.groups(a for a in axes) == want
    assert mesh.groups(list(axes)) == want
    order = tuple(a for a in ("data", "model") if a in axes)
    assert mesh.axes_group(order)[1:] == {
        (): (1, 0), ("data",): (2, 1), ("model",): (2, 1),
        ("data", "model"): (4, 3)}[order]


def test_collectives_without_a_group_are_the_identity():
    x = torch.randn(3, requires_grad=True)
    for fn in (C.all_reduce_identity_bwd, C.all_reduce_sum_bwd):
        assert fn(x, None) is x


@pytest.mark.parametrize("sharded", [False, True])
def test_one_process_mesh_step_is_the_unsharded_step_bit_for_bit(sharded):
    """A (1, 1) mesh outside a process group reduces nothing, and its one
    rank owns every row: with ids in range, the sharded step gives the
    bits of the step without a mesh."""
    cfg = ranks.dlrm_cfg()
    rng = np.random.default_rng(8)
    batch = {"dense": rng.normal(size=(8, cfg.dense_features)).astype(
                 np.float32),
             "sparse": rng.integers(0, cfg.rows_per_table,
                                    (8, cfg.n_tables, cfg.multi_hot)).astype(
                 np.int32),
             "label": (rng.random(8) < 0.5).astype(np.float32)}
    out = []
    for mesh, run in ((None, RunConfig(remat="none")),
                      (M.make_host_mesh(), RunConfig(
                          remat="none", dlrm_sharded_lookup=sharded))):
        params = D.init_dlrm(cfg, seed=1, device="cpu")
        opt = init_opt(OptConfig(lr=LR), [p for _, p in
                                          named_leaves(params)])
        bundle = build(cfg, device="cpu", run=run)
        loss, grads = make_grads_fn(bundle, 2, mesh)(params, batch)
        m = make_train_step(bundle, 2, mesh)(params, opt, batch)
        out.append((loss, grads, m["loss"], named_leaves(params)))
    (l0, g0, s0, p0), (l1, g1, s1, p1) = out
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(p0, p1))


def test_compressed_grads_on_one_rank_are_dequant_of_quant():
    """One data rank: the reduced gradient is ``dequant(quant(g + err))``
    and the new error what that drops."""
    cfg = ranks.dlrm_cfg()
    params = D.init_dlrm(cfg, seed=2, device="cpu")
    bundle = build(cfg, device="cpu", run=RunConfig(remat="none"))
    rng = np.random.default_rng(9)
    batch = {"dense": torch.from_numpy(rng.normal(
                 size=(4, cfg.dense_features)).astype(np.float32)),
             "sparse": torch.from_numpy(rng.integers(
                 0, cfg.rows_per_table, (4, cfg.n_tables, cfg.multi_hot))
                 .astype(np.int32)),
             "label": torch.from_numpy((rng.random(4) < 0.5).astype(
                 np.float32))}
    err = [0.01 * torch.randn(p.shape) for p in init_error(params)]
    loss, grads, new_err = make_compressed_dp_grads(
        bundle.loss, M.make_host_mesh())(params, err, batch)
    plain, want = make_grads_fn(bundle)(params, batch)
    assert torch.equal(loss, plain)
    for g, w, e, e2 in zip(grads, want, err, new_err):
        deq = dequantize_int8(*quantize_int8(w + e))
        assert torch.equal(g, deq)
        assert torch.equal(e2, (w + e) - deq)


def test_adamw_updates_a_large_leaf_a_chunk_at_a_time_with_the_same_bits(
        monkeypatch):
    """The chunked update of a leaf larger than ``CHUNK`` (the DLRM top
    MLP's 376 M weights on the ranks) gives the whole-leaf update's bits,
    with bf16 moments and an fp32 master copy too."""
    from repro_torch.optim import adamw

    for kw in ({}, dict(moment_dtype="bfloat16", master_fp32=True)):
        out = []
        for chunk in (1 << 26, 7):
            monkeypatch.setattr(adamw, "CHUNK", chunk)
            torch.manual_seed(0)
            p = torch.randn(5, 9).to(torch.bfloat16)
            opt = init_opt(OptConfig(lr=1e-2, **kw), [p])
            for _ in range(3):
                opt.apply([torch.randn(5, 9)])
            out.append((p.clone(), [t.clone() for t in
                                    opt.state_dict()["v"]]))
        assert torch.equal(out[0][0], out[1][0])
        assert torch.equal(out[0][1][0], out[1][1][0])


def test_run_config_names_its_grad_compression():
    assert RunConfig(grad_compression="int8_ef").grad_compression == \
        "int8_ef"
    assert not RunConfig().moe_local_dispatch
    with pytest.raises(ValueError, match="int8_ef"):
        RunConfig(grad_compression="fp8")
