"""The port's sharded training (JAX's ``param_pspecs`` layouts) against
the JAX package's, on the CPU.

JAX runs in one subprocess of its own with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(``tests/jax_sharded_train_ref.py``): ``make_train_step`` jitted with the
parameter and AdamW shardings of each variant on a mesh of the four
devices.  The port runs as four ``gloo`` processes on a ``file://`` store
(``tests/torch_sharded_train_ranks.py``), each holding its shard of every
leaf (``shard_model``) and training under ``remat="full"``.  Both start
from JAX's ``init_lm(PRNGKey(0))`` and train two steps of two
microbatches over ``batch_at``'s batches, for reduced qwen2.5-3b (GQA
4/2 with qkv bias: whole heads at model 2, half a kv head a rank at model
4, so the attention is gathered there), smollm-135m (tied embeddings:
the vocab-parallel head is the embedding's shard) and granite-moe
(tensor-parallel experts, global dispatch), under ``fsdp_tp`` at (2, 2),
(1, 4) and (4, 1) and ``tp`` and ``fsdp`` at (2, 2) (``fsdp`` splits the
batch over all four ranks), and qwen under ``dp``.

Held: each step's loss and grad norm, and each rank's shard of every
parameter and of both moments against the JAX device at the same mesh
position, within 1e-5 of each leaf's largest magnitude (or 1).  AdamW's
``clip_norm`` is 1.0 and every step's norm is above it, so every step
clips by the whole gradient's norm (summed over the shards).  ``dp``
gives the bits of the step of a model built without the mesh.  A
checkpoint written at (2, 2) resumes at (1, 4) and on one rank with the
unbroken run's third loss and parameters.  The families whose layers
are gathered whole (the SSM, the hybrid, whisper) train on (2, 2) as on
one rank, within the same 1e-5.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch.multiprocessing as mp

import torch_sharded_train_ranks as ranks
from jax_dist_train_ref import named
from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
ARCHS = ("qwen2.5-3b", "smollm-135m", "granite-moe-1b-a400m")
LAYOUTS = (("fsdp_tp", 2, 2), ("fsdp_tp", 1, 4), ("fsdp_tp", 4, 1),
           ("tp", 2, 2), ("fsdp", 2, 2))
CASES = tuple(f"{a}|{s}|{d}|{m}" for a in ARCHS for s, d, m in LAYOUTS) \
    + (f"{ARCHS[0]}|dp|2|2",)
SETTINGS = dict(lr=1e-3, steps=2, microbatches=2, seq=16, batch=8)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(JAX's results, every rank's results)``; JAX's subprocess runs
    while the ranks do."""
    work = tmp_path_factory.mktemp("sharded_train")
    data = {"cases": np.array(CASES)}
    data.update({k: np.array(v) for k, v in SETTINGS.items()})
    for arch in ARCHS:
        tree = JT.init_lm(jax.random.PRNGKey(0),
                          jax_get_config(arch).reduced())
        data.update({f"init/{arch}/{k}": v for k, v in named(tree).items()})
    np.savez(work / "inputs.npz", **data)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "jax_sharded_train_ref.py"),
         str(work / "inputs.npz"), str(work / "jax.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    mp.spawn(ranks.rank_main, args=(4, str(work)), nprocs=4, join=True)
    log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log
    return (dict(np.load(work / "jax.npz")),
            [dict(np.load(work / f"rank{r}.npz")) for r in range(4)])


def _close(got, want, what, tol=TOL):
    bound = tol * max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max abs err {err} > {bound}"


@pytest.mark.parametrize("case", CASES)
def test_losses_and_norms_match_jax(runs, case):
    jx, by_rank = runs
    assert (jx[f"{case}/grad_norm"] > 1.0).all()  # every step clips
    for res in by_rank:
        np.testing.assert_allclose(res[f"{case}/loss"], jx[f"{case}/loss"],
                                   rtol=TOL)
        np.testing.assert_allclose(res[f"{case}/grad_norm"],
                                   jx[f"{case}/grad_norm"], rtol=TOL)


@pytest.mark.parametrize("what", ["param", "m", "v"])
@pytest.mark.parametrize("case", CASES)
def test_every_shard_matches_the_jax_device_at_its_position(runs, case,
                                                            what):
    jx, by_rank = runs
    for r, res in enumerate(by_rank):
        want = {k.split("/", 3)[3]: v for k, v in jx.items()
                if k.startswith(f"{case}/{what}/r{r}/")}
        got = {k.split("/", 2)[2]: v for k, v in res.items()
               if k.startswith(f"{case}/{what}/")}
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            _close(got[name], w, f"rank {r} {what} {name}")


def test_layouts_shard_what_the_rules_say(runs):
    """At (2, 2) under fsdp_tp qwen's projections into heads lie on model
    by columns and on data by rows, and the embedding's vocab on model; at
    (1, 4) wk's 32 columns leave each rank half a kv head (so the
    attention is gathered); under fsdp granite's experts split their
    widest dim over every rank."""
    _, by_rank = runs
    specs = eval(str(by_rank[0][f"{ARCHS[0]}|fsdp_tp|2|2/specs"]))
    assert specs["blocks.0.attn.wq"] == ("data", "model")
    assert specs["blocks.0.attn.wo"] == ("model", "data")
    assert specs["embed"] == ("model", "data")
    assert specs["blocks.0.ln1"] == ()
    q14 = by_rank[0][f"{ARCHS[0]}|fsdp_tp|1|4/param/blocks.0.attn.wk"]
    assert q14.shape == (64, 8)
    fsdp = eval(str(by_rank[0][f"{ARCHS[2]}|fsdp|2|2/specs"]))
    assert fsdp["blocks.0.moe.w1"] == (None, None, ("data", "model"))


def test_dp_is_the_unsharded_step_bit_for_bit(runs):
    _, by_rank = runs
    for res in by_rank:
        assert bool(res["dp/untagged"]) and bool(res["dp/bit_equal"])


def test_checkpoint_moves_between_meshes_and_to_one_rank(runs):
    """Written at (2, 2) after two steps: the third step resumed at (1, 4)
    on four ranks and on one rank gives the unbroken run's loss and
    parameters."""
    _, by_rank = runs
    want = float(by_rank[0]["ckpt/loss"])
    for res in by_rank:
        assert int(res["ckpt/start_14"]) == ranks.CKPT_STEPS - 1
        np.testing.assert_allclose(float(res["ckpt/loss_14"]), want,
                                   rtol=TOL)
        assert float(res["ckpt/param_err_14"]) <= TOL
    np.testing.assert_allclose(float(by_rank[0]["ckpt/loss_11"]), want,
                               rtol=TOL)
    assert float(by_rank[0]["ckpt/param_err_11"]) <= TOL


@pytest.mark.parametrize("arch", ranks.GATHERED)
def test_gathered_families_match_one_rank(runs, arch):
    _, by_rank = runs
    for res in by_rank:
        (whole, sharded) = res[f"gathered/{arch}/loss"]
        np.testing.assert_allclose(sharded, whole, rtol=TOL)
        assert int(res[f"gathered/{arch}/sharded_leaves"]) > 0
        assert float(res[f"gathered/{arch}/param_err"]) <= TOL
