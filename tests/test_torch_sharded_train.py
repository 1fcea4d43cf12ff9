"""The port's sharded training (JAX's ``param_pspecs`` layouts) against
the JAX package's, on the CPU.

JAX runs in two subprocesses of its own, each with half the cases and
``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(``tests/jax_sharded_train_ref.py``): ``make_train_step`` jitted with the
parameter and AdamW shardings of each variant on a mesh of the four
devices.  The port runs as four ``gloo`` processes on a ``file://`` store
(``tests/torch_sharded_train_ranks.py``), each holding its shard of every
leaf (``shard_model``) and training under ``remat="full"``.  Both start
from JAX's ``build(cfg).init(PRNGKey(0))`` and train two steps of two
microbatches over ``batch_at``'s batches, for reduced qwen2.5-3b (GQA
4/2 with qkv bias: whole heads at model 2, half a kv head a rank at model
4, so the attention is gathered there), smollm-135m (tied embeddings:
the vocab-parallel head is the embedding's shard) and granite-moe
(tensor-parallel experts, global dispatch), under ``fsdp_tp`` at (2, 2),
(1, 4) and (4, 1) and ``tp`` and ``fsdp`` at (2, 2) (``fsdp`` splits the
batch over all four ranks), and qwen under ``dp``; and for reduced
falcon-mamba-7b (channel-parallel mamba blocks, Di 128 over 2 or 4),
hymba-1.5b (its 4/2 heads tensor parallel at model 2 and gathered at
model 4, its mamba channel parallel at both) and whisper-large-v3
(tensor-parallel self-attention, cross-attention and GELU MLP; seeded
audio frames) under ``fsdp_tp`` at (2, 2) and (1, 4).  Reduced fp32
DLRM trains with its tables under ``emb_rows="all"`` (rows over both
axes) on (2, 2), through the row-sharded lookup (ids out of range
dropped) and the dense one (wrapped and clamped), ids over [-2, R + 2).
Under ``fsdp_seq`` (every leaf FSDP over both axes) both sides train
inside ``activation_sharding(mesh, "fsdp_seq")``, which splits the
sequence: the three archs on (2, 2) and (1, 4), and falcon-mamba-7b,
hymba-1.5b, whisper-large-v3 and internvl2-26b (on text) on (2, 2), each
rank its S/model positions at offset ``m S/model`` (the attention's K/V
and the mamba block's input gathered over ``model``, whisper's frames
split and its encoder output gathered, the MoE's dispatch over every
rank's tokens, the loss the mean over every rank's tokens).  Shapes an
axis does not divide (``ranks.FIT_CASES``, JAX's ``fit_spec``
replicating them): a microbatch of one row on data 2 under ``fsdp_tp``,
two rows over four ranks under ``fsdp``, 15 positions inside the
``fsdp_seq`` scope (no split), and granite's ``moe_local_dispatch``
under the split (two shards, one a data rank's rows, or the halves of
one replicated row), beside it (a microbatch of one row, replicated over
data) and where its two shards do not divide the tokens (JAX's fallback
to the global dispatch); two of them in bf16 (JAX's parameters cast,
held within 2e-2 as the fp32 cases within 1e-5).  DLRM also trains under ``fsdp`` (the batch
over both axes), both lookups.

Held: each step's loss and grad norm, and each rank's shard of every
parameter and of both moments against the JAX device at the same mesh
position, within 1e-5 of each leaf's largest magnitude (or 1).  AdamW's
``clip_norm`` is 1.0 and every LM step's norm is above it, so every step
clips by the whole gradient's norm (summed over the shards).  No mamba
leaf and no whisper attention, cross-attention or MLP leaf is gathered
over ``model``, and DLRM's table gradient is not all-reduced.  ``dp``
gives the bits of the step of a model built without the mesh, and DLRM
under ``emb_rows="model"`` those of the row-sharded training set up
without it.  Checkpoints written at (2, 2) (qwen; DLRM under
``emb_rows="all"``) resume at (1, 4) and on one rank with the unbroken
run's third loss and parameters.  The SSM, the hybrid and whisper train
on (2, 2) as on one rank, within the same 1e-5.
"""
import os
import re
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
from repro.models import model_api as JMA

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
TOL_BF16 = 2e-2
ARCHS = ("qwen2.5-3b", "smollm-135m", "granite-moe-1b-a400m")
LAYOUTS = (("fsdp_tp", 2, 2), ("fsdp_tp", 1, 4), ("fsdp_tp", 4, 1),
           ("tp", 2, 2), ("fsdp", 2, 2))
TP_LAYOUTS = (("fsdp_tp", 2, 2), ("fsdp_tp", 1, 4))
# The sequence split under a gradient (fsdp_seq inside its scope): the
# three archs on (2, 2) and (1, 4), every other family on (2, 2).
SEQ_LAYOUTS = (("fsdp_seq", 2, 2), ("fsdp_seq", 1, 4))
SEQ_FAMILIES = ranks.TP_FAMILIES + ("internvl2-26b",)
CASES = tuple(f"{a}|{s}|{d}|{m}" for a in ARCHS for s, d, m in LAYOUTS) \
    + (f"{ARCHS[0]}|dp|2|2",) \
    + tuple(f"{a}|{s}|{d}|{m}" for a in ranks.TP_FAMILIES
            for s, d, m in TP_LAYOUTS) \
    + tuple(f"{a}|{s}|{d}|{m}" for a in ARCHS for s, d, m in SEQ_LAYOUTS) \
    + tuple(f"{a}|fsdp_seq|2|2" for a in SEQ_FAMILIES) \
    + ranks.FIT_CASES
DLRM_CASES = tuple(f"{ranks.DLRM}|{s}|2|2|{lookup}"
                   for s in ("fsdp_tp", "fsdp")
                   for lookup in ("sharded", "dense"))
SETTINGS = dict(lr=1e-3, steps=2, microbatches=2, seq=16, batch=8)
DLRM_B = 8
# JAX's cases split over this many subprocesses, which compile in
# parallel with each other and with the ranks.
JAX_PROCS = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(JAX's results, every rank's results)``; JAX's subprocesses run
    while the ranks do."""
    work = tmp_path_factory.mktemp("sharded_train")
    data = {"cases": np.array(CASES), "dlrm_cases": np.array(DLRM_CASES)}
    data.update({k: np.array(v) for k, v in SETTINGS.items()})
    rng = np.random.default_rng(31)
    for arch in ARCHS + SEQ_FAMILIES + (ranks.DLRM,):
        cfg = jax_get_config(arch).reduced()
        tree = JMA.build(cfg).init(jax.random.PRNGKey(0))
        data.update({f"init/{arch}/{k}": v for k, v in named(tree).items()})
        if cfg.enc_dec:
            for s in range(SETTINGS["steps"]):
                data[f"frames/{arch}/{s}"] = rng.normal(size=(
                    SETTINGS["batch"], cfg.enc_len, cfg.d_model)).astype(
                        np.float32)
    cfg = jax_get_config(ranks.DLRM).reduced()
    for s in range(ranks.CKPT_STEPS):
        data[f"dlrm/{s}/dense"] = rng.normal(
            size=(DLRM_B, cfg.dense_features)).astype(np.float32)
        data[f"dlrm/{s}/sparse"] = rng.integers(
            -2, cfg.rows_per_table + 2,
            (DLRM_B, cfg.n_tables, cfg.multi_hot)).astype(np.int32)
        data[f"dlrm/{s}/label"] = (rng.random(DLRM_B) < 0.5).astype(
            np.float32)
    np.savez(work / "inputs.npz", **data)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "jax_sharded_train_ref.py"),
         str(work / "inputs.npz"), str(work / f"jax{i}.npz"),
         f"{i}/{JAX_PROCS}"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(JAX_PROCS)]
    mp.spawn(ranks.rank_main, args=(4, str(work)), nprocs=4, join=True)
    jx = {}
    for i, proc in enumerate(procs):
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, log
        jx.update(np.load(work / f"jax{i}.npz"))
    return jx, [dict(np.load(work / f"rank{r}.npz")) for r in range(4)]


def _close(got, want, what, tol=TOL):
    bound = tol * max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max abs err {err} > {bound}"


@pytest.mark.parametrize("case", CASES)
def test_losses_and_norms_match_jax(runs, case):
    jx, by_rank = runs
    assert (jx[f"{case}/grad_norm"] > 1.0).all()  # every step clips
    if "|fsdp_seq|" in case:  # the ranks trained their positions only
        nm = int(case.split("|")[3])
        s = ranks.case_opts(case).get("S", SETTINGS["seq"])
        for res in by_rank:  # all of them where model does not divide S
            assert res[f"{case}/seq_rows"].tolist() == [
                s if s % nm else s // nm]
    tol = TOL_BF16 if "bf16" in ranks.case_opts(case) else TOL
    for res in by_rank:
        np.testing.assert_allclose(res[f"{case}/loss"], jx[f"{case}/loss"],
                                   rtol=tol)
        np.testing.assert_allclose(res[f"{case}/grad_norm"],
                                   jx[f"{case}/grad_norm"], rtol=tol)


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
            _close(got[name], w, f"rank {r} {what} {name}",
                   TOL_BF16 if "bf16" in ranks.case_opts(case) else TOL)


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


@pytest.mark.parametrize("arch", ranks.TP_FAMILIES)
def test_gathered_families_match_one_rank(runs, arch):
    """The SSM, the hybrid and whisper, whose layers were gathered whole
    and now compute tensor parallel, train on (2, 2) as on one rank."""
    _, by_rank = runs
    for res in by_rank:
        (whole, sharded) = res[f"tp_family/{arch}/loss"]
        np.testing.assert_allclose(sharded, whole, rtol=TOL)
        assert int(res[f"tp_family/{arch}/sharded_leaves"]) > 0
        assert float(res[f"tp_family/{arch}/param_err"]) <= TOL


# Leaves that JAX's rules put on ``model`` and that the tensor-parallel
# layers compute on the rank's part.
_TP_LEAF = re.compile(r"\.(ssm\.\w+|(attn|xattn)\.w[qkvo]|mlp\.w[12])$")


@pytest.mark.parametrize("case", [c for c in CASES
                                  if c.split("|")[0] in ranks.TP_FAMILIES
                                  and c.split("|")[1] == "fsdp_tp"])
def test_tp_layers_gather_nothing_over_model(runs, case):
    """No mamba leaf and no whisper attention, cross-attention or MLP
    leaf is gathered over ``model``: they lie there (the specs) and the
    layers compute on the rank's part.  Only hymba's attention at model 4
    (2 kv heads) is gathered."""
    _, by_rank = runs
    arch, _, _, nm = case.split("|")
    for res in by_rank:
        specs = eval(str(res[f"{case}/specs"]))
        on_model = sorted(n for n, s in specs.items() if _TP_LEAF.search(n)
                          and any("model" in (e if isinstance(e, tuple)
                                              else (e,)) for e in s))
        assert on_model, case
        gathered = eval(str(res[f"{case}/model_gathered"]))
        if arch == "hymba-1.5b" and nm == "4":
            assert gathered and all(".attn." in n for n in gathered)
        else:
            assert not gathered, (case, gathered)


def _dlrm_shards(jx, res, case, what, r):
    want = {k.split("/", 3)[3]: v for k, v in jx.items()
            if k.startswith(f"{case}/{what}/r{r}/")}
    got = {k.split("/", 2)[2]: v for k, v in res.items()
           if k.startswith(f"{case}/{what}/")}
    return got, want


@pytest.mark.parametrize("case", DLRM_CASES)
def test_dlrm_rows_over_both_axes_match_jax(runs, case):
    """Losses, grad norms and every rank's shard of the tables, the MLPs
    and both moments against the JAX device at its position; the table's
    spec is rows over ("data", "model") and its gradient is never
    all-reduced (its shape is not among the step's all-reduces)."""
    jx, by_rank = runs
    for r, res in enumerate(by_rank):
        np.testing.assert_allclose(res[f"{case}/loss"], jx[f"{case}/loss"],
                                   rtol=TOL)
        np.testing.assert_allclose(res[f"{case}/grad_norm"],
                                   jx[f"{case}/grad_norm"], rtol=TOL)
        for what in ("param", "m", "v"):
            got, want = _dlrm_shards(jx, res, case, what, r)
            assert sorted(got) == sorted(want)
            for name, w in want.items():
                _close(got[name], w, f"rank {r} {what} {name}")
        assert eval(str(res[f"{case}/specs"]))["emb"] == (
            None, ("data", "model"))
        emb = res[f"{case}/param/emb"].shape
        assert emb[1] * 4 == 256
        assert emb not in eval(str(res[f"{case}/reduced"]))


def test_dlrm_lookups_differ_on_ids_out_of_range(runs):
    """The two lookups give other losses: the batches' ids out of [0, R)
    are dropped by one and wrapped or clamped by the other."""
    jx, _ = runs
    for i in range(0, len(DLRM_CASES), 2):
        a, b = (jx[f"{c}/loss"] for c in DLRM_CASES[i:i + 2])
        assert float(np.abs(a - b).max()) > 100 * TOL


def test_dlrm_emb_rows_model_is_the_row_sharded_training(runs):
    """``emb_rows="model"`` is the row-sharded training's layout and
    arithmetic, bit for bit; the grad norm is the whole gradient's, the
    same on every rank (above 1 at the second step, which clips)."""
    _, by_rank = runs
    norms = by_rank[0]["dlrm_model/grad_norm"]
    assert norms[1] > 1.0
    for res in by_rank:
        assert eval(str(res["dlrm_model/spec"])) == (None, "model")
        assert bool(res["dlrm_model/bit_equal"])
        np.testing.assert_array_equal(res["dlrm_model/grad_norm"], norms)


def test_dlrm_checkpoint_moves_between_meshes_and_to_one_rank(runs):
    _, by_rank = runs
    want = float(by_rank[0]["dlrm_ckpt/loss"])
    for res in by_rank:
        assert int(res["dlrm_ckpt/start_14"]) == ranks.CKPT_STEPS - 1
        np.testing.assert_allclose(float(res["dlrm_ckpt/loss_14"]), want,
                                   rtol=TOL)
        assert float(res["dlrm_ckpt/param_err_14"]) <= TOL
    np.testing.assert_allclose(float(by_rank[0]["dlrm_ckpt/loss_11"]), want,
                               rtol=TOL)
    assert float(by_rank[0]["dlrm_ckpt/param_err_11"]) <= TOL
