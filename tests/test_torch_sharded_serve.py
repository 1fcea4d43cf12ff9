"""The port's LMs served over a mesh (each rank's shards, JAX's batch and
cache layouts) against the JAX package's, on the CPU.

JAX runs in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(``tests/jax_sharded_serve_ref.py``): ``bundle.prefill`` and
``bundle.decode`` jitted with ``param_pspecs``, ``batch_pspecs`` and
``cache_pspecs`` shardings under ``activation_sharding(mesh, variant)``,
as ``launch/dryrun.py:104-122`` lowers them, on a mesh of the four
devices.  The port runs as four ``gloo`` processes on a ``file://`` store
(``tests/torch_sharded_serve_ranks.py``), each serving its shards
(``build(..., mesh=)``, ``shard_model``).  Both start from JAX's
``build(cfg).init(PRNGKey(0))`` and serve one seeded global batch: a
prefill into a cache of ``cap`` slots and three decode steps.

Cases: reduced qwen2.5-3b (GQA 4/2 with qkv bias) under every variant
(``fsdp_tp``, ``tp``, ``dp``, ``fsdp``, ``fsdp_seq``) with ``shard_kv_seq``
true and false on (2, 2), ``fsdp_tp`` and ``fsdp_seq`` on (1, 4) (2 KV
heads do not split over 4: a cache of heads is replicated there), and a
ring shorter than the prompt (``cap`` 6 < S 8); qwen, granite-moe,
falcon-mamba-7b and whisper at a batch or a prompt that an axis does not
divide on (2, 2), which JAX's ``fit_spec`` replicates over that axis: one
row under ``fsdp_seq`` (over ``model`` by position, replicated over
``data``) and ``fsdp_tp``, two rows under ``fsdp`` (over ``data``,
replicated over ``model``), and 15 positions under ``fsdp_seq`` (no
sequence split), three of them also in bf16 (``|bf16``: JAX's parameters
cast, held within 2e-2 normwise); granite-moe (tensor-parallel
experts, the capacity dispatch over every rank's tokens under
``fsdp_seq``), internvl2 (its frontend positions straddling the sequence
split), smollm-135m (a vocab-parallel tied head), falcon-mamba-7b (the
conv and SSM states' channels over ``model``, channel-parallel decode,
the sequence gathered for the mamba block under ``fsdp_seq``),
hymba-1.5b (its window cut to 6: a ring of 6 slots over ``model``, or
replicated at model 4) and whisper-large-v3 (the encoder's frames split
under ``fsdp_seq``, the cross-attention's xk/xv over ``model``).

Held: every rank's logits rows (the prefill's and each step's) and its
part of every cache leaf after the prefill and after the last step
against the JAX device at the same mesh position, within 1e-5 of the
largest magnitude (or 1); under ``fsdp_seq`` each rank's attention took
S/model query rows at offset ``m S/model`` against all S keys (whisper's
encoder its frames likewise).  And ``fsdp_seq`` training follows JAX's
scopes: bit for bit ``fsdp``'s on (4, 1); on (2, 2) within 1e-5 of the
same steps on one rank, with no sequence split in the default scope and
each rank's S/2 positions at offset ``m S/2`` inside the ``fsdp_seq``
one.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch.multiprocessing as mp

import torch_sharded_serve_ranks as ranks
from jax_dist_train_ref import named
from repro.configs import get_config as jax_get_config
from repro.models import model_api as JMA

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
TOL_BF16 = 2e-2
B, S, CAP, STEPS = 4, 8, 12, 3
QWEN, GRANITE, VLM, SMOL = ("qwen2.5-3b", "granite-moe-1b-a400m",
                            "internvl2-26b", "smollm-135m")
SSM, HYBRID, AUDIO = "falcon-mamba-7b", "hymba-1.5b", "whisper-large-v3"
VARIANTS = ("fsdp_tp", "tp", "dp", "fsdp", "fsdp_seq")
CASES = tuple(f"{QWEN}|{v}|2|2|{kv}|{CAP}" for v in VARIANTS
              for kv in (1, 0)) + (
    f"{QWEN}|fsdp_tp|1|4|1|{CAP}", f"{QWEN}|fsdp_tp|1|4|0|{CAP}",
    f"{QWEN}|fsdp_seq|1|4|1|{CAP}", f"{QWEN}|fsdp_tp|2|2|1|6",
    f"{GRANITE}|fsdp_tp|2|2|1|{CAP}", f"{GRANITE}|fsdp_seq|2|2|0|{CAP}",
    f"{GRANITE}|fsdp|2|2|1|{CAP}", f"{VLM}|tp|2|2|0|{CAP}",
    f"{VLM}|fsdp_seq|2|2|1|{CAP}", f"{VLM}|fsdp_seq|1|4|0|{CAP}",
    f"{SMOL}|fsdp_tp|2|2|1|{CAP}",
    f"{SSM}|fsdp_tp|2|2|1|{CAP}", f"{SSM}|fsdp_seq|2|2|0|{CAP}",
    f"{SSM}|fsdp|2|2|1|{CAP}", f"{SSM}|tp|1|4|1|{CAP}",
    f"{HYBRID}|fsdp_tp|2|2|1|{CAP}", f"{HYBRID}|fsdp_seq|2|2|1|{CAP}",
    f"{HYBRID}|dp|2|2|0|{CAP}", f"{HYBRID}|fsdp_tp|1|4|1|{CAP}",
    f"{AUDIO}|fsdp_tp|2|2|1|{CAP}", f"{AUDIO}|tp|2|2|0|{CAP}",
    f"{AUDIO}|fsdp|2|2|0|{CAP}", f"{AUDIO}|fsdp_seq|2|2|1|{CAP}",
    f"{AUDIO}|fsdp_seq|1|4|0|{CAP}") + tuple(
    # Batches and sequences an axis does not divide (``|B|S``): one row
    # replicated over data (split over model under fsdp_seq), two rows
    # over data and replicated over model under fsdp, and 15 positions
    # that model does not divide (the split dropped).
    f"{a}|{v}|2|2|1|{CAP}|{b}|{s}" for a in (QWEN, GRANITE, SSM, AUDIO)
    for v, b, s in (("fsdp_seq", 1, S), ("fsdp_tp", 1, S), ("fsdp", 2, S),
                    ("fsdp_seq", B, 15))) + (
    # The same shapes in bf16 (``|bf16``), held within 2e-2 normwise.
    f"{QWEN}|fsdp_seq|2|2|1|{CAP}|1|{S}|bf16",
    f"{GRANITE}|fsdp|2|2|1|{CAP}|2|{S}|bf16",
    f"{AUDIO}|fsdp_seq|2|2|1|{CAP}|{B}|15|bf16")
ARCHS = (QWEN, GRANITE, VLM, SMOL, SSM, HYBRID, AUDIO)
# internvl2's prompt: 12 positions, the first 8 its frontend's.
VLM_S = 12


def _batch(case, cfg):
    """The case's global batch and prompt length: ``|B|S`` where given."""
    extra = case.split("|")[6:]
    if extra:
        return int(extra[0]), int(extra[1])
    return B, (VLM_S if cfg.frontend == "vision" else S)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(JAX's results, every rank's results)``; JAX's subprocess runs
    while the ranks do."""
    work = tmp_path_factory.mktemp("sharded_serve")
    data = {"cases": np.array(CASES)}
    rng = np.random.default_rng(32)
    for arch in ARCHS:
        tree = JMA.build(jax_get_config(arch).reduced()).init(
            jax.random.PRNGKey(0))
        data.update({f"init/{arch}/{k}": v for k, v in named(tree).items()})
    for case in CASES:
        arch = case.split("|")[0]
        cfg = jax_get_config(arch).reduced()
        b, s = _batch(case, cfg)
        data[f"{case}/tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(
            np.int32)
        data[f"{case}/steps"] = rng.integers(
            0, cfg.vocab, (STEPS, b, 1)).astype(np.int32)
        if cfg.frontend:  # a VLM's image positions, whisper's audio frames
            n = cfg.enc_len if cfg.enc_dec else cfg.n_frontend_tokens
            data[f"{case}/frontend"] = rng.normal(size=(
                b, n, cfg.d_model)).astype(np.float32)
    np.savez(work / "inputs.npz", **data)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "jax_sharded_serve_ref.py"),
         str(work / "inputs.npz"), str(work / "jax.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    mp.spawn(ranks.rank_main, args=(4, str(work)), nprocs=4, join=True)
    log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log
    return (dict(np.load(work / "jax.npz")),
            [dict(np.load(work / f"rank{r}.npz")) for r in range(4)])


def _close(got, want, what, bf16=False):
    """fp32: the largest error within TOL of the largest magnitude (or
    1); bf16: the error's norm within TOL_BF16 of the reference's."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if bf16:
        err = float(np.linalg.norm(got - want)) / max(
            float(np.linalg.norm(want)), 1e-30)
    else:
        err = float(np.abs(got - want).max()) / max(
            1.0, float(np.abs(want).max()))
    assert err <= (TOL_BF16 if bf16 else TOL), (what, err)


@pytest.mark.parametrize("case", CASES)
def test_serve_matches_jax(runs, case):
    jx, rs = runs
    for rank, res in enumerate(rs):
        rows = res[f"{case}/rows"]
        for i in range(STEPS + 1):
            _close(res[f"{case}/logits{i}"], jx[f"{case}/logits{i}"][rows],
                   (rank, f"logits{i}"), case.endswith("|bf16"))
        for when in ("prefill", "decode"):
            names = [k.split("/")[-1] for k in jx
                     if k.startswith(f"{case}/{when}/r{rank}/")]
            assert sorted(names) == sorted(
                k.split("/")[-1] for k in res
                if k.startswith(f"{case}/{when}/")), (rank, when, names)
            for name in names:
                # The rank's part of every layer against the device's
                # shard of JAX's stacked (L, ...) cache leaf.
                _close(res[f"{case}/{when}/{name}"],
                       jx[f"{case}/{when}/r{rank}/{name}"],
                       (rank, when, name), case.endswith("|bf16"))


@pytest.mark.parametrize("case", [c for c in CASES if "|fsdp_seq|" in c])
def test_fsdp_seq_prefill_splits_the_sequence(runs, case):
    _, rs = runs
    arch, _, _, nm = case.split("|")[:4]
    cfg = jax_get_config(arch).reduced()
    s, n = _batch(case, cfg)[1], int(nm)
    for rank, res in enumerate(rs):
        m = rank % n
        # The encoder's layers (whisper) over its frames, then the
        # decoder's attention layers (none in the SSM: its blocks gather
        # the sequence); none where model does not divide the positions
        # (JAX's fit_spec drops the split).
        want = [[cfg.enc_len // n, m * cfg.enc_len // n, cfg.enc_len]] \
            * (cfg.n_enc_layers if cfg.enc_dec else 0) \
            + [[s // n, m * s // n, s]] * (
                0 if cfg.family == "ssm" or s % n else cfg.n_layers)
        calls = res[f"{case}/seq_calls"]
        assert calls.tolist() == want, (rank, calls)


def test_fsdp_seq_trains_as_jax_trainer(runs):
    """fsdp_seq training follows JAX's scopes: in the default scope (JAX's
    launcher) no sequence split, within 1e-5 of one rank; inside
    ``activation_sharding(mesh, "fsdp_seq")`` (JAX's ``make_train_step``
    there) each rank's attention takes its S/2 rows at offset ``m S/2``
    against all S keys, every layer, forward and recompute, and the steps
    stay within 1e-5 of one rank; on (4, 1) (one model rank: nothing to
    split) bit for bit ``fsdp``'s steps."""
    _, rs = runs
    s = ranks.TRAIN_S
    for rank, res in enumerate(rs):
        assert bool(res["train/bit_equal"])
        assert int(res["train/default_kv_stream_calls"]) == 0
        assert float(res["train/default_param_err"]) <= TOL
        calls = res["train/seq_calls"]
        m = rank % 2
        assert len(calls) > 0 and {tuple(c) for c in calls.tolist()} == {
            (s // 2, m * s // 2, s)}, (rank, calls)
        losses = res["train/loss"]
        assert np.allclose(losses[0], losses[2], rtol=0, atol=TOL), losses
        assert np.allclose(losses[1], losses[2], rtol=0, atol=TOL), losses
        assert float(res["train/param_err"]) <= TOL
