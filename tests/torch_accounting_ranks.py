"""The port's ranks for ``tests/test_torch_accounting.py``: four ``gloo``
processes on the CPU, started by ``torch.multiprocessing.spawn`` on a
``file://`` store.  Imports no JAX.

Every rank, over the world of four on a (2, 2) mesh, for each case of
:data:`CASES` (``arch|sharding``, the reduced arch through ``build(...,
mesh=)`` from seed 0, DLRM's tables under ``emb_rows="all"``): one train
step of :data:`MB` microbatches inside ``activation_sharding(mesh,
sharding)`` (under ``fsdp_seq`` that scope splits the sequence), a
prefill of capacity :data:`CAP` and one decode step on its cache (DLRM:
the served forward on the rank's rows), each with the collectives'
recorder reset before it (``collectives.RECORD``); beside each, the
accountant's trace of the same rank on the ``meta`` device over a virtual
mesh (``accounting.account(..., rank=rank)``: the reduced archs' 2 layers
and 2 microbatches are traced whole).  Leaves
``rank<r>.npz``: ``<case>/<pass>/real`` and ``.../traced``, the counts in
:data:`KEYS`' order.
"""
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import RunConfig, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import mesh as M
from repro_torch.launch import accounting as A
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model_api import build
from repro_torch.optim.adamw import OptConfig, init_opt
from repro_torch.sharding import partition as SP
from repro_torch.tree import leaves

CASES = ("smollm-135m|fsdp_tp", "smollm-135m|fsdp_seq",
         "granite-moe-1b-a400m|fsdp_tp", "falcon-mamba-7b|fsdp_tp",
         "whisper-large-v3|fsdp_tp", "dlrm-recmg|fsdp_tp")
B, S, MB, CAP = 4, 16, 2, 20
KEYS = tuple(sorted(C.collective_stats()))


def passes(case):
    return (("train", "prefill") if case.startswith("dlrm")
            else ("train", "prefill", "decode"))


def _vec(stats):
    return np.array([stats[k] for k in KEYS], dtype=np.int64)


def _batch(cfg, bundle, kind, rng):
    """The global batch of ``kind`` (B rows of S tokens; DLRM's queries),
    drawn from ``rng``."""
    out = {}
    seq = 1 if kind == "decode" else S
    shape = ShapeConfig(kind, kind, seq, B)
    for k, (dims, dt) in bundle.batch_struct(shape).items():
        if dt.is_floating_point:
            v = rng.normal(size=dims)
            if k == "label":
                v = rng.integers(0, 2, dims)
            out[k] = torch.tensor(v, dtype=dt)
        else:
            hi = (cfg.rows_per_table if cfg.family == "dlrm" else cfg.vocab)
            out[k] = torch.tensor(rng.integers(0, hi, dims), dtype=dt)
    return out


def run_case(case, mesh, res):
    arch, sharding = case.split("|")
    cfg = get_config(arch).reduced()
    run = RunConfig(sharding=sharding)
    bundle = build(cfg, device="cpu", run=run, mesh=mesh)
    rng = np.random.default_rng(0)
    scope = M.activation_sharding(mesh, sharding)

    params = bundle.init(seed=0)
    opt = init_opt(OptConfig(), leaves(params))
    step = make_train_step(bundle, MB, mesh)
    batch = _batch(cfg, bundle, "train", rng)
    C.reset_record()
    with scope:
        step(params, opt, batch)
    res[f"{case}/train/real"] = _vec(C.collective_stats())
    acc = A.account(cfg, ShapeConfig("t", "train", S, B), run, mesh.shape,
                    MB, rank=mesh.rank)
    res[f"{case}/train/traced"] = _vec(acc["collectives"])

    params = bundle.init(seed=0)
    batch = _batch(cfg, bundle, "prefill", rng)
    if cfg.family == "dlrm":  # the served forward on the rank's rows
        batch = {k: M.batch_shard(v, mesh, sharding)
                 for k, v in batch.items()}
        rows = SP.batch_axes(tuple(batch["sparse"].shape), mesh,
                             sharding)[0]
        C.reset_record()
        with M.activation_sharding(mesh, sharding, rows=rows):
            bundle.prefill(params, batch)
        res[f"{case}/prefill/real"] = _vec(C.collective_stats())
    else:
        C.reset_record()
        with scope:
            _, cache = bundle.prefill(params, batch, CAP)
        res[f"{case}/prefill/real"] = _vec(C.collective_stats())
        token = _batch(cfg, bundle, "decode", rng)["token"]
        C.reset_record()
        with scope:
            bundle.decode(params, token, cache)
        res[f"{case}/decode/real"] = _vec(C.collective_stats())
        acc = A.account(cfg, ShapeConfig("t", "decode", CAP, B), run,
                        mesh.shape, rank=mesh.rank, pos=S)
        res[f"{case}/decode/traced"] = _vec(acc["collectives"])
    acc = A.account(cfg, ShapeConfig("t", "prefill", S, B), run, mesh.shape,
                    rank=mesh.rank, cache_len=CAP)
    res[f"{case}/prefill/traced"] = _vec(acc["collectives"])


def rank_main(rank, world, work):
    torch.set_num_threads(1)  # four ranks share the test worker's cores
    work = Path(work)
    res = {}
    M.init_distributed("gloo", f"file://{work}/store", rank, world,
                       device="cpu", timeout=120)
    mesh = M.make_mesh(2, 2)
    for case in CASES:
        run_case(case, mesh, res)
    M.close_distributed()
    np.savez(work / f"rank{rank}.npz", **res)
