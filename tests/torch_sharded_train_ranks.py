"""The port's ranks for ``tests/test_torch_sharded_train.py``: four
``gloo`` processes on the CPU, started by ``torch.multiprocessing.spawn``
on a ``file://`` store.  Imports no JAX: each rank reads JAX's initial
parameters from the ``.npz`` the test wrote and leaves its results in
``rank<r>.npz``.

Every rank, over the world of four:
- for each case (``arch|sharding|data|model``), builds the reduced arch
  from JAX's parameters, cuts its shards (``shard_model``) and trains two
  steps of two microbatches under ``remat="full"``: each step's loss and
  grad norm, and its shard of every parameter and moment after them;
- trains the first arch with ``sharding="dp"`` and with a bundle built
  without the mesh (whole parameters, the mesh's data all-reduce): every
  loss and parameter, bit for bit (``dp/...``);
- trains the first arch under ``fsdp_tp`` on (2, 2) for three steps,
  checkpointing after two (``ckpt/...``), and resumes that checkpoint on a
  (1, 4) mesh: the third step's loss and its shards against the unbroken
  run's.
- trains reduced falcon-mamba-7b, hymba-1.5b and whisper-large-v3
  (whose layers are gathered whole and computed replicated over
  ``model``) under ``fsdp_tp`` on (2, 2) and, in the same process, on one
  rank: the losses and its shard of every parameter against the one
  rank's (``gathered/...``).
Then rank 0 alone, outside any process group, resumes the checkpoint on
one rank.
"""
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import RunConfig, get_config
from repro_torch.data.lm_data import LMDataConfig, batch_at
from repro_torch.distributed import mesh as M
from repro_torch.distributed.collectives import gather_leaf
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import _restore
from repro_torch.models import transformer as T
from repro_torch.models.model_api import build
from repro_torch.optim.adamw import OptConfig, init_opt
from repro_torch.sharding.partition import shard_of
from repro_torch.tree import named_leaves

CKPT_STEPS = 3
GATHERED = ("falcon-mamba-7b", "hymba-1.5b", "whisper-large-v3")


def whole_model(data, arch):
    """The reduced arch with JAX's initial parameters, whole."""
    cfg = get_config(arch).reduced()
    model = T.init_lm(cfg, device="cpu")
    with torch.no_grad():
        for name, p in named_leaves(model):
            p.copy_(torch.from_numpy(data[f"init/{arch}/{name}"]))
    return cfg, model


def trainer(data, arch, sharding, mesh, steps, build_mesh=True):
    """``(model, opt, step_fn, batch(s))`` for ``arch`` on ``mesh``."""
    cfg, model = whole_model(data, arch)
    run = RunConfig(remat="full", sharding=sharding)
    bundle = build(cfg, device="cpu", run=run,
                   mesh=mesh if build_mesh else None)
    if build_mesh:
        T.shard_model(model, mesh, sharding)
    opt = init_opt(OptConfig(lr=float(data["lr"]), total_steps=steps),
                   list(model.parameters()))
    step = make_train_step(bundle, int(data["microbatches"]), mesh)
    dcfg = LMDataConfig(vocab=cfg.vocab, seq_len=int(data["seq"]),
                        global_batch=int(data["batch"]))
    return model, opt, step, lambda s: batch_at(dcfg, s)


def put(res, prefix, named):
    for name, t in named:
        res[f"{prefix}/{name}"] = t.detach().float().numpy().copy()


def train_case(data, case, res):
    arch, sharding, nd, nm = case.split("|")
    mesh = M.make_mesh(int(nd), int(nm))
    steps = int(data["steps"])
    model, opt, step, batch = trainer(data, arch, sharding, mesh, steps)
    ms = [step(model, opt, batch(s)) for s in range(steps)]
    res[f"{case}/loss"] = np.array([float(m["loss"]) for m in ms])
    res[f"{case}/grad_norm"] = np.array([float(m["grad_norm"]) for m in ms])
    names = [n for n, _ in named_leaves(model)]
    put(res, f"{case}/param", named_leaves(model))
    state = opt.state_dict()
    put(res, f"{case}/m", zip(names, state["m"]))
    put(res, f"{case}/v", zip(names, state["v"]))
    res[f"{case}/specs"] = np.array(repr({n: p.placement.spec
                                          for n, p in named_leaves(model)
                                          if M.placement(p) is not None}))


def dp_bits(data, arch, res):
    """``sharding="dp"`` against the step of a bundle built without the
    mesh: the same losses and parameters, bit for bit."""
    mesh = M.make_mesh(2, 2)
    steps = int(data["steps"])
    out = []
    for build_mesh in (True, False):
        model, opt, step, batch = trainer(data, arch, "dp", mesh, steps,
                                          build_mesh)
        losses = [step(model, opt, batch(s))["loss"] for s in range(steps)]
        out.append((losses, [p.detach().clone() for p in
                             model.parameters()], model))
    (l0, p0, m0), (l1, p1, _) = out
    res["dp/untagged"] = np.array(all(M.placement(p) is None
                                      for p in m0.parameters()))
    res["dp/bit_equal"] = np.array(
        all(torch.equal(a, b) for a, b in zip(l0, l1))
        and all(torch.equal(a, b) for a, b in zip(p0, p1)))


def checkpoint_across_meshes(data, arch, work, res):
    """Three steps on (2, 2), checkpointed after two; the third step
    resumed on (1, 4).  Returns the unbroken run's whole parameters."""
    mesh = M.make_mesh(2, 2)
    model, opt, step, batch = trainer(data, arch, "fsdp_tp", mesh,
                                      CKPT_STEPS)
    for s in range(CKPT_STEPS - 1):
        step(model, opt, batch(s))
    ckpt.save(str(work / "ckpt"), CKPT_STEPS - 1,
              {"params": model, "opt": opt.state_dict()},
              write=mesh.rank == 0)
    res["ckpt/loss"] = np.array(float(step(model, opt, batch(
        CKPT_STEPS - 1))["loss"]))
    with torch.no_grad():
        whole = {n: gather_leaf(p) for n, p in named_leaves(model)}
    torch.distributed.barrier()  # the checkpoint is written

    mesh = M.make_mesh(1, 4)
    model, opt, step, batch = trainer(data, arch, "fsdp_tp", mesh,
                                      CKPT_STEPS)
    start = _restore(str(work / "ckpt"), model, opt)
    res["ckpt/start_14"] = np.array(start)
    res["ckpt/loss_14"] = np.array(float(step(model, opt, batch(
        start))["loss"]))
    err = 0.0
    for n, p in named_leaves(model):
        want = shard_of(whole[n], p.placement.spec, mesh)
        err = max(err, float((p.detach() - want).abs().max())
                  / max(1.0, float(want.abs().max())))
    res["ckpt/param_err_14"] = np.array(err)
    return whole


def one_rank_resume(data, arch, work, whole, res):
    model, opt, step, batch = trainer(data, arch, "fsdp_tp", None,
                                      CKPT_STEPS)
    start = _restore(str(work / "ckpt"), model, opt)
    res["ckpt/loss_11"] = np.array(float(step(model, opt, batch(
        start))["loss"]))
    res["ckpt/param_err_11"] = np.array(max(
        float((p.detach() - whole[n]).abs().max())
        / max(1.0, float(whole[n].abs().max()))
        for n, p in named_leaves(model)))


def gathered_families(data, res):
    """Each arch of ``GATHERED`` trained two steps on (2, 2) and on one
    rank from seed 0 (whisper's audio frames a seeded draw)."""
    mesh = M.make_mesh(2, 2)
    steps, mb = int(data["steps"]), int(data["microbatches"])
    for arch in GATHERED:
        cfg = get_config(arch).reduced()
        dcfg = LMDataConfig(vocab=cfg.vocab, seq_len=int(data["seq"]),
                            global_batch=int(data["batch"]))

        def batch(s):
            b = batch_at(dcfg, s)
            if cfg.enc_dec:
                b["frontend"] = np.random.default_rng(s).normal(size=(
                    dcfg.global_batch, cfg.enc_len, cfg.d_model)).astype(
                        np.float32)
            return b

        out = []
        for m in (None, mesh):
            bundle = build(cfg, device="cpu", run=RunConfig(remat="full"),
                           mesh=m)
            model = bundle.init(seed=0)
            opt = init_opt(OptConfig(lr=float(data["lr"]), total_steps=steps),
                           list(model.parameters()))
            step = make_train_step(bundle, mb, m)
            out.append(([float(step(model, opt, batch(s))["loss"])
                         for s in range(steps)], model))
        (l0, whole), (l1, model) = out
        want = dict(named_leaves(whole))
        res[f"gathered/{arch}/loss"] = np.array([l0, l1])
        res[f"gathered/{arch}/sharded_leaves"] = np.array(sum(
            bool(p.placement.spec) for p in model.parameters()))
        res[f"gathered/{arch}/param_err"] = np.array(max(
            float((p.detach() - shard_of(want[n].detach(), p.placement.spec,
                                         mesh)).abs().max())
            / max(1.0, float(want[n].abs().max()))
            for n, p in named_leaves(model)))


def rank_main(rank, world, work):
    torch.set_num_threads(1)  # four ranks share the test worker's cores
    work = Path(work)
    data = np.load(work / "inputs.npz")
    res = {}
    M.init_distributed("gloo", f"file://{work}/store", rank, world,
                       device="cpu", timeout=120)
    for case in data["cases"]:
        train_case(data, str(case), res)
    first = str(data["cases"][0]).split("|")[0]
    dp_bits(data, first, res)
    gathered_families(data, res)
    whole = checkpoint_across_meshes(data, first, work, res)
    M.close_distributed()
    if rank == 0:
        one_rank_resume(data, first, work, whole, res)
    np.savez(work / f"rank{rank}.npz", **res)
