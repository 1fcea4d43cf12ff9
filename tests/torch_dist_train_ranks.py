"""The port's ranks for ``tests/test_torch_distributed_train.py``: four
``gloo`` processes on the CPU, started by ``torch.multiprocessing.spawn``
on a ``file://`` store (no TCP port, so parallel test workers cannot
collide).  Imports no JAX: each rank reads its inputs from the ``.npz`` the
test wrote and leaves its results in ``rank<r>.npz``.

Every rank, over the world of four:
- trains reduced dlrm-recmg (fp32) two steps on a (2, 2) mesh through the
  row-sharded lookup, two microbatches, its shard of every table;
- compresses and all-reduces the test's gradients (``compress_tree``,
  ``psum_int8``) over four data ranks;
- runs ``moe_block`` on its quarter of the tokens under a (4, 1) mesh,
  with the global and the data-local dispatch, and the gradients of a
  loss the way a data-parallel step reduces them;
- runs the launcher from the test's step-0 checkpoints: reduced granite
  with ``--model-parallel 2`` (a (2, 2) mesh) and reduced smollm with
  ``--grad-compression int8_ef`` (a (4, 1) mesh).
Then ranks 0 and 1 start a world of two and resume the granite run from
its step-2 checkpoint.
"""
import contextlib
import io
import shutil
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed import mesh as M
from repro_torch.distributed.compression import compress_tree, psum_int8
from repro_torch.launch.steps import make_grads_fn, make_train_step
from repro_torch.launch.train import main as train_main
from repro_torch.models import dlrm as D
from repro_torch.models import layers as L
from repro_torch.models.model_api import build
from repro_torch.optim.adamw import OptConfig, init_opt
from repro_torch.tree import named_leaves, unflatten

MOE_MODES = ("global", "local")
AUX_WEIGHT = 0.37  # the test loss's weight on the aux


def dlrm_cfg():
    return get_config("dlrm-recmg").reduced()


def tree_from(data, prefix, like):
    """``like``'s structure with the leaves ``data[prefix/<leaf name>]``."""
    return unflatten(like, iter(torch.from_numpy(data[f"{prefix}/{name}"])
                                for name, _ in named_leaves(like)))


def put(res, prefix, named):
    """Copies (an fp32 ``numpy()`` shares the parameter's memory, which
    the next step updates in place)."""
    for name, t in named:
        res[f"{prefix}/{name}"] = t.detach().float().numpy().copy()


def train_dlrm(data, res):
    cfg = dlrm_cfg()
    mesh = M.make_mesh(2, 2)
    lo, hi = D.shard_rows(cfg.rows_per_table, mesh)
    whole = tree_from(data, "dlrm/init", D.init_dlrm(cfg, device="cpu"))
    params = {**whole, "emb": whole["emb"][:, lo:hi].contiguous()}
    res["dlrm/rows"] = np.array([lo, hi])
    bundle = build(cfg, device="cpu",
                   run=RunConfig(remat="none", dlrm_sharded_lookup=True))
    mb = int(data["dlrm/microbatches"])
    opt = init_opt(OptConfig(lr=float(data["lr"])),
                   [p for _, p in named_leaves(params)])
    grads_fn = make_grads_fn(bundle, mb, mesh)
    step = make_train_step(bundle, mb, mesh)
    for s in range(int(data["dlrm/steps"])):
        batch = {k: data[f"dlrm/{s}/{k}"] for k in ("dense", "sparse",
                                                     "label")}
        loss, grads = grads_fn(params, batch)
        put(res, f"dlrm/{s}/grad",
            zip([n for n, _ in named_leaves(params)], grads))
        m = step(params, opt, batch)
        res[f"dlrm/{s}/loss"] = np.array([float(loss), float(m["loss"])])
        res[f"dlrm/{s}/grad_norm"] = np.array(float(m["grad_norm"]))
        put(res, f"dlrm/{s}/param", named_leaves(params))


def compression(data, res):
    mesh = M.make_mesh(4, 1)
    r = mesh.data_rank
    n = int(data["cmp/n"])
    g = [torch.from_numpy(data[f"cmp/g{i}"][r]) for i in range(n)]
    e = [torch.from_numpy(data[f"cmp/e{i}"][r]) for i in range(n)]
    q, s, new_e = compress_tree(g, e)
    summed = psum_int8(q, s, mesh.data_group, mesh.data)
    for i in range(n):
        res[f"cmp/q{i}"] = q[i].numpy()
        res[f"cmp/s{i}"] = s[i].numpy()
        res[f"cmp/e{i}"] = new_e[i].numpy()
        res[f"cmp/sum{i}"] = summed[i].numpy()


def moe(data, res):
    """The test's loss over the global tokens is ``sum(out * w) + AUX_WEIGHT
    * aux``; a data rank's loss is ``n_data * sum(its out * its w) +
    AUX_WEIGHT * aux``, whose gradients, meaned over the ranks as a step
    means them, are the global loss's."""
    cfg = ModelConfig(**{k[len("moe/cfg/"):]: data[k].item()
                         for k in data.files if k.startswith("moe/cfg/")})
    mesh = M.make_mesh(4, 1)
    x = M.batch_shard(torch.from_numpy(data["moe/x"]), mesh)
    w = M.batch_shard(torch.from_numpy(data["moe/w"]), mesh)
    for mode in MOE_MODES:
        p = {k: torch.from_numpy(data[f"moe/p/{k}"]).requires_grad_(True)
             for k in ("router", "w1", "w3", "w2")}
        with M.activation_sharding(mesh):
            out, aux = L.moe_block(p, cfg, x,
                                   local_dispatch=mode == "local")
        loss = mesh.data * (out * w).sum() + AUX_WEIGHT * aux
        grads = torch.autograd.grad(loss, list(p.values()))
        for g in grads:
            dist.all_reduce(g, group=mesh.data_group)
            g.div_(mesh.data)
        res[f"moe/{mode}/out"] = M.gather_batch(out.detach(), mesh).numpy()
        res[f"moe/{mode}/aux"] = aux.detach().numpy()
        put(res, f"moe/{mode}/grad", zip(p, grads))


def launch(argv, res, key):
    """``train_main(argv)``, its losses and printed lines kept."""
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        losses = train_main(argv)
    res[f"{key}/losses"] = np.array(losses)
    res[f"{key}/stdout"] = np.array(text.getvalue())


def launcher_args(data, prefix, ckpt):
    return ["--device", "cpu", "--reduced", "--log-every", "1",
            "--lr", str(float(data["lr"])), "--ckpt", str(ckpt),
            "--steps", str(int(data[f"{prefix}/steps"])),
            "--seq-len", str(int(data[f"{prefix}/seq"])),
            "--batch", str(int(data[f"{prefix}/batch"]))]


def rank_main(rank, world, work):
    torch.set_num_threads(1)  # four ranks share the test worker's cores
    work = Path(work)
    data = np.load(work / "inputs.npz")
    res = {}
    M.init_distributed("gloo", f"file://{work}/store", rank, world,
                       device="cpu", timeout=120)
    train_dlrm(data, res)
    compression(data, res)
    moe(data, res)
    plain = launcher_args(data, "plain", work / "plain") + [
        "--arch", "granite-moe-1b-a400m", "--model-parallel", "2",
        "--microbatches", str(int(data["plain/microbatches"])),
        "--ckpt-every", "2"]
    launch(plain, res, "plain")
    if rank == 0:  # the step-2 checkpoint alone, to resume on two ranks
        shutil.copytree(work / "plain" / "step_00000002",
                        work / "resume" / "step_00000002")
    launch(launcher_args(data, "int8", work / "int8") + [
        "--grad-compression", "int8_ef", "--microbatches", "2"], res, "int8")
    M.close_distributed()
    if rank < 2:
        M.init_distributed("gloo", f"file://{work}/store2", rank, 2,
                           device="cpu", timeout=120)
        resume = [work / "resume" if a == str(work / "plain") else a
                  for a in plain]
        launch([str(a) for a in resume], res, "resume")
        M.close_distributed()
    np.savez(work / f"rank{rank}.npz", **res)
