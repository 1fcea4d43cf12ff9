"""LM training launcher: config-driven, fault-tolerant, resumable.

    rm -rf build/ck build/ck_full   # a fresh run; keep them to resume
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --reduced --steps 6 --seq-len 64 --batch 2 --ckpt build/ck
    PYTHONPATH=src python -m repro_torch.launch.train --steps 6 \
        --seq-len 4096 --batch 8 --microbatches 2 --remat full \
        --ckpt build/ck_full

Ported from ``src/repro/launch/train.py``: the same flags and printed lines,
plus ``--device`` (``cuda`` unless the caller asks for ``cpu``; without
CUDA the default raises) and ``--dist-backend``.  Without a process group
it trains on one device and prints a ``device:`` line.  Under one (started
by the caller, or by the launcher from torchrun's ``WORLD_SIZE``, ``RANK``
and ``MASTER_ADDR`` with the backend ``--dist-backend`` names; nothing
picks one), it prints JAX's ``mesh:`` line and trains on
``ElasticMesh(--model-parallel)``: every rank holds and updates its
shard of each parameter and of AdamW's state as JAX's ``param_pspecs``
places them under ``RunConfig.sharding`` (``"fsdp_tp"``: tensor parallel
over ``model``, FSDP over ``data``; :func:`repro_torch.models.
transformer.shard_model`), takes its part of each step's global batch
(``distributed/mesh.py::microbatch_shard``), and reduces each gradient
by its layout (:func:`repro_torch.launch.steps.make_grads_fn`).  With
``--grad-compression int8_ef`` the parameters stay whole on every rank
and the gradients are all-reduced over ``data`` as int8 codes with error
feedback (:func:`repro_torch.distributed.compression.
make_compressed_dp_grads`: each rank's whole part in one pass, so
``--microbatches`` does not apply, as in JAX).  Every rank gathers the
checkpoints' leaves whole and rank 0 writes them and the heartbeat;
every rank restores them, cutting its own shards, so a restart on fewer
ranks re-factors the mesh and reads the same global batches.
Deterministic resumable data
(:mod:`repro_torch.data.lm_data`), atomic async checkpoints of the
parameters and the AdamW state (its step count included), retry of a
step that failed before its update (:func:`run_step`), straggler
monitoring and a heartbeat file.  A restart restores the latest
checkpoint and runs on to ``--steps``, whose value also sets the schedule
(``OptConfig(lr, total_steps=steps)``), so a resumed run takes the same
``--steps`` as the run it resumes.

Like JAX's launcher this one feeds LM data only (tokens and labels), so
``--arch`` is an LM the port builds: dense, MoE (its loss adds the load-balance
term), the VLM (its text alone, no frontend, as in JAX), the SSM LM or the
hybrid LM (falcon-mamba-7b, hymba-1.5b); DLRM and the encoder-decoder LM (whose
data would need audio frames) are refused and train through
:func:`repro_torch.launch.steps.make_train_step`.  The optimizer is
``OptConfig(lr, total_steps)`` with JAX's defaults (fp32 moments, no master
copy): JAX's launcher has no flag for either knob.
"""
from __future__ import annotations

import contextlib

import argparse
import os
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import RunConfig, get_config
from repro_torch.data.lm_data import LMDataConfig, batch_at
from repro_torch.device import resolve_device
from repro_torch.distributed import mesh as M
from repro_torch.distributed.compression import (init_error,
                                                 make_compressed_dp_grads)
from repro_torch.distributed.fault_tolerance import (ElasticMesh, Heartbeat,
                                                     StragglerMonitor,
                                                     retry_step)
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model_api import build
from repro_torch.optim.adamw import OptConfig, init_opt
from repro_torch.tree import named_leaves


def _restore(ckpt_dir: str, params, opt):
    """Loads the latest checkpoint of ``ckpt_dir`` into ``params`` and
    ``opt`` in place; returns its step."""
    tree, start = ckpt.restore(ckpt_dir,
                               {"params": params, "opt": opt.state_dict()})
    with torch.no_grad():
        for (_, p), (_, t) in zip(named_leaves(params),
                                  named_leaves(tree["params"])):
            p.copy_(t)
    opt.load_state_dict(tree["opt"])
    return start


class _BeforeUpdate(Exception):
    """A step's failure that left the parameters and the optimizer as they
    were; its cause is the failure itself."""


def run_step(step_fn, params, opt, batch, **retry_kw):
    """``step_fn(params, opt, batch)`` under :func:`retry_step` (``retry_kw``
    goes to it).  A failure before the update (the loss, the backward)
    leaves the parameters and the optimizer as they were, so the step is
    retried from the same state, as JAX's pure step is.  The update
    changes them in place, leaf by leaf, after ``opt.count`` has moved: a
    failure once the count has moved is raised at once, since a retry
    would apply the step a second time.  Either way the error that
    surfaces is the step's own."""
    def attempt():
        count = opt.count
        try:
            return step_fn(params, opt, batch)
        except Exception as e:
            if opt.count != count:
                raise
            raise _BeforeUpdate() from e

    try:
        return retry_step(attempt, retryable=_BeforeUpdate, **retry_kw)
    except _BeforeUpdate as e:
        err = e.__cause__
    raise err


def main(argv=None, cfg=None):
    """The launcher over ``argv``; a Python caller may pass ``cfg``, a
    ``ModelConfig`` that stands in for ``--arch``'s (a depth cut, say),
    which the command line cannot name."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--grad-compression", default="",
                    choices=["", "int8_ef"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--dist-backend", default="", choices=["", *M.BACKENDS],
                    help="the process group's backend, when the launcher "
                    "starts it (WORLD_SIZE set by torchrun)")
    args = ap.parse_args(argv)

    if cfg is None:
        cfg = get_config(args.arch)
    if cfg.family == "dlrm":
        raise NotImplementedError(
            f"--arch {cfg.name}: the launcher feeds LM data only, as JAX's "
            "does (DLRM trains through make_train_step)")
    if cfg.enc_dec:
        raise NotImplementedError(
            f"--arch {cfg.name}: the launcher's data feeds no frontend, as "
            "JAX's feeds none (the encoder-decoder LM trains through "
            "make_train_step)")
    if args.reduced:
        cfg = cfg.reduced()
    run = RunConfig(remat=args.remat, grad_compression=args.grad_compression)
    started = _start_group(args)
    try:
        return _train(args, cfg, run)
    finally:
        if started:
            M.close_distributed()


def _start_group(args) -> bool:
    """Starts the process group from torchrun's environment when no group
    runs and ``WORLD_SIZE`` is set, with the backend the caller named;
    returns whether it did."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    if not args.dist_backend:
        raise ValueError("WORLD_SIZE is set: name the process group's "
                         "backend with --dist-backend nccl or gloo")
    M.init_distributed(args.dist_backend,
                       device=None if args.device == "cuda" else args.device)
    return True


def _train(args, cfg, run: RunConfig):
    grouped = dist.is_initialized()
    rank0 = not grouped or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **kw: None)
    dev = resolve_device(args.device)
    mesh = None
    if grouped or run.grad_compression:
        mesh = ElasticMesh(args.model_parallel).make()
    if grouped:
        say(f"mesh: {mesh.shape} devices={mesh.data * mesh.model}")
    else:
        say(f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})"
                                if dev.type == "cuda" else ""))

    bundle = build(cfg, device=dev, run=run, mesh=mesh if grouped else None)
    opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps)
    data_cfg = LMDataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                            global_batch=args.batch)

    # Init or restore.
    start = 0
    params = bundle.init(seed=0)
    opt = init_opt(opt_cfg, list(params.parameters()))
    if args.ckpt and ckpt.latest_step(args.ckpt) is not None:
        start = _restore(args.ckpt, params, opt)
        say(f"restored step {start} from {args.ckpt}")

    if run.grad_compression == "int8_ef":
        if args.microbatches > 1:
            say(f"--microbatches {args.microbatches} does not apply under "
                "--grad-compression int8_ef: each data rank's part of the "
                "batch runs in one pass")
        grads_fn = make_compressed_dp_grads(bundle.loss, mesh)
        err = init_error(params)

        def step_fn(params, opt, batch):
            nonlocal err
            loss, grads, new_err = grads_fn(params, err, batch)
            m = opt.apply(grads)
            err = new_err
            m["loss"] = loss
            return m
    else:
        step_fn = make_train_step(bundle, args.microbatches,
                                  mesh if grouped else None)
    mon = StragglerMonitor()
    hb = (Heartbeat(Path(args.ckpt) / "heartbeat.json")
          if args.ckpt and rank0 else None)
    # A rank retries no step alone: its collectives would pair with the
    # other ranks' next ones.
    retries = 0 if grouped else 3
    losses = []
    # JAX's launcher trains in the default activation scope
    # (src/repro/launch/train.py:83): no sequence split, whatever the
    # sharding variant.
    scope = (M.activation_sharding(mesh) if mesh is not None
             else contextlib.nullcontext())
    for step in range(start, args.steps):
        batch = batch_at(data_cfg, step)
        t0 = time.perf_counter()
        with scope:
            m = run_step(step_fn, params, opt, batch, retries=retries)
        loss = float(m["loss"])  # waits for the step's device work
        dt = time.perf_counter() - t0
        slow = mon.record(step, dt)
        losses.append(loss)
        if hb:
            hb.beat(step, loss=loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {loss:.4f} "
                f"({dt*1e3:.0f} ms{' STRAGGLER' if slow else ''})",
                flush=True)
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(args.ckpt, step + 1,
                            {"params": params, "opt": opt.state_dict()},
                            write=rank0)
    if args.ckpt:
        ckpt.wait_pending(args.ckpt)
        ckpt.save(args.ckpt, args.steps,
                  {"params": params, "opt": opt.state_dict()}, write=rank0)
    if grouped:
        dist.barrier()  # every rank returns once the checkpoint is written
    if losses:
        say(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
            f"steps/s {1.0/max(mon.mean,1e-9):.2f}; {mon.summary()}")
    else:  # restored at --steps: nothing left to train
        say(f"done: no step to run (restored step {start} of "
            f"{args.steps})")
    return losses


if __name__ == "__main__":
    main()
