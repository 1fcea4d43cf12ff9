"""Per-rank memory, step time and collective traffic of the SSM's and
whisper's layers trained sharded, for each of two checkouts of this repo,
on one card.

    python scripts/sharded_layers_ab.py --trees OLD NEW [--order AB]

Each letter of ``--order`` is one worker process (A the first tree, B the
second) that imports ``repro_torch`` from that tree's ``src`` and spawns
four ``gloo`` ranks on the card (a ``file://`` store in a temporary
directory), a (2, 2) mesh under ``fsdp_tp``.  Each rank trains, from seed
0 through ``build(..., mesh=)``, the arms of ``ARMS`` at full width in
bf16 with their depth cut: falcon-mamba-7b at 2 of 64 layers (S = 2,048)
and whisper-large-v3 at 2 + 2 of 32 + 32 layers (448 tokens over 8 clips
of seeded (1500, 1280) frames), a global batch of 8 in 2 microbatches,
``remat="full"``, 2 steps without warmup (:func:`lm_arm`).  Prints one
JSON line per worker (every rank's record) and a summary: the card's
``nvidia-smi`` name and power limit, and by tree and arm the largest
rank's bytes of parameters and AdamW moments, peak GB, step ms, and the
collectives' bytes of the two steps by kind (the kinds the tree's
``collectives.TRAFFIC`` counts).  ``chip_smoke.py``'s ``sharded_train``
phase runs the same arms through :func:`lm_arm`.  Needs one card and
nvcc.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (arch, n_layers (decoder), n_enc_layers, S): the arms' cuts.
ARMS = (("falcon-mamba-7b", 2, 0, 2048), ("whisper-large-v3", 2, 2, 448))
BATCH, MB, STEPS, CHUNK, LR = 8, 2, 2, 1024, 1e-3


def arm_cfg(arch, n_layers, n_enc, dtype="bfloat16"):
    """``arch`` at full width with its depth cut, in ``dtype``."""
    import dataclasses

    from repro_torch.configs import get_config

    kw = dict(n_layers=n_layers, param_dtype=dtype, compute_dtype=dtype)
    if n_enc:
        kw["n_enc_layers"] = n_enc
    return dataclasses.replace(get_config(arch), **kw)


def arm_batch(cfg, seq, batch, s, dev):
    """Step ``s``'s global batch: ``batch_at``'s tokens, whisper's seeded
    frames (the compute dtype) on ``dev``."""
    import torch

    from repro_torch.data.lm_data import LMDataConfig, batch_at

    b = batch_at(LMDataConfig(vocab=cfg.vocab, seq_len=seq,
                              global_batch=batch), s)
    if cfg.enc_dec:
        g = torch.Generator(device=dev).manual_seed(s)
        b["frontend"] = torch.randn(
            (batch, cfg.enc_len, cfg.d_model), generator=g,
            device=dev).to(getattr(torch, cfg.compute_dtype))
    return b


def lm_arm(cfg, mesh, dev, seq, batch=BATCH, mb=MB, steps=STEPS):
    """``cfg`` through ``build(..., mesh=)`` from seed 0 on this rank,
    ``steps`` steps of ``mb`` microbatches: its bytes of parameters and
    AdamW moments against the ``fsdp_tp`` rule's (``shard_bytes``), the
    peak GB over the steps (the allocator's, less what was allocated
    before the model), each step's ms (host clock, ranks aligned by a
    barrier), the losses and grad norms, and the steps' collective
    traffic by kind."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import RunConfig
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model_api import build
    from repro_torch.optim.adamw import OptConfig, init_opt
    from repro_torch.sharding import partition as SP

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    bundle = build(cfg, device=dev, run=RunConfig(
        remat="full", logits_chunk=CHUNK), mesh=mesh)
    model = bundle.init(seed=0)
    opt = init_opt(OptConfig(lr=LR, warmup_steps=0, total_steps=steps),
                   list(model.parameters()))
    step = make_train_step(bundle, mb, mesh)
    held = sum(p.numel() * p.element_size() for p in model.parameters())
    held += sum(t.numel() * t.element_size() for st in opt.state.values()
                for t in st.values())
    struct = bundle.param_struct()
    specs = SP.param_specs(struct, mesh)
    rule = SP.shard_bytes(struct, specs, mesh) \
        + 2 * SP.shard_bytes(struct, specs, mesh, itemsize=4)
    batches = [arm_batch(cfg, seq, batch, s, dev) for s in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    C.reset_traffic()
    losses, norms, step_ms = [], [], []
    for s in range(steps):
        dist.barrier()
        t0 = time.perf_counter()
        m = step(model, opt, batches[s])
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "n_enc_layers": cfg.n_enc_layers, "S": seq, "B": batch,
           "microbatches": mb, "steps": steps,
           "param_and_adamw_bytes": held, "shard_bytes_rule": rule,
           "peak_gb_steps": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "step_ms": step_ms, "losses": losses, "grad_norms": norms,
           "traffic_two_steps": copy.deepcopy(C.TRAFFIC)}
    del model, opt, step, batches
    torch.cuda.empty_cache()
    return rec


def _rank(rank, work):
    from repro_torch.distributed import mesh as M

    M.init_distributed("gloo", f"file://{work}/store", rank, 4,
                       device="cuda:0", timeout=600)
    mesh = M.make_mesh(2, 2)
    recs = [lm_arm(arm_cfg(a, n, e), mesh, "cuda:0", s)
            for a, n, e, s in ARMS]
    M.close_distributed()
    Path(work, f"rank{rank}.json").write_text(json.dumps(
        {"rank": rank, "coords": [mesh.data_rank, mesh.model_rank],
         "arms": recs}))


def worker():
    """The four ranks of this process's ``repro_torch`` (the tree on
    PYTHONPATH); every rank's record."""
    import torch.multiprocessing as mp

    work = tempfile.mkdtemp(prefix="sharded_layers_ab_")
    mp.spawn(_rank, args=(work,), nprocs=4, join=True)
    return [json.loads(Path(work, f"rank{r}.json").read_text())
            for r in range(4)]


def _summary(ranks):
    out = {}
    for i, arm in enumerate(ranks[0]["arms"]):
        recs = [r["arms"][i] for r in ranks]
        out[arm["arch"]] = {
            "param_and_adamw_bytes": max(r["param_and_adamw_bytes"]
                                         for r in recs),
            "shard_bytes_rule": max(r["shard_bytes_rule"] for r in recs),
            "peak_gb": max(r["peak_gb_steps"] for r in recs),
            "step_ms": [max(r["step_ms"][s] for r in recs)
                        for s in range(len(arm["step_ms"]))],
            "losses": arm["losses"],
            "traffic_bytes": {k: v["bytes"] for k, v in
                              arm["traffic_two_steps"].items()}}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--order", default="AB")
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker()))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    trees = dict(zip("AB", (Path(t).resolve() for t in args.trees)))
    summary = {}
    for i, t in enumerate(args.order):
        env = dict(os.environ, PYTHONPATH=str(trees[t] / "src"))
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker"],
            env=env, cwd=trees[t], capture_output=True, text=True)
        if res.returncode:
            print(json.dumps({"run": i, "tree": t, "failed":
                              res.stderr[-6000:]}))
            continue
        ranks = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i, "tree": t, "ranks": ranks}))
        summary[f"{i}{t}"] = _summary(ranks)
    print(json.dumps({"trees": {t: str(p) for t, p in trees.items()},
                      "order": args.order, "device": smi,
                      "by_run": summary}))


if __name__ == "__main__":
    main()
