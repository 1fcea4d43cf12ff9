"""The dry-run as accounting: every (arch, shape, mesh) cell's per-rank
bytes and model arithmetic, computed on the ``meta`` device.

    python -m repro_torch.launch.dryrun --all [--mesh both] [--out runs/dryrun]
        [--tag baseline] [--sharding fsdp_tp] [--emb-rows all]
        [--no-shard-kv-seq] [--microbatches 0] [--list]

Counterpart of ``src/repro/launch/dryrun.py``.  JAX lowers and compiles
each cell for 512 placeholder devices and reads XLA's memory and cost
analyses and its HLO; the port emits no HLO, so it keeps the part of the
cell that does not come from XLA (``lower_cell``'s keys ``arch``,
``shape``, ``mesh``, ``kind``, ``status``, ``reason`` for a skipped cell,
``devices``, ``microbatches``, ``param_bytes_per_device`` by
``_sizeof``'s rule (:func:`repro_torch.sharding.partition.shard_bytes`),
``n_params``, ``n_active_params``, ``run_config``) and adds, per rank, the
AdamW moments (fp32 ``m`` and ``v`` laid out as the parameters), the batch
(``batch_pspecs``), the decode cache (``cache_pspecs``) and the step's
arguments, with ``model_flops`` and ``model_bytes``
(:mod:`repro_torch.launch.roofline`).  The meshes are stand-ins of JAX's
production meshes (``launch/mesh.py::make_production_mesh``): (data 16,
model 16) and (pod 2, data 16, model 16).  Nothing is allocated (the
models are built on the ``meta`` device), no process group is started and
no XLA flag is set: ``--all`` runs in seconds on a CPU.  One JSON file a
cell is written to ``OUT/TAG/<arch>__<shape>__<mesh>.json``.

The prefill and decode that JAX's cells lower run for real, rank by rank,
in :func:`repro_torch.models.transformer.prefill_sharded` and
``decode_sharded``; a cell's lowering for 512 devices, its HLO reading
(``launch/hlo_analysis.py``) and the production mesh are out of the
port's scope (ROADMAP A11c-6d).
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import traceback
from pathlib import Path
from typing import Dict

from repro_torch.configs import (ALL_ARCHS, RunConfig, auto_microbatches,
                                 get_config, shape_applicable, shapes_for)
from repro_torch.launch import roofline
from repro_torch.models.model_api import build
from repro_torch.sharding import partition as SP

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
MOMENT_BYTES = 4  # AdamW's m and v in fp32 (JAX's opt_dtype default)


def _sized(shape, itemsize: int, spec, mesh) -> int:
    """``_sizeof``'s rule for one leaf: its bytes floor-divided by its
    parts."""
    n = math.prod(shape) if shape else 1
    parts = math.prod(mesh[a] for a in SP.spec_axes(spec))
    return n * itemsize // parts


def batch_bytes(bundle, shape, mesh, sharding: str) -> int:
    """Per-rank bytes of a shape cell's batch laid out by
    ``batch_pspecs``."""
    total = 0
    for dims, dtype in bundle.batch_struct(shape).values():
        total += _sized(dims, dtype.itemsize,
                        SP.batch_spec(dims, mesh, sharding), mesh)
    return total


def cache_bytes(bundle, shape, mesh, shard_kv_seq: bool) -> int:
    """Per-rank bytes of a decode cell's cache laid out by
    ``cache_pspecs`` (0 for DLRM)."""
    cache = bundle.cache_struct(shape)
    if cache is None:
        return 0
    specs = SP.cache_pspecs(cache, mesh, shard_kv_seq)
    return sum(_sized(tuple(t.shape), t.element_size(), (None,) + specs[k]
                      if t.dim() else (), mesh)
               for k, t in cache.items())


@functools.lru_cache(maxsize=None)
def _layout(arch: str, mesh_name: str, sharding: str, emb_rows: str):
    """``(n_params, n_active_params, per-rank parameter bytes, per-rank
    bytes of one fp32 copy)``: the arch's model on the ``meta`` device laid
    out once per mesh and variant."""
    bundle = build(get_config(arch), device="meta")
    model = bundle.param_struct()
    mesh = MESHES[mesh_name]
    specs = SP.param_specs(model, mesh, sharding, emb_rows)
    return (bundle.n_params(), bundle.n_active_params(),
            SP.shard_bytes(model, specs, mesh),
            SP.shard_bytes(model, specs, mesh, MOMENT_BYTES))


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               run: RunConfig, microbatches: int = 0) -> Dict:
    """The cell's report (JAX's ``lower_cell`` less what XLA gives)."""
    cfg = get_config(arch)
    shape = shapes_for(cfg)[shape_name]
    ok, why = shape_applicable(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    meta = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "kind": shape.kind}
    if not ok:
        return {**meta, "status": "skipped", "reason": why}
    mesh = MESHES[mesh_name]
    n_data = math.prod(mesh[a] for a in SP.data_axes(mesh))
    bundle = build(cfg, device="meta", run=run)
    n_params, n_active, params, fp32 = _layout(arch, mesh_name, run.sharding,
                                               run.emb_rows)
    mb = microbatches or auto_microbatches(cfg, shape, n_data)
    out = {**meta, "status": "ok", "microbatches": mb,
           "devices": math.prod(mesh.values()),
           "param_bytes_per_device": params,
           "batch_bytes_per_device": batch_bytes(bundle, shape, mesh,
                                                 run.sharding)}
    args = params + out["batch_bytes_per_device"]
    if shape.kind == "train":
        out["opt_bytes_per_device"] = 2 * fp32
        args += out["opt_bytes_per_device"]
    elif shape.kind == "decode":
        out["cache_bytes_per_device"] = cache_bytes(bundle, shape, mesh,
                                                    run.shard_kv_seq)
        args += out["cache_bytes_per_device"]
    out["argument_bytes_per_device"] = args
    out["n_params"] = n_params
    out["n_active_params"] = n_active
    out["model_flops"] = roofline.model_flops(out)
    out["model_bytes"] = roofline.model_bytes(out)
    out["run_config"] = {
        "remat": run.remat, "sharding": run.sharding, "microbatches": mb,
        "logits_chunk": run.logits_chunk, "shard_kv_seq": run.shard_kv_seq,
        "emb_rows": run.emb_rows,
        "dlrm_sharded_lookup": run.dlrm_sharded_lookup,
        "moe_local_dispatch": run.moe_local_dispatch}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="per-rank dry-run accounting")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--sharding", default="fsdp_tp")
    ap.add_argument("--no-shard-kv-seq", action="store_true")
    ap.add_argument("--emb-rows", default="all", choices=["all", "model"])
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    archs = ALL_ARCHS if (args.all or not args.arch) else [args.arch]
    cells = [(arch, s) for arch in archs
             for s in ([args.shape] if args.shape
                       else list(shapes_for(get_config(arch))))]
    if args.list:
        for c in cells:
            print(*c)
        return 0
    run = RunConfig(sharding=args.sharding, emb_rows=args.emb_rows,
                    shard_kv_seq=not args.no_shard_kv_seq)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    outdir = Path(args.out) / args.tag
    outdir.mkdir(parents=True, exist_ok=True)
    n_ok = n_fail = 0
    for arch, shape_name in cells:
        for multi in meshes:
            mesh_name = "2x16x16" if multi else "16x16"
            try:
                res = lower_cell(arch, shape_name, multi, run,
                                 args.microbatches)
            except Exception as e:  # a cell's failure is its report
                res = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                       "status": "error", "error": str(e),
                       "traceback": traceback.format_exc()}
            status = res["status"]
            (outdir / f"{arch}__{shape_name}__{mesh_name}.json").write_text(
                json.dumps(res, indent=2))
            n_ok += status == "ok"
            n_fail += status == "error"
            mark = {"ok": "PASS", "skipped": "SKIP", "error": "FAIL"}[status]
            print(f"{mark} {arch} {shape_name} {mesh_name}", flush=True)
            if status == "error":
                print(res["error"], flush=True)
    print(f"dry-run: {n_ok} ok, {n_fail} failed -> {outdir}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
