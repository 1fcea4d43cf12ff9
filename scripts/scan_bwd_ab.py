"""Compare the scan's backward (``csrc/selective_scan_bwd.cu``) of two
checkouts of this repo on one card: device times at the SSM and hybrid LMs'
training microbatch, and the registers and spills of the kernels.

    python scripts/scan_bwd_ab.py --trees OLD NEW [--order ABBA]

Each letter of ``--order`` is one worker process (A the first tree, B the
second) that imports ``repro_torch`` from that tree's ``src``, builds its
kernels into that tree's ``build/`` and times ``selective_scan_bwd`` at
``chip_smoke.SCAN_BWD_SHAPES`` (falcon-mamba-7b's and hymba-1.5b's training
microbatch, bf16 and fp32) on the states its own forward saved, timed as
``attention_bwd_ab.py`` times (a call is the kernel and the wrapper's sum
of the partials).  A tree whose wrapper has no ``bwd_geometry`` reports null
for the geometry.  Prints one JSON line per worker and a summary line:
each tree's times by run, its geometry, and its
``selective_scan_bwd_kernel`` registers and spills, read from its build's
``-Xptxas -v`` report by ``chip_smoke.ptxas_kernels``.  Needs one card and
nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

from attention_bwd_ab import _median_ms

ROOT = Path(__file__).resolve().parents[1]


def _inputs(b, s, di, n, dtype):
    """The scan's inputs at the model's scales (as ``chip_smoke``'s
    ``scan_inputs``), dt = 0 every seventh step, an h0, a dh_last and dy,
    all from one seed on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(s + di + n)

    def f(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    xc, z = (f(b, s, di).to(dtype) for _ in range(2))
    dt = torch.nn.functional.softplus(f(b, s, di) - 2.0)
    dt[:, ::7] = 0.0
    a = -torch.arange(1, n + 1, dtype=torch.float32, device="cuda").repeat(
        di, 1) * torch.exp(0.1 * f(di, n))
    bm, cm = f(b, s, n), f(b, s, n)
    d_skip = f(di)
    h0, dh_last = f(b, di, n), f(b, di, n)
    dy = f(b, s, di).to(dtype)
    return (xc, z, dt, a, bm, cm, d_skip), h0, dh_last, dy


def worker(reps, shapes):
    """Times this process's ``repro_torch`` (the tree on PYTHONPATH)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as ss

    ss._bwd_lib()
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    out, geo = {}, {}
    for name, b, s, di, n, dt_name in shapes:
        ins, h0, dh_last, dy = _inputs(b, s, di, n, dtypes[dt_name])
        _, _, states = ss.selective_scan(*ins, h0, save_states=True)
        key = f"{name}_{dt_name}"
        out[key] = _median_ms(lambda: ss.selective_scan_bwd(
            *ins, states, dy, dh_last), reps)
        geo[key] = (ss.bwd_geometry(n, dtypes[dt_name])
                    if hasattr(ss, "bwd_geometry") else None)
        del ins, h0, dh_last, dy, states
        torch.cuda.empty_cache()
    return {"ms": out, "geometry": geo,
            "ptxas": _build.ptxas_report("selective_scan_bwd")}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--worker", metavar="SHAPES_JSON")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.reps, json.loads(args.worker))))
        return
    # chip_smoke puts this tree's src first on the path: the workers, which
    # must import their own tree's repro_torch, get its shapes as JSON.
    sys.path.insert(0, str(ROOT))
    from chip_smoke import SCAN_BWD_SHAPES, ptxas_kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    trees = dict(zip("AB", (Path(t).resolve() for t in args.trees)))
    runs = {t: [] for t in trees}
    kernels, geometry = {}, {}
    for i, t in enumerate(args.order):
        env = dict(os.environ, PYTHONPATH=str(trees[t] / "src"))
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             json.dumps(SCAN_BWD_SHAPES), "--reps", str(args.reps)],
            env=env, cwd=trees[t],
            capture_output=True, text=True)
        if res.returncode:
            sys.exit(f"worker {i} ({t}) failed:\n{res.stderr[-4000:]}")
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        runs[t].append(rec["ms"])
        kernels[t] = {k: v for k, v in ptxas_kernels(rec["ptxas"]).items()
                      if k.startswith("selective_scan_bwd_kernel")}
        geometry[t] = rec["geometry"]
        print(json.dumps({"run": i, "tree": t, "ms": rec["ms"]}))
    print(json.dumps({"trees": {t: str(p) for t, p in trees.items()},
                      "order": args.order, "device": smi,
                      "ms_by_run": runs, "kernels": kernels,
                      "geometry": geometry}))


if __name__ == "__main__":
    main()
