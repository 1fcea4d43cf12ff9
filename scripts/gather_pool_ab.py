"""Compare the pooled gather (``csrc/embedding_gather.cu``) of two
checkouts of this repo on one card: device times at DLRM's full-width
forward shape, the registers and spills of its kernels, and whether the
two trees' unmasked ``gather_pool`` gives the same bits.

    python scripts/gather_pool_ab.py --trees OLD NEW [--order ABBA]

Each letter of ``--order`` is one worker process (A the first tree, B the
second) that imports ``repro_torch`` from that tree's ``src``, builds its
kernels into that tree's ``build/`` and times ``gather_pool`` at ``SHAPE``
(dlrm-recmg's 856 tables of 72,704 rows, D = 128, bf16, as one (T*R, D)
table; B = 256 queries' 219,136 pooled rows of P = 20 ids), the median of
``--reps`` launches (CUDA events, L2 flushed before each, a spin kernel
hiding the host's launches).  A tree whose wrapper has the shard window
(``gather_pool_shard``) also times it with every id owned and with the
ids of one model rank of a (2, 2) mesh (rows [0, R/2) of each table
kept, the rest -1).  Each worker hashes (SHA-256) the unmasked output at
fp32 and bf16, from ids drawn the same way in every tree.  Prints one
JSON line per worker and a summary: each tree's times by run, its
``gather_pool_kernel`` instantiations' registers and spills (from its
build's ``-Xptxas -v`` report, read by ``chip_smoke.ptxas_kernels``), and
whether every worker of both trees gave the same bits.  Needs one card
and nvcc.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (tables, rows a table, D, queries, P): dlrm-recmg at full width, B = 256.
SHAPE = (856, 72704, 128, 256, 20)


def _median_ms(fn, reps):
    import numpy as np
    import torch

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def _table(n, d, dtype):
    """(n, d) normal rows of ``dtype``, drawn in chunks from one seed."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(0)
    table = torch.empty((n, d), dtype=dtype, device="cuda")
    step = 1 << 24
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        table[lo:hi] = torch.randn((hi - lo, d), generator=g, device="cuda")
    return table


def worker(reps):
    """Times this process's ``repro_torch`` (the tree on PYTHONPATH)."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import embedding_gather as eg

    t, r, d, b, p = SHAPE
    eg._lib()
    rng = np.random.default_rng(0)
    rows = rng.integers(0, r, (b * t, p))
    tab = np.tile(np.arange(t), b)[:, None]  # pooled row q * T + t
    idx = torch.from_numpy((rows + tab * r).astype(np.int32)).cuda()
    # One model rank of a (2, 2) mesh: rows [0, R/2) of each table kept,
    # as ids into its (T * R/2, D) shard; the rest -1.
    half = r // 2
    shard_idx = torch.from_numpy(np.where(
        rows < half, rows + tab * half, -1).astype(np.int32)).cuda()
    out, digests = {}, {}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        table = _table(t * r, d, dtype)
        pooled = eg.gather_pool(table, idx)
        digests[name] = hashlib.sha256(
            pooled.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
        if name == "bf16":
            out["gather_pool"] = _median_ms(lambda: eg.gather_pool(
                table, idx), reps)
            if hasattr(eg, "gather_pool_shard"):
                same = torch.equal(eg.gather_pool_shard(table, idx), pooled)
                out["shard_all_owned"] = _median_ms(
                    lambda: eg.gather_pool_shard(table, idx), reps)
                shard = table[: t * half]
                out["shard_half_owned"] = _median_ms(
                    lambda: eg.gather_pool_shard(shard, shard_idx), reps)
                out["shard_all_owned_bits_equal"] = same
        del table, pooled
        torch.cuda.empty_cache()
    return {"ms": out, "digests": digests,
            "ptxas": _build.ptxas_report("embedding_gather")}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.reps)))
        return
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import ptxas_kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    trees = dict(zip("AB", (Path(t).resolve() for t in args.trees)))
    runs = {t: [] for t in trees}
    kernels, bits = {}, []
    for i, t in enumerate(args.order):
        env = dict(os.environ, PYTHONPATH=str(trees[t] / "src"))
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             "--reps", str(args.reps)], env=env, cwd=trees[t],
            capture_output=True, text=True)
        if res.returncode:
            sys.exit(f"worker {i} ({t}) failed:\n{res.stderr[-4000:]}")
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        runs[t].append(rec["ms"])
        bits.append(rec["digests"])
        kernels[t] = {k: v for k, v in ptxas_kernels(rec["ptxas"]).items()
                      if k.startswith("gather_pool_kernel")}
        print(json.dumps({"run": i, "tree": t, "ms": rec["ms"]}))
    print(json.dumps({"trees": {t: str(p) for t, p in trees.items()},
                      "order": args.order, "device": smi, "shape": SHAPE,
                      "ms_by_run": runs, "pool_kernels": kernels,
                      "bits_equal": {key: len({d[key] for d in bits}) == 1
                                     for key in bits[0]}}))


if __name__ == "__main__":
    main()
