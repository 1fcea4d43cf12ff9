"""Compare the bf16 attention backward (``csrc/flash_attention_bwd.cu``) of
two checkouts of this repo on one card: device times at the LM training
shapes, the registers and spills of the tensor-core kernels, and whether
the two trees' causal and windowed attention give the same bits.

    python scripts/attention_bwd_ab.py --trees OLD NEW [--order ABBA]

Each letter of ``--order`` is one worker process (A the first tree, B the
second) that imports ``repro_torch`` from that tree's ``src``, builds its
kernels into that tree's ``build/`` and times
``flash_attention_bwd`` at ``SHAPES`` (the median of ``--reps`` launches,
CUDA events, L2 flushed before each, a spin kernel hiding the host's
launches).  A tree whose wrapper takes no ``window`` reports null for the
windowed shape.  Each worker also hashes (SHA-256) the forward's output,
its output and log-sum-exp, and the backward's dq, dk and dv at
``BIT_SHAPES`` in both dtypes, from inputs drawn the same way in every
tree.  Prints one JSON line per worker and a summary line: each tree's
times by run, its ``attn_bwd_*_mma`` kernels' registers and spills, read
from its build's ``-Xptxas -v`` report by ``chip_smoke.ptxas_kernels``,
and by shape whether every worker of both trees gave the same bits.
Needs one card and nvcc.
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

# (name, B, S, H, K, hd, window): smollm-135m's, granite-moe's and
# hymba-1.5b's training microbatch (hymba causal and in its window).
SHAPES = (("smollm_train", 4, 4096, 9, 3, 64, 0),
          ("granite_train", 4, 4096, 16, 8, 64, 0),
          ("hymba_train_causal", 4, 4096, 25, 5, 64, 0),
          ("hymba_train_window", 4, 4096, 25, 5, 64, 1024))
# (name, B, S, H, K, hd, window): causal at the training cut, a ragged S
# and hd 128 (G = 8), and in a window.
BIT_SHAPES = (("train_cut", 4, 4096, 9, 3, 64, 0),
              ("ragged", 2, 1000, 9, 3, 64, 0),
              ("hd128", 1, 300, 16, 2, 128, 0),
              ("window", 1, 2048, 25, 5, 64, 1024))


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


def worker(reps):
    """Times this process's ``repro_torch`` (the tree on PYTHONPATH)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    fa._bwd_lib()
    out = {}
    for name, b, s, h, n_kv, hd, w in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(s + hd + 1)
        q, k, v, do = (torch.randn((b, s, n, hd), generator=g, device="cuda")
                       .to(torch.bfloat16) for n in (h, n_kv, n_kv, h))
        kw = {"window": w} if w else {}
        try:
            o, lse = fa.flash_attention(q, k, v, with_lse=True, **kw)
            out[name] = _median_ms(lambda: fa.flash_attention_bwd(
                q, k, v, o, do, lse, **kw), reps)
        except TypeError:  # a wrapper without the window
            out[name] = None
        del q, k, v, do
        torch.cuda.empty_cache()
    return {"ms": out, "digests": digests(),
            "ptxas": _build.ptxas_report("flash_attention_bwd")}


def digests():
    """{shape/dtype: SHA-256 of the forward's output (serve path), its
    output and log-sum-exp, and dq, dk, dv} at ``BIT_SHAPES``."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    out = {}
    for name, b, s, h, n_kv, hd, w in BIT_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(s + hd + w)
            q, k, v, do = (torch.randn((b, s, n, hd), generator=g,
                                       device="cuda").to(dt)
                           for n in (h, n_kv, n_kv, h))
            kw = {"window": w} if w else {}
            h_ = hashlib.sha256()
            served = fa.flash_attention(q, k, v, **kw)
            o, lse = fa.flash_attention(q, k, v, with_lse=True, **kw)
            for t in (served, o, lse,
                      *fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)):
                h_.update(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes())
            out[f"{name}/{str(dt).split('.')[-1]}"] = h_.hexdigest()
            del q, k, v, do, served, o, lse
            torch.cuda.empty_cache()
    return out


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
                      if "_mma" in k}
        print(json.dumps({"run": i, "tree": t, "ms": rec["ms"]}))
    print(json.dumps({"trees": {t: str(p) for t, p in trees.items()},
                      "order": args.order, "device": smi,
                      "ms_by_run": runs, "mma_kernels": kernels,
                      "bits_equal": {key: len({d[key] for d in bits}) == 1
                                     for key in bits[0]}}))


if __name__ == "__main__":
    main()
