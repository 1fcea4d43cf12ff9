"""Check the query-offset mode of the attention forward and backward
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``) on one
card, and that it left the old calls' bits alone.

    python scripts/flash_offset_check.py --trees OLD NEW

Each tree runs in a worker process that imports ``repro_torch`` from that
tree's ``src`` and builds its kernels into that tree's ``build/``.  Both
workers hash (SHA-256) ``flash_attention``'s output and log-sum-exp, and
``flash_attention_bwd``'s dq, dk and dv (keys ending ``_bwd``), at
``BIT_SHAPES`` (causal, windowed, unmasked, a ragged S; fp32 and bf16),
from inputs drawn the same way in both trees; the summary says by shape
whether the two trees gave the same bits.  The NEW tree's worker also
holds the offset mode against ``ref.kv_stream_attention_ref`` at
``OFFSET_CASES`` (qwen2.5-3b's rank shapes under a four-way sequence
split, a window, an unmasked case and a ragged offset) and says whether
each offset's rows equal the same rows of the whole attention bit for bit
(expected where the offset is a whole number of query tiles: 64 rows
fp32, 128 bf16), and its backward's largest error against
``ref.flash_attention_bwd_ref`` at the same offset (``bwd_max_rel_err``,
over each gradient's largest magnitude; where the tree has the backward's
offset mode).  Prints one JSON line per worker and a summary line.
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

# (name, B, S, H, K, hd, window, causal)
BIT_SHAPES = (("causal", 2, 1000, 16, 2, 128, 0, True),
              ("window", 1, 2048, 25, 5, 64, 1024, True),
              ("unmasked", 2, 300, 20, 20, 64, 0, False),
              ("small", 1, 77, 4, 2, 16, 0, True))
# (name, B, Sq, Sk, H, K, hd, offsets, window, causal)
OFFSET_CASES = (
    ("qwen_seq4", 8, 512, 2048, 16, 2, 128, (0, 512, 1024, 1536), 0, True),
    ("qwen_seq4_window", 8, 512, 2048, 16, 2, 128, (1536,), 700, True),
    ("qwen_unmasked", 8, 512, 2048, 16, 2, 128, (0,), 0, False),
    ("ragged", 2, 300, 1000, 9, 3, 64, (100, 700), 0, True))


def _digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().view(-1).view(
            __import__("torch").uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def worker(offsets: bool) -> dict:
    import torch

    from repro_torch.kernels import flash_attention as fa

    out = {"bits": {}}
    for name, b, s, h, n_kv, hd, w, causal in BIT_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(s + hd)
            q, k, v = (torch.randn((b, s, n, hd), generator=g,
                                   device="cuda").to(dt)
                       for n in (h, n_kv, n_kv))
            o = fa.flash_attention(q, k, v, window=w, causal=causal)
            o2, lse = fa.flash_attention(q, k, v, with_lse=True, window=w,
                                         causal=causal)
            out["bits"][f"{name}_{str(dt)[6:]}"] = _digest(o, o2, lse)
            do = torch.randn(q.shape, generator=g, device="cuda").to(dt)
            out["bits"][f"{name}_{str(dt)[6:]}_bwd"] = _digest(
                *fa.flash_attention_bwd(q, k, v, o2, do, lse, window=w,
                                        causal=causal))
    if not offsets:
        return out
    from repro_torch.kernels import ref

    res = {}
    for name, b, sq, sk, h, n_kv, hd, offs, w, causal in OFFSET_CASES:
        for dt in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(sk + hd)
            qf = torch.randn((b, sk, h, hd), generator=g, device="cuda").to(dt)
            k, v = (torch.randn((b, sk, n_kv, hd), generator=g,
                                device="cuda").to(dt) for _ in range(2))
            whole = fa.flash_attention(qf, k, v, window=w, causal=causal)
            for off in offs:
                q = qf[:, off:off + sq].contiguous()
                got = fa.flash_attention(q, k, v, window=w, causal=causal,
                                         q_offset=off)
                want = ref.kv_stream_attention_ref(q, k, v, w, 512, off,
                                                   causal)
                tile = 64 if dt == torch.float32 else 128
                entry = {
                    "max_abs_err": float((got.float() - want.float())
                                         .abs().max()),
                    "rows_bit_equal": bool(torch.equal(
                        got, whole[:, off:off + sq])),
                    "whole_tiles": off % tile == 0}
                o, lse = fa.flash_attention(q, k, v, with_lse=True, window=w,
                                            causal=causal, q_offset=off)
                do = torch.randn(q.shape, generator=g, device="cuda").to(dt)
                got_b = fa.flash_attention_bwd(q, k, v, o, do, lse, window=w,
                                               causal=causal, q_offset=off)
                want_b = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, w,
                                                     causal, off)
                entry["bwd_max_rel_err"] = max(
                    float((a.float() - b.float()).abs().max())
                    / max(float(b.float().abs().max()), 1e-30)
                    for a, b in zip(got_b, want_b))
                res[f"{name}_{off}_{str(dt)[6:]}"] = entry
    out["offset"] = res
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--worker", choices=("old", "new"))
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker == "new")))
        return 0
    runs = {}
    for tag, tree in zip(("old", "new"), args.trees):
        env = dict(os.environ, PYTHONPATH=str(Path(tree).resolve() / "src"))
        p = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--worker", tag], env=env, capture_output=True,
                           text=True, cwd=tree)
        if p.returncode:
            print(p.stdout, p.stderr, file=sys.stderr)
            return 1
        runs[tag] = json.loads(p.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tag, **runs[tag]}))
    same = {k: runs["old"]["bits"][k] == runs["new"]["bits"][k]
            for k in runs["new"]["bits"]}
    print(json.dumps({"summary": {"same_bits": same,
                                  "offset": runs["new"]["offset"]}}))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
