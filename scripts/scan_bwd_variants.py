"""Time variants of the scan's backward (``csrc/selective_scan_bwd.cu``) on
one card: what each part of the kernel costs, by taking it out.

    python scripts/scan_bwd_variants.py [--variants base,lb1,...]

Each variant is this checkout's source with textual patches (``VARIANTS``),
built by ``nvcc`` with the repo's flags into ``build/scan_bwd_variants/``
and called through the repo's wrapper at falcon-mamba-7b's and hymba-1.5b's
bf16 training microbatch (``chip_smoke.SCAN_BWD_SHAPES``), timed as
``scripts/scan_bwd_ab.py`` times (median of ``--reps`` calls, L2 flushed).
All but ``base`` and ``lb1`` compute wrong gradients on purpose: they say
what a part costs, not how to do without it.  Prints one JSON line per
variant (registers and spills from nvcc's ``-Xptxas -v`` report, ms, and
whether the gradients equal ``base``'s bit for bit) after the card's name
and power limit.  A patch that no longer applies to the source stops the
script.  With ``--sass``, first the instructions of the bf16, N = 16
kernel's tile body (between its two block barriers) a lane and step,
with their commonest opcodes, from ``cuobjdump -sass`` of the ``base``
build.  Needs one card and nvcc.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
from chip_smoke import SCAN_BWD_SHAPES, ptxas_kernels  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import selective_scan as ss  # noqa: E402
from scan_bwd_ab import _inputs, _median_ms  # noqa: E402

SRC = _build.CSRC / "selective_scan_bwd.cu"
OUT = ROOT / "build" / "scan_bwd_variants"

# name -> [(text in the source, its replacement)].
VARIANTS = {
    "base": [],
    # One block an SM: registers uncapped (8 warps an SM instead of 16).
    "lb1": [("  return 512 / threads<N>();", "  return 1;")],
    # No sums over a channel's lanes (r, sum dh B, ... stay partial).
    "no_group_sums": [(
        "                                                     int j) {\n",
        "                                                     int j) {\n"
        "  return;\n")],
    # No dB, dC sums over a warp's channels: the lane's own values, added
    # without shuffles.
    "no_channel_sums": [(
        "                                                        int lane) {\n",
        "                                                        int lane) {\n"
        "  return ((p[0] + p[1]) + (p[2] + p[3])) + "
        "((p[4] + p[5]) + (p[6] + p[7]));\n")],
    # The recompute's exponentials replaced by an FMA.
    "no_recompute_ex2": [(
        "            fmaf(exp2_approx(dtv * a2[v]), hs[u][v], dtx * bn[v]);",
        "            fmaf(fmaf(dtv, a2[v], 1.0f), hs[u][v], dtx * bn[v]);")],
    # No staging after the first two tiles (the stage is reused).
    "no_stage_loads": [("    if (k + 1 < n_chunks) {\n      load_stage(",
                        "    if (k + 1 < n_chunks && k < 1) {\n"
                        "      load_stage(")],
    # No outputs of a tile but the first: dx, dz, ddt and the dB, dC
    # partials are neither stored nor summed.
    "no_tile_stores": [("    store_out(c);\n",
                        "    if (c != 0) continue;\n    store_out(c);\n")],
}


def patched(name):
    """The source of variant ``name``."""
    text = SRC.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            sys.exit(f"variant {name}: patch does not apply: {old!r}")
        text = text.replace(old, new)
    return text


def build(name):
    text = patched(name)
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"{name}.cu"
    src.write_text(text)
    lib = OUT / f"{name}.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                          f"-I{_build.CSRC}", "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        sys.exit(f"variant {name}: nvcc failed:\n{res.stdout}{res.stderr}")
    return name, lib, res.stdout + res.stderr


def tile_body(sass: str, steps: int = 16) -> dict:
    """The bf16, N = 16 kernel's instructions between its two BAR.SYNCs
    (the unrolled passes over one tile), a lane and step, and the ten
    commonest opcodes a step."""
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next(f for f in funcs[1:]
                if "selective_scan_bwd_kernel" in f.split("\n", 1)[0]
                and "nv_bfloat16Li16" in f.split("\n", 1)[0])
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     body)
    bars = [i for i, op in enumerate(ops) if op.startswith("BAR.SYNC")]
    tile = ops[bars[0] + 1:bars[1]]
    count = collections.Counter(op.split(".")[0] for op in tile)
    return {"per_lane_step": len(tile) / steps,
            "top_per_lane_step": {k: v / steps
                                  for k, v in count.most_common(10)}}


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    names = args.variants.split(",")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with ThreadPoolExecutor(len(names)) as ex:
        built = list(ex.map(build, names))
    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(_build._nvcc()),
                                 "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", str(built[0][1])],
                              capture_output=True, text=True,
                              check=True).stdout
        print(json.dumps({"variant": built[0][0],
                          "tile_body": tile_body(sass)}), flush=True)
    lib0 = ss._bwd_lib()
    shapes = [s for s in SCAN_BWD_SHAPES if s[5] == "bf16"]
    data = {}
    for name, b, s, di, n, dt_name in shapes:
        ins, h0, dh_last, dy = _inputs(b, s, di, n, torch.bfloat16)
        _, _, states = ss.selective_scan(*ins, h0, save_states=True)
        data[name] = (ins, states, dy, dh_last)
    base = {}
    for name, lib, report in built:
        cdll = ctypes.CDLL(str(lib))
        cdll.repro_selective_scan_bwd.argtypes = \
            lib0.repro_selective_scan_bwd.argtypes
        cdll.repro_selective_scan_bwd.restype = ctypes.c_int
        ss._BWD_LIB = cdll
        rec = {"variant": name,
               "kernels": {k: v for k, v in ptxas_kernels(report).items()
                           if k.endswith(",16>")}}
        for shape, (ins, states, dy, dh_last) in data.items():
            got = ss.selective_scan_bwd(*ins, states, dy, dh_last)
            torch.cuda.synchronize()
            if name == "base":
                base[shape] = got
            rec[f"{shape}_bf16_ms"] = _median_ms(
                lambda: ss.selective_scan_bwd(*ins, states, dy, dh_last),
                args.reps)
            if shape in base:
                rec[f"{shape}_bit_equal_base"] = all(
                    torch.equal(u, v) for u, v in zip(got, base[shape]))
        ss._BWD_LIB = lib0
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
