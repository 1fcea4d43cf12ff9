"""The roofline of a dry-run cell: its model arithmetic, and the compute,
memory and collective terms of one rank's step against the H100's limits.

Ported from ``src/repro/launch/roofline.py``: ``_n_active``,
``model_flops`` and ``model_bytes`` (:36-93), pure arithmetic over a
cell's report (:mod:`repro_torch.launch.dryrun`); ``model_flops`` is 6 N D
for training (N the active parameters: an MoE's experts at ``top_k /
n_experts``), 2 N D for prefill and 2 N B for decode, DLRM its MLPs, its
pairwise interaction and its pooling per query; ``model_bytes`` reads
every parameter once (the per-rank bytes times the ranks) and, for
decode, at least the step's arguments (JAX takes them from XLA's
``memory_analysis``, the port from its own per-rank accounting:
parameters, batch and decode cache).

``roofline_row``, ``load_rows``, ``fmt_s``, ``to_markdown`` and ``main``
(:96-205) read the traced half of a cell
(:mod:`repro_torch.launch.accounting`), every figure per rank:

    compute term    = cost["dot_flops"] / PEAK_FLOPS
    memory term     = cost["bytes_accessed"] / HBM_BW
    collective term = collectives["collective_bytes"] / LINK_BW

The port runs eager ops, so its bytes are each op's own traffic and need
no scaling by a fused figure (JAX's :103-111).  The largest term is the
roofline-bound step time and names the bottleneck; ``useful_ratio`` is
``model_flops / (dot_flops x ranks)`` (remat, replicated compute),
``roofline_fraction`` the ideal time (``model_flops`` at the peak over
every rank, decode ``model_bytes`` over HBM) over the bound.  The limits
are an H100 80GB HBM3 (SXM5) at 700 W, the card of ``PERF.md``'s bounds
(datasheet figures, not measurements).

    python -m repro_torch.launch.roofline [--dir runs/dryrun] [--tag
        baseline] [--mesh 16x16] [--json-out FILE]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

# H100 80GB HBM3 (SXM5), 700 W, datasheet figures: dense bf16 on the
# tensor cores, HBM3, and one 400 Gb/s NDR InfiniBand NIC a GPU (the DGX
# H100's layout: every group of the (16, 16) mesh spans 8-GPU nodes, so
# the NIC, not NVLink, limits its collectives).
PEAK_FLOPS = 989e12  # FLOP/s, H100 80GB HBM3 (SXM5), 700 W: bf16 dense
HBM_BW = 3.35e12  # B/s, H100 80GB HBM3 (SXM5), 700 W: HBM3
LINK_BW = 50e9  # B/s a GPU, H100 80GB HBM3 (SXM5), 700 W: one NDR NIC
CARD = "H100 80GB HBM3 (SXM5), 700 W"

_N_ACTIVE_CACHE: Dict[str, int] = {}

# The LM shape cells' tokens a sequence and sequences a step
# (configs/base.py::LM_SHAPES; a decode step is one token), and DLRM's
# queries a step (DLRM_SHAPES).
_SEQ = {"train_4k": 4096, "prefill_32k": 32768, "decode_32k": 1,
        "long_500k": 1}
_BATCH = {"train_4k": 256, "prefill_32k": 32, "decode_32k": 128,
          "long_500k": 1}
_DLRM_BATCH = {"infer_6k": 6144, "infer_18k": 18432, "train_6k": 6144}


def _n_active(arch: str) -> int:
    if arch not in _N_ACTIVE_CACHE:
        from repro_torch.configs import get_config
        from repro_torch.models.model_api import build

        _N_ACTIVE_CACHE[arch] = build(get_config(arch),
                                      device="meta").n_active_params()
    return _N_ACTIVE_CACHE[arch]


def model_flops(cell: Dict) -> float:
    """Global useful FLOPs a step from the analytic 6ND / 2ND rule."""
    n_act = _n_active(cell["arch"])
    kind, shape = cell["kind"], cell["shape"]
    if cell["arch"] == "dlrm-recmg":
        # The tables are touched sparsely: the useful dense compute is the
        # MLPs, the pairwise interaction and the pooling of each query.
        from repro_torch.configs import get_config

        cfg = get_config("dlrm-recmg")
        f = cfg.n_tables + 1
        bot = sum(a * b for a, b in zip(
            (cfg.dense_features,) + tuple(cfg.bottom_mlp[:-1]),
            cfg.bottom_mlp))
        top_in = cfg.emb_dim + f * (f - 1) // 2
        top = sum(a * b for a, b in zip(
            (top_in,) + tuple(cfg.top_mlp[:-1]), cfg.top_mlp))
        inter = f * f * cfg.emb_dim
        pool = cfg.n_tables * cfg.multi_hot * cfg.emb_dim
        per_q = 2 * (bot + top) + 2 * inter + 2 * pool
        mult = 3 if kind == "train" else 1
        return mult * per_q * _DLRM_BATCH[shape]
    per = 6 if kind == "train" else 2
    return per * n_act * _SEQ[shape] * _BATCH[shape]


def model_bytes(cell: Dict) -> float:
    """The least global bytes a step moves: every live parameter read once;
    for decode, at least the step's arguments (the cache dominates)."""
    devices = cell.get("devices", 1)
    p_bytes = cell.get("param_bytes_per_device", 0) * devices
    if cell["kind"] != "decode":
        return float(p_bytes)
    arg_bytes = cell.get("argument_bytes_per_device", 0) * devices
    return float(max(p_bytes, arg_bytes))


def roofline_row(cell: Dict) -> Optional[Dict]:
    """A traced ``ok`` cell's terms (seconds a step, per rank), its
    bottleneck and its fractions; None for any other cell."""
    if cell.get("status") != "ok" or "cost" not in cell:
        return None
    flops_dev = cell["cost"]["dot_flops"]
    bytes_dev = cell["cost"]["bytes_accessed"]
    coll_dev = cell["collectives"]["collective_bytes"]
    chips = cell.get("devices", 256)
    terms = {"compute": flops_dev / PEAK_FLOPS,
             "memory": bytes_dev / HBM_BW,
             "collective": coll_dev / LINK_BW}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cell)
    bound_t = max(terms.values())
    if cell["kind"] == "decode":
        ideal_t = model_bytes(cell) / (chips * HBM_BW)
    else:
        ideal_t = mf / (chips * PEAK_FLOPS)
    ma = cell["memory_analysis"]
    hbm = (ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]
           + ma["output_size_in_bytes"] - ma["alias_size_in_bytes"])
    return {
        "arch": cell["arch"], "shape": cell["shape"], "mesh": cell["mesh"],
        "kind": cell["kind"], "compute_s": terms["compute"],
        "memory_s": terms["memory"], "collective_s": terms["collective"],
        "dominant": dominant, "model_flops": mf,
        "dot_flops_dev": flops_dev, "bytes_dev": bytes_dev,
        "collective_bytes_dev": coll_dev,
        "useful_ratio": mf / max(flops_dev * chips, 1.0),
        "roofline_fraction": ideal_t / max(bound_t, 1e-30),
        "bound_step_s": bound_t, "hbm_gb_per_dev": hbm / 1e9,
        "microbatches": cell.get("microbatches")}


def load_rows(tag_dir: Path, mesh: Optional[str] = None) -> List[Dict]:
    rows = []
    for f in sorted(Path(tag_dir).glob("*.json")):
        cell = json.loads(f.read_text())
        if mesh and cell.get("mesh") != mesh:
            continue
        r = roofline_row(cell)
        if r:
            rows.append(r)
    return rows


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def to_markdown(rows: List[Dict]) -> str:
    hdr = ("| arch | shape | mesh | compute | memory | collective | bound | "
           "useful | roofline-frac | HBM/dev |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} "
            f"| {fmt_s(r['collective_s'])} | **{r['dominant']}** "
            f"| {r['useful_ratio']*100:.1f}% "
            f"| {r['roofline_fraction']*100:.1f}% "
            f"| {r['hbm_gb_per_dev']:.2f}GB |\n")
    return "".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description="the roofline of a dry-run's "
                                             "traced cells on the H100")
    ap.add_argument("--dir", default="runs/dryrun")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--json-out", default="")
    args = ap.parse_args(argv)

    rows = load_rows(Path(args.dir) / args.tag, args.mesh or None)
    rows.sort(key=lambda r: r["roofline_fraction"])
    print(f"limits, {CARD}: {PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16 dense, "
          f"{HBM_BW / 1e12:.2f} TB/s HBM3, {LINK_BW / 1e9:.0f} GB/s a GPU "
          "(one NDR NIC); datasheet figures\n")
    print(to_markdown(rows))
    worst = rows[:3]
    coll_bound = [r for r in rows if r["dominant"] == "collective"]
    print(f"\ncells: {len(rows)}; worst roofline fraction: "
          + ", ".join(f"{r['arch']}/{r['shape']}"
                      f"={r['roofline_fraction']*100:.1f}%" for r in worst))
    if coll_bound:
        print("collective-bound: "
              + ", ".join(f"{r['arch']}/{r['shape']}" for r in coll_bound))
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(rows, indent=2))
    return rows


if __name__ == "__main__":
    main()
