"""The model accounting of a dry-run cell: useful FLOPs and the least
bytes a step must move.

Ported from ``src/repro/launch/roofline.py:36-93`` (``_n_active``,
``model_flops``, ``model_bytes``): pure arithmetic over a cell's report
(:mod:`repro_torch.launch.dryrun`).  ``model_flops`` is 6 N D for
training (N the active parameters: an MoE's experts at ``top_k /
n_experts``), 2 N D for prefill and 2 N B for decode; DLRM counts its MLPs,
its pairwise interaction and its pooling per query.  ``model_bytes`` reads
every parameter once (the per-rank bytes times the ranks) and, for decode,
at least the step's arguments: JAX takes them from XLA's
``memory_analysis``, the port from its own per-rank accounting
(``argument_bytes_per_device``: parameters, batch and decode cache).

JAX's ``roofline_row`` and its peak constants (a TPU's) are not ported:
its compute, memory and collective terms read XLA's HLO
(``launch/hlo_analysis.py``), which nothing in the port emits; the H100's
limits come with the port's benchmark (ROADMAP A15).
"""
from __future__ import annotations

from typing import Dict

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
