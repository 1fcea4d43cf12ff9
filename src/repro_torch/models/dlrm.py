"""The paper's own architecture, DLRM, in PyTorch.

Ported from ``src/repro/models/dlrm.py``: a bottom MLP projects the dense
features to ``emb_dim``, each sparse feature sum-pools ``multi_hot`` rows of
its table, a pairwise dot-product interaction feeds the top MLP, and the
output is one logit per query; ``dlrm_loss`` (:153-160) is the training
loss.  The pooled lookup is differentiable in the tables
(:func:`repro_torch.kernels.ops.gather_pool`: the kernel forward, a
scatter-add backward).

Parameters are a plain dict shaped like the JAX pytree: ``{"emb": (T, R, D),
"bottom": {"w": [...], "b": [...]}, "top": {...}}``.  MLP weights keep the
JAX layout ``(in, out)`` and apply as ``x @ w + b``, so
:func:`params_from_jax` copies arrays without transposing them.
``init_dlrm`` draws from a ``torch.Generator``; its numbers differ from
``jax.random``'s, so the parity tests load JAX's parameters through
:func:`params_from_jax`.  ``embedding_lookup_rowsharded`` (a lookup
sharded across devices) waits for several cards: ROADMAP A10b.

:func:`quantize_tables` stores the tables as the quantized fast tier does
(int8 or fp8 codes and one fp32 scale per row, ``emb_scales`` (T, R)
beside ``emb``); :func:`dlrm_forward` then pools through the dequantizing
gather, the caller the JAX package's ``gather_pool_dequant`` kernel was
written for.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ROW_FORMATS

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r} "
                         f"(expected one of {sorted(_DTYPES)})")
    return _DTYPES[name]


def _init_mlp(g: torch.Generator, dims: Sequence[int], dt: torch.dtype,
              dev: torch.device):
    ws, bs = [], []
    for i in range(len(dims) - 1):
        w = torch.randn((dims[i], dims[i + 1]), generator=g, device=dev)
        ws.append((w / math.sqrt(dims[i])).to(dt))
        bs.append(torch.zeros((dims[i + 1],), dtype=dt, device=dev))
    return {"w": ws, "b": bs}


def _mlp(p, x: torch.Tensor) -> torch.Tensor:
    n = len(p["w"])
    for i in range(n):
        x = x @ p["w"][i].to(x.dtype) + p["b"][i].to(x.dtype)
        if i < n - 1:
            x = torch.relu(x)
    return x


def num_interactions(cfg: ModelConfig) -> int:
    f = cfg.n_tables + 1
    return f * (f - 1) // 2


def init_dlrm(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random DLRM parameters drawn on ``device`` from one seeded
    ``torch.Generator``.  The tables are drawn one at a time into their
    final dtype, so a full-size table never exists in fp32."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = torch_dtype(cfg.param_dtype)
    emb = torch.empty((cfg.n_tables, cfg.rows_per_table, cfg.emb_dim),
                      dtype=dt, device=dev)
    scale = 1.0 / math.sqrt(cfg.emb_dim)
    for t in range(cfg.n_tables):
        emb[t] = torch.randn((cfg.rows_per_table, cfg.emb_dim), generator=g,
                             device=dev) * scale
    bot_dims = (cfg.dense_features,) + tuple(cfg.bottom_mlp)
    top_dims = (cfg.emb_dim + num_interactions(cfg),) + tuple(cfg.top_mlp)
    return {"emb": emb,
            "bottom": _init_mlp(g, bot_dims, dt, dev),
            "top": _init_mlp(g, top_dims, dt, dev)}


def _tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: torch refuses it
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def params_from_jax(tree, device="cuda") -> Dict:
    """The JAX ``init_dlrm`` pytree, as NumPy arrays (``{"emb", "bottom":
    {"w": [..], "b": [..]}, "top": ...}``), as the port's parameters on
    ``device``: same layout, same dtypes, same bits."""
    dev = resolve_device(device)
    return {
        "emb": _tensor(tree["emb"], dev),
        **{k: {"w": [_tensor(w, dev) for w in tree[k]["w"]],
               "b": [_tensor(b, dev) for b in tree[k]["b"]]}
           for k in ("bottom", "top")},
    }


def _flat_ids(sparse_idx: torch.Tensor, t: int, r: int,
              dev: torch.device) -> torch.Tensor:
    """(B, T, P) per-table ids -> (B*T, P) int32 ids into the (T*R, D)
    view of the tables: a negative id counts from the end of its table,
    one out of range is clamped (``jnp`` indexing), then table t is offset
    by t*R."""
    ids = sparse_idx.to(torch.int32)
    ids = torch.where(ids < 0, ids + r, ids).clamp(0, r - 1)
    off = torch.arange(t, device=dev, dtype=torch.int32) * r
    b, _, p = ids.shape
    return (ids + off[None, :, None]).reshape(b * t, p).contiguous()


def embedding_lookup(emb: torch.Tensor, sparse_idx: torch.Tensor
                     ) -> torch.Tensor:
    """emb: (T, R, D); sparse_idx: (B, T, P) int -> pooled (B, T, D) in
    emb's dtype.

    The T tables are viewed as one (T*R, D) table and the ids offset by
    ``t*R``, so the whole lookup is one call of
    :func:`repro_torch.kernels.ops.gather_pool` (one CUDA launch on the
    card), summed in fp32 and cast back to the tables' dtype as the JAX
    path yields it.  Ids index their own table as ``jnp`` indexing does:
    a negative id counts from the end, and one out of range is clamped."""
    t, r, d = emb.shape
    pooled = ops.gather_pool(emb.reshape(t * r, d),
                             _flat_ids(sparse_idx, t, r, emb.device))
    return pooled.reshape(-1, t, d).to(emb.dtype)


def quantize_tables(params, row_format: str = "int8"):
    """``params`` with ``emb`` (T, R, D) replaced by its per-row quantized
    codes and ``emb_scales`` (T, R) fp32 added, on the tables' device.
    One :func:`repro_torch.kernels.ops.quantize_scatter` per table, so only
    one table at a time exists in fp32."""
    emb = params["emb"]
    t, r, d = emb.shape
    codes = torch.empty((t, r, d), dtype=ROW_FORMATS[row_format][0],
                        device=emb.device)
    scales = torch.empty((t, r), dtype=torch.float32, device=emb.device)
    slots = torch.arange(r, dtype=torch.int32, device=emb.device)
    for i in range(t):
        ops.quantize_scatter(codes[i], scales[i], slots, emb[i].float(),
                             row_format)
    return {**params, "emb": codes, "emb_scales": scales}


def embedding_lookup_dequant(codes: torch.Tensor, scales: torch.Tensor,
                             sparse_idx: torch.Tensor) -> torch.Tensor:
    """codes: (T, R, D) int8/fp8; scales: (T, R); sparse_idx: (B, T, P)
    int -> pooled (B, T, D) fp32, ``sum_p code * scale``: one call of
    :func:`repro_torch.kernels.ops.gather_pool_dequant` over the flattened
    tables, ids handled as in :func:`embedding_lookup`."""
    t, r, d = codes.shape
    pooled = ops.gather_pool_dequant(codes.reshape(t * r, d),
                                     scales.reshape(t * r),
                                     _flat_ids(sparse_idx, t, r, codes.device))
    return pooled.reshape(-1, t, d)


def interact_top(params, bot: torch.Tensor, pooled: torch.Tensor
                 ) -> torch.Tensor:
    """Pairwise dot-product interaction of ``[bot, pooled]`` and the top
    MLP: (B, D) and (B, T, D) in the compute dtype -> (B,) logits in it.

    The dots are taken in fp32 (JAX's ``einsum(...,
    preferred_element_type=float32)``; a bf16 ``bmm`` would round them to
    bf16), and ``torch.triu_indices(f, f, 1)`` orders the pairs as
    ``jnp.triu_indices(f, k=1)`` does."""
    ct = bot.dtype
    z = torch.cat([bot[:, None, :], pooled.to(ct)], dim=1).float()
    zz = torch.bmm(z, z.transpose(1, 2))
    f = z.shape[1]
    iu, ju = torch.triu_indices(f, f, offset=1, device=z.device)
    inter = zz[:, iu, ju]
    top_in = torch.cat([bot.float(), inter], dim=1)
    return _mlp(params["top"], top_in.to(ct))[:, 0]


def dlrm_forward(params, cfg: ModelConfig, dense: torch.Tensor,
                 sparse_idx: torch.Tensor) -> torch.Tensor:
    """dense: (B, F_dense) f32; sparse_idx: (B, T, P) int -> logits (B,)
    fp32, with the tables in device memory (quantized ones if ``params``
    came from :func:`quantize_tables`)."""
    ct = torch_dtype(cfg.compute_dtype)
    bot = _mlp(params["bottom"], dense.to(ct))
    if "emb_scales" in params:
        pooled = embedding_lookup_dequant(params["emb"], params["emb_scales"],
                                          sparse_idx)
    else:
        pooled = embedding_lookup(params["emb"].to(ct), sparse_idx)
    return interact_top(params, bot, pooled).float()


def dlrm_loss(params, cfg: ModelConfig, dense: torch.Tensor,
              sparse_idx: torch.Tensor, labels: torch.Tensor
              ) -> torch.Tensor:
    """Mean binary cross-entropy of the logits against ``labels`` (B,)
    in {0, 1}, in the numerically stable form JAX writes: ``max(x, 0) - x
    y + log1p(exp(-|x|))``."""
    logit = dlrm_forward(params, cfg, dense, sparse_idx)
    loss = (torch.clamp_min(logit, 0.0) - logit * labels
            + torch.log1p(torch.exp(-logit.abs())))
    return loss.mean()
