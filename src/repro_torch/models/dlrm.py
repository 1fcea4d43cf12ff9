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
:func:`params_from_jax`.

:func:`embedding_lookup_rowsharded` (:67-105) is the serving lookup with
every table's rows split over the ``model`` ranks of a
:mod:`repro_torch.distributed.mesh` mesh: each rank pools the rows it owns
through the shard window of the ``gather_pool`` kernel
(:func:`repro_torch.kernels.ops.gather_pool_shard`) and the fp32 partial
sums are all-reduced over the ``model`` group, pool before reduce, as
JAX's ``shard_map`` does; ``dlrm_forward(sharded_lookup=True)`` runs it on
the rank's ``data`` part of the batch.  An id outside ``[0, R)`` is owned
by no shard and adds nothing there, where the dense lookup wraps or clamps
it.  :func:`shard_params` and ``init_dlrm(rows=)`` give a rank its rows.
``dlrm_loss(sharded_lookup=True)`` trains through it: the shard window's
backward scatter-adds into the owned rows only, and the all-reduce over
``model`` passes its gradient through unchanged (the loss is replicated
over the model ranks), so each rank's table gradient is its rows' slice
of the dense lookup's.

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
from repro_torch.device import generator, resolve_device
from repro_torch.distributed import mesh as M
from repro_torch.distributed.collectives import all_reduce_identity_bwd
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


def _rows(rows, r: int):
    """``rows`` as ``(lo, hi)`` within a table of ``r`` rows (all of
    them for None)."""
    lo, hi = (0, r) if rows is None else rows
    if not 0 <= lo < hi <= r:
        raise ValueError(f"rows {rows} not within the tables' {r} rows")
    return lo, hi


def init_dlrm(cfg: ModelConfig, seed: int = 0, device="cuda", rows=None):
    """Random DLRM parameters drawn on ``device`` from one seeded
    ``torch.Generator``.  The tables are drawn one at a time into their
    final dtype, so a full-size table never exists in fp32.  ``rows=(lo,
    hi)`` keeps only those rows of every table (a rank's shard): each table
    is still drawn whole from the same generator, so the shard has the
    bits of the unsharded tables' slice, and the MLPs are the same."""
    dev = resolve_device(device)
    lo, hi = _rows(rows, cfg.rows_per_table)
    g = generator(dev, seed)
    dt = torch_dtype(cfg.param_dtype)
    emb = torch.empty((cfg.n_tables, hi - lo, cfg.emb_dim), dtype=dt,
                      device=dev)
    scale = 1.0 / math.sqrt(cfg.emb_dim)
    for t in range(cfg.n_tables):
        emb[t] = (torch.randn((cfg.rows_per_table, cfg.emb_dim), generator=g,
                              device=dev) * scale)[lo:hi]
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


def params_from_jax(tree, device="cuda", rows=None) -> Dict:
    """The JAX ``init_dlrm`` pytree, as NumPy arrays (``{"emb", "bottom":
    {"w": [..], "b": [..]}, "top": ...}``), as the port's parameters on
    ``device``: same layout, same dtypes, same bits.  ``rows=(lo, hi)``
    keeps only those rows of every table (a rank's shard)."""
    dev = resolve_device(device)
    emb = np.asarray(tree["emb"])
    lo, hi = _rows(rows, emb.shape[1])
    return {
        "emb": _tensor(emb[:, lo:hi], dev),
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


def shard_rows(r: int, mesh: M.Mesh):
    """``(lo, hi)``: the rows of every table that ``mesh``'s model rank
    owns, ``[m * R/n, (m + 1) * R/n)``; raises when the model axis does not
    divide R, as ``shard_map`` does."""
    return M.shard_bounds(r, mesh.model, mesh.model_rank)


def shard_params(params, mesh: M.Mesh):
    """``params`` with ``emb`` cut to this rank's rows of every table (a
    contiguous copy, unless the rank owns every row); the MLPs whole."""
    if "emb_scales" in params:
        raise NotImplementedError("quantized tables have no row-sharded "
                                  "lookup (JAX has none)")
    lo, hi = shard_rows(params["emb"].shape[1], mesh)
    return {**params, "emb": params["emb"][:, lo:hi].contiguous()}


def _flat_shard_ids(sparse_idx: torch.Tensor, t: int, rs: int, lo: int
                    ) -> torch.Tensor:
    """(B, T, P) ids of whole tables -> (B*T, P) int32 ids into the (T*Rs,
    D) view of a shard that holds rows ``[lo, lo + Rs)`` of each table:
    ``t*Rs + id - lo`` for an id the shard owns, else -1 (the kernel's
    shard window skips it).  JAX's ``local()`` (``dlrm.py:86-98``)."""
    rel = sparse_idx.to(torch.int32) - lo
    ok = (rel >= 0) & (rel < rs)
    off = torch.arange(t, device=rel.device, dtype=torch.int32) * rs
    flat = torch.where(ok, rel + off[None, :, None], -1)
    b, _, p = flat.shape
    return flat.reshape(b * t, p).contiguous()


def embedding_lookup_rowsharded(emb_shard: torch.Tensor,
                                sparse_idx: torch.Tensor, mesh: M.Mesh,
                                rows: int = 0) -> torch.Tensor:
    """Pool-before-reduce lookup of tables whose rows are split over the
    ``model`` ranks of ``mesh``.

    emb_shard: (T, R/n, D), this rank's rows ``[m R/n, (m+1) R/n)`` of each
    table; sparse_idx: (B_local, T, P) ids of the whole tables, this rank's
    part of the batch -> pooled (B_local, T, D) in emb_shard's dtype.  One
    launch of the shard window of ``gather_pool`` pools the owned rows in
    fp32; the (B_local, T, D) partials are summed over the ``model`` group
    in fp32 (P times fewer bytes than exchanging the rows) and cast once.
    An id outside ``[0, R)`` is owned by no rank and adds nothing, as in
    JAX.  ``rows``, when given, is R: it must split evenly over the model
    axis into the shard's rows.  Differentiable in ``emb_shard``: the
    all-reduce's backward is the identity, as the ``psum`` inside JAX's
    ``shard_map`` transposes for a loss replicated over ``model``."""
    t, rs, d = emb_shard.shape
    if rows:
        lo, hi = shard_rows(rows, mesh)
        if hi - lo != rs:
            raise ValueError(f"the shard holds {rs} rows of each table; "
                             f"model rank {mesh.model_rank} of "
                             f"{mesh.model} owns {hi - lo} of {rows}")
    pooled = ops.gather_pool_shard(
        emb_shard.reshape(t * rs, d),
        _flat_shard_ids(sparse_idx, t, rs, mesh.model_rank * rs))
    pooled = all_reduce_identity_bwd(pooled, mesh.model_group)
    return pooled.reshape(-1, t, d).to(emb_shard.dtype)


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
                 sparse_idx: torch.Tensor, sharded_lookup: bool = False
                 ) -> torch.Tensor:
    """dense: (B, F_dense) f32; sparse_idx: (B, T, P) int -> logits (B,)
    fp32, with the tables in device memory (quantized ones if ``params``
    came from :func:`quantize_tables`).

    ``sharded_lookup``: run under :class:`repro_torch.distributed.mesh.
    activation_sharding`, ``params["emb"]`` this rank's shard of rows
    (:func:`shard_params`), dense and sparse_idx this rank's ``data`` part
    of the batch; the logits are this rank's, and
    :func:`repro_torch.distributed.mesh.gather_batch` gathers them."""
    ct = torch_dtype(cfg.compute_dtype)
    bot = _mlp(params["bottom"], dense.to(ct))
    if sharded_lookup:
        mesh = M.active_mesh()
        if mesh is None:
            raise RuntimeError("the sharded lookup needs a mesh scope "
                               "(repro_torch.distributed.mesh."
                               "activation_sharding)")
        if "emb_scales" in params:
            raise NotImplementedError("quantized tables have no row-sharded "
                                      "lookup (JAX has none)")
        pooled = embedding_lookup_rowsharded(params["emb"].to(ct), sparse_idx,
                                             mesh, rows=cfg.rows_per_table)
    elif "emb_scales" in params:
        pooled = embedding_lookup_dequant(params["emb"], params["emb_scales"],
                                          sparse_idx)
    else:
        pooled = embedding_lookup(params["emb"].to(ct), sparse_idx)
    return interact_top(params, bot, pooled).float()


def dlrm_loss(params, cfg: ModelConfig, dense: torch.Tensor,
              sparse_idx: torch.Tensor, labels: torch.Tensor,
              sharded_lookup: bool = False) -> torch.Tensor:
    """Mean binary cross-entropy of the logits against ``labels`` (B,)
    in {0, 1}, in the numerically stable form JAX writes: ``max(x, 0) - x
    y + log1p(exp(-|x|))``.  ``sharded_lookup``: the forward's, on this
    rank's ``data`` part of the batch; the loss is that part's mean."""
    logit = dlrm_forward(params, cfg, dense, sparse_idx, sharded_lookup)
    loss = (torch.clamp_min(logit, 0.0) - logit * labels
            + torch.log1p(torch.exp(-logit.abs())))
    return loss.mean()
