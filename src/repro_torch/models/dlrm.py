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
it.  :func:`shard_params` and ``init_dlrm(rows=)`` give a rank its rows
(the first tags them with their placement; an untagged shard trains, but
the step's gradient norm then counts only the rank's rows).
``dlrm_loss(sharded_lookup=True)`` trains through it: the shard window's
backward scatter-adds into the owned rows only, and the all-reduce over
``model`` passes its gradient through unchanged (the loss is replicated
over the model ranks), so each rank's table gradient is its rows' slice
of the dense lookup's.

:func:`init_placed` (or :func:`place_tables`, from whole tables) gives a
rank its rows of JAX's ``param_pspecs`` layout (``RunConfig.emb_rows``;
``"all"``: over ``data`` and ``model``, part ``d * model + m`` on rank
(d, m)) and tags the shard with its
:class:`~repro_torch.distributed.mesh.Placement`; :func:`dlrm_forward`
then looks the ids up through :func:`embedding_lookup_placed`, which
keeps JAX's semantics of each flag: with ``sharded_lookup`` an id outside
``[0, R)`` is dropped (the ``shard_map`` lookup), without it the ids are
first wrapped and clamped (the dense lookup's gather).

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
from repro_torch.distributed.collectives import (
    all_reduce_identity_bwd, reduce_scatter_all_gather_bwd)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ROW_FORMATS
from repro_torch.sharding import partition as SP

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


def _wrapped(sparse_idx: torch.Tensor, r: int) -> torch.Tensor:
    """int32 ids of tables of ``r`` rows, a negative id counted from the
    end of its table (``jnp`` indexing)."""
    ids = sparse_idx.to(torch.int32)
    return torch.where(ids < 0, ids + r, ids)


def _in_range(sparse_idx: torch.Tensor, r: int) -> torch.Tensor:
    """:func:`_wrapped`, an id still out of range clamped: the rows
    ``jnp`` indexing reads.  Its gradient drops such an id (the
    transpose of the clamped gather is a scatter that skips it)."""
    return _wrapped(sparse_idx, r).clamp(0, r - 1)


def _flat_ids(sparse_idx: torch.Tensor, t: int, r: int,
              dev: torch.device) -> torch.Tensor:
    """(B, T, P) per-table ids -> (B*T, P) int32 ids into the (T*R, D)
    view of the tables: :func:`_in_range`, then table t offset by t*R."""
    ids = _in_range(sparse_idx, r)
    off = torch.arange(t, device=dev, dtype=torch.int32) * r
    b, _, p = ids.shape
    return (ids + off[None, :, None]).reshape(b * t, p).contiguous()


def _flat_grad_ids(sparse_idx: torch.Tensor, t: int, r: int
                   ) -> torch.Tensor:
    """The ids :func:`_flat_ids`'s gather sends its gradient to: an id out
    of range after :func:`_wrapped` is -1 (dropped), as in JAX."""
    return _flat_shard_ids(_wrapped(sparse_idx, r), t, r, 0)


def embedding_lookup(emb: torch.Tensor, sparse_idx: torch.Tensor
                     ) -> torch.Tensor:
    """emb: (T, R, D); sparse_idx: (B, T, P) int -> pooled (B, T, D) in
    emb's dtype.

    The T tables are viewed as one (T*R, D) table and the ids offset by
    ``t*R``, so the whole lookup is one call of
    :func:`repro_torch.kernels.ops.gather_pool` (one CUDA launch on the
    card), summed in fp32 and cast back to the tables' dtype as the JAX
    path yields it.  Ids index their own table as ``jnp`` indexing does:
    a negative id counts from the end, and one out of range is clamped,
    and its gradient drops such an id, as JAX's does."""
    t, r, d = emb.shape
    grad_ids = (_flat_grad_ids(sparse_idx, t, r) if emb.requires_grad
                else None)
    pooled = ops.gather_pool(emb.reshape(t * r, d),
                             _flat_ids(sparse_idx, t, r, emb.device),
                             grad_ids)
    return pooled.reshape(-1, t, d).to(emb.dtype)


def shard_rows(r: int, mesh: M.Mesh):
    """``(lo, hi)``: the rows of every table that ``mesh``'s model rank
    owns, ``[m * R/n, (m + 1) * R/n)``; raises when the model axis does not
    divide R, as ``shard_map`` does."""
    return M.shard_bounds(r, mesh.model, mesh.model_rank)


def shard_params(params, mesh: M.Mesh):
    """``params`` with ``emb`` cut to this rank's rows of every table (a
    contiguous copy, unless the rank owns every row) and tagged with its
    :class:`~repro_torch.distributed.mesh.Placement`, rows over ``model``
    (:func:`place_tables`'s ``emb_rows="model"`` layout, so a training
    step's gradient norm sums every model rank's rows); the MLPs
    whole."""
    if "emb_scales" in params:
        raise NotImplementedError("quantized tables have no row-sharded "
                                  "lookup (JAX has none)")
    lo, hi = shard_rows(params["emb"].shape[1], mesh)
    emb = params["emb"][:, lo:hi].contiguous()
    emb.placement = M.Placement(mesh, (None, "model"), "fsdp_tp")
    return {**params, "emb": emb}


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
    rs = emb_shard.shape[1]
    if rows:
        lo, hi = shard_rows(rows, mesh)
        if hi - lo != rs:
            raise ValueError(f"the shard holds {rs} rows of each table; "
                             f"model rank {mesh.model_rank} of "
                             f"{mesh.model} owns {hi - lo} of {rows}")
    return embedding_lookup_placed(emb_shard, sparse_idx, mesh, ("model",))


def _row_axes(spec) -> tuple:
    return SP.axes_of(spec[1]) if len(spec) > 1 else ()


def _placed(shape, mesh: M.Mesh, sharding: str, emb_rows: str):
    """``(spec, (lo, hi))``: the tables' spec of ``shape`` on ``mesh``
    (JAX's ``param_pspecs`` rule) and this rank's rows of every table."""
    spec = SP.leaf_spec("emb", shape, mesh, sharding, emb_rows)
    index, parts = SP.part_index(_row_axes(spec), mesh)
    rs = shape[1] // parts
    return spec, (index * rs, (index + 1) * rs)


def init_placed(cfg: ModelConfig, seed: int, device, mesh: M.Mesh,
                sharding: str = "fsdp_tp", emb_rows: str = "all"):
    """:func:`init_dlrm` with ``emb`` this rank's rows of the tables'
    layout on ``mesh`` (the bits of the whole tables' slice), tagged with
    its :class:`~repro_torch.distributed.mesh.Placement`; the MLPs whole
    and untagged."""
    spec, rows = _placed((cfg.n_tables, cfg.rows_per_table, cfg.emb_dim),
                         mesh, sharding, emb_rows)
    params = init_dlrm(cfg, seed, device, rows=rows)
    params["emb"].placement = M.Placement(mesh, spec, sharding)
    return params


def place_tables(params, mesh: M.Mesh, sharding: str = "fsdp_tp",
                 emb_rows: str = "all"):
    """Whole ``params`` with ``emb`` cut to this rank's rows, as
    :func:`init_placed` gives them (a copy), tagged."""
    spec, (lo, hi) = _placed(tuple(params["emb"].shape), mesh, sharding,
                             emb_rows)
    emb = params["emb"][:, lo:hi].clone()
    emb.placement = M.Placement(mesh, spec, sharding)
    return {**params, "emb": emb}


def embedding_lookup_placed(emb_shard: torch.Tensor,
                            sparse_idx: torch.Tensor, mesh: M.Mesh,
                            axes: tuple, grad_idx=None,
                            rows: tuple = ("data",)) -> torch.Tensor:
    """Pool-before-reduce lookup of tables whose rows lie over the mesh
    ``axes`` (a spec entry's: ``("data", "model")``, ``("model",)``,
    ``("data",)`` or none), part ``index`` of them on this rank
    (:func:`repro_torch.sharding.partition.part_index`), for a batch
    whose rows lie over the mesh axes ``rows`` (``data``; both under
    ``"fsdp"``; fewer where they do not divide it).

    emb_shard: (T, Rs, D) this rank's rows ``[index Rs, (index + 1) Rs)``
    of each table; sparse_idx: (B_local, T, P) ids of the whole tables,
    this rank's part of the batch -> pooled (B_local, T, D) in
    emb_shard's dtype.  Over the axes both the tables' rows and the
    batch's lie on, the ranks hold other rows of the tables for other
    rows of the batch, so the ids are all-gathered over them first and
    the rank pools its rows for all of their batch.  One launch of the
    shard window of ``gather_pool`` pools the owned rows in fp32 (an id
    no rank owns adds nothing); the partials are reduce-scattered over
    those axes to this rank's B_local (the backward all-gathers the
    upstream gradient: each rank's loss reads its part) and summed over
    the tables' other axes (the batch is replicated there, and so is the
    loss: the identity backward), in fp32, and cast once.  ``grad_idx``
    (B_local, T, P), when given, holds the ids the backward scatters to.
    :func:`embedding_lookup_rowsharded` is the ``("model",)`` case."""
    t, rs, d = emb_shard.shape
    index, _ = SP.part_index(axes, mesh)
    shared = tuple(a for a in axes if a in rows)
    group, n, _ = mesh.axes_group(shared)
    summed = mesh.axes_group(tuple(a for a in axes if a not in rows))[0]

    def window(ids):
        if ids is None:
            return None
        return _flat_shard_ids(M.gather_batch(ids, mesh, shared), t, rs,
                               index * rs)

    pooled = ops.gather_pool_shard(emb_shard.reshape(t * rs, d),
                                   window(sparse_idx), window(grad_idx))
    pooled = reduce_scatter_all_gather_bwd(pooled, group, 0, n)
    pooled = all_reduce_identity_bwd(pooled, summed)
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
    :func:`repro_torch.distributed.mesh.gather_batch` gathers them.

    With ``params["emb"]`` placed (:func:`init_placed`) the lookup is
    :func:`embedding_lookup_placed` on the placement's mesh, dense and
    sparse_idx this rank's part of the batch, the ids wrapped and clamped
    first unless ``sharded_lookup``."""
    ct = torch_dtype(cfg.compute_dtype)
    bot = _mlp(params["bottom"], dense.to(ct))
    pl = M.placement(params["emb"])
    if pl is not None:
        r = cfg.rows_per_table
        ids, grad_ids = ((sparse_idx, None) if sharded_lookup
                         else (_in_range(sparse_idx, r),
                               _wrapped(sparse_idx, r)))
        # The batch's rows: the step's or serve's scope, else the
        # variant's batch entry (the caller passes the rank's part).
        rows = (M.row_axes() if M.active_mesh() is not None
                else SP.batch_entry(pl.mesh, pl.variant))
        pooled = embedding_lookup_placed(params["emb"].to(ct), ids, pl.mesh,
                                         _row_axes(pl.spec), grad_ids, rows)
    elif sharded_lookup:
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
