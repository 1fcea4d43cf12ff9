"""Partitioning rules: which mesh axes each parameter's dims shard over.

Copied from ``src/repro/sharding/partition.py:22-272`` (``STACKED_KEYS``,
``data_axes``, ``batch_entry``, ``seq_entry``, ``fit_spec``, ``_RULES``
and the rules of ``param_pspecs``, ``batch_pspecs`` and
``cache_pspecs``), without JAX: a spec is a tuple with one entry a dim,
``None`` (replicated), an axis name or a tuple of axis names, trailing
``None``s dropped, as a ``PartitionSpec`` holds them.  Imports torch and
nothing of JAX.

Strategy ("fsdp_tp", the default): every >= 2-D parameter shards its
feature-out dim over ``model`` (tensor parallelism) and one other large
dim over ``data`` (FSDP/ZeRO-3); an assignment whose dim the axes' size
does not divide is dropped, progressively for a tuple of axes, so odd head
counts or vocabularies replicate instead.  Variants: ``"tp"`` (no FSDP),
``"dp"`` (everything replicated), ``"fsdp"`` and ``"fsdp_seq"`` (the
largest rule dim over every axis, no tensor parallelism).

JAX stacks an LM's layers on a leading axis that is never sharded
(``blocks``, ``enc_blocks``, ``dec_blocks``); the port keeps one leaf a
layer (``blocks.3.attn.wq``), whose spec is JAX's for the stacked leaf
without its leading ``None``.  Rank ``d * model + m`` of a mesh sits at
``(d, m)``; a dim over ``("data", "model")`` is cut into ``data * model``
parts, part ``d * model + m`` on that rank, as JAX lays a tuple of axes
out.

A mesh here is anything with a ``shape`` mapping (a
:class:`repro_torch.distributed.mesh.Mesh`, a stand-in), the mapping
itself or a ``(data, model)`` pair.

A batch's layout is JAX's ``batch_pspecs`` (:func:`batch_spec`: the
global batch over :func:`batch_entry`'s axes and, under ``"fsdp_seq"``,
the sequence over ``model``, :func:`seq_entry`) and a decode cache's
JAX's ``cache_pspecs`` (:func:`cache_spec`, one layer's slice: the batch
over the data axes, the ring's slots or, without ``shard_kv_seq``, the
KV heads over ``model``; the mamba states' channels over ``model``).

The mamba block's fused ``in_proj`` (D, 2 Di) lies over ``model`` by its
columns as one block, so at model 2 rank 0 holds every channel of ``xi``
and rank 1 every channel of ``z`` (JAX splits ``xz`` after the product,
``layers.py:664-665``); a channel-parallel block wants ``xi`` and ``z`` of
its own channels.  :func:`in_proj_blocks` says where each column of a
rank's shard belongs.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.tree import named_leaves

STACKED_KEYS = ("blocks", "enc_blocks", "dec_blocks")
VARIANTS = ("fsdp_tp", "tp", "dp", "fsdp", "fsdp_seq")
EMB_ROWS = ("all", "model")

Spec = Tuple  # entries: None | axis name | tuple of axis names

# (model_dim, fsdp_dim) for each named parameter, relative to the UNSTACKED
# tensor.  Parent-qualified names ("moe/w1") take precedence.
_RULES = {
    "embed": (0, 1),
    "lm_head": (1, 0),
    "wq": (1, 0), "wk": (1, 0), "wv": (1, 0), "wo": (0, 1),
    "bq": (0, None), "bk": (0, None), "bv": (0, None),
    "w1": (1, 0), "w3": (1, 0), "w2": (0, 1),
    "router": (None, 0),
    "moe/w1": (2, 1), "moe/w3": (2, 1), "moe/w2": (1, 2),
    "in_proj": (1, 0),
    "conv_w": (1, None), "conv_b": (0, None),
    "x_proj": (0, None), "dt_proj": (1, None), "dt_bias": (0, None),
    "A_log": (0, None), "D_skip": (0, None),
    "out_proj": (0, 1),
}


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a mesh, a stand-in or a ``(data, model)``
    pair."""
    if isinstance(mesh, (tuple, list)):
        return {"data": int(mesh[0]), "model": int(mesh[1])}
    return dict(mesh if isinstance(mesh, dict) else mesh.shape)


def check_variant(sharding: str) -> None:
    if sharding not in VARIANTS:
        raise ValueError(f"sharding {sharding!r}: expected one of "
                         f"{VARIANTS}")


def data_axes(mesh) -> Tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def batch_entry(mesh, variant: str) -> Tuple[str, ...]:
    """Axes the batch dim of activations and inputs shards over: every
    axis under ``"fsdp"`` (no tensor parallelism), else the data axes."""
    dp = data_axes(mesh)
    return dp + ("model",) if variant == "fsdp" else dp


def seq_entry(mesh, variant: str) -> Optional[Tuple[str, ...]]:
    """Axes the sequence dim of activations shards over: ``model`` under
    ``"fsdp_seq"`` (sequence-parallel prefill), else none."""
    return ("model",) if variant == "fsdp_seq" else None


def axes_of(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_size(shape: Dict[str, int], axes) -> int:
    n = 1
    for a in axes_of(axes):
        n *= shape[a]
    return n


def fit_spec(shape, entries, mesh) -> Spec:
    """Drop (progressively) axis assignments that don't divide the dim."""
    sizes = mesh_shape(mesh)
    out = []
    for dim, ent in enumerate(entries):
        if ent is None or dim >= len(shape):
            out.append(None)
            continue
        cand = axes_of(ent)
        while cand and shape[dim] % _axis_size(sizes, cand) != 0:
            cand = cand[:-1]
        if not cand:
            out.append(None)
        elif len(cand) == 1:
            out.append(cand[0])
        else:
            out.append(cand)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def jax_path(name: str) -> Tuple[Tuple[str, ...], bool]:
    """``(JAX's key path, stacked)`` of a port leaf name: the layer index
    after a stacked key dropped (``blocks.3.attn.wq`` -> ``("blocks",
    "attn", "wq")``, stacked)."""
    parts = name.split(".")
    out, stacked = [], False
    for i, p in enumerate(parts):
        if i and parts[i - 1] in STACKED_KEYS and p.isdigit():
            stacked = True
            continue
        out.append(p)
    return tuple(out), stacked


def leaf_spec(name: str, shape: Sequence[int], mesh,
              sharding: str = "fsdp_tp", emb_rows: str = "all") -> Spec:
    """The spec of the port's leaf ``name`` of ``shape``: JAX's
    ``param_pspecs`` rule on the leaf as JAX holds it (stacked under
    ``blocks``), less the stacked dim."""
    check_variant(sharding)
    sizes = mesh_shape(mesh)
    names, stacked = jax_path(name)
    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    shape = ((1,) if stacked else ()) + tuple(shape)
    dp = data_axes(sizes)
    use_tp = sharding in ("fsdp_tp", "tp") and "model" in sizes
    use_fsdp = sharding == "fsdp_tp"
    fsdp_all = sharding in ("fsdp", "fsdp_seq")

    def unstacked(spec: Spec) -> Spec:
        return spec[1:] if stacked and spec else spec

    if leaf == "emb" and len(shape) == 3:  # DLRM EMBs: row-sharded
        axes = ("model",) if emb_rows == "model" else dp + ("model",)
        return unstacked(fit_spec(shape, [None, axes, None], sizes))
    rule = _RULES.get(f"{parent}/{leaf}") or _RULES.get(leaf)
    if rule is None or len(shape) < 2:
        return ()
    model_dim, fsdp_dim = rule
    off = 1 if stacked else 0
    entries = [None] * len(shape)
    if fsdp_all:
        cands = [d for d in (model_dim, fsdp_dim)
                 if d is not None and d + off < len(shape)]
        if cands:
            d = max(cands, key=lambda dd: shape[dd + off])
            entries[d + off] = dp + ("model",)
        return unstacked(fit_spec(shape, entries, sizes))
    if use_tp and model_dim is not None and model_dim + off < len(shape):
        entries[model_dim + off] = "model"
    if use_fsdp and dp and fsdp_dim is not None \
            and fsdp_dim + off < len(shape):
        entries[fsdp_dim + off] = dp
    return unstacked(fit_spec(shape, entries, sizes))


def param_specs(model, mesh, sharding: str = "fsdp_tp",
                emb_rows: str = "all") -> Dict[str, Spec]:
    """``{leaf name: spec}`` of a module or a tree of tensors (a model on
    the ``meta`` device gives them without memory)."""
    if emb_rows not in EMB_ROWS:
        raise ValueError(f"emb_rows {emb_rows!r}: expected one of "
                         f"{EMB_ROWS}")
    return {n: leaf_spec(n, t.shape, mesh, sharding, emb_rows)
            for n, t in named_leaves(model)}


def batch_spec(shape: Sequence[int], mesh,
               sharding: str = "fsdp_tp") -> Spec:
    """JAX's ``batch_pspecs`` rule for one batch leaf of ``shape``: dim 0
    (the global batch) over :func:`batch_entry`'s axes, and under
    ``"fsdp_seq"`` dim 1 (the sequence; a VLM's frontend positions) over
    ``model``, each dropped where it does not divide."""
    check_variant(sharding)
    if not shape:
        return ()
    entries = [batch_entry(mesh, sharding)] + [None] * (len(shape) - 1)
    se = seq_entry(mesh, sharding)
    if se and len(shape) >= 2:
        entries[1] = se
    return fit_spec(shape, entries, mesh)


def batch_pspecs(batch_struct: Dict, mesh,
                 sharding: str = "fsdp_tp") -> Dict[str, Spec]:
    """``{name: spec}`` of a batch (tensors or anything with a
    ``shape``): JAX's ``batch_pspecs`` (``partition.py:229``)."""
    return {k: batch_spec(tuple(v.shape), mesh, sharding)
            for k, v in batch_struct.items()}


# The decode cache's leaves by JAX's name (``cache_pspecs``): attention
# keys and values (self and cross), the mamba conv and SSM states.
CACHE_KV = ("k", "v", "xk", "xv")


def cache_spec(name: str, shape: Sequence[int], mesh,
               shard_kv_seq: bool = True) -> Spec:
    """JAX's ``cache_pspecs`` rule (``partition.py:246``) for one layer's
    slice of the cache leaf ``name``, of ``shape`` without the stacked
    layer dim (JAX's spec less its leading ``None``): k/v/xk/xv (B, C, K,
    hd) the batch over the data axes and the length C over ``model`` when
    ``shard_kv_seq``, else the KV heads over ``model``; ``conv`` (B, W-1,
    Di) and ``h`` (B, Di, N) Di over ``model``; ``pos`` replicated.  An
    axis that does not divide its dim is dropped (the cache is replicated
    over it)."""
    dp = data_axes(mesh)
    shape = (1,) + tuple(shape)  # JAX's stacked leaf
    if name == "pos" or len(shape) == 1:
        return ()
    if name in CACHE_KV:
        entries = ([None, dp, "model", None, None] if shard_kv_seq
                   else [None, dp, None, "model", None])
    elif name == "conv":
        entries = [None, dp, None, "model"]
    elif name == "h":
        entries = [None, dp, "model", None]
    else:
        entries = [None, dp]
    return fit_spec(shape, entries, mesh)[1:]


def cache_pspecs(cache_struct: Dict, mesh,
                 shard_kv_seq: bool = True) -> Dict[str, Spec]:
    """``{name: spec}`` of a decode cache whose leaves are stacked on a
    leading layer dim (the port's ``init_cache``, ``ModelBundle.
    cache_struct``): each leaf's :func:`cache_spec`, the spec of one
    layer's slice."""
    return {k: cache_spec(k, tuple(getattr(v, "shape", ()))[1:], mesh,
                          shard_kv_seq)
            for k, v in cache_struct.items()}


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every axis a spec shards over, in the order the dims name them."""
    return tuple(a for e in spec for a in axes_of(e))


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    sizes = mesh_shape(mesh)
    out = list(shape)
    for dim, ent in enumerate(spec):
        n = _axis_size(sizes, ent)
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"over {ent!r} ({n})")
        out[dim] //= n
    return tuple(out)


def coords(mesh, rank: Optional[int] = None) -> Dict[str, int]:
    """``{axis: index}`` of ``rank`` (by default the mesh's own) in the
    row-major (data, model) layout."""
    sizes = mesh_shape(mesh)
    if rank is None:
        rank = mesh.rank
    return {"data": rank // sizes["model"], "model": rank % sizes["model"]}


def part_index(entry, mesh, rank: Optional[int] = None) -> Tuple[int, int]:
    """``(index, parts)`` of this rank's part of a dim sharded over
    ``entry``: major-to-minor over the entry's axes."""
    sizes, at = mesh_shape(mesh), coords(mesh, rank)
    index, parts = 0, 1
    for a in axes_of(entry):
        index = index * sizes[a] + at[a]
        parts *= sizes[a]
    return index, parts


def shard_of(full: torch.Tensor, spec: Spec, mesh,
             rank: Optional[int] = None) -> torch.Tensor:
    """This rank's part of ``full`` (a view; ``.clone()`` it to free the
    whole tensor)."""
    out = full
    for dim, ent in enumerate(spec):
        if ent is None:
            continue
        index, parts = part_index(ent, mesh, rank)
        size = full.shape[dim] // parts
        if size * parts != full.shape[dim]:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"split into {parts}")
        out = out.narrow(dim, index * size, size)
    return out


def in_proj_blocks(di: int, model: int, rank: int
                   ) -> Tuple[Tuple[int, str, int, int], ...]:
    """Where the columns of model rank ``rank``'s shard of the fused
    ``in_proj`` (D, 2 Di) belong: ``((dest, part, lo, hi), ...)``, columns
    ``[lo, hi)`` of the rank's (D, 2 Di / model) shard are channels
    ``[dest Di/model, (dest + 1) Di/model)`` of ``part`` (``"xi"`` or
    ``"z"``), in the shard's column order.  The shard holds blocks ``2
    rank`` and ``2 rank + 1`` of the 2 ``model`` blocks of Di/model
    columns; block ``j`` is ``xi`` for ``j < model``, else ``z``, of rank
    ``j % model``."""
    if di % model:
        raise ValueError(f"Di {di} does not split over {model} model ranks")
    c = di // model
    return tuple((j % model, "xi" if j < model else "z", i * c, (i + 1) * c)
                 for i, j in enumerate((2 * rank, 2 * rank + 1)))


def shard_bytes(model, specs: Dict[str, Spec], mesh,
                itemsize: Optional[int] = None) -> int:
    """Per-rank bytes of the leaves under ``specs``: each leaf's elements
    times its element size, floor-divided by its parts (JAX's
    ``launch/dryrun.py::_sizeof``, :46-62).  ``itemsize`` stands in for
    every leaf's element size (1 counts elements)."""
    sizes = mesh_shape(mesh)
    total = 0
    for name, t in named_leaves(model):
        n = t.numel()
        shards = _axis_size(sizes, spec_axes(specs[name]))
        total += n * (itemsize or t.element_size()) // shards
    return total
