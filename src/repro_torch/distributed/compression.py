"""int8 tensor compression with one tensor-wide scale, and the
data-parallel gradient all-reduce in int8 with error feedback.

Ported from ``src/repro/distributed/compression.py``: :func:`quantize_int8`
and :func:`dequantize_int8` (:19-26) in torch, on the input's device.  The
scale is ``absmax / 127 + 1e-12`` and the codes round half to even
(``torch.round`` rounds as ``jnp.round`` does).  The sharded store sizes a
recovering shard's modeled int8 transfers with it
(:meth:`repro_torch.core.sharded_serving.ShardedTieredStore.
_pump_recovery`).

:func:`compress_tree`, :func:`init_error`, :func:`psum_int8` and
:func:`make_compressed_dp_grads` (:29-103) run JAX's ``shard_map`` step
across the ``data`` ranks of a :mod:`repro_torch.distributed.mesh` mesh,
with JAX's arithmetic: each rank quantizes ``g + err`` with one scale a
tensor, the codes are summed as int32 and the scales meaned over
``data``, ``g_avg = sum_codes * mean_scale / n``, and each rank carries
``(g + err) - dequant(its codes, its scale)`` into its next step.  Trees
are lists of tensors, in the order of :func:`repro_torch.tree.leaves`; the
scale is one a tensor of JAX's tree, so an LM's layers, which JAX stacks
into one array a weight, share theirs.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed import mesh as M
from repro_torch.tree import jax_stacks, leaves


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(codes, scale)``: int8 codes of ``x / scale`` and the fp32 0-dim
    scale, both on ``x``'s device."""
    x = x.to(torch.float32)
    scale = x.abs().max() / 127.0 + 1e-12
    return _codes(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads: Sequence[torch.Tensor],
                  err: Sequence[torch.Tensor],
                  stacks: Optional[Sequence[int]] = None):
    """``(grads + err) -> (codes, scales, new_err)``, three lists: int8
    codes and fp32 0-dim scales of ``g + e`` (``g`` widened to fp32), and
    the residual ``(g + e) - dequant(codes, scale)``.  ``stacks`` names,
    leaf by leaf, the array of JAX's tree that holds it
    (:func:`repro_torch.tree.jax_stacks`): the leaves of one share a scale,
    the absmax over them all, as JAX's one scale of the stacked array."""
    xs = [g.to(torch.float32) + e for g, e in zip(grads, err)]
    stacks = range(len(xs)) if stacks is None else stacks
    absmax = {}
    for k, x in zip(stacks, xs):
        m = x.abs().max()
        absmax[k] = m if k not in absmax else torch.maximum(absmax[k], m)
    qs, ss, es = [], [], []
    for k, x in zip(stacks, xs):
        s = absmax[k] / 127.0 + 1e-12
        q = _codes(x, s)
        qs.append(q)
        ss.append(s)
        es.append(x - dequantize_int8(q, s))
    return qs, ss, es


def init_error(params) -> List[torch.Tensor]:
    """Zero fp32 error feedback, one tensor a leaf of ``params``."""
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves(params)]


def psum_int8(codes: Sequence[torch.Tensor], scales: Sequence[torch.Tensor],
              group, n: int) -> List[torch.Tensor]:
    """The sum over ``group``'s ``n`` ranks of each tensor's codes, as
    int32 (int8 sums overflow), times the mean of its scales: fp32.  The
    payload all-reduced is the int32 codes, 4 bytes an element: JAX's
    note has XLA move the int8 operand and widen it at the reduction,
    which ``all_reduce`` cannot ask for.  The codes, the scales and (in
    :func:`make_compressed_dp_grads`) the loss are counted by
    :mod:`repro_torch.distributed.collectives` as sum all-reduces."""
    out = []
    for q, s in zip(codes, scales):
        q = q.to(torch.int32)
        s = s.clone()
        if group is not None:
            C.all_reduce_(q, group)
            C.all_reduce_(s, group)
        out.append(q.to(torch.float32) * (s / n) / 1.0)
    return out


def make_compressed_dp_grads(loss_fn: Callable, mesh: M.Mesh,
                             axis: str = "data") -> Callable:
    """``grads_fn(params, err, batch) -> (loss, grads, new_err)``: the
    gradient of ``loss_fn(params, batch)`` on this rank's ``data`` part of
    the global ``batch`` (a dict of tensors whose first axis is the
    batch), all-reduced over ``data`` as int8 codes with error feedback
    (:func:`compress_tree`, :func:`psum_int8`) and divided by the data
    rank count; the loss is the data mean.  Outside any mesh scope, as
    JAX runs its per-shard loss under ``activation_sharding(None)``: an
    MoE dispatches over this rank's tokens, and there are no microbatches.
    ``params`` are replicated over ``data`` (and over ``model``, whose
    ranks run the same step)."""
    from repro_torch.launch.steps import trainable_leaves, value_and_grad

    if axis != "data":
        raise ValueError(f"axis {axis!r}: the gradients reduce over 'data'")
    n = mesh.data

    def grads_fn(params, err, batch):
        stacks = jax_stacks(params)
        ps = trainable_leaves(params)
        local = {k: M.batch_shard(v, mesh) for k, v in batch.items()}
        with M.activation_sharding(None):
            loss, gs = value_and_grad(loss_fn, params, ps, local)
        q, s, new_err = compress_tree(gs, err, stacks)
        g_avg = [g / n for g in psum_int8(q, s, mesh.data_group, n)]
        loss = loss.float()
        if mesh.data_group is not None:
            loss = C.all_reduce_(loss.clone(), mesh.data_group)
        return loss / n, g_avg, new_err

    return grads_fn
