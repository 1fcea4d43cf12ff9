"""All-reduces over a process group, each with the backward its use needs.

JAX's ``shard_map`` transposes a ``psum`` to fit the values around it;
under autograd a collective's backward is written out, and which one is
right depends on how the losses of the group's ranks combine:

- a loss **replicated** over the group (every rank holds the same loss and
  the ranks' gradients are not combined afterwards): the all-reduce's
  backward is the identity.  DLRM's pooled partials over ``model``: each
  model rank's table gradient covers its own rows and is used as it is.
- losses **averaged** over the group (the step averages the ranks'
  gradients): a value that every rank's loss uses in full must send each
  rank the sum of the ranks' gradients.  The MoE's aux statistics over
  ``data``: with an identity backward the router's aux gradient would come
  out ``n_data`` times too small, and no error would show it.

Outside a process group (``group`` None) both are the identity: there is
one rank.  :func:`repro_torch.distributed.mesh.gather_batch` is the
all-gather over ``data`` without a gradient.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


class _AllReduceIdentityBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllReduceSumBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


def all_reduce_identity_bwd(x: torch.Tensor,
                            group: Optional[dist.ProcessGroup]
                            ) -> torch.Tensor:
    """Sum of ``x`` over ``group``; the gradient passes through unchanged.
    For a loss replicated over the group (DLRM's pooled partials over
    ``model``)."""
    return x if group is None else _AllReduceIdentityBwd.apply(x, group)


def all_reduce_sum_bwd(x: torch.Tensor,
                       group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Sum of ``x`` over ``group``; the gradient is summed over it too.
    For a value that every rank's loss uses when the ranks' gradients are
    averaged (the MoE's aux statistics over ``data``)."""
    return x if group is None else _AllReduceSumBwd.apply(x, group)
