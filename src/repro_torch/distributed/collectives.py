"""Collectives over a process group, each with the backward its use needs.

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

The same rule picks the backward of a sharded parameter's all-gather
(:func:`gather_leaf`, before the parameter is used):

- over the axes the **batch** splits over (``data``; every axis under
  ``"fsdp"``; each as far as it divides the rows, JAX's ``fit_spec``),
  where each rank's loss covers other rows and the step averages the
  ranks' gradients: a reduce-scatter, each rank keeping the sum of the
  ranks' gradients of its part (FSDP);
- over ``model``, or an axis the rows are replicated on, when its ranks
  compute the same replicated loss from the gathered leaf: this rank's
  slice of the gradient, **not** summed (a sum would multiply the
  gradient by the axis's size, and no shape error would show it); but
  under a sequence split (``"fsdp_seq"`` training) the model ranks hold
  other positions of the rows, and their gradients are summed by a
  reduce-scatter, as over ``data``.

Tensor parallelism over ``model`` (Megatron's) uses two more: "f",
:func:`copy_all_reduce_bwd`, the identity forward with an all-reduced
backward, on the input of a column-parallel product, and "g",
:func:`all_reduce_identity_bwd`, on the partial output of a row-parallel
one.  :func:`all_reduce_max` takes no gradient (the vocab-parallel
softmax's shift).

:func:`exchange_dims` moves a tensor's split from one dim to another
without a gradient (a served model's keys and values from the layout
that computed them to the decode cache's).  Two more move a tensor's
parts between ranks, each with its reverse as its backward: :func:`all_to_all` (the mamba block's exchange of
``in_proj``'s columns within ``model``: the backward sends the gradient's
columns back to their owners) and :func:`reduce_scatter_all_gather_bwd`
(DLRM's pooled partials over ``data`` when the tables' rows lie over
``data`` too: every data rank's rows pool the global batch, and each data
rank's loss reads its part of the sum, so the backward all-gathers the
ranks' gradients of their parts).

Outside a process group (``group`` None) each is the identity: there is
one rank.  :func:`gather_parts` (``mesh.gather_batch``) is the
all-gather of a batch's rows without a gradient.

Every collective of the port goes through this module (set-up calls
aside: the launcher's barrier, ``init_distributed``'s device check), and
two counters see each one:

- :data:`TRAFFIC`, which the card's smoke run reads: the calls and bytes
  (the whole tensor's, in its dtype) of the gathers (their output),
  reduce-scatters (their input), all-reduces (sum and max, forward and
  backward; AdamW's norm, the int8 codes, scales and loss of
  ``compression.psum_int8``) and exchanges (their input);
- :data:`RECORD`, JAX's ``launch/hlo_analysis.py::collective_stats``
  (:139-167) for the port's own program: ``bytes_<op>`` the **result**
  bytes of each kind (``all-gather``, ``reduce-scatter``, ``all-reduce``
  counted twice, a ring's two phases, ``all-to-all``;
  ``collective-permute`` stays 0: the port sends nothing point to
  point), ``count_<op>`` the calls (:func:`collective_stats`).

On a virtual mesh (:func:`repro_torch.distributed.mesh.virtual_mesh`)
the groups are stand-ins: each collective is counted as above, runs
nothing, and gives a ``meta`` tensor of the shape and dtype the real one
gives, so a rank's step runs on the ``meta`` device as it would on the
mesh (:mod:`repro_torch.launch.accounting`).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed import mesh as M
from repro_torch.sharding.partition import axes_of, batch_entry

TRAFFIC: Dict[str, Dict[str, int]] = {
    kind: {"calls": 0, "bytes": 0}
    for kind in ("all_gather", "reduce_scatter", "all_reduce", "exchange")}


# JAX's collective kinds (hlo_analysis.py's _COLLECTIVES).
OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
       "collective-permute")
RECORD: Dict[str, int] = {f"{k}_{op}": 0 for op in OPS
                          for k in ("bytes", "count")}


def reset_traffic() -> None:
    for rec in TRAFFIC.values():
        rec.update(calls=0, bytes=0)


def reset_record() -> None:
    for key in RECORD:
        RECORD[key] = 0


def collective_stats() -> Dict[str, int]:
    """:data:`RECORD` with ``collective_bytes``, the sum of its bytes:
    JAX's ``collective_stats`` keys."""
    out = dict(RECORD)
    out["collective_bytes"] = sum(RECORD[f"bytes_{op}"] for op in OPS)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _count(kind: str, n_bytes: int, op: str, result_bytes: int) -> None:
    """One call: ``n_bytes`` into :data:`TRAFFIC`'s ``kind``, the
    result's bytes into :data:`RECORD`'s ``op`` (an all-reduce's
    twice)."""
    TRAFFIC[kind]["calls"] += 1
    TRAFFIC[kind]["bytes"] += n_bytes
    RECORD[f"count_{op}"] += 1
    RECORD[f"bytes_{op}"] += result_bytes * (2 if op == "all-reduce"
                                             else 1)


def _runs(group, t: torch.Tensor) -> bool:
    """Whether a collective over ``group`` runs: not over a virtual
    mesh's stand-in, whose tensors must be ``meta``."""
    if not M.is_virtual(group):
        return True
    if not t.is_meta:
        raise ValueError(f"a virtual mesh's collective over {group.axes} "
                         f"takes meta tensors, not {t.device}")
    return False


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in place, counted; returns ``x``."""
    _count("all_reduce", _nbytes(x), "all-reduce", _nbytes(x))
    if _runs(group, x):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    return all_reduce_(x.contiguous().clone(), group)


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


class _CopyAllReduceBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


def copy_all_reduce_bwd(x: torch.Tensor,
                        group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Megatron's "f": ``x`` itself; the gradient is summed over
    ``group``.  On the replicated input of a column-parallel product,
    whose ranks each give a partial gradient of it."""
    return x if group is None else _CopyAllReduceBwd.apply(x, group)


def all_reduce_max(x: torch.Tensor,
                   group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group``, without a gradient."""
    y = x.detach().clone()
    if group is not None:
        _count("all_reduce", _nbytes(y), "all-reduce", _nbytes(y))
        if _runs(group, y):
            dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def all_gather(x: torch.Tensor, group, dim: int, n: int) -> torch.Tensor:
    """The ``n`` ranks' ``x`` concatenated along ``dim`` in group order."""
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    _count("all_gather", _nbytes(out), "all-gather", _nbytes(out))
    if _runs(group, src):
        dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def gather_parts(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' ``x`` concatenated along dim 0 in group order,
    without a gradient (a batch's rows: ``mesh.gather_batch``)."""
    parts = [torch.empty_like(x) for _ in range(n)]
    _count("all_gather", n * _nbytes(x), "all-gather", n * _nbytes(x))
    if _runs(group, x):
        dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def reduce_scatter(x: torch.Tensor, group, dim: int, n: int
                   ) -> torch.Tensor:
    """This rank's part along ``dim`` of the sum of the ``n`` ranks'
    ``x``."""
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    _count("reduce_scatter", _nbytes(src), "reduce-scatter", _nbytes(out))
    if _runs(group, src):
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                                   group=group)
    return out.movedim(0, dim).contiguous()


class _GatherReduceScatterBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, n):
        ctx.args = (group, dim, n)
        return all_gather(x, group, dim, n)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, *ctx.args), None, None, None


class _GatherSliceBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, n, index):
        ctx.part = (dim, index, x.shape[dim])
        return all_gather(x, group, dim, n)

    @staticmethod
    def backward(ctx, grad):
        dim, index, size = ctx.part
        return (grad.narrow(dim, index * size, size).contiguous(), None,
                None, None, None)


class _ReduceScatterGatherBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, n):
        ctx.args = (group, dim, n)
        return reduce_scatter(x, group, dim, n)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, *ctx.args), None, None, None


def reduce_scatter_all_gather_bwd(x, group, dim: int, n: int):
    """This rank's part along ``dim`` of the ranks' sum; the backward
    all-gathers the ranks' gradients of their parts (each rank's ``x``
    feeds every rank's part)."""
    return (x if group is None
            else _ReduceScatterGatherBwd.apply(x, group, dim, n))


def _exchange(x: torch.Tensor, group, dim: int, send, recv
              ) -> torch.Tensor:
    src = x.movedim(dim, 0).contiguous()
    rest = tuple(src.shape[1:])
    out = src.new_empty((sum(recv),) + rest)
    _count("exchange", _nbytes(src), "all-to-all", _nbytes(out))
    if _runs(group, src):
        dist.all_to_all_single(out, src, output_split_sizes=list(recv),
                               input_split_sizes=list(send), group=group)
    return out.movedim(0, dim).contiguous()


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, send, recv):
        ctx.args = (group, dim, recv, send)
        return _exchange(x, group, dim, send, recv)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, *ctx.args), None, None, None, None


def all_to_all(x: torch.Tensor, group, dim: int, send, recv
               ) -> torch.Tensor:
    """The exchange within ``group``: ``x``'s first ``send[0]`` entries
    along ``dim`` go to rank 0 of the group, the next ``send[1]`` to rank
    1, and so on; returns what the ranks sent here, ``recv[r]`` entries
    from rank ``r``, in rank order.  The backward sends the gradient's
    parts back where they came from."""
    return (x if group is None
            else _AllToAll.apply(x, group, dim, tuple(send), tuple(recv)))


def exchange_dims(x: torch.Tensor, group, n: int, split_dim: int,
                  cat_dim: int) -> torch.Tensor:
    """Moves a tensor split over ``group``'s ``n`` ranks along ``cat_dim``
    to a split along ``split_dim``, without a gradient (serving): ``x``
    cut into ``n`` equal parts along ``split_dim``, part ``r`` sent to rank
    ``r``, the parts received concatenated along ``cat_dim`` in rank
    order."""
    parts = torch.stack(x.chunk(n, split_dim)).contiguous()
    out = torch.empty_like(parts)
    _count("exchange", _nbytes(parts), "all-to-all", _nbytes(out))
    if _runs(group, parts):
        dist.all_to_all_single(out, parts, group=group)
    return torch.cat(out.unbind(0), dim=cat_dim)


def all_gather_reduce_scatter_bwd(x, group, dim: int, n: int):
    """All-gather along ``dim``; the backward reduce-scatters (sums) the
    gradient back to this rank's part."""
    return (x if group is None
            else _GatherReduceScatterBwd.apply(x, group, dim, n))


def all_gather_slice_bwd(x, group, dim: int, n: int, index: int):
    """All-gather along ``dim``; the backward keeps this rank's slice
    (``index``) of the gradient, unsummed."""
    return (x if group is None
            else _GatherSliceBwd.apply(x, group, dim, n, index))


def gather_leaf(p: torch.Tensor, keep_model: bool = False) -> torch.Tensor:
    """The leaf ``p`` as the compute uses it: a parameter without a
    :class:`~repro_torch.distributed.mesh.Placement` as it is; a shard
    gathered along each sharded dim, with the backward the axis needs:
    a reduce-scatter over the axes whose ranks hold other tokens of the
    batch (:func:`repro_torch.distributed.mesh.token_axes`: the rows'
    fitted axes and, under a sequence split, ``model``; outside a scope
    the variant's batch entry), this rank's slice over the others (they
    compute the same rows).  A dim over both axes whose backward is the
    same on both is gathered by one collective over the world group
    (its parts lie in world rank order); else the minor axis first.
    ``keep_model`` keeps the ``model`` part (tensor-parallel compute) and
    gathers the rest."""
    pl = M.placement(p)
    if pl is None:
        return p
    mesh = pl.mesh
    batch = (M.token_axes() if M.active_mesh() is not None
             else batch_entry(mesh, pl.variant))
    x = p
    for dim, ent in enumerate(pl.spec):
        axes = axes_of(ent)
        if keep_model and "model" in axes:
            if axes != ("model",):
                raise ValueError(f"spec {pl.spec}: dim {dim} mixes model "
                                 "with other axes under tensor parallelism")
            continue
        summed = [ax in batch for ax in axes]
        runs = ([axes] if len(set(summed)) == 1
                else [(ax,) for ax in reversed(axes)])
        for run in runs:
            group, n, index = mesh.axes_group(run)
            if run[0] in batch:
                x = all_gather_reduce_scatter_bwd(x, group, dim, n)
            else:
                x = all_gather_slice_bwd(x, group, dim, n, index)
    return x
