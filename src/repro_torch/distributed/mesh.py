"""A (data, model) mesh of ``torch.distributed`` ranks.

Counterpart of ``src/repro/launch/mesh.py``'s ``make_host_mesh`` (:17-23)
and of the activation scope of ``src/repro/sharding/partition.py``
(``_ACT_MESH``, ``activation_sharding``, ``data_axes``; :35-55, :114).
JAX lays its devices out as ``jax.make_mesh((n // mp, mp), ("data",
"model"))``, row-major; here rank ``r`` sits at ``(r // model, r %
model)`` in the same layout, and a :class:`Mesh` holds the two process
groups through that rank: the ``data`` group (the ranks that share its
model coordinate) and the ``model`` group (those that share its data
coordinate), and the world group over all of them.

:func:`init_distributed` starts the process group with an explicit
backend, device and timeout: nothing here picks a backend or a device on
its own.  Without an initialised process group a mesh is the one process
it runs in, ``(1, 1)`` with no groups, as ``make_host_mesh`` over one JAX
device is.  :class:`activation_sharding` sets the mesh and the sharding
variant that ``models/dlrm.py::dlrm_forward(sharded_lookup=True)``, the
MoE's dispatch and the batch split read, as JAX's ``_ACT_MESH`` and
``_ACT_VARIANT`` are read: the batch splits over ``data``, or over
``data`` x ``model`` under ``"fsdp"`` (``batch_entry``, :57-63), whose
ranks then all act as data ranks (:func:`batch_mesh`), each axis as far
as it divides the rows (JAX's ``fit_spec``: over the axes it drops, the
rows are replicated, and every rank of such an axis computes them).  The
scope carries the axes the current batch's rows lie over
(:func:`row_axes`), which the gradients' reductions, the MoE's dispatch
and DLRM's lookup read.

:func:`virtual_mesh` is a rank's place in a mesh with no process group:
its groups are :class:`VirtualGroup` stand-ins, over which the
collectives record what they would move and give ``meta`` tensors, so
one rank's step of a mesh of any size runs on the ``meta`` device (the
dry-run's accounting, :mod:`repro_torch.launch.accounting`).  JAX's
``make_production_mesh`` has no counterpart here: the dry-run's
``launch/dryrun.py::MESHES`` names its shapes.

A parameter stored as this rank's shard carries a :class:`Placement`
(``p.placement``): its mesh, its spec
(:mod:`repro_torch.sharding.partition`) and the variant, which the layers'
gathers, the step's reduction, AdamW's norm and the checkpoint read.
"""
from __future__ import annotations

import datetime
import math
import os
import socket
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.sharding.partition import batch_axes, batch_entry

BACKENDS = ("nccl", "gloo")
_ACT_MESH: Optional["Mesh"] = None
_ACT_VARIANT = "fsdp_tp"
_ACT_SPLIT_SEQ = False
_ACT_ROWS: Optional[Tuple[str, ...]] = None


@dataclass(frozen=True)
class VirtualGroup:
    """The stand-in for a process group of a virtual mesh
    (:func:`virtual_mesh`): ``size`` ranks along ``axes``.  A collective
    over it runs nothing: it records what it would move and gives a
    ``meta`` tensor of the shape and dtype the real one gives
    (:mod:`repro_torch.distributed.collectives`)."""
    axes: Tuple[str, ...]
    size: int


def is_virtual(group) -> bool:
    return isinstance(group, VirtualGroup)


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, model) mesh of ``data * model``
    ranks, and its two process groups (``None`` outside a process
    group; :class:`VirtualGroup` stand-ins on a virtual mesh)."""
    data: int
    model: int
    rank: int
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None
    world_group: Optional[dist.ProcessGroup] = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.data_group if axis == "data" else self.model_group

    def groups(self, axes) -> Tuple[Optional[dist.ProcessGroup], ...]:
        """The groups whose all-reduces together cover the mesh ``axes``:
        the world group for both axes, the axis's for one, none for
        none (:meth:`axes_group`)."""
        wanted = set(axes)
        axes = tuple(a for a in ("data", "model") if a in wanted)
        return (self.axes_group(axes)[0],) if axes else ()

    def size(self, axis: str) -> int:
        return self.data if axis == "data" else self.model

    def axes_group(self, axes) -> Tuple[Optional[dist.ProcessGroup], int,
                                        int]:
        """``(group, size, index)`` of the ranks that differ only along the
        mesh ``axes`` (none, one, or both in (data, model) order), in the
        order JAX lays out a tuple of axes: the world group for both, no
        group (size 1, index 0) for none."""
        axes = tuple(axes)
        if not axes:
            return None, 1, 0
        if len(axes) == 2:
            return self.world_group, self.data * self.model, self.rank
        return self.group(axes[0]), self.size(axes[0]), self.index(axes[0])

    def index(self, axis: str) -> int:
        return self.data_rank if axis == "data" else self.model_rank

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model


def host_mesh_shape(n: int, model_parallel: int) -> Tuple[int, int]:
    """``make_host_mesh``'s rule: the model axis is ``gcd(model_parallel,
    n)``."""
    mp = math.gcd(model_parallel, n)
    return n // mp, mp


def world_rank() -> Tuple[int, int]:
    """``(world size, rank)``; ``(1, 0)`` outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(data: int, model: int) -> Mesh:
    """The (data, model) mesh over every rank of the process group; every
    rank calls it with the same shape (it builds the groups
    collectively)."""
    world, rank = world_rank()
    if data < 1 or model < 1 or data * model != world:
        raise ValueError(f"mesh ({data}, {model}) does not cover the "
                         f"{world} ranks")
    if world == 1 and not dist.is_initialized():
        return Mesh(data, model, rank)
    data_group, _ = dist.new_subgroups_by_enumeration(
        [[d * model + m for d in range(data)] for m in range(model)])
    model_group, _ = dist.new_subgroups_by_enumeration(
        [[d * model + m for m in range(model)] for d in range(data)])
    return Mesh(data, model, rank, data_group, model_group,
                dist.group.WORLD)


def virtual_mesh(data: int, model: int, rank: int = 0) -> Mesh:
    """Rank ``rank``'s place in a (data, model) mesh with no process
    group: its groups are :class:`VirtualGroup` stand-ins, laid out as
    :func:`make_mesh` lays out the real ones (a group of one rank where an
    axis has size 1, as inside a process group).  The model then runs as
    that rank would, on the ``meta`` device, and its collectives are
    recorded, not run (:mod:`repro_torch.launch.accounting`)."""
    if not 0 <= rank < data * model:
        raise ValueError(f"rank {rank} is not in a ({data}, {model}) mesh")
    return Mesh(data, model, rank, VirtualGroup(("data",), data),
                VirtualGroup(("model",), model),
                VirtualGroup(("data", "model"), data * model))


def make_host_mesh(model_parallel: int = 1) -> Mesh:
    """Mesh over every rank, the model axis ``gcd(model_parallel, n)``
    (``src/repro/launch/mesh.py:17-23``)."""
    return make_mesh(*host_mesh_shape(world_rank()[0], model_parallel))


class activation_sharding:
    """Scope in which the model runs on ``mesh`` under the sharding
    ``variant``; scopes nest and restore the previous ones on exit.
    ``split_seq``: whether a training step's (B, S, ...) activations are
    split by sequence over ``model`` (JAX's ``seq_entry``); by default
    under ``"fsdp_seq"``, as JAX splits them there.  ``rows``: the axes
    the batch's rows lie over (the step's and the served batch's fitted
    spec, :func:`repro_torch.sharding.partition.batch_axes`); by default
    the variant's batch entry."""

    def __init__(self, mesh: Mesh, variant: str = "fsdp_tp",
                 split_seq: Optional[bool] = None,
                 rows: Optional[Sequence[str]] = None):
        self.mesh = mesh
        self.variant = variant
        self.split_seq = (variant == "fsdp_seq" if split_seq is None
                          else split_seq)
        self.rows = None if rows is None else tuple(rows)

    def __enter__(self):
        global _ACT_MESH, _ACT_VARIANT, _ACT_SPLIT_SEQ, _ACT_ROWS
        self._prev = (_ACT_MESH, _ACT_VARIANT, _ACT_SPLIT_SEQ, _ACT_ROWS)
        _ACT_MESH, _ACT_VARIANT = self.mesh, self.variant
        _ACT_SPLIT_SEQ, _ACT_ROWS = self.split_seq, self.rows
        return self

    def __exit__(self, *exc):
        global _ACT_MESH, _ACT_VARIANT, _ACT_SPLIT_SEQ, _ACT_ROWS
        _ACT_MESH, _ACT_VARIANT, _ACT_SPLIT_SEQ, _ACT_ROWS = self._prev
        return False


def active_mesh() -> Optional[Mesh]:
    return _ACT_MESH


def active_variant() -> str:
    return _ACT_VARIANT


def row_axes() -> Tuple[str, ...]:
    """The axes the active scope's batch rows lie over: those the scope
    was given, by default its variant's batch entry; none outside a
    scope."""
    if _ACT_MESH is None:
        return ()
    return (batch_entry(_ACT_MESH, _ACT_VARIANT) if _ACT_ROWS is None
            else _ACT_ROWS)


def token_axes() -> Tuple[str, ...]:
    """The axes whose ranks hold other tokens of the active scope's batch:
    its rows' axes and, under a sequence split, ``model``."""
    return row_axes() + (("model",) if splits_sequence() else ())


def batch_mesh(mesh: Mesh, rows: Optional[Sequence[str]] = None) -> Mesh:
    """The mesh whose ``data`` axis is the batch's rows: the ranks along
    ``rows`` (by default :func:`row_axes`) as one axis over their group,
    in the rank order JAX's tuple of axes gives (under ``"fsdp"`` every
    rank a data rank), model 1; ``(1, 1)`` without groups where the rows
    are replicated."""
    group, n, index = mesh.axes_group(row_axes() if rows is None else rows)
    return Mesh(n, 1, index, group, None, group)


@dataclass(frozen=True)
class SeqSplit:
    """This rank's part of a sequence split over ``model`` (JAX's
    ``seq_entry`` under ``"fsdp_seq"``: a prefill, or a training step in
    that scope): positions ``[offset, offset + length)`` of the
    ``mesh.model`` equal parts, the batch's rows over the axes ``rows``
    (``data``, or none where ``data`` does not divide them)."""
    mesh: "Mesh"
    offset: int
    length: int
    rows: Tuple[str, ...]

    def part(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's positions of ``x``'s whole sequence along ``dim``."""
        return x.narrow(dim, self.offset, self.length)

    @property
    def group(self) -> Optional[dist.ProcessGroup]:
        """The ranks that hold the batch's other tokens: over the rows'
        axes and ``model``."""
        return self.mesh.axes_group(self.rows + ("model",))[0]


def splits_sequence() -> bool:
    """Whether the active scope splits a training step's sequence over a
    ``model`` axis of more than one rank."""
    return _ACT_SPLIT_SEQ and _ACT_MESH is not None and _ACT_MESH.model > 1


def seq_split(s: int) -> Optional[SeqSplit]:
    """This rank's part of a sequence of ``s`` positions when the active
    scope splits the sequence (:func:`splits_sequence`) and ``model``
    divides ``s``, else None: JAX's ``fit_spec`` drops the entry, and the
    sequence is computed whole on every model rank."""
    if not splits_sequence() or s % _ACT_MESH.model:
        return None
    n = s // _ACT_MESH.model
    return SeqSplit(_ACT_MESH, _ACT_MESH.model_rank * n, n, row_axes())


def local_split(n: int) -> Optional[SeqSplit]:
    """The split whose rank part holds ``n`` positions (tokens the step
    has cut already), or None outside a split."""
    return None if not splits_sequence() else SeqSplit(
        _ACT_MESH, _ACT_MESH.model_rank * n, n, row_axes())


@dataclass(frozen=True)
class Placement:
    """Where a parameter stored as this rank's shard lives: ``spec`` over
    ``mesh`` under the sharding ``variant``."""
    mesh: Mesh
    spec: tuple
    variant: str


def placement(t: torch.Tensor) -> Optional[Placement]:
    return getattr(t, "placement", None)


def shard_bounds(n: int, parts: int, index: int) -> Tuple[int, int]:
    """``[lo, hi)`` of part ``index`` of ``n`` split evenly into ``parts``;
    raises when ``parts`` does not divide ``n``, as ``shard_map`` does."""
    if n % parts:
        raise ValueError(f"{n} does not split evenly over {parts} shards")
    size = n // parts
    return index * size, (index + 1) * size


def batch_shard(x: torch.Tensor, mesh: Mesh,
                variant: Optional[str] = None) -> torch.Tensor:
    """This rank's rows of a global batch by its fitted spec
    (:func:`repro_torch.sharding.partition.batch_axes` under ``variant``,
    by default the active scope's): its part along ``data``, or along
    ``data`` x ``model`` under ``"fsdp"``, the whole batch over an axis
    that does not divide it."""
    rows = batch_axes(tuple(x.shape[:1]), mesh, variant or _ACT_VARIANT)[0]
    bm = batch_mesh(mesh, rows)
    size = x.shape[0] // bm.data
    return x[bm.data_rank * size:(bm.data_rank + 1) * size]


def microbatch_shard(x: torch.Tensor, microbatches: int, i: int,
                     mesh: Optional[Mesh] = None,
                     variant: Optional[str] = None) -> torch.Tensor:
    """This rank's rows of microbatch ``i`` of a global batch: the batch
    is cut into ``microbatches`` first, and the microbatch is then split
    as :func:`batch_shard` splits it (rank r's rows of it are ``i B/mb +
    r B/(mb n) ..``, not a contiguous block of the whole batch; the whole
    microbatch over an axis that does not divide it); without a mesh, the
    whole microbatch.  Raises when ``microbatches`` does not divide the
    batch, as JAX's reshape does."""
    n = x.shape[0]
    if n % microbatches:
        raise ValueError(f"batch of {n} does not split into "
                         f"{microbatches} microbatches")
    mb = x.reshape(microbatches, n // microbatches, *x.shape[1:])[i]
    return mb if mesh is None else batch_shard(mb, mesh, variant)


def gather_batch(x: torch.Tensor, mesh: Mesh,
                 rows: Sequence[str] = ("data",)) -> torch.Tensor:
    """The batch from every rank's part along the axes ``rows`` (by
    default ``data``), in their order; ``x`` itself over none
    (:func:`repro_torch.distributed.collectives.gather_parts`, which
    counts it)."""
    from repro_torch.distributed.collectives import gather_parts

    group, n, _ = mesh.axes_group(rows)
    return x if group is None else gather_parts(x, group, n)


def shared_devices(devices: Sequence[str]) -> List[str]:
    """The entries of ``devices`` (``host/device`` by rank) that more than
    one rank names."""
    return sorted({d for d in devices if devices.count(d) > 1})


def _env_int(name: str) -> int:
    if name not in os.environ:
        raise ValueError(f"{name} is not set: pass rank and world_size, or "
                         "start the ranks with torchrun")
    return int(os.environ[name])


def init_distributed(backend: str, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None, device=None,
                     timeout: float = 60.0) -> torch.device:
    """Start this rank's default process group and return its device.

    ``backend`` is ``"nccl"`` or ``"gloo"``, named by the caller.  Rank,
    world size and init method default to torchrun's ``RANK``,
    ``WORLD_SIZE`` and ``env://``; the device to ``cuda:LOCAL_RANK``
    (``cuda:rank`` without ``LOCAL_RANK``), and the CPU only when
    ``device="cpu"`` is asked for.  A collective that waits longer than
    ``timeout`` seconds fails.  NCCL runs one rank a card: two ranks
    naming one device raise ``ValueError`` on every rank before NCCL
    starts."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend nccl runs on CUDA devices, not {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout))
    if backend == "nccl" and world_size > 1:
        names: List[Optional[str]] = [None] * world_size
        dist.all_gather_object(names, f"{socket.gethostname()}/{dev}",
                               group=dist.new_group(backend="gloo"))
        shared = shared_devices(names)
        if shared:
            dist.destroy_process_group()
            raise ValueError(
                f"backend nccl with several ranks on one device ({shared}): "
                "NCCL runs one rank a card; ask for backend='gloo' to run "
                "several ranks on one card")
    return dev


def close_distributed() -> None:
    """Destroy the default process group, if one is running."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
