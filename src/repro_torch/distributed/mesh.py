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
ranks then all act as data ranks (:func:`batch_mesh`).

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

BACKENDS = ("nccl", "gloo")
_ACT_MESH: Optional["Mesh"] = None
_ACT_VARIANT = "fsdp_tp"


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, model) mesh of ``data * model``
    ranks, and its two process groups (``None`` outside a process
    group)."""
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
        the world group for both axes, else one a named axis."""
        axes = set(axes)
        if axes == {"data", "model"}:
            return (self.world_group,)
        return tuple(self.group(a) for a in sorted(axes))

    def size(self, axis: str) -> int:
        return self.data if axis == "data" else self.model

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


def make_host_mesh(model_parallel: int = 1) -> Mesh:
    """Mesh over every rank, the model axis ``gcd(model_parallel, n)``
    (``src/repro/launch/mesh.py:17-23``)."""
    return make_mesh(*host_mesh_shape(world_rank()[0], model_parallel))


class activation_sharding:
    """Scope in which the model runs on ``mesh`` under the sharding
    ``variant``; scopes nest and restore the previous ones on exit."""

    def __init__(self, mesh: Mesh, variant: str = "fsdp_tp"):
        self.mesh = mesh
        self.variant = variant

    def __enter__(self):
        global _ACT_MESH, _ACT_VARIANT
        self._prev = (_ACT_MESH, _ACT_VARIANT)
        _ACT_MESH, _ACT_VARIANT = self.mesh, self.variant
        return self

    def __exit__(self, *exc):
        global _ACT_MESH, _ACT_VARIANT
        _ACT_MESH, _ACT_VARIANT = self._prev
        return False


def active_mesh() -> Optional[Mesh]:
    return _ACT_MESH


def active_variant() -> str:
    return _ACT_VARIANT


def batch_mesh(mesh: Mesh, variant: Optional[str] = None) -> Mesh:
    """The mesh whose ``data`` axis is the batch's: ``mesh`` itself, or
    under ``"fsdp"`` every rank as a data rank (``(data * model, 1)``
    over the world group), in the rank order JAX's ``("data", "model")``
    batch split gives."""
    if (variant or _ACT_VARIANT) != "fsdp" or mesh.model == 1:
        return mesh
    return Mesh(mesh.data * mesh.model, 1, mesh.rank, mesh.world_group,
                None, mesh.world_group)


@dataclass(frozen=True)
class SeqSplit:
    """This rank's part of a sequence split over ``model`` (a prefill under
    ``"fsdp_seq"``, JAX's ``seq_entry``): positions ``[offset, offset +
    length)`` of the ``mesh.model`` equal parts, the batch's rows over
    ``data`` as usual."""
    mesh: "Mesh"
    offset: int
    length: int


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
    """This rank's rows of a global batch: its part along ``data``, or
    along ``data`` x ``model`` under ``"fsdp"`` (``variant``, by default
    the active scope's)."""
    bm = batch_mesh(mesh, variant)
    lo, hi = shard_bounds(x.shape[0], bm.data, bm.data_rank)
    return x[lo:hi]


def microbatch_shard(x: torch.Tensor, microbatches: int, i: int,
                     mesh: Optional[Mesh] = None,
                     variant: Optional[str] = None) -> torch.Tensor:
    """This rank's rows of microbatch ``i`` of a global batch: the batch
    is cut into ``microbatches`` first, and the microbatch is then split
    as :func:`batch_shard` splits it (rank r's rows of it are ``i B/mb +
    r B/(mb n) ..``, not a contiguous block of the whole batch); without a
    mesh, the whole microbatch."""
    n = x.shape[0]
    if n % microbatches:
        raise ValueError(f"batch of {n} does not split into "
                         f"{microbatches} microbatches")
    mb = x.reshape(microbatches, n // microbatches, *x.shape[1:])[i]
    return mb if mesh is None else batch_shard(mb, mesh, variant)


def gather_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global batch from every data rank's part, in data order."""
    if mesh.data_group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.data)]
    dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
    return torch.cat(parts)


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
