"""The training step: gradient accumulation over microbatches, the
data-parallel all-reduce over the ranks of a mesh, and AdamW.

Ported from ``src/repro/launch/steps.py::make_train_step`` (:15-94).
``opt_struct_and_specs`` (sharding specs only) is not ported.  PyTorch
updates in place, so the step returns only its metrics: the parameters and
the optimizer (:func:`repro_torch.optim.adamw.init_opt`) hold the new
state.

As in JAX, with ``microbatches > 1`` the batch is split along its first
axis, each microbatch's gradients are summed into **fp32** accumulators
(``g0 = zeros(f32)`` in JAX: bf16 parameters' gradients are not rounded to
bf16 between microbatches, as ``.grad`` accumulation would round them),
and the sums and the loss are divided by the count.  With one microbatch
the gradients keep the parameters' dtype, as ``jax.value_and_grad`` gives
them; the optimizer widens them to fp32 either way.

With a ``mesh`` (:mod:`repro_torch.distributed.mesh`) the step runs in its
activation scope under the bundle's sharding variant, on this rank's rows:
the microbatches are cut first and each is split over the batch's axes
(:func:`repro_torch.distributed.mesh.microbatch_shard`, JAX's ``[None,
dp]`` constraint on the ``(mb, B/mb, ...)`` reshape; ``data``, or every
axis under ``"fsdp"``).  Each gradient is then reduced by its leaf's
layout (:class:`~repro_torch.distributed.mesh.Placement`), in fp32:

- a leaf sharded over a batch axis got the sum of the ranks' gradients of
  its part from its gather's reduce-scatter (in the backward);
- over the batch axes it is replicated on, it is all-reduced (a whole
  leaf: over ``data``);
- nothing is reduced over ``model`` under ``"fsdp_tp"`` or ``"tp"``: the
  model ranks compute one replicated loss, a tensor-parallel leaf's
  gradient covers its own part, and a leaf replicated over ``model``
  gets equal gradients on its ranks (through Megatron's "f");

and every gradient is divided by the batch's rank count; the loss is the
mean over those ranks.  A DLRM table whose rows lie over ``data`` too
(``RunConfig.emb_rows="all"``) is not all-reduced either: its lookup's
backward all-gathers every data rank's gradient of the pooled rows, so
its rows' gradient already sums the data ranks' losses.  ``grad_norm``
is the whole gradient's (:func:`repro_torch.optim.adamw.global_norm`).  A DLRM's MLP gradients
are equal on the model ranks and each table gradient covers the rank's
own rows.  A (1, 1) mesh outside a process group reduces nothing: the
step gives the bits it gives without a mesh.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed import mesh as M
from repro_torch.models.model_api import ModelBundle
from repro_torch.optim.adamw import AdamW
from repro_torch.sharding.partition import batch_entry, spec_axes
from repro_torch.tree import leaves


def _on(x, dev: torch.device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(dev)


def trainable_leaves(params) -> List[torch.Tensor]:
    """``leaves(params)``, each switched to ``requires_grad``."""
    ps = leaves(params)
    for p in ps:
        if not p.requires_grad:
            p.requires_grad_(True)
    return ps


def value_and_grad(loss_fn: Callable, params, ps, batch):
    """``(loss, grads)``: ``loss_fn(params, batch)`` detached, and its
    gradients in the leaves ``ps``, zeros for a leaf the loss does not
    reach (JAX's gradient of an unused leaf)."""
    loss = loss_fn(params, batch)
    gs = torch.autograd.grad(loss, ps, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(ps, gs)]


def _reduce_groups(p: torch.Tensor, mesh: M.Mesh, variant: str) -> tuple:
    """The groups to all-reduce ``p``'s gradient over: the batch's axes
    its layout does not shard it on (all of them for a whole leaf)."""
    pl = M.placement(p)
    held = set(spec_axes(pl.spec)) if pl is not None else set()
    return mesh.groups(a for a in batch_entry(mesh, variant)
                       if a not in held)


def make_grads_fn(bundle: ModelBundle, microbatches: int = 1,
                  mesh: Optional[M.Mesh] = None
                  ) -> Callable[[Any, Dict], tuple]:
    """Returns ``grads_fn(params, batch) -> (loss, grads)``: the step's
    loss (0-d fp32) and gradients (a list in the order of
    ``repro_torch.tree.leaves(params)``), accumulated over the
    microbatches and, with a mesh, reduced over the batch's ranks."""
    loss_fn = bundle.loss
    reduce = mesh is not None and mesh.data_group is not None
    variant = bundle.run.sharding

    def grads_fn(params, batch: Dict):
        dev = resolve_device(bundle.device)
        ps = trainable_leaves(params)
        batch = {k: _on(v, dev) for k, v in batch.items()}
        # The scope carries the variant (the batch over its axes).  Under
        # "fsdp_seq" that is the data axes, and nothing here splits the
        # sequence: only a prefill does (transformer.prefill_sharded), as
        # JAX's trainer splits nothing by sequence (launch/train.py:83).
        scope = (M.activation_sharding(mesh, variant) if mesh is not None
                 else contextlib.nullcontext())
        with scope:
            if microbatches <= 1:
                if mesh is not None:
                    batch = {k: M.batch_shard(v, mesh, variant)
                             for k, v in batch.items()}
                loss, grads = value_and_grad(loss_fn, params, ps, batch)
            else:
                acc = [torch.zeros_like(p, dtype=torch.float32) for p in ps]
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                for i in range(microbatches):
                    mb = {k: M.microbatch_shard(v, microbatches, i, mesh,
                                                variant)
                          for k, v in batch.items()}
                    li, gi = value_and_grad(loss_fn, params, ps, mb)
                    for a, g in zip(acc, gi):
                        a.add_(g)  # widened inside the add: no fp32 copy
                    loss = loss + li
                loss = loss / microbatches
                grads = [a.div_(microbatches) for a in acc]
        if reduce:
            bm = M.batch_mesh(mesh, variant)
            grads, loss = [g.float() for g in grads], loss.clone()
            C.all_reduce_(loss, bm.data_group).div_(bm.data)
            for p, g in zip(ps, grads):
                for group in _reduce_groups(p, mesh, variant):
                    C.all_reduce_(g, group)
                g.div_(bm.data)
        return loss, grads

    return grads_fn


def make_train_step(bundle: ModelBundle, microbatches: int = 1,
                    mesh: Optional[M.Mesh] = None
                    ) -> Callable[[Any, AdamW, Dict], Dict[str, Any]]:
    """Returns ``train_step(params, opt, batch) -> {"loss", "grad_norm",
    "lr"}`` (loss and grad_norm 0-d fp32 tensors on the device), which
    updates ``params`` (a module or a dict of tensors, trained through
    ``opt``; with a mesh, this rank's: a DLRM's table shard) in place.
    ``batch`` holds arrays or tensors whose first axis is the global batch;
    they go to the bundle's device once a step."""
    grads_fn = make_grads_fn(bundle, microbatches, mesh)

    def train_step(params, opt: AdamW, batch: Dict) -> Dict[str, Any]:
        ps = leaves(params)
        held = [p for g in opt.param_groups for p in g["params"]]
        if len(held) != len(ps) or any(p is not q for p, q in zip(ps, held)):
            raise ValueError("the optimizer must hold the parameters in the "
                             "order of repro_torch.tree.leaves(params)")
        loss, grads = grads_fn(params, batch)
        metrics = opt.apply(grads)
        metrics["loss"] = loss
        return metrics

    return train_step
