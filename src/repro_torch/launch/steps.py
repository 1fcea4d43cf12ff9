"""The training step: gradient accumulation over microbatches and AdamW.

Ported from ``src/repro/launch/steps.py::make_train_step`` (:15-94).  The
mesh and gradient-sharding constraints are dropped (one card), and so is
``opt_struct_and_specs`` (sharding specs only).  PyTorch updates in place,
so the step returns only its metrics: the parameters and the optimizer
(:func:`repro_torch.optim.adamw.init_opt`) hold the new state.

As in JAX, with ``microbatches > 1`` the batch is split along its first
axis, each microbatch's gradients are summed into **fp32** accumulators
(``g0 = zeros(f32)`` in JAX: bf16 parameters' gradients are not rounded to
bf16 between microbatches, as ``.grad`` accumulation would round them),
and the sums and the loss are divided by the count.  With one microbatch
the gradients keep the parameters' dtype, as ``jax.value_and_grad`` gives
them; the optimizer widens them to fp32 either way.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model_api import ModelBundle
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import leaves


def _on(x, dev: torch.device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(dev)


def _grads(loss: torch.Tensor, params):
    """d loss / d params, zeros for a parameter the loss does not reach
    (JAX's gradient of an unused leaf)."""
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, gs)]


def make_train_step(bundle: ModelBundle, microbatches: int = 1
                    ) -> Callable[[Any, AdamW, Dict], Dict[str, Any]]:
    """Returns ``train_step(params, opt, batch) -> {"loss", "grad_norm",
    "lr"}`` (loss and grad_norm 0-d fp32 tensors on the device), which
    updates ``params`` (a module or a dict of tensors, trained through
    ``opt``) in place.  ``batch`` holds arrays or tensors whose first axis
    is the batch; they go to the bundle's device once a step."""
    loss_fn = bundle.loss

    def train_step(params, opt: AdamW, batch: Dict) -> Dict[str, Any]:
        dev = resolve_device(bundle.device)
        ps = leaves(params)
        held = [p for g in opt.param_groups for p in g["params"]]
        if len(held) != len(ps) or any(p is not q for p, q in zip(ps, held)):
            raise ValueError("the optimizer must hold the parameters in the "
                             "order of repro_torch.tree.leaves(params)")
        for p in ps:
            if not p.requires_grad:
                p.requires_grad_(True)
        batch = {k: _on(v, dev) for k, v in batch.items()}
        if microbatches <= 1:
            loss = loss_fn(params, batch)
            grads = _grads(loss, ps)
            loss = loss.detach()
        else:
            n = next(iter(batch.values())).shape[0]
            if n % microbatches:
                raise ValueError(f"batch of {n} does not split into "
                                 f"{microbatches} microbatches")
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in ps]
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(microbatches):
                mb = {k: v.reshape(microbatches, n // microbatches,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                li = loss_fn(params, mb)
                for a, g in zip(acc, _grads(li, ps)):
                    a.add_(g.float())
                loss = loss + li.detach()
            loss = loss / microbatches
            grads = [a.div_(microbatches) for a in acc]
        metrics = opt.apply(grads)
        metrics["loss"] = loss
        return metrics

    return train_step
