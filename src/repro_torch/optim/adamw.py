"""AdamW with global-norm clipping and a warmup + cosine schedule.

Ported from ``src/repro/optim/adamw.py`` (``OptConfig``, ``schedule``,
``global_norm`` and ``apply_updates``, lines 18-105) as a
``torch.optim.Optimizer`` that takes exactly the JAX step:

* the step count starts at 1 on the first update, and the learning rate of
  update ``t`` is ``lr * min(t / warmup, 1) * (0.1 + 0.9 * cos)`` with
  ``cos = 0.5 (1 + cos(pi * clip((t - warmup) / (total - warmup), 0,
  1)))``;
* the gradients of *all* parameters are scaled by
  ``min(1, clip_norm / max(|g|, 1e-9))``, ``|g|`` their global L2 norm;
* ``p -= lr * (mhat / (sqrt(vhat) + eps) + weight_decay * p)`` with the
  bias-corrected moments.

``torch.optim.AdamW`` with ``clip_grad_norm_`` and ``LambdaLR`` is not
this update: its schedule is one step behind (``LambdaLR`` gives the
first update the factor of step 0) and its clip divides by the norm plus
1e-6.  The moments are fp32 (the JAX default ``moment_dtype``), one pair a
parameter from the start (``init_opt``'s state).  Like JAX's default
(``master_fp32=False``) the update runs in fp32 and is cast back to the
parameter's dtype, bf16 parameters included, with no fp32 master copy.

:meth:`AdamW.apply` takes the gradients as a list, in any float dtype (the
train step hands in fp32 sums over microbatches, as JAX's
``apply_updates`` takes them); :meth:`AdamW.step` reads ``.grad``.
``state_dict`` is ``{"count", "m", "v"}`` with the moments in parameter
order, and ``load_state_dict`` copies them back in place, so a restored
optimizer resumes the schedule at its step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

import torch


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def schedule(cfg: OptConfig, step: int) -> float:
    """Linear warmup + cosine decay, for update number ``step`` (from 1)."""
    step = float(step)
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    t = min(max((step - cfg.warmup_steps)
                / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


class AdamW(torch.optim.Optimizer):
    """The JAX package's ``apply_updates`` as a PyTorch optimizer."""

    def __init__(self, params, cfg: OptConfig):
        super().__init__(params, {})
        self.cfg = cfg
        self.count = 0
        for p in self._params():
            self.state[p]["m"] = torch.zeros_like(p, dtype=torch.float32)
            self.state[p]["v"] = torch.zeros_like(p, dtype=torch.float32)

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for p in self._params() if p.grad is not None]
        if params:
            self._update(params, [p.grad for p in params])
        return loss

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor]) -> Dict[str, object]:
        """One update of every parameter from ``grads`` (in parameter
        order).  Returns ``{"grad_norm": tensor, "lr": float}``."""
        params = self._params()
        if len(grads) != len(params):
            raise ValueError(f"{len(grads)} gradients for {len(params)} "
                             "parameters")
        return self._update(params, list(grads))

    def _update(self, params, grads) -> Dict[str, object]:
        cfg = self.cfg
        self.count += 1
        lr = schedule(cfg, self.count)
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        bc1 = 1.0 - cfg.b1 ** self.count
        bc2 = 1.0 - cfg.b2 ** self.count
        for p, grad in zip(params, grads):
            self._update_leaf(p, grad, scale, lr, bc1, bc2)
        return {"grad_norm": gnorm, "lr": lr}

    def _update_leaf(self, p, grad, scale, lr, bc1, bc2) -> None:
        """One leaf's moments and value, in place.  The leaves are updated
        one after another, after ``count`` has moved: a failure here leaves
        the step half applied (the launcher does not retry it)."""
        cfg = self.cfg
        st = self.state[p]
        g = grad.float() * scale
        m, v = st["m"], st["v"]
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).add_(g * g, alpha=1 - cfg.b2)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        p32 = p.float()
        if cfg.weight_decay:
            upd = upd + cfg.weight_decay * p32
        p.copy_(p32 - lr * upd)

    def state_dict(self) -> Dict[str, object]:
        params = self._params()
        return {"count": self.count,
                "m": [self.state[p]["m"] for p in params],
                "v": [self.state[p]["v"] for p in params]}

    @torch.no_grad()
    def load_state_dict(self, state_dict) -> None:
        params = self._params()
        if len(state_dict["m"]) != len(params):
            raise ValueError(f"state for {len(state_dict['m'])} parameters, "
                             f"the optimizer has {len(params)}")
        for p, m, v in zip(params, state_dict["m"], state_dict["v"]):
            self.state[p]["m"].copy_(m)
            self.state[p]["v"].copy_(v)
        self.count = int(state_dict["count"])


def init_opt(cfg: OptConfig, params: Sequence[torch.Tensor]) -> AdamW:
    """An :class:`AdamW` over ``params`` with zeroed fp32 moments and count
    0, JAX's ``init_opt``."""
    return AdamW(params, cfg)
