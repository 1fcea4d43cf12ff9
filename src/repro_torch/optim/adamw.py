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
1e-6.  One pair of moments a parameter exists from the start
(``init_opt``'s state).  The update math runs in fp32 whatever the
storage, as JAX's ``upd`` does:

* ``moment_dtype`` (``"float32"``, the default, or ``"bfloat16"``) is the
  moments' storage: ``m`` and ``v`` are widened to fp32, updated, used for
  the step and rounded back once a step (round to nearest even, as
  ``astype`` rounds);
* ``master_fp32`` keeps an fp32 copy of every parameter
  (``state["master"]``): the step reads it (weight decay too), writes it,
  and casts it into the parameter.  Without it (the default) the update
  reads the parameter widened to fp32 and is cast back to the parameter's
  dtype, bf16 parameters included.

:meth:`AdamW.apply` takes the gradients as a list, in any float dtype (the
train step hands in fp32 sums over microbatches, as JAX's
``apply_updates`` takes them); :meth:`AdamW.step` reads ``.grad``.
``state_dict`` is ``{"count", "m", "v"}`` (and ``"master"`` with
``master_fp32``), each a list in parameter order in its stored dtype, and
``load_state_dict`` copies them back in place, so a restored optimizer
resumes the schedule at its step with the same bits.

A parameter stored as this rank's shard (one with a
:class:`~repro_torch.distributed.mesh.Placement`) has moments and a
master copy of its shard's shape, each tagged with the same placement
(the checkpoint gathers and cuts them as it does the parameter), and
:func:`global_norm` takes the norm of the whole gradient: a leaf's sum of
squares is summed over the axes its layout shards it on, and a
replicated leaf counts once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed import mesh as M
from repro_torch.sharding.partition import spec_axes

MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Elements a leaf's update takes at a time (its fp32 temporaries: 256 MB).
CHUNK = 1 << 26


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
    moment_dtype: str = "float32"
    master_fp32: bool = False

    def __post_init__(self):
        if self.moment_dtype not in MOMENT_DTYPES:
            raise ValueError(f"moment_dtype {self.moment_dtype!r}: expected "
                             f"one of {sorted(MOMENT_DTYPES)}")


def schedule(cfg: OptConfig, step: int) -> float:
    """Linear warmup + cosine decay, for update number ``step`` (from 1)."""
    step = float(step)
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    t = min(max((step - cfg.warmup_steps)
                / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _shard_groups(p: torch.Tensor) -> Tuple:
    """The groups over which ``p``'s shards differ: one a sharded axis
    (the world group when a leaf is sharded over both)."""
    pl = M.placement(p)
    return () if pl is None else pl.mesh.groups(spec_axes(pl.spec))


def global_norm(tensors, params: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
    """The L2 norm of the gradients ``tensors``; with ``params`` (the
    parameters they belong to, in order) each sharded leaf's sum of
    squares is first summed over the ranks that hold its other parts,
    one all-reduce a set of groups."""
    sq = [torch.sum(t.float() * t.float()) for t in tensors]
    if params is not None:
        by_groups: Dict[Tuple, List[int]] = {}
        for i, p in enumerate(params):
            groups = _shard_groups(p)
            if groups:
                by_groups.setdefault(groups, []).append(i)
        for groups, idx in by_groups.items():
            part = torch.stack([sq[i] for i in idx])
            for group in groups:
                if group is not None:
                    C.all_reduce_(part, group)
            for j, i in enumerate(idx):
                sq[i] = part[j]
    return torch.sqrt(sum(sq))


class AdamW(torch.optim.Optimizer):
    """The JAX package's ``apply_updates`` as a PyTorch optimizer."""

    def __init__(self, params, cfg: OptConfig):
        super().__init__(params, {})
        self.cfg = cfg
        self.count = 0
        mdt = MOMENT_DTYPES[cfg.moment_dtype]
        for p in self._params():
            self.state[p]["m"] = torch.zeros_like(p, dtype=mdt)
            self.state[p]["v"] = torch.zeros_like(p, dtype=mdt)
            if cfg.master_fp32:
                self.state[p]["master"] = p.detach().to(torch.float32,
                                                        copy=True)
            if M.placement(p) is not None:
                for t in self.state[p].values():
                    t.placement = p.placement

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
        gnorm = global_norm(grads, params)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        bc1 = 1.0 - cfg.b1 ** self.count
        bc2 = 1.0 - cfg.b2 ** self.count
        for p, grad in zip(params, grads):
            self._update_leaf(p, grad, scale, lr, bc1, bc2)
        return {"grad_norm": gnorm, "lr": lr}

    def _update_leaf(self, p, grad, scale, lr, bc1, bc2) -> None:
        """One leaf's moments and value (and master copy), in place.  The
        leaves are updated one after another, after ``count`` has moved: a
        failure here leaves the step half applied (the launcher does not
        retry it).  A leaf of more than ``CHUNK`` elements is updated a
        chunk of its flat view at a time, so the update's fp32
        temporaries stay a chunk's size (the arithmetic is elementwise:
        the same bits)."""
        st = self.state[p]
        parts = [p, grad, st["m"], st["v"], st.get("master")]
        if p.numel() <= CHUNK or not p.is_contiguous():
            self._update_part(*parts, scale, lr, bc1, bc2)
            return
        flat = [None if t is None else t.reshape(-1) for t in parts]
        for i in range(0, p.numel(), CHUNK):
            self._update_part(*[None if t is None else t[i:i + CHUNK]
                                for t in flat], scale, lr, bc1, bc2)

    def _update_part(self, p, grad, m, v, master, scale, lr, bc1,
                     bc2) -> None:
        cfg = self.cfg
        g = grad.float() * scale
        m32 = m if m.dtype == torch.float32 else m.float()
        v32 = v if v.dtype == torch.float32 else v.float()
        m32.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v32.mul_(cfg.b2).add_(g * g, alpha=1 - cfg.b2)
        upd = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        p32 = p.float() if master is None else master
        if cfg.weight_decay:
            upd = upd + cfg.weight_decay * p32
        new = p32 - lr * upd
        if m32 is not m:  # bf16 moments: rounded once, to nearest even
            m.copy_(m32)
            v.copy_(v32)
        if master is not None:
            master.copy_(new)
        p.copy_(new)

    def state_dict(self) -> Dict[str, object]:
        params = self._params()
        out = {"count": self.count,
               "m": [self.state[p]["m"] for p in params],
               "v": [self.state[p]["v"] for p in params]}
        if self.cfg.master_fp32:
            out["master"] = [self.state[p]["master"] for p in params]
        return out

    @torch.no_grad()
    def load_state_dict(self, state_dict) -> None:
        params = self._params()
        if len(state_dict["m"]) != len(params):
            raise ValueError(f"state for {len(state_dict['m'])} parameters, "
                             f"the optimizer has {len(params)}")
        if ("master" in state_dict) != self.cfg.master_fp32:
            raise ValueError(
                "the state " + ("holds" if "master" in state_dict else
                                "lacks") + " an fp32 master copy; the "
                f"optimizer has master_fp32={self.cfg.master_fp32}")
        keys = ("m", "v", "master") if self.cfg.master_fp32 else ("m", "v")
        for key in keys:
            for p, t in zip(params, state_dict[key]):
                self.state[p][key].copy_(t)
        self.count = int(state_dict["count"])


def init_opt(cfg: OptConfig, params: Sequence[torch.Tensor]) -> AdamW:
    """An :class:`AdamW` over ``params`` with zeroed moments in
    ``cfg.moment_dtype``, an fp32 master copy with ``cfg.master_fp32``, and
    count 0: JAX's ``init_opt``."""
    return AdamW(params, cfg)
