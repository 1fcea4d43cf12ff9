"""int8 tensor compression with one tensor-wide scale.

Ported from ``src/repro/distributed/compression.py`` (lines 19-26):
:func:`quantize_int8` and :func:`dequantize_int8` in torch, on the input's
device.  The scale is ``absmax / 127 + 1e-12`` and the codes round half to
even (``torch.round`` rounds as ``jnp.round`` does).  The sharded store
sizes a recovering shard's modeled int8 transfers with it
(:meth:`repro_torch.core.sharded_serving.ShardedTieredStore.
_pump_recovery`).

The rest of that module (:29-103), the error-feedback gradient
all-reduce under ``shard_map`` (``psum``/``pmean`` across devices), runs
across the ranks of a :mod:`repro_torch.distributed.mesh` mesh in
training, which is ROADMAP A10b-2.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(codes, scale)``: int8 codes of ``x / scale`` and the fp32 0-dim
    scale, both on ``x``'s device."""
    x = x.to(torch.float32)
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
