"""Plain PyTorch versions of the port's kernels.

Counterpart of ``src/repro/kernels/ref.py``.  The CPU path runs these, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.  Indices
are clamped into range, as XLA's gather clamps them in the JAX package and
as the kernels do.
"""
from __future__ import annotations

from typing import Optional

import torch


def _clamped(idx: torch.Tensor, n: int) -> torch.Tensor:
    return idx.long().clamp(0, max(n - 1, 0))


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: (N, D); idx: (M,) -> (M, D) = table[idx], dtype kept."""
    return table[_clamped(idx, table.shape[0])]


def gather_rows_expand_ref(table: torch.Tensor, slots: torch.Tensor,
                           inv: torch.Tensor,
                           ov: Optional[torch.Tensor] = None,
                           host_rows: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The store's fused read: ``out[i] = ov[inv[i]] ? host_rows[inv[i]]
    : table[slots[inv[i]]]``.  slots/ov: (U,); host_rows: (U, D);
    inv: (M,) -> (M, D) in request order (``_JIT_GATHER`` /
    ``_JIT_GATHER_OV`` of ``src/repro/core/tiered.py``)."""
    rows = gather_rows_ref(table, slots)
    if ov is not None:
        rows = torch.where(ov[:, None], host_rows, rows)
    return rows[_clamped(inv, slots.shape[0])]


def gather_pool_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: (N, D); idx: (B, P) -> (B, D) fp32 sum-pool."""
    return table[_clamped(idx, table.shape[0])].float().sum(dim=1)
