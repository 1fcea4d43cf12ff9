"""Device-dispatching entry points to the port's kernels.

Counterpart of ``src/repro/kernels/ops.py``.  There is no ``use_pallas``
knob: a CUDA tensor goes to the CUDA kernel (which launches or raises),
and a CPU tensor goes to the plain PyTorch version.  Nothing falls back
from the card to the plain path.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import embedding_gather as _eg
from repro_torch.kernels import ref


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device} (expected cuda or cpu)")


def gather_rows_expand(table: torch.Tensor, slots: torch.Tensor,
                       inv: torch.Tensor, ov: Optional[torch.Tensor] = None,
                       host_rows: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The store's fused read, rows in request order:
    ``out[i] = ov[inv[i]] ? host_rows[inv[i]] : table[slots[inv[i]]]``."""
    if _on_cuda(table):
        return _eg.gather_rows_expand(table, slots, inv, ov, host_rows)
    return ref.gather_rows_expand_ref(table, slots, inv, ov, host_rows)


def gather_pool(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: (N, D); idx: (B, P) int32 -> (B, D) fp32 sum-pool."""
    if _on_cuda(table):
        return _eg.gather_pool(table, idx)
    return ref.gather_pool_ref(table, idx)


def quantize_scatter(buf: torch.Tensor, scales: torch.Tensor,
                     slots: torch.Tensor, rows: torch.Tensor,
                     row_format: str) -> None:
    """Quantize ``rows`` (M, D) per row into ``buf[slots]`` and
    ``scales[slots]``, in place."""
    if _on_cuda(buf):
        _eg.quantize_scatter(buf, scales, slots, rows, row_format)
    else:
        ref.quantize_scatter_ref(buf, scales, slots, rows, row_format)


def gather_rows_dequant_expand(table: torch.Tensor, scales: torch.Tensor,
                               slots: torch.Tensor, inv: torch.Tensor,
                               ov: Optional[torch.Tensor] = None,
                               host_rows: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """The quantized store's fused read, fp32 rows in request order:
    ``out[i] = ov[inv[i]] ? host_rows[inv[i]] : table[slots[inv[i]]] *
    scales[slots[inv[i]]]``."""
    if _on_cuda(table):
        return _eg.gather_rows_dequant_expand(table, scales, slots, inv, ov,
                                              host_rows)
    return ref.gather_rows_dequant_expand_ref(table, scales, slots, inv, ov,
                                              host_rows)


def gather_pool_dequant(table: torch.Tensor, scales: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """table: (N, D) int8/fp8; scales: (N,); idx: (B, P) int32 -> (B, D)
    fp32 ``sum_p table[idx] * scales[idx]``."""
    if _on_cuda(table):
        return _eg.gather_pool_dequant(table, scales, idx)
    return ref.gather_pool_dequant_ref(table, scales, idx)
