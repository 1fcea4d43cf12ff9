"""Plain PyTorch versions of the port's kernels.

Counterpart of ``src/repro/kernels/ref.py`` and of the jnp references in
``src/repro/kernels/embedding_gather.py`` (``quantize_rows_ref``,
``dequantize_rows_ref``).  The CPU path runs these, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.  Indices are clamped into
range, as XLA's gather clamps them in the JAX package and as the kernels
do.

The quantized fast tier stores one byte per element (``ROW_FORMATS``:
symmetric int8 in +-127, or ``float8_e4m3fn`` in +-448) and one fp32 scale
per row.  Every division here is a true IEEE division by a tensor, never a
multiply by a reciprocal (PyTorch's CUDA ``div`` by a Python scalar is
one), so the plain versions give the kernels' bits on both devices.
"""
from __future__ import annotations

from typing import Optional

import torch

# row format -> (storage dtype, largest magnitude the scale normalises to)
ROW_FORMATS = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
}


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


# ---------------------------------------------------------------------------
# Quantized fast tier.
# ---------------------------------------------------------------------------

def quantize_rows_ref(rows: torch.Tensor, row_format: str = "int8"):
    """rows: (M, D) float -> ((M, D) codes, (M,) fp32 scales), the steps of
    the JAX ``quantize_rows_ref``: ``scale = max|row| / qmax + 1e-12`` in
    fp32, ``y = row / scale``; int8 rounds half to even and clips to +-127,
    fp8 is a plain cast (round to nearest even)."""
    if row_format not in ROW_FORMATS:
        raise ValueError(f"unknown row_format {row_format!r} "
                         f"(expected one of {sorted(ROW_FORMATS)})")
    qdtype, qmax = ROW_FORMATS[row_format]
    rows = rows.float()
    q = torch.tensor(qmax, dtype=torch.float32, device=rows.device)
    scales = rows.abs().amax(dim=1) / q + 1e-12
    y = rows / scales[:, None]
    if row_format == "int8":
        y = torch.clamp(torch.round(y), -qmax, qmax)
    return y.to(qdtype), scales


def _take(codes: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``codes[i]`` through a byte view: PyTorch's indexing kernels do not
    all take the fp8 dtypes."""
    return codes.view(torch.uint8)[i].view(codes.dtype)


def quantize_scatter_ref(buf: torch.Tensor, scales: torch.Tensor,
                         slots: torch.Tensor, rows: torch.Tensor,
                         row_format: str) -> None:
    """Quantize ``rows`` (M, D) and write codes and scales at ``slots``
    (M,) of ``buf`` (C, D) and ``scales`` (C,), in place (the JAX store's
    donated ``_JIT_SCATTER_Q``)."""
    q, s = quantize_rows_ref(rows, row_format)
    idx = slots.long()
    buf.view(torch.uint8).index_copy_(0, idx, q.view(torch.uint8))
    scales.index_copy_(0, idx, s)


def dequantize_rows_ref(q: torch.Tensor, scales: torch.Tensor
                        ) -> torch.Tensor:
    """(M, D) codes + (M,) scales -> (M, D) fp32, one multiply each."""
    return q.float() * scales[:, None]


def gather_rows_dequant_ref(table: torch.Tensor, scales: torch.Tensor,
                            idx: torch.Tensor) -> torch.Tensor:
    """table: (N, D) codes; scales: (N,); idx: (M,) -> (M, D) fp32
    ``table[idx] * scales[idx]``."""
    i = _clamped(idx, table.shape[0])
    return dequantize_rows_ref(_take(table, i), scales[i])


def gather_rows_dequant_expand_ref(table: torch.Tensor, scales: torch.Tensor,
                                   slots: torch.Tensor, inv: torch.Tensor,
                                   ov: Optional[torch.Tensor] = None,
                                   host_rows: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """The quantized store's fused read (``_JIT_GATHER_Q`` /
    ``_JIT_GATHER_Q_OV`` of ``src/repro/core/tiered.py``): ``out[i] =
    ov[inv[i]] ? host_rows[inv[i]] : table[slots[inv[i]]] * scales[...]``,
    fp32, with fp32 ``host_rows`` (U, D)."""
    rows = gather_rows_dequant_ref(table, scales, slots)
    if ov is not None:
        rows = torch.where(ov[:, None], host_rows, rows)
    return rows[_clamped(inv, slots.shape[0])]


def gather_pool_dequant_ref(table: torch.Tensor, scales: torch.Tensor,
                            idx: torch.Tensor) -> torch.Tensor:
    """table: (N, D) codes; scales: (N,); idx: (B, P) -> (B, D) fp32
    ``sum_p table[idx] * scales[idx]``, each product rounded, then summed
    in the order p = 0 .. P-1 (as the TPU kernel accumulates)."""
    b, p = idx.shape
    i = _clamped(idx, table.shape[0])
    acc = torch.zeros((b, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for j in range(p):
        acc = acc + dequantize_rows_ref(_take(table, i[:, j]),
                                        scales[i[:, j]])
    return acc
