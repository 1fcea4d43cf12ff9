"""ctypes-bound wrappers of the CUDA kernels in ``csrc/embedding_gather.cu``
(fp32/bf16 row gathers) and ``csrc/embedding_quant.cu`` (the quantized fast
tier).

Counterpart of ``src/repro/kernels/embedding_gather.py``: ``gather_rows``,
``gather_pool``, ``gather_rows_dequant``, ``gather_pool_dequant`` and
``quantize_rows`` (here fused with the store's scatter as
``quantize_scatter``).  ``gather_pool_shard`` is ``gather_pool``'s shard
window, the per-shard pool of the row-sharded DLRM lookup: an id < 0 adds
nothing.  Each wrapper takes CUDA tensors only: it checks
device, dtype, shape and contiguity, allocates its output with
``torch.empty``, launches on the current stream, raises if the launch
reports an error, and adds one to its ``launches`` count.  On the
``meta`` device (the dry-run's accounting) it checks and allocates the
same, launches nothing, counts no launch, and charges its work
(:mod:`repro_torch.kernels.work`) instead.  The plain
versions are in :mod:`repro_torch.kernels.ref`; :mod:`repro_torch.kernels.ops`
picks between the two by the tensors' device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import work as W
from repro_torch.kernels.ref import ROW_FORMATS

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Code dtype -> format number of csrc/embedding_quant.cu.
_QDTYPE_CODE = {ROW_FORMATS["int8"][0]: 0, ROW_FORMATS["fp8"][0]: 1}
_VP, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


_LIB: Optional[ctypes.CDLL] = None
_QLIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures."""
    global _LIB
    if _LIB is None:
        lib = _build.load("embedding_gather")
        lib.repro_gather_rows.argtypes = [_VP, _I64, _I64, _VP, _I64, _VP,
                                          _VP, _VP, _VP, _I64, _VP]
        lib.repro_gather_rows.restype = _INT
        lib.repro_gather_pool.argtypes = [_VP, _I64, _I64, _INT, _VP, _I64,
                                          _INT, _VP, _INT, _VP]
        lib.repro_gather_pool.restype = _INT
        _LIB = lib
    return _LIB


def _qlib() -> ctypes.CDLL:
    """The quantized-tier kernel library, built at first use."""
    global _QLIB
    if _QLIB is None:
        lib = _build.load("embedding_quant")
        lib.repro_quantize_scatter.argtypes = [_VP, _VP, _I64, _I64, _INT,
                                               _VP, _VP, _I64, _VP]
        lib.repro_gather_rows_dequant.argtypes = [
            _VP, _VP, _I64, _I64, _INT, _VP, _I64, _VP, _VP, _VP, _VP, _I64,
            _VP]
        lib.repro_gather_pool_dequant.argtypes = [_VP, _VP, _I64, _I64, _INT,
                                                  _VP, _I64, _INT, _VP, _VP]
        for fn in (lib.repro_quantize_scatter, lib.repro_gather_rows_dequant,
                   lib.repro_gather_pool_dequant):
            fn.restype = _INT
        _QLIB = lib
    return _QLIB


def _check(t: torch.Tensor, name: str, ndim: int, dtypes, device=None):
    if not isinstance(t, torch.Tensor) or t.device.type not in ("cuda",
                                                                 "meta"):
        raise ValueError(f"{name} must be a CUDA tensor (the plain version "
                         "in repro_torch.kernels.ref serves CPU tensors)")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{sorted(str(d) for d in dtypes)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on(err: int, fn: str):
    if err:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def _launch_rows(table, slots, inv, ov, host_rows, m) -> torch.Tensor:
    out = torch.empty((m, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if m == 0:
        return out
    if table.shape[0] == 0:
        raise ValueError("gather from a table with no rows")
    if table.is_meta:
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().repro_gather_rows(
            table.data_ptr(), table.shape[0],
            table.shape[1] * table.element_size(),
            slots.data_ptr(), slots.shape[0], _ptr(inv), _ptr(ov),
            _ptr(host_rows), out.data_ptr(), m, stream)
    _raise_on(err, "gather_rows")
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: (N, D) fp32/bf16; idx: (M,) int32 -> (M, D) = table[idx],
    dtype kept: the contract of the TPU kernel, bit-exact."""
    _check(table, "table", 2, _DTYPE_CODE)
    _check(idx, "idx", 1, (torch.int32,), table.device)
    out = _launch_rows(table, idx, None, None, None, idx.shape[0])
    if table.is_meta:
        W.charge("gather_rows", W.gather_rows(table, idx))
    elif idx.shape[0]:
        gather_rows.launches += 1
    return out


gather_rows.launches = 0


def gather_rows_expand(table: torch.Tensor, slots: torch.Tensor,
                       inv: torch.Tensor, ov: Optional[torch.Tensor] = None,
                       host_rows: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The store's read in one launch, rows in request order:
    ``out[i] = ov[inv[i]] ? host_rows[inv[i]] : table[slots[inv[i]]]``.

    table: (N, D) fp32/bf16; slots: (U,) int32; inv: (M,) int32; ov: (U,)
    bool and host_rows: (U, D) of table's dtype, both or neither."""
    _check(table, "table", 2, _DTYPE_CODE)
    dev = table.device
    _check(slots, "slots", 1, (torch.int32,), dev)
    _check(inv, "inv", 1, (torch.int32,), dev)
    if (ov is None) != (host_rows is None):
        raise ValueError("pass both ov and host_rows, or neither")
    if ov is not None:
        _check(ov, "ov", 1, (torch.bool,), dev)
        _check(host_rows, "host_rows", 2, (table.dtype,), dev)
        if ov.shape[0] != slots.shape[0] or \
                host_rows.shape != (slots.shape[0], table.shape[1]):
            raise ValueError(f"ov {tuple(ov.shape)} / host_rows "
                             f"{tuple(host_rows.shape)} do not match slots "
                             f"{tuple(slots.shape)} and D={table.shape[1]}")
    if inv.shape[0] and not slots.shape[0]:
        raise ValueError("inv indexes an empty slots vector")
    out = _launch_rows(table, slots, inv, ov, host_rows, inv.shape[0])
    if table.is_meta:
        W.charge("gather_rows_expand",
                 W.gather_rows_expand(table, slots, inv, ov))
    elif inv.shape[0]:
        gather_rows_expand.launches += 1
    return out


gather_rows_expand.launches = 0


def _launch_pool(table, idx, skip_negative: bool, wrapper) -> torch.Tensor:
    """The pooled gather's launch for ``wrapper`` (``gather_pool`` or
    ``gather_pool_shard``), which it counts."""
    _check(table, "table", 2, _DTYPE_CODE)
    _check(idx, "idx", 2, (torch.int32,), table.device)
    b, p = idx.shape
    d = table.shape[1]
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if b == 0 or d == 0:
        return out
    if p == 0:
        return out.zero_()
    if table.shape[0] == 0:
        raise ValueError("gather from a table with no rows")
    if table.is_meta:
        W.charge(wrapper.__name__, W.gather_pool_shard(table, idx)
                 if skip_negative else W.gather_pool(table, idx))
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().repro_gather_pool(
            table.data_ptr(), table.shape[0], d, _DTYPE_CODE[table.dtype],
            idx.data_ptr(), b, p, out.data_ptr(), int(skip_negative), stream)
    _raise_on(err, wrapper.__name__)
    wrapper.launches += 1
    return out


def gather_pool(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: (N, D) fp32/bf16; idx: (B, P) int32 -> (B, D) fp32 sum-pool,
    accumulated in fp32 in the order p = 0 .. P-1; ids clamped into
    [0, N)."""
    return _launch_pool(table, idx, False, gather_pool)


gather_pool.launches = 0


def gather_pool_shard(table: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    """``gather_pool`` in its shard window: an id < 0 (a row that another
    shard owns) adds nothing; the others, in [0, N), are summed in fp32 in
    the order p = 0 .. P-1, so with no negative id the result has
    ``gather_pool``'s bits.  table: (N, D) fp32/bf16, the rank's shard;
    idx: (B, P) int32 -> (B, D) fp32."""
    return _launch_pool(table, idx, True, gather_pool_shard)


gather_pool_shard.launches = 0


# ---------------------------------------------------------------------------
# Quantized fast tier: (N, D) int8 / fp8 codes with (N,) fp32 scales.
# ---------------------------------------------------------------------------

def _check_quant(table, scales):
    _check(table, "table", 2, _QDTYPE_CODE)
    _check(scales, "scales", 1, (torch.float32,), table.device)
    if scales.shape[0] != table.shape[0]:
        raise ValueError(f"scales {tuple(scales.shape)} do not match table "
                         f"{tuple(table.shape)}")


def quantize_scatter(buf: torch.Tensor, scales: torch.Tensor,
                     slots: torch.Tensor, rows: torch.Tensor,
                     row_format: str) -> None:
    """Quantize ``rows`` (M, D) fp32 per row and write the codes to
    ``buf[slots]`` and the scales to ``scales[slots]``, in place: the TPU
    kernel ``quantize_rows`` fused with the store's two scatters.

    buf: (C, D) codes of ``row_format``; scales: (C,) fp32; slots: (M,)
    int32, distinct (a row whose slot is out of range is dropped)."""
    _check_quant(buf, scales)
    if ROW_FORMATS.get(row_format, (None,))[0] != buf.dtype:
        raise ValueError(f"buf has dtype {buf.dtype}, which row_format "
                         f"{row_format!r} does not store")
    dev = buf.device
    _check(slots, "slots", 1, (torch.int32,), dev)
    _check(rows, "rows", 2, (torch.float32,), dev)
    m, d = rows.shape
    if d != buf.shape[1] or slots.shape[0] != m:
        raise ValueError(f"rows {tuple(rows.shape)} / slots "
                         f"{tuple(slots.shape)} do not match buf "
                         f"{tuple(buf.shape)}")
    if m == 0:
        return
    if buf.is_meta:
        W.charge("quantize_scatter", W.quantize_scatter(m, d))
        return
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _qlib().repro_quantize_scatter(
            buf.data_ptr(), scales.data_ptr(), buf.shape[0], d,
            _QDTYPE_CODE[buf.dtype], slots.data_ptr(), rows.data_ptr(), m,
            stream)
    _raise_on(err, "quantize_scatter")
    quantize_scatter.launches += 1


quantize_scatter.launches = 0


def _launch_rows_dequant(table, scales, slots, inv, ov, host_rows, m):
    out = torch.empty((m, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    if m == 0:
        return out
    if table.shape[0] == 0:
        raise ValueError("gather from a table with no rows")
    if table.is_meta:
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _qlib().repro_gather_rows_dequant(
            table.data_ptr(), scales.data_ptr(), table.shape[0],
            table.shape[1], _QDTYPE_CODE[table.dtype], slots.data_ptr(),
            slots.shape[0], _ptr(inv), _ptr(ov), _ptr(host_rows),
            out.data_ptr(), m, stream)
    _raise_on(err, "gather_rows_dequant")
    return out


def gather_rows_dequant(table: torch.Tensor, scales: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """table: (N, D) int8/fp8; scales: (N,) fp32; idx: (M,) int32 ->
    (M, D) fp32 ``table[idx] * scales[idx]``: the contract of the TPU
    kernel, bit-exact against the plain version."""
    _check_quant(table, scales)
    _check(idx, "idx", 1, (torch.int32,), table.device)
    out = _launch_rows_dequant(table, scales, idx, None, None, None,
                               idx.shape[0])
    if table.is_meta:
        W.charge("gather_rows_dequant",
                 W.gather_rows_dequant(table, scales, idx))
    elif idx.shape[0]:
        gather_rows_dequant.launches += 1
    return out


gather_rows_dequant.launches = 0


def gather_rows_dequant_expand(table: torch.Tensor, scales: torch.Tensor,
                               slots: torch.Tensor, inv: torch.Tensor,
                               ov: Optional[torch.Tensor] = None,
                               host_rows: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """The quantized store's read in one launch, rows in request order:
    ``out[i] = ov[inv[i]] ? host_rows[inv[i]] : table[slots[inv[i]]] *
    scales[slots[inv[i]]]``, fp32.

    table: (N, D) int8/fp8; scales: (N,) fp32; slots: (U,) int32; inv:
    (M,) int32; ov: (U,) bool and host_rows: (U, D) fp32, both or
    neither."""
    _check_quant(table, scales)
    dev = table.device
    _check(slots, "slots", 1, (torch.int32,), dev)
    _check(inv, "inv", 1, (torch.int32,), dev)
    if (ov is None) != (host_rows is None):
        raise ValueError("pass both ov and host_rows, or neither")
    if ov is not None:
        _check(ov, "ov", 1, (torch.bool,), dev)
        _check(host_rows, "host_rows", 2, (torch.float32,), dev)
        if ov.shape[0] != slots.shape[0] or \
                host_rows.shape != (slots.shape[0], table.shape[1]):
            raise ValueError(f"ov {tuple(ov.shape)} / host_rows "
                             f"{tuple(host_rows.shape)} do not match slots "
                             f"{tuple(slots.shape)} and D={table.shape[1]}")
    if inv.shape[0] and not slots.shape[0]:
        raise ValueError("inv indexes an empty slots vector")
    out = _launch_rows_dequant(table, scales, slots, inv, ov, host_rows,
                               inv.shape[0])
    if table.is_meta:
        W.charge("gather_rows_dequant_expand",
                 W.gather_rows_expand(table, slots, inv, ov, quantized=True))
    elif inv.shape[0]:
        gather_rows_dequant_expand.launches += 1
    return out


gather_rows_dequant_expand.launches = 0


def gather_pool_dequant(table: torch.Tensor, scales: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """table: (N, D) int8/fp8; scales: (N,) fp32; idx: (B, P) int32 ->
    (B, D) fp32 ``sum_p table[idx] * scales[idx]``, each product rounded
    and summed in fp32 in the order p = 0 .. P-1."""
    _check_quant(table, scales)
    _check(idx, "idx", 2, (torch.int32,), table.device)
    b, p = idx.shape
    d = table.shape[1]
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if b == 0 or d == 0:
        return out
    if p == 0:
        return out.zero_()
    if table.shape[0] == 0:
        raise ValueError("gather from a table with no rows")
    if table.is_meta:
        W.charge("gather_pool_dequant", W.gather_pool(table, idx,
                                                      quantized=True))
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _qlib().repro_gather_pool_dequant(
            table.data_ptr(), scales.data_ptr(), table.shape[0], d,
            _QDTYPE_CODE[table.dtype], idx.data_ptr(), b, p, out.data_ptr(),
            stream)
    _raise_on(err, "gather_pool_dequant")
    gather_pool_dequant.launches += 1
    return out


gather_pool_dequant.launches = 0

KERNELS = (gather_rows, gather_rows_expand, gather_pool, gather_pool_shard,
           quantize_scatter, gather_rows_dequant, gather_rows_dequant_expand,
           gather_pool_dequant)


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0
