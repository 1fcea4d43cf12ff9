"""ctypes-bound wrapper of the CUDA kernel in ``csrc/selective_scan.cu``.

No TPU kernel is its counterpart: JAX computes the mamba-1 scan of
``src/repro/models/layers.py::selective_scan`` (:612-657) in XLA, as a
chunked ``lax.associative_scan`` over (B, S, Di, N) arrays.  The kernel
runs the same recurrence sequentially over S in one pass over the block's
inputs, each channel's N states in registers split across a group of N / 4
lanes, its exponentials on the SFU.  The wrapper takes CUDA tensors only:
it checks device, dtype, shape and contiguity, copies ``Bm`` or ``Cm`` if
it is not 16-byte aligned (the kernel stages them 16 bytes at a time),
allocates its outputs with ``torch.empty``, launches on the current
stream, raises if the launch reports an error, and adds one to its
``launches`` count.  The plain
version is :func:`repro_torch.kernels.ref.selective_scan_ref`;
:func:`repro_torch.kernels.ops.selective_scan` picks between the two by
the tensors' device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_gather import (_DTYPE_CODE, _check, _ptr,
                                                  _raise_on)

_VP, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# The state sizes the kernel is compiled for (``ModelConfig.ssm_state``:
# 16 at full width, 8 in ``reduced()``).
STATE_SIZES = (8, 16)

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures."""
    global _LIB
    if _LIB is None:
        lib = _build.load("selective_scan")
        lib.repro_selective_scan.argtypes = [_VP] * 10 + [
            _I64, _I64, _I64, _INT, _INT, _VP]
        lib.repro_selective_scan.restype = _INT
        lib.repro_selective_scan_geometry.argtypes = [_INT, _INT] + [
            ctypes.POINTER(_INT)] * 3
        lib.repro_selective_scan_geometry.restype = _INT
        _LIB = lib
    return _LIB


def geometry(n_state: int, dtype: torch.dtype) -> dict:
    """The kernel's launch geometry on the current card for ``n_state`` and
    x's ``dtype``: ``{"threads", "channels"}`` a block (the grid is
    ``ceil(Di / channels) x B`` blocks) and ``"blocks_per_sm"``, the blocks
    an SM holds at once by the runtime's occupancy calculator."""
    out = [_INT() for _ in range(3)]
    err = _lib().repro_selective_scan_geometry(
        n_state, _DTYPE_CODE[dtype], *(ctypes.byref(v) for v in out))
    _raise_on(err, "selective_scan geometry")
    return dict(zip(("threads", "channels", "blocks_per_sm"),
                    (v.value for v in out)))


def selective_scan(xc: torch.Tensor, z: torch.Tensor, dt: torch.Tensor,
                   a: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                   d_skip: torch.Tensor,
                   h0: Optional[torch.Tensor] = None):
    """xc, z: (B, S, Di) fp32 or bf16; dt: (B, S, Di), a = -exp(A_log):
    (Di, N), bm/cm: (B, S, N), d_skip: (Di,) and h0: None or (B, Di, N),
    all fp32, on one card -> ``(y (B, S, Di) in xc's dtype, h_last (B, Di,
    N) fp32)``: ``h_t = exp(dt_t a) h_{t-1} + dt_t x_t bm_t`` from ``h0``
    (zeros when None), ``y_t = (h_t . cm_t + d_skip x_t) silu(z_t)``."""
    _check(xc, "xc", 3, tuple(_DTYPE_CODE))
    dev = xc.device
    f32 = (torch.float32,)
    _check(z, "z", 3, (xc.dtype,), dev)
    _check(dt, "dt", 3, f32, dev)
    _check(a, "a", 2, f32, dev)
    _check(bm, "bm", 3, f32, dev)
    _check(cm, "cm", 3, f32, dev)
    _check(d_skip, "d_skip", 1, f32, dev)
    if h0 is not None:
        _check(h0, "h0", 3, f32, dev)
    b, s, di = xc.shape
    n = a.shape[1]
    if (z.shape != xc.shape or dt.shape != xc.shape or a.shape[0] != di
            or bm.shape != (b, s, n) or cm.shape != (b, s, n)
            or d_skip.shape != (di,)
            or (h0 is not None and h0.shape != (b, di, n))):
        raise ValueError(
            f"selective_scan shapes do not match: xc {tuple(xc.shape)}, z "
            f"{tuple(z.shape)}, dt {tuple(dt.shape)}, a {tuple(a.shape)}, "
            f"bm {tuple(bm.shape)}, cm {tuple(cm.shape)}, d_skip "
            f"{tuple(d_skip.shape)}, h0 "
            f"{None if h0 is None else tuple(h0.shape)} (expected xc, z, dt "
            "(B, S, Di), a (Di, N), bm, cm (B, S, N), d_skip (Di,), h0 (B, "
            "Di, N))")
    if n not in STATE_SIZES:
        raise ValueError(f"selective_scan takes a state size in "
                         f"{STATE_SIZES}, got {n}")
    y = torch.empty_like(xc)
    h_last = torch.empty((b, di, n), dtype=torch.float32, device=dev)
    if b == 0 or di == 0:
        return y, h_last
    if s == 0:
        return y, (h_last.zero_() if h0 is None else h_last.copy_(h0))
    bm, cm = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (bm, cm))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().repro_selective_scan(
            xc.data_ptr(), z.data_ptr(), dt.data_ptr(), a.data_ptr(),
            bm.data_ptr(), cm.data_ptr(), d_skip.data_ptr(), _ptr(h0),
            y.data_ptr(), h_last.data_ptr(), b, s, di, n,
            _DTYPE_CODE[xc.dtype], stream)
    _raise_on(err, "selective_scan")
    selective_scan.launches += 1
    return y, h_last


selective_scan.launches = 0
