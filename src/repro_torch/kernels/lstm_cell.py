"""ctypes-bound wrapper of the CUDA kernel in ``csrc/lstm_cell.cu``.

Counterpart of ``src/repro/kernels/lstm_cell.py::lstm_cell``: one fused
LSTM step, ``z = [x, h] @ w + b`` and the gate math, in one launch.  The
wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, copies x, h or w if it is not 16-byte aligned (a view that
starts inside an allocation; the kernel stages 16 bytes at a time),
allocates its outputs with ``torch.empty``, launches on the
current stream, raises if the launch reports an error, and adds one to its
``launches`` count.  On the ``meta`` device it allocates the
same, launches nothing and charges its work
(:mod:`repro_torch.kernels.work`).  The plain version is
:func:`repro_torch.kernels.ref.lstm_cell_ref`;
:func:`repro_torch.kernels.ops.lstm_cell` picks between the two by the
tensors' device and carries the backward.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import work as W
from repro_torch.kernels.embedding_gather import _check, _ptr, _raise_on

_VP, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signature."""
    global _LIB
    if _LIB is None:
        lib = _build.load("lstm_cell")
        lib.repro_lstm_cell.argtypes = [_VP] * 8 + [_I64, _INT, _INT, _VP]
        lib.repro_lstm_cell.restype = _INT
        _LIB = lib
    return _LIB


def lstm_cell(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              w: torch.Tensor, b: torch.Tensor, save_gates: bool = True):
    """x: (B, in); h/c: (B, H); w: (in+H, 4H); b: (4H,), all fp32 on one
    card -> ``(h', c', gates)``, each fp32: (B, H), (B, H) and the
    activated (B, 4H) ``[sigmoid(i), sigmoid(f), tanh(g), sigmoid(o)]``
    (``None`` unless ``save_gates``)."""
    f32 = (torch.float32,)
    _check(h, "h", 2, f32)
    dev = h.device
    _check(x, "x", 2, f32, dev)
    _check(c, "c", 2, f32, dev)
    _check(w, "w", 2, f32, dev)
    _check(b, "b", 1, f32, dev)
    n, hid = h.shape
    in_dim = x.shape[1]
    if (x.shape[0] != n or c.shape != h.shape
            or w.shape != (in_dim + hid, 4 * hid) or b.shape != (4 * hid,)):
        raise ValueError(
            f"lstm_cell shapes do not match: x {tuple(x.shape)}, h "
            f"{tuple(h.shape)}, c {tuple(c.shape)}, w {tuple(w.shape)}, b "
            f"{tuple(b.shape)} (expected w (in+H, 4H), b (4H,))")
    h2 = torch.empty_like(h)
    c2 = torch.empty_like(h)
    gates = (torch.empty((n, 4 * hid), dtype=torch.float32, device=dev)
             if save_gates else None)
    if n == 0 or hid == 0:
        return h2, c2, gates
    if h.is_meta:
        W.charge("lstm_cell", W.lstm_cell(n, in_dim, hid, save_gates))
        return h2, c2, gates
    x, h, w = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, h, w))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().repro_lstm_cell(
            x.data_ptr(), h.data_ptr(), c.data_ptr(), w.data_ptr(),
            b.data_ptr(), h2.data_ptr(), c2.data_ptr(), _ptr(gates), n,
            in_dim, hid, stream)
    _raise_on(err, "lstm_cell")
    lstm_cell.launches += 1
    return h2, c2, gates


lstm_cell.launches = 0
