"""ctypes-bound wrapper of the CUDA kernel in ``csrc/chamfer.cu``.

Counterpart of ``src/repro/kernels/chamfer_kernel.py::chamfer``: the
bidirectional Chamfer distance of each batch row, with the argmins of its
two min-reductions.  The wrapper takes CUDA tensors only: it checks device,
dtype, shape and contiguity, copies ``po`` or ``w`` first when it does not
start on a 16-byte boundary (a view inside an allocation: the kernel stages
with 16-byte copies), allocates its outputs with ``torch.empty``, launches
on the current stream, raises if the launch reports an error, and
adds one to its ``launches`` count.  On the ``meta`` device it allocates the
same, launches nothing and charges its work
(:mod:`repro_torch.kernels.work`).  The plain version is
:func:`repro_torch.kernels.ref.chamfer_ref`;
:func:`repro_torch.kernels.ops.chamfer` picks between the two by the
tensors' device and carries the backward.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import work as W
from repro_torch.kernels.embedding_gather import _check, _raise_on

_VP, _I64, _INT, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_float)

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signature."""
    global _LIB
    if _LIB is None:
        lib = _build.load("chamfer")
        lib.repro_chamfer.argtypes = [_VP] * 5 + [_I64, _INT, _INT, _INT,
                                                  _F32, _F32, _VP]
        lib.repro_chamfer.restype = _INT
        _LIB = lib
    return _LIB


def chamfer(po: torch.Tensor, w: torch.Tensor, alpha: float = 0.7):
    """po: (B, P, F); w: (B, W, F), both fp32 on one card -> ``(loss (B,)
    fp32, arg_fwd (B, P) int32, arg_bwd (B, W) int32)``: ``loss = alpha *
    mean_p min_w |po_p - w_w|^2 + (1 - alpha) * mean_w min_p |po_p -
    w_w|^2``, ``arg_fwd[p]`` the nearest w of each p and ``arg_bwd[w]`` the
    nearest p of each w (ties to the lowest index)."""
    f32 = (torch.float32,)
    _check(po, "po", 3, f32)
    _check(w, "w", 3, f32, po.device)
    n, n_p, n_f = po.shape
    n_w = w.shape[1]
    if w.shape[0] != n or w.shape[2] != n_f:
        raise ValueError(f"chamfer shapes do not match: po {tuple(po.shape)},"
                         f" w {tuple(w.shape)}")
    if n and (n_p == 0 or n_w == 0 or n_f == 0):
        raise ValueError("chamfer needs at least one point of at least one "
                         "feature on each side")
    loss = torch.empty((n,), dtype=torch.float32, device=po.device)
    arg_fwd = torch.empty((n, n_p), dtype=torch.int32, device=po.device)
    arg_bwd = torch.empty((n, n_w), dtype=torch.int32, device=po.device)
    if n == 0:
        return loss, arg_fwd, arg_bwd
    if po.is_meta:
        W.charge("chamfer", W.chamfer(n, n_p, n_w, n_f))
        return loss, arg_fwd, arg_bwd
    po, w = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (po, w))
    with torch.cuda.device(po.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().repro_chamfer(
            po.data_ptr(), w.data_ptr(), loss.data_ptr(), arg_fwd.data_ptr(),
            arg_bwd.data_ptr(), n, n_p, n_w, n_f, alpha, 1.0 - alpha, stream)
    _raise_on(err, "chamfer")
    chamfer.launches += 1
    return loss, arg_fwd, arg_bwd


chamfer.launches = 0
