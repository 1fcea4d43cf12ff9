"""ctypes-bound wrappers of the CUDA kernels in ``csrc/selective_scan.cu``
and ``csrc/selective_scan_bwd.cu``.

No TPU kernel is their counterpart: JAX computes the mamba-1 scan of
``src/repro/models/layers.py::selective_scan`` (:612-657) in XLA, as a
chunked ``lax.associative_scan`` over (B, S, Di, N) arrays, and
differentiates it there.  The forward kernel runs the same recurrence
sequentially over S in one pass over the block's inputs, each channel's N
states in registers split across a group of N / 4 lanes, its exponentials
on the SFU; asked for them (training), it also writes the state entering
every 16 steps.  The backward kernel walks those tiles in reverse, a
channel's states over the same N / 4 lanes, recomputing each tile's states
from the saved one into registers, and sums over channels without atomics
(per-block partials that the wrapper adds in a fixed order).  The wrappers
take CUDA tensors only: they check device, dtype, shape and contiguity,
copy ``Bm``, ``Cm`` or the saved states if one is not 16-byte aligned (the
kernels stage them 16 bytes at a time), allocate
their outputs and scratch with ``torch.empty``, launch on the current
stream, raise if the launch reports an error, and add one to their
``launches`` counts (on the ``meta`` device they check and allocate the
same, launch nothing, and charge their work,
:mod:`repro_torch.kernels.work`, in place of a launch).  The plain
versions are
:func:`repro_torch.kernels.ref.selective_scan_ref` and
:func:`~repro_torch.kernels.ref.selective_scan_bwd_ref`;
:func:`repro_torch.kernels.ops.selective_scan` picks between kernel and
plain version by the tensors' device, forward and backward.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import work as W
from repro_torch.kernels.embedding_gather import (_DTYPE_CODE, _check, _ptr,
                                                  _raise_on)

_VP, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# The state sizes the kernel is compiled for (``ModelConfig.ssm_state``:
# 16 at full width, 8 in ``reduced()``).
STATE_SIZES = (8, 16)

_LIB: Optional[ctypes.CDLL] = None
_BWD_LIB: Optional[ctypes.CDLL] = None
# The backward's layout, read from its library: ``{"chunk": steps between
# saved states, "channels": channels a block}``.
_BWD_LAYOUT: dict = {}


def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures."""
    global _LIB
    if _LIB is None:
        lib = _build.load("selective_scan")
        lib.repro_selective_scan.argtypes = [_VP] * 11 + [
            _I64, _I64, _I64, _INT, _INT, _VP]
        lib.repro_selective_scan.restype = _INT
        lib.repro_selective_scan_geometry.argtypes = [_INT, _INT] + [
            ctypes.POINTER(_INT)] * 3
        lib.repro_selective_scan_geometry.restype = _INT
        lib.repro_selective_scan_state_chunk.argtypes = []
        lib.repro_selective_scan_state_chunk.restype = _INT
        _LIB = lib
    return _LIB


def _bwd_lib() -> ctypes.CDLL:
    """The backward's library, built at first use, with its C signature;
    its layout goes to ``_BWD_LAYOUT`` once its chunk is checked against
    the forward's."""
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = _build.load("selective_scan_bwd")
        lib.repro_selective_scan_bwd.argtypes = [_VP] * 17 + [
            _I64, _I64, _I64, _INT, _INT, _VP]
        lib.repro_selective_scan_bwd.restype = _INT
        lib.repro_selective_scan_bwd_layout.argtypes = [
            ctypes.POINTER(_INT)] * 2
        lib.repro_selective_scan_bwd_layout.restype = None
        lib.repro_selective_scan_bwd_geometry.argtypes = [_INT, _INT] + [
            ctypes.POINTER(_INT)] * 3
        lib.repro_selective_scan_bwd_geometry.restype = _INT
        chunk, channels = _INT(), _INT()
        lib.repro_selective_scan_bwd_layout(ctypes.byref(chunk),
                                            ctypes.byref(channels))
        saved = state_chunk()
        if chunk.value != saved:
            raise RuntimeError(
                f"selective_scan_bwd walks {chunk.value}-step chunks, but "
                f"the forward saves a state every {saved} steps")
        _BWD_LAYOUT.update(chunk=chunk.value, channels=channels.value)
        _BWD_LIB = lib
    return _BWD_LIB


def state_chunk() -> int:
    """Steps between the states the forward saves, from its library."""
    return _lib().repro_selective_scan_state_chunk()


def n_chunks(s: int, meta: bool = False) -> int:
    """The number of saved states of an S-step scan (on ``meta``, by the
    kernel's compiled chunk)."""
    return -(-s // (W.SCAN_STATE_CHUNK if meta else state_chunk()))


def _geometry(query, n_state: int, dtype: torch.dtype, what: str) -> dict:
    out = [_INT() for _ in range(3)]
    err = query(n_state, _DTYPE_CODE[dtype], *(ctypes.byref(v) for v in out))
    _raise_on(err, what)
    return dict(zip(("threads", "channels", "blocks_per_sm"),
                    (v.value for v in out)))


def geometry(n_state: int, dtype: torch.dtype) -> dict:
    """The kernel's launch geometry on the current card for ``n_state`` and
    x's ``dtype``: ``{"threads", "channels"}`` a block (the grid is
    ``ceil(Di / channels) x B`` blocks) and ``"blocks_per_sm"``, the blocks
    an SM holds at once by the runtime's occupancy calculator."""
    return _geometry(_lib().repro_selective_scan_geometry, n_state, dtype,
                     "selective_scan geometry")


def bwd_geometry(n_state: int, dtype: torch.dtype) -> dict:
    """:func:`geometry` of the backward kernel, from its library."""
    return _geometry(_bwd_lib().repro_selective_scan_bwd_geometry, n_state,
                     dtype, "selective_scan_bwd geometry")


def _check_scan(xc, z, dt, a, bm, cm, d_skip, h0, fn):
    """Checks the scan's inputs; returns ``(B, S, Di, N)``."""
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
            f"{fn} shapes do not match: xc {tuple(xc.shape)}, z "
            f"{tuple(z.shape)}, dt {tuple(dt.shape)}, a {tuple(a.shape)}, "
            f"bm {tuple(bm.shape)}, cm {tuple(cm.shape)}, d_skip "
            f"{tuple(d_skip.shape)}, h0 "
            f"{None if h0 is None else tuple(h0.shape)} (expected xc, z, dt "
            "(B, S, Di), a (Di, N), bm, cm (B, S, N), d_skip (Di,), h0 (B, "
            "Di, N))")
    if n not in STATE_SIZES:
        raise ValueError(f"{fn} takes a state size in {STATE_SIZES}, got "
                         f"{n}")
    return b, s, di, n


def selective_scan(xc: torch.Tensor, z: torch.Tensor, dt: torch.Tensor,
                   a: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                   d_skip: torch.Tensor,
                   h0: Optional[torch.Tensor] = None,
                   save_states: bool = False):
    """xc, z: (B, S, Di) fp32 or bf16; dt: (B, S, Di), a = -exp(A_log):
    (Di, N), bm/cm: (B, S, N), d_skip: (Di,) and h0: None or (B, Di, N),
    all fp32, on one card -> ``(y (B, S, Di) in xc's dtype, h_last (B, Di,
    N) fp32)``: ``h_t = exp(dt_t a) h_{t-1} + dt_t x_t bm_t`` from ``h0``
    (zeros when None), ``y_t = (h_t . cm_t + d_skip x_t) silu(z_t)``.
    With ``save_states``, ``(y, h_last, states)``: states (B, ceil(S /
    16), Di, N) fp32, the state entering steps 0, 16, 32, ...
    (:func:`state_chunk` steps apart), what
    :func:`selective_scan_bwd` takes; y and h_last have the same bits
    either way."""
    b, s, di, n = _check_scan(xc, z, dt, a, bm, cm, d_skip, h0,
                              "selective_scan")
    dev = xc.device
    y = torch.empty_like(xc)
    h_last = torch.empty((b, di, n), dtype=torch.float32, device=dev)
    states = (torch.empty((b, n_chunks(s, xc.is_meta), di, n),
                          dtype=torch.float32, device=dev)
              if save_states else None)
    out = (y, h_last, states) if save_states else (y, h_last)
    if b == 0 or di == 0:
        return out
    if s == 0:
        if h0 is None:
            h_last.zero_()
        else:
            h_last.copy_(h0)
        return out
    if xc.is_meta:
        W.charge("selective_scan",
                 W.selective_scan(b, s, di, n, xc.element_size()))
        return out
    bm, cm = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (bm, cm))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().repro_selective_scan(
            xc.data_ptr(), z.data_ptr(), dt.data_ptr(), a.data_ptr(),
            bm.data_ptr(), cm.data_ptr(), d_skip.data_ptr(), _ptr(h0),
            y.data_ptr(), h_last.data_ptr(), _ptr(states), b, s, di, n,
            _DTYPE_CODE[xc.dtype], stream)
    _raise_on(err, "selective_scan")
    selective_scan.launches += 1
    return out


selective_scan.launches = 0


def selective_scan_bwd(xc: torch.Tensor, z: torch.Tensor, dt: torch.Tensor,
                       a: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                       d_skip: torch.Tensor, states: torch.Tensor,
                       dy: torch.Tensor,
                       dh_last: Optional[torch.Tensor] = None):
    """The gradients of :func:`selective_scan`: its inputs as it took them,
    ``states`` as it saved them (``save_states``), dy (B, S, Di) in xc's
    dtype and dh_last None (zeros) or (B, Di, N) fp32 -> ``(dx, dz, ddt,
    da, dbm, dcm, dd, dh0)``: dx and dz in xc's dtype, the rest fp32 in
    the shapes of dt, a, bm, cm, d_skip and h0.  dB, dC, da and dD are
    summed over channels and rows from per-block partials in a fixed order,
    so two calls give the same bits."""
    b, s, di, n = _check_scan(xc, z, dt, a, bm, cm, d_skip, None,
                              "selective_scan_bwd")
    dev = xc.device
    f32 = (torch.float32,)
    _check(states, "states", 4, f32, dev)
    _check(dy, "dy", 3, (xc.dtype,), dev)
    if dh_last is not None:
        _check(dh_last, "dh_last", 3, f32, dev)
    if (states.shape != (b, n_chunks(s, xc.is_meta), di, n)
            or dy.shape != xc.shape
            or (dh_last is not None and dh_last.shape != (b, di, n))):
        raise ValueError(
            f"selective_scan_bwd shapes do not match: states "
            f"{tuple(states.shape)}, dy {tuple(dy.shape)}, dh_last "
            f"{None if dh_last is None else tuple(dh_last.shape)} (expected "
            f"states {(b, n_chunks(s, xc.is_meta), di, n)}, dy like xc, "
            f"dh_last {(b, di, n)})")
    dx, dz = torch.empty_like(xc), torch.empty_like(z)
    ddt = torch.empty_like(dt)
    dh0 = torch.empty((b, di, n), dtype=torch.float32, device=dev)
    if b == 0 or di == 0 or s == 0:
        if dh_last is None:
            dh0.zero_()
        else:
            dh0.copy_(dh_last)
        return (dx, dz, ddt, torch.zeros_like(a), torch.zeros_like(bm),
                torch.zeros_like(cm), torch.zeros_like(d_skip), dh0)
    da_part = torch.empty((b, di, n), dtype=torch.float32, device=dev)
    lib = None if xc.is_meta else _bwd_lib()
    channels = (W.SCAN_BWD_CHANNELS if xc.is_meta
                else _BWD_LAYOUT["channels"])
    dbc_part = torch.empty((-(-di // channels), b, s, 2 * n),
                           dtype=torch.float32, device=dev)
    dd_part = torch.empty((b, di), dtype=torch.float32, device=dev)
    if xc.is_meta:
        W.charge("selective_scan_bwd",
                 W.selective_scan_bwd(b, s, di, n, xc.element_size()))
    else:
        _launch_scan_bwd(lib, xc, z, dt, a, bm, cm, d_skip, states, dy,
                         dh_last, dx, dz, ddt, da_part, dbc_part, dd_part,
                         dh0)
    dbc = dbc_part.sum(dim=0)
    return (dx, dz, ddt, da_part.sum(dim=0), dbc[..., :n].contiguous(),
            dbc[..., n:].contiguous(), dd_part.sum(dim=0), dh0)


selective_scan_bwd.launches = 0


def _launch_scan_bwd(lib, xc, z, dt, a, bm, cm, d_skip, states, dy, dh_last,
                     dx, dz, ddt, da_part, dbc_part, dd_part, dh0) -> None:
    """:func:`selective_scan_bwd`'s launch into the buffers it allocated."""
    b, s, di = xc.shape
    n = a.shape[1]
    dev = xc.device
    bm, cm, states = (t if t.data_ptr() % 16 == 0 else t.clone()
                      for t in (bm, cm, states))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_selective_scan_bwd(
            xc.data_ptr(), z.data_ptr(), dt.data_ptr(), a.data_ptr(),
            bm.data_ptr(), cm.data_ptr(), d_skip.data_ptr(),
            states.data_ptr(), dy.data_ptr(), _ptr(dh_last), dx.data_ptr(),
            dz.data_ptr(), ddt.data_ptr(), da_part.data_ptr(),
            dbc_part.data_ptr(), dd_part.data_ptr(), dh0.data_ptr(), b, s,
            di, n, _DTYPE_CODE[xc.dtype], stream)
    _raise_on(err, "selective_scan_bwd")
    selective_scan_bwd.launches += 1
