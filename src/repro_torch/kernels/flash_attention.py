"""ctypes-bound wrappers of the CUDA kernels in ``csrc/flash_attention.cu``
and ``csrc/flash_attention_bwd.cu``.

Counterpart of ``src/repro/kernels/flash_attention.py::flash_attention``:
causal attention with an online softmax in fp32, scale ``1/sqrt(hd)``.
The forward also takes a sliding ``window`` (query q sees keys ``q -
window < k <= q``), which the Pallas kernel does not have: JAX computes
the windowed attention in XLA (``blocked_causal_attention(window=)``).
``causal=False`` lets every query see every key (an encoder's
self-attention, JAX's ``plain_attention(causal=False)`` in XLA), forward
and backward, with no window.  The forward also takes q (B, Sq, H, hd)
against k/v (B, Sk, K, hd) at a query offset (``q_offset``: query row i
sits at position ``q_offset + i``, the keys at 0 .. Sk - 1; causal needs
``q_offset + Sq <= Sk``): a sequence-parallel rank's queries against
every key (JAX's ``kv_stream_attention``, XLA).
The kernel takes the model's layout, q (B, S, H, hd) and k/v (B, S, K, hd)
with ``H % K == 0`` (query head h reads KV head ``h // (H // K)``), any S,
fp32 or bf16, hd in {16, 32, 64, 128}.  bf16 runs the products on the
tensor cores (p rounded to bf16 for the p v product), forward and
backward; fp32 runs fp32 FMAs.
The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, copies a bf16 input that is not 16-byte aligned, allocates its
outputs and scratch with ``torch.empty``, launches on the current stream,
raises if the launch reports an error, and adds one to its ``launches``
count.  Asked
for it (``with_lse``), the forward also returns each row's log-sum-exp,
(B, H, S) fp32, which :func:`flash_attention_bwd` (no TPU counterpart: JAX
differentiates the attention's XLA version) takes to give dq, dk and dv
without storing the scores, under the same ``window``.  The plain versions
are :func:`repro_torch.kernels.ref.causal_attention_ref`,
:func:`~repro_torch.kernels.ref.causal_attention_lse_ref`,
:func:`~repro_torch.kernels.ref.flash_attention_ref` and
:func:`~repro_torch.kernels.ref.flash_attention_bwd_ref`;
:func:`repro_torch.kernels.ops.flash_attention` picks between kernel and
plain version by the tensors' device.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_gather import (_DTYPE_CODE, _check,
                                                  _raise_on)

_VP, _I64, _INT, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_float)
HEAD_DIMS = (16, 32, 64, 128)

_LIB: Optional[ctypes.CDLL] = None
_BWD_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signature."""
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention")
        lib.repro_flash_attention.argtypes = [_VP] * 5 + [
            _I64, _I64, _I64, _I64, _INT, _INT, _INT, _INT, _F32, _I64, _INT,
            _VP]
        lib.repro_flash_attention.restype = _INT
        _LIB = lib
    return _LIB


def _bwd_lib() -> ctypes.CDLL:
    """The backward's library, built at first use, with its C signature."""
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = _build.load("flash_attention_bwd")
        lib.repro_flash_attention_bwd_split.argtypes = [_VP] * 11 + [
            _I64, _I64, _INT, _INT, _INT, _INT, _F32, _INT, _INT, _INT, _VP]
        lib.repro_flash_attention_bwd_split.restype = _INT
        _BWD_LIB = lib
    return _BWD_LIB


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               fn: str, q_offset: Optional[int] = None,
               causal: bool = True):
    """Device, dtype and shapes; ``q_offset`` None asks for k/v of q's
    length (the backward), else k/v may be of any length Sk, and a causal
    attention needs ``0 <= q_offset`` and ``q_offset + Sq <= Sk``."""
    _check(q, "q", 4, tuple(_DTYPE_CODE))
    _check(k, "k", 4, (q.dtype,), q.device)
    _check(v, "v", 4, (q.dtype,), q.device)
    b, s, h, hd = q.shape
    kv = k.shape[2]
    s_k = s if q_offset is None else k.shape[1]
    if (k.shape != v.shape or k.shape[:2] != (b, s_k) or k.shape[3] != hd
            or kv == 0 or h % kv):
        raise ValueError(
            f"{fn} shapes do not match: q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)} (expected k/v (B, "
            f"{'S' if q_offset is None else 'Sk'}, K, hd) with H % K == 0)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{fn} takes head_dim in {HEAD_DIMS}, got {hd}")
    if q_offset is not None and (q_offset < 0 or (
            causal and q_offset + s > k.shape[1])):
        raise ValueError(
            f"{fn} q_offset {q_offset}: queries at {q_offset} .. "
            f"{q_offset + s - 1} need keys up to there (Sk "
            f"{k.shape[1]}){' under causal' if causal else ''}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    with_lse: bool = False, window: int = 0,
                    causal: bool = True, q_offset: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, Sk, K, hd), one dtype (fp32 or bf16) on
    one card -> (B, Sq, H, hd) causal attention in q's dtype; with
    ``with_lse``, ``(out, lse)`` with lse (B, H, Sq) fp32, each row's
    log-sum-exp of its scaled scores (natural log).  Without it the
    output's bits are those of the serve path.  Query row i sits at
    position ``q_offset + i`` (causal: ``q_offset + Sq <= Sk``); Sq = Sk
    at offset 0 is the model's prefill.  ``window > 0``: query q sees keys
    ``q - window < k <= q`` only (JAX's sliding window); 0 is causal.
    ``causal=False``: every query sees every key (no window)."""
    _check_qkv(q, k, v, "flash_attention", q_offset, causal)
    b, s, h, hd = q.shape
    s_k = k.shape[1]
    window = _window(window, s_k, causal, "flash_attention")
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b == 0 or s == 0 or h == 0 or s_k == 0:
        if s_k == 0:  # unmasked rows that see no key
            out.zero_()
            lse = None if lse is None else lse.fill_(-math.inf)
        return (out, lse) if with_lse else out
    if q.dtype == torch.bfloat16:
        # The bf16 kernel copies 16 bytes at a time: a view that starts
        # inside an allocation off a 16-byte boundary is copied first.
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, s, s_k, q_offset, h,
            k.shape[2], hd, _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(hd), window,
            int(causal), stream)
    _raise_on(err, "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


flash_attention.launches = 0


def _window(window: int, s: int, causal: bool, fn: str) -> int:
    """The window as the kernels take it: 0 (causal) or 1 .. S; a window
    of S or more masks no key of a real row, so it is passed as S.  An
    unmasked (``causal=False``) attention takes none."""
    if window < 0:
        raise ValueError(f"{fn} window {window}: expected >= 0 (0 is "
                         "causal)")
    if window and not causal:
        raise ValueError(f"{fn}: a window ({window}) is causal; "
                         "causal=False takes none")
    return min(window, s)


# The dK/dV kernel's key tile (csrc/flash_attention_bwd.cu, kMmaRows).
BWD_KEY_TILE = 64


def bwd_splits(b: int, s: int, n_kv: int, group: int, sms: int) -> int:
    """Over how many blocks the bf16 backward splits each KV head's
    ``group`` query heads for dK and dV: 1 when the B * K * ceil(S / 64)
    key-tile blocks reach two a streaming multiprocessor, else the least
    divisor of ``group`` that brings them there (or ``group``).  A split
    costs an fp32 partial of dK and dV each and a pass that sums them."""
    blocks = b * n_kv * -(-s // BWD_KEY_TILE)
    for d in range(1, group + 1):
        if group % d == 0 and blocks * d >= 2 * sms:
            return d
    return group


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor,
                        lse: torch.Tensor, splits: Optional[int] = None,
                        window: int = 0, causal: bool = True):
    """The gradients of :func:`flash_attention`: q, o and do (B, S, H, hd);
    k/v (B, S, K, hd), one dtype on one card; lse (B, H, S) fp32 from the
    forward of the same ``window`` (0 is causal) and ``causal`` -> ``(dq,
    dk, dv)``, dq in q's dtype and dk, dv in k's.  ``splits`` (bf16 only)
    overrides :func:`bwd_splits`'s choice; it must divide H / K."""
    _check_qkv(q, k, v, "flash_attention_bwd")
    _check(o, "o", 4, (q.dtype,), q.device)
    _check(do, "do", 4, (q.dtype,), q.device)
    _check(lse, "lse", 3, (torch.float32,), q.device)
    b, s, h, hd = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, s):
        raise ValueError(
            f"flash_attention_bwd shapes do not match: q {tuple(q.shape)}, "
            f"o {tuple(o.shape)}, do {tuple(do.shape)}, lse "
            f"{tuple(lse.shape)} (expected o, do like q, lse (B, H, S))")
    window = _window(window, s, causal, "flash_attention_bwd")
    n_kv = k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    if splits is not None and (splits < 1 or (h // n_kv) % splits
                               or (splits > 1 and not bf16)):
        raise ValueError(f"flash_attention_bwd splits {splits}: a divisor "
                         f"of H / K = {h // n_kv}, above 1 only for bf16")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if b == 0 or s == 0 or h == 0:
        return dq, dk.zero_(), dv.zero_()
    if bf16:
        # The bf16 kernels copy q, k, v and do 16 bytes at a time: a view
        # that starts off a 16-byte boundary is copied first.
        q, k, v, do = (t if t.data_ptr() % 16 == 0 else t.clone()
                       for t in (q, k, v, do))
        if splits is None:
            splits = bwd_splits(b, s, n_kv, h // n_kv, torch.cuda
                                .get_device_properties(q.device)
                                .multi_processor_count)
    splits = splits or 1
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    partial = (torch.empty((2, splits, b, s, n_kv, hd), dtype=torch.float32,
                           device=q.device) if splits > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_lib().repro_flash_attention_bwd_split(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            None if partial is None else partial.data_ptr(), b, s, h, n_kv,
            hd, _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(hd), splits, window,
            int(causal), stream)
    _raise_on(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
