"""Device-dispatching entry points to the port's kernels.

Counterpart of ``src/repro/kernels/ops.py``.  There is no ``use_pallas``
knob: a CUDA tensor goes to the CUDA kernel (which launches or raises),
and a CPU tensor goes to the plain PyTorch version.  Nothing falls back
from the card to the plain path.

``lstm_cell``, ``chamfer``, ``gather_pool`` (and its shard window
``gather_pool_shard``), ``flash_attention`` and ``selective_scan`` sit
under gradients (every LSTM step of the learned models, the prefetch
model's loss, the DLRM and LM training losses, the row-sharded DLRM's and
the SSM and hybrid LMs' included), so under autograd they are
``torch.autograd.Function``s whose forward is the kernel (or the plain
version on the CPU).  The backwards of ``lstm_cell``, ``chamfer`` and
``gather_pool`` are device-agnostic PyTorch on what the forward saved (the
activated gates, the argmins, the ids: a scatter-add, which skips the
shard window's ids < 0); the Pallas kernels have no backward either.
``flash_attention``'s backward, causal or in a sliding window, is a kernel of
its own on the card (``flash_attention_bwd``, from the forward's log-sum-exp)
and its plain version on the CPU; so is ``selective_scan``'s (the mamba-1 scan,
a kernel with no TPU counterpart: ``selective_scan_bwd``, from the states the
forward saved every 16 steps).  A ``meta`` tensor takes the kernel's
route: its wrapper checks and allocates as on the card, launches nothing
and charges the kernel's work to the dry-run's meters.  Outside autograd (serving under
``torch.inference_mode()``) each op calls its kernel directly:
``flash_attention`` writes no log-sum-exp and ``selective_scan`` saves no
states.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import chamfer_kernel as _ck
from repro_torch.kernels import embedding_gather as _eg
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lstm_cell as _lc
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as _ss

# Every kernel wrapper of the port, each with its ``launches`` count.
KERNELS = _eg.KERNELS + (_lc.lstm_cell, _ck.chamfer,
                         _fa.flash_attention, _fa.flash_attention_bwd,
                         _ss.selective_scan, _ss.selective_scan_bwd)


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0


def _on_cuda(t: torch.Tensor) -> bool:
    """True for a tensor the kernel wrapper takes: a CUDA tensor (the
    kernel launches) or a ``meta`` one (the wrapper charges the kernel's
    work, :mod:`repro_torch.kernels.work`, and launches nothing); False on
    the CPU (the plain version)."""
    if t.device.type in ("cuda", "meta"):
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


def _requires_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _gather_pool_forward(table: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    if _on_cuda(table):
        return _eg.gather_pool(table, idx)
    return ref.gather_pool_ref(table, idx)


# Spare rows past the table that take the shard window's ids < 0 in the
# backward, spread by pooled row so that their atomic adds do not pile onto
# one address (a rank's foreign ids are half of them).
_SPARE_ROWS = 256


def _pool_backward(idx: torch.Tensor, dout: torch.Tensor, shape,
                   dtype: torch.dtype, skip_negative: bool) -> torch.Tensor:
    """The table's gradient of a sum-pool: the pooled gradient scatter-added
    into a dense fp32 table, one scatter per pooled position (never a (B *
    P, D) copy), cast once to ``dtype``.  With ``skip_negative`` an id < 0
    adds nothing: it goes to one of ``_SPARE_ROWS`` rows past the table,
    which are dropped (clamping it would add every foreign row's gradient
    into row 0)."""
    n = shape[0]
    spare = _SPARE_ROWS if skip_negative else 0
    grad = torch.zeros((n + spare, *shape[1:]), dtype=torch.float32,
                       device=dout.device)
    dout = dout.float()
    if spare:
        spill = n + torch.arange(idx.shape[0], device=idx.device) % spare
    for p in range(idx.shape[1]):
        ids = ref._clamped(idx[:, p], n)
        if spare:
            ids = torch.where(idx[:, p] < 0, spill, ids)
        grad.index_add_(0, ids, dout)
    return grad[:n].to(dtype)


class _GatherPool(torch.autograd.Function):
    """Sum-pool; the table's gradient is :func:`_pool_backward`.  With
    ``skip_negative`` it is the shard window: ids < 0 add nothing, forward
    and backward.  ``grad_idx``, when given, holds the ids the backward
    scatters to, ids < 0 adding nothing (a gather whose forward clamped an
    id that its gradient drops)."""

    @staticmethod
    def forward(ctx, table, idx, skip_negative, grad_idx):
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        ctx.skip_negative = skip_negative or grad_idx is not None
        ctx.save_for_backward(idx if grad_idx is None else grad_idx)
        if skip_negative:
            return _gather_pool_shard_forward(table, idx)
        return _gather_pool_forward(table, idx)

    @staticmethod
    def backward(ctx, dout):
        (idx,) = ctx.saved_tensors
        return _pool_backward(idx, dout, ctx.table_shape, ctx.table_dtype,
                              ctx.skip_negative), None, None, None


def gather_pool(table: torch.Tensor, idx: torch.Tensor,
                grad_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """table: (N, D); idx: (B, P) int32 -> (B, D) fp32 sum-pool,
    differentiable in ``table`` (the backward into ``grad_idx``'s rows
    when given, ids < 0 dropped)."""
    if _requires_grad(table):
        return _GatherPool.apply(table, idx, False, grad_idx)
    return _gather_pool_forward(table, idx)


def _gather_pool_shard_forward(table: torch.Tensor,
                               idx: torch.Tensor) -> torch.Tensor:
    if _on_cuda(table):
        return _eg.gather_pool_shard(table, idx)
    return ref.gather_pool_shard_ref(table, idx)


def gather_pool_shard(table: torch.Tensor, idx: torch.Tensor,
                      grad_idx: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """table: (N, D), a rank's shard of rows; idx: (B, P) int32 with -1
    for a row the shard does not own -> (B, D) fp32 sum-pool of the owned
    rows, differentiable in ``table``: the backward scatter-adds the
    pooled gradient into the owned rows only (:func:`_pool_backward`;
    those of ``grad_idx`` when given)."""
    if _requires_grad(table):
        return _GatherPool.apply(table, idx, True, grad_idx)
    return _gather_pool_shard_forward(table, idx)


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


def _lstm_forward(x, h, c, w, b, save_gates: bool):
    """``(h', c', gates)`` from the kernel on the card (``gates`` None when
    not saved), from the plain version on the CPU."""
    if _on_cuda(h):
        return _lc.lstm_cell(x.contiguous(), h.contiguous(), c.contiguous(),
                             w.contiguous(), b.contiguous(),
                             save_gates=save_gates)
    return ref.lstm_cell_ref(x, h, c, w, b)


class _LSTMCell(torch.autograd.Function):
    """One LSTM step; backward from the saved activated gates."""

    @staticmethod
    def forward(ctx, x, h, c, w, b):
        h2, c2, gates = _lstm_forward(x, h, c, w, b, save_gates=True)
        ctx.save_for_backward(x, h, c, w, gates, c2)
        return h2, c2

    @staticmethod
    def backward(ctx, dh2, dc2):
        x, h, c, w, gates, c2 = ctx.saved_tensors
        hid = h.shape[1]
        i, f, g, o = gates.split(hid, dim=1)
        tc = torch.tanh(c2)
        dh2 = torch.zeros_like(c2) if dh2 is None else dh2.to(c2.dtype)
        dct = dh2 * o * (1 - tc * tc)
        if dc2 is not None:
            dct = dct + dc2
        dz = torch.cat([dct * g * i * (1 - i),        # d z_i
                        dct * c * f * (1 - f),        # d z_f
                        dct * i * (1 - g * g),        # d z_g
                        dh2 * tc * o * (1 - o)],      # d z_o
                       dim=1)
        xh = torch.cat([x, h], dim=1).to(dz.dtype)
        dw = xh.t() @ dz
        db = dz.sum(dim=0)
        dxh = dz @ w.to(dz.dtype).t()
        dx, dh = dxh.split([x.shape[1], hid], dim=1)
        return (dx.to(x.dtype), dh.to(h.dtype), (dct * f).to(c.dtype),
                dw.to(w.dtype), db)


def lstm_cell(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              w: torch.Tensor, b: torch.Tensor):
    """x: (B, in); h/c: (B, H); w: (in+H, 4H); b: (4H,) -> ``(h', c')``
    of one LSTM step, differentiable in every input.  Outside autograd
    (inference) the kernel writes no gates."""
    if _requires_grad(x, h, c, w, b):
        return _LSTMCell.apply(x, h, c, w, b)
    return _lstm_forward(x, h, c, w, b, save_gates=False)[:2]


class _Chamfer(torch.autograd.Function):
    """Bidirectional Chamfer; the gradient reaches ``po`` only (the
    prefetch model stop-gradients its targets)."""

    @staticmethod
    def forward(ctx, po, w, alpha):
        if _on_cuda(po):
            loss, af, ab = _ck.chamfer(po.contiguous(), w.contiguous(),
                                       alpha)
        else:
            loss, af, ab = ref.chamfer_ref(po, w, alpha)
        ctx.alpha = alpha
        ctx.save_for_backward(po, w, af, ab)
        ctx.mark_non_differentiable(af, ab)
        return loss, af, ab

    @staticmethod
    def backward(ctx, dloss, _daf, _dab):
        po, w, af, ab = ctx.saved_tensors
        n_p, n_w = po.shape[1], w.shape[1]
        alpha = ctx.alpha
        wt = w.to(po.dtype)
        # Each p pulls towards its nearest w: 2 alpha / P (po_p - w_af[p]).
        near_w = torch.gather(wt, 1, af.long()[..., None].expand(
            -1, -1, po.shape[2]))
        dpo = (2.0 * alpha / n_p) * (po - near_w)
        # Each w pulls its nearest p: 2 (1 - alpha) / W (po_ab[w] - w).
        idx = ab.long()[..., None].expand(-1, -1, po.shape[2])
        near_p = torch.gather(po, 1, idx)
        dpo = dpo.scatter_add(1, idx,
                              (2.0 * (1.0 - alpha) / n_w) * (near_p - wt))
        return dloss[:, None, None] * dpo, None, None


def chamfer(po: torch.Tensor, w: torch.Tensor, alpha: float = 0.7):
    """po: (B, P, F); w: (B, W, F) -> (B,) ``alpha * mean_p min_w |po_p -
    w_w|^2 + (1 - alpha) * mean_w min_p |po_p - w_w|^2``, differentiable in
    ``po`` (``w`` gets no gradient)."""
    return _Chamfer.apply(po, w, alpha)[0]


class _FlashAttention(torch.autograd.Function):
    """Causal attention, in a sliding ``window`` when it is above 0, or
    unmasked (``causal`` False), with q's rows at ``q_offset`` against
    every key; the backward recomputes p from the forward's log-sum-exp
    under the same mask and offset: ``flash_attention_bwd`` on the card,
    its plain version on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal, q_offset):
        if _on_cuda(q):
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            o, lse = _fa.flash_attention(q, k, v, with_lse=True,
                                         window=window, causal=causal,
                                         q_offset=q_offset)
        else:
            o, lse = ref.causal_attention_lse_ref(q, k, v, window, causal,
                                                  q_offset)
        ctx.window, ctx.causal, ctx.q_offset = window, causal, q_offset
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if _on_cuda(q):
            grads = _fa.flash_attention_bwd(q, k, v, o, do.contiguous(), lse,
                                            window=ctx.window,
                                            causal=ctx.causal,
                                            q_offset=ctx.q_offset)
        else:
            grads = ref.flash_attention_bwd_ref(q, k, v, o, do, lse,
                                                ctx.window, ctx.causal,
                                                ctx.q_offset)
        return (*grads, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int = 0, causal: bool = True,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, K, hd) with ``H % K == 0`` -> (B,
    Sq, H, hd) causal attention in q's dtype (query head h reads KV head
    ``h // (H // K)``), scale ``1/sqrt(hd)``, any S; ``window > 0`` limits
    query q to keys ``q - window < k <= q`` (0 is causal); ``causal=False``
    lets every query see every key (no window).  Query row i sits at
    position ``q_offset + i`` (a sequence-parallel rank's queries; causal
    needs ``q_offset + Sq <= Sk``); Sq = Sk at offset 0 is the model's own
    attention.  Differentiable in q, k and v, whatever the mask and
    offset: dk and dv are these queries' part (the kernel's offset mode
    on the card, forward and backward)."""
    if _requires_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, window, causal, q_offset)
    if _on_cuda(q):
        return _fa.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), window=window,
                                   causal=causal, q_offset=q_offset)
    return ref.causal_attention_ref(q, k, v, window, causal, q_offset)


class _SelectiveScan(torch.autograd.Function):
    """The mamba-1 scan; the backward walks the recurrence in reverse:
    ``selective_scan_bwd`` on the card, from the states the forward kernel
    saved every 16 steps, and ``selective_scan_bwd_ref`` on the CPU.  An
    output that the loss does not use (``h_last`` in training) gets a
    gradient of zeros (autograd materialises it)."""

    @staticmethod
    def forward(ctx, xc, z, dt, a, bm, cm, d_skip, h0):
        if _on_cuda(xc):
            xc, z, dt, a, bm, cm, d_skip = (t.contiguous() for t in (
                xc, z, dt, a, bm, cm, d_skip))
            h0 = None if h0 is None else h0.contiguous()
            y, h_last, states = _ss.selective_scan(
                xc, z, dt, a, bm, cm, d_skip, h0, save_states=True)
        else:
            (y, h_last), states = ref.selective_scan_ref(
                xc, z, dt, a, bm, cm, d_skip, h0), None
        ctx.has_h0 = h0 is not None
        ctx.save_for_backward(xc, z, dt, a, bm, cm, d_skip, h0, states)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        xc, z, dt, a, bm, cm, d_skip, h0, states = ctx.saved_tensors
        if _on_cuda(xc):
            grads = _ss.selective_scan_bwd(
                xc, z, dt, a, bm, cm, d_skip, states, dy.contiguous(),
                dh_last.contiguous())
        else:
            grads = ref.selective_scan_bwd_ref(xc, z, dt, a, bm, cm, d_skip,
                                               h0, dy, dh_last)
        return (*grads[:7], grads[7] if ctx.has_h0 else None)


def selective_scan(xc: torch.Tensor, z: torch.Tensor, dt: torch.Tensor,
                   a: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                   d_skip: torch.Tensor,
                   h0: Optional[torch.Tensor] = None):
    """The mamba-1 scan: xc, z (B, S, Di); dt (B, S, Di), a (Di, N), bm/cm
    (B, S, N), d_skip (Di,), h0 None or (B, Di, N), fp32 -> ``(y (B, S,
    Di) in xc's dtype, h_last (B, Di, N) fp32)``, differentiable in every
    input.  Outside autograd (serving) the kernel saves no states."""
    if _requires_grad(xc, z, dt, a, bm, cm, d_skip,
                      *(() if h0 is None else (h0,))):
        return _SelectiveScan.apply(xc, z, dt, a, bm, cm, d_skip, h0)
    if _on_cuda(xc):
        return _ss.selective_scan(
            xc.contiguous(), z.contiguous(), dt.contiguous(), a.contiguous(),
            bm.contiguous(), cm.contiguous(), d_skip.contiguous(),
            None if h0 is None else h0.contiguous())
    return ref.selective_scan_ref(xc, z, dt, a, bm, cm, d_skip, h0)
