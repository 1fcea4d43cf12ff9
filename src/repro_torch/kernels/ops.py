"""Device-dispatching entry points to the port's kernels.

Counterpart of ``src/repro/kernels/ops.py``.  There is no ``use_pallas``
knob: a CUDA tensor goes to the CUDA kernel (which launches or raises),
and a CPU tensor goes to the plain PyTorch version.  Nothing falls back
from the card to the plain path.

``flash_attention`` serves only (LM prefill runs under
``torch.inference_mode()``): on the card a call whose inputs require grad
raises, since the kernel has no backward yet.

``lstm_cell`` and ``chamfer`` sit under gradients (every LSTM step of the
learned models, the prefetch model's loss), so they are
``torch.autograd.Function``s: the forward is the kernel (or the plain
version on the CPU), and the backward is device-agnostic PyTorch on what
the forward saved (the activated gates, the argmins).  The Pallas kernels
have no backward either.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import chamfer_kernel as _ck
from repro_torch.kernels import embedding_gather as _eg
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lstm_cell as _lc
from repro_torch.kernels import ref

# Every kernel wrapper of the port, each with its ``launches`` count.
KERNELS = _eg.KERNELS + (_lc.lstm_cell, _ck.chamfer,
                         _fa.flash_attention)


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0


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
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, h, c, w, b)):
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


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, K, hd) with ``H % K == 0`` -> (B, S,
    H, hd) causal attention in q's dtype (query head h reads KV head
    ``h // (H // K)``), scale ``1/sqrt(hd)``, any S."""
    if _on_cuda(q):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise NotImplementedError(
                "flash_attention has no backward on the card: the attention "
                "backward comes with LM training (ROADMAP A11b); call it "
                "under torch.inference_mode()")
        return _fa.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous())
    return ref.causal_attention_ref(q, k, v)
