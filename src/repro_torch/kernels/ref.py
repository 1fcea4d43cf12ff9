"""Plain PyTorch versions of the port's kernels.

Counterpart of ``src/repro/kernels/ref.py`` and of the jnp references in
``src/repro/kernels/embedding_gather.py`` (``quantize_rows_ref``,
``dequantize_rows_ref``).  ``lstm_cell_ref`` and ``chamfer_ref`` also
return what their kernels save for the backward (the activated gates, the
argmins).  The CPU path runs these, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.  Indices are clamped into
range, as XLA's gather clamps them in the JAX package and as the kernels
do.

The quantized fast tier stores one byte per element (``ROW_FORMATS``:
symmetric int8 in +-127, or ``float8_e4m3fn`` in +-448) and one fp32 scale
per row.  Every division here is a true IEEE division by a tensor, never a
multiply by a reciprocal (PyTorch's CUDA ``div`` by a Python scalar is
one), so the plain versions give the kernels' bits on both devices.
The attention versions (``causal_attention_ref``,
``causal_attention_lse_ref``, ``flash_attention_ref`` and the backward
``flash_attention_bwd_ref``) sum in another order than the kernels and
agree with them within a tolerance; all but ``flash_attention_ref`` take
the forward's sliding ``window`` and ``causal=False`` (no mask).
``kv_stream_attention_ref`` is JAX's ``kv_stream_attention`` with a query
offset, the twin of the forward kernel's offset mode.
``selective_scan_ref`` is the mamba-1 scan's plain version (its kernel
has no TPU counterpart: JAX's scan is XLA), the same recurrence step by
step.
"""
from __future__ import annotations

import math
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


def gather_pool_shard_ref(table: torch.Tensor, idx: torch.Tensor
                          ) -> torch.Tensor:
    """``gather_pool_ref`` in the shard window: an id < 0 adds nothing
    (JAX's ``where(ok, rows, 0).sum`` of ``src/repro/models/dlrm.py:91-
    93``).  table: (N, D); idx: (B, P) -> (B, D) fp32."""
    rows = table[_clamped(idx, table.shape[0])].float()
    return torch.where((idx >= 0)[..., None], rows, 0.0).sum(dim=1)


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


# ---------------------------------------------------------------------------
# Learned RecMG models: the LSTM cell and the bidirectional Chamfer loss.
# ---------------------------------------------------------------------------

def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    """fp32 for fp32 (and narrower) inputs, fp64 for fp64 ones (the
    float64 gradient checks)."""
    return torch.promote_types(t.dtype, torch.float32)


def lstm_cell_ref(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                  w: torch.Tensor, b: torch.Tensor):
    """x: (B, in); h/c: (B, H); w: (in+H, 4H); b: (4H,) ->
    ``(h', c', gates)``: ``z = [x, h] @ w + b`` with gates in the order
    i, f, g, o; ``c' = sigmoid(f) c + sigmoid(i) tanh(g)`` in fp32,
    ``h' = sigmoid(o) tanh(c')`` in h's dtype, and ``gates`` the activated
    (B, 4H) ``[sigmoid(i), sigmoid(f), tanh(g), sigmoid(o)]`` in fp32 (the
    math of ``src/repro/kernels/ref.py:40-47``)."""
    ct = _compute_dtype(h)
    hid = h.shape[1]
    z = torch.cat([x, h], dim=1).to(ct) @ w.to(ct) + b.to(ct)
    i = torch.sigmoid(z[:, :hid])
    f = torch.sigmoid(z[:, hid:2 * hid])
    g = torch.tanh(z[:, 2 * hid:3 * hid])
    o = torch.sigmoid(z[:, 3 * hid:])
    c2 = f * c.to(ct) + i * g
    h2 = o * torch.tanh(c2)
    return h2.to(h.dtype), c2, torch.cat([i, f, g, o], dim=1)


def _sum_in_order(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in the order 0, 1, ..., n-1, one rounding per
    add (the order the kernel adds in, so the two agree bit for bit)."""
    acc = t[..., 0]
    for j in range(1, t.shape[-1]):
        acc = acc + t[..., j]
    return acc


def chamfer_ref(po: torch.Tensor, w: torch.Tensor, alpha: float = 0.7):
    """po: (B, P, F); w: (B, W, F) -> ``(loss (B,), arg_fwd (B, P) int32,
    arg_bwd (B, W) int32)``.

    ``loss = alpha * mean_p min_w d2 + (1 - alpha) * mean_w min_p d2`` with
    ``d2[p, w] = |po_p - w_w|^2`` (the math of
    ``src/repro/kernels/ref.py:15-23``); ``arg_fwd[p]`` is the w that
    attains ``min_w d2[p, w]`` and ``arg_bwd[w]`` the p that attains
    ``min_p d2[p, w]``, ties going to the lowest index.  ``d2`` sums over F
    and the means sum over P and W in index order, one rounding per
    operation, as the CUDA kernel does, so on the card the two give the
    same bits."""
    ct = _compute_dtype(po)
    n_p, n_w = po.shape[1], w.shape[1]
    d = po.to(ct)[:, :, None, :] - w.to(ct)[:, None, :, :]
    d2 = _sum_in_order(d * d)  # (B, P, W)
    fmin, arg_fwd = d2.min(dim=2)
    bmin, arg_bwd = d2.min(dim=1)
    # True divisions by a tensor: CUDA's div by a Python scalar multiplies
    # by its reciprocal instead.  ``torch.full`` fills on the device (no
    # host copy, no stream sync).
    fwd = _sum_in_order(fmin) / torch.full((), n_p, dtype=ct,
                                           device=po.device)
    bwd = _sum_in_order(bmin) / torch.full((), n_w, dtype=ct,
                                           device=po.device)
    loss = alpha * fwd + (1.0 - alpha) * bwd
    return loss, arg_fwd.to(torch.int32), arg_bwd.to(torch.int32)


# ---------------------------------------------------------------------------
# LM attention.
# ---------------------------------------------------------------------------

def _scores(q: torch.Tensor, k: torch.Tensor, window: int = 0,
            causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k: (B, Sk, K, hd) -> (B, K, G, Sq, Sk) scaled
    scores in the compute dtype, -inf where a key lies past its query (query
    row i at position ``q_offset + i``) and, with a ``window``, where ``q -
    k >= window`` (JAX's ``plain_attention`` mask); unmasked when
    ``causal`` is False (which takes no window)."""
    if window and not causal:
        raise ValueError(f"a window ({window}) is causal; causal=False "
                         "takes none")
    b, s, h, hd = q.shape
    n_kv = k.shape[2]
    ct = _compute_dtype(q)
    qg = q.to(ct).reshape(b, s, n_kv, h // n_kv, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(ct)) * (
        1.0 / math.sqrt(hd))
    if not causal:
        return scores
    keep = torch.ones((s, k.shape[1]), dtype=torch.bool,
                      device=q.device).tril(q_offset)
    if window:
        keep = keep.triu(q_offset + 1 - window)
    return scores.masked_fill(~keep, float("-inf"))


def _attend(scores: torch.Tensor, q: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(p.dtype))
    return o.reshape(q.shape).to(q.dtype)


def causal_attention_ref(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, window: int = 0,
                         causal: bool = True,
                         q_offset: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, K, hd) with ``H % K == 0`` -> (B, S,
    H, hd) causal attention in q's dtype, scale ``1/sqrt(hd)``, computed in
    fp32 (p stays fp32 for the p v product, as in the Pallas kernel; the
    bf16 CUDA kernel rounds it to bf16 there).  ``window > 0``: query q
    sees keys ``q - window < k <= q`` only (a sliding window; 0 is causal).
    ``causal=False``: every query sees every key, no window (JAX's
    ``plain_attention(causal=False)``, an encoder's self-attention).  k/v
    may hold Sk keys against Sq queries, query row i at position
    ``q_offset + i``.

    Heads are grouped as ``src/repro/models/layers.py:65-75`` groups them:
    ``q.reshape(B, S, K, G, hd)`` with ``G = H // K``, so query head
    ``h = kv * G + g`` reads KV head ``h // G`` (not ``h % K``)."""
    return _attend(_scores(q, k, window, causal, q_offset), q, v)


def kv_stream_attention_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, window: int = 0, bk: int = 512,
                            q_offset: int = 0,
                            causal: bool = True) -> torch.Tensor:
    """JAX's ``kv_stream_attention`` (``src/repro/models/layers.py:194``):
    every query row against keys streamed in blocks of ``bk``, an online
    softmax in fp32 (running max m, sum l and accumulator, block by block
    in key order, p rounded to v's dtype for the p v product, the
    accumulator over ``max(l, 1e-30)`` at the end).  q (B, Sq, H, hd), query
    row i at position ``q_offset + i``; k/v (B, Sk, K, hd) at 0 .. Sk - 1;
    causal (with ``window``) or, with ``causal=False``, unmasked.  JAX's
    function is this with Sq = Sk and offset 0; the sequence-parallel
    prefill gives each rank its rows."""
    if window and not causal:
        raise ValueError(f"a window ({window}) is causal; causal=False "
                         "takes none")
    b, s, h, hd = q.shape
    s_k, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    ct = _compute_dtype(q)
    qg = q.to(ct).reshape(b, s, n_kv, g, hd)
    scale = 1.0 / math.sqrt(hd)
    q_pos = torch.arange(s, device=q.device) + q_offset
    m = torch.full((b, n_kv, g, s), float("-inf"), dtype=ct, device=q.device)
    l_sum = torch.zeros((b, n_kv, g, s), dtype=ct, device=q.device)
    acc = torch.zeros((b, s, n_kv, g, hd), dtype=ct, device=q.device)
    for j in range(0, s_k, bk):
        k_blk, v_blk = k[:, j:j + bk], v[:, j:j + bk]
        kpos = torch.arange(j, j + k_blk.shape[1], device=q.device)
        sc = torch.einsum("bqkgd,bskd->bkgqs", qg, k_blk.to(ct)) * scale
        if causal:
            mask = q_pos[:, None] >= kpos[None, :]
            if window:
                mask &= q_pos[:, None] - kpos[None, :] < window
            sc = sc.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        corr = torch.exp(torch.where(m == float("-inf"),
                                     torch.zeros_like(m), m - m_new))
        p = torch.exp(sc - m_new[..., None])
        if causal:
            p = p.masked_fill(~mask, 0.0)
        l_sum = l_sum * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).to(ct),
                          v_blk.to(ct))
        acc = acc * corr.movedim(-1, 1)[..., None] + pv
        m = m_new
    out = acc / l_sum.movedim(-1, 1)[..., None].clamp_min(1e-30)
    return out.reshape(b, s, h, hd).to(q.dtype)


def causal_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, window: int = 0,
                             causal: bool = True):
    """:func:`causal_attention_ref` and each row's log-sum-exp of its
    scaled scores: ``(o, lse)``, lse (B, H, S) in the compute dtype (fp32;
    fp64 for fp64 inputs), what the backward recomputes p from."""
    b, s, h, _ = q.shape
    scores = _scores(q, k, window, causal)
    lse = torch.logsumexp(scores, dim=-1).reshape(b, h, s)
    return _attend(scores, q, v), lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor,
                            window: int = 0, causal: bool = True):
    """The plain attention backward: q, o, do (B, S, H, hd); k/v (B, S, K,
    hd); lse (B, H, S) from the forward of the same ``window`` (0 is
    causal) and ``causal`` -> ``(dq, dk, dv)`` in q's and k's dtypes.  With s the scaled
    scores, p = exp(s - lse) where the forward lets a query see a key (0
    elsewhere) and delta = sum_d do o: dV = p^T dO, dS = p (dO v^T -
    delta), dQ = dS k * scale, dK = dS^T q * scale, dK and dV summed over
    the query heads of a KV head.  Materialises (B, K, G, S, S) in the
    compute dtype."""
    b, s, h, hd = q.shape
    n_kv = k.shape[2]
    g = h // n_kv
    scale = 1.0 / math.sqrt(hd)
    scores = _scores(q, k, window, causal)
    ct = scores.dtype
    p = torch.exp(scores - lse.to(ct).reshape(b, n_kv, g, s, 1))
    qg, og, dog = (t.to(ct).reshape(b, s, n_kv, g, hd) for t in (q, o, do))
    kc, vc = k.to(ct), v.to(ct)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vc)
    delta = (dog * og).sum(-1).permute(0, 2, 3, 1)[..., None]
    ds = p * (dp - delta)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kc) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """The Pallas kernel's own contract (``src/repro/kernels/ref.py:26-36``):
    q/k/v (BH, S, hd), one KV head per query head -> (BH, S, hd) causal
    attention in q's dtype."""
    return causal_attention_ref(q[:, :, None], k[:, :, None],
                                v[:, :, None])[:, :, 0]


# ---------------------------------------------------------------------------
# The mamba-1 selective scan (no TPU kernel: JAX's is XLA).
# ---------------------------------------------------------------------------

def selective_scan_ref(xc: torch.Tensor, z: torch.Tensor, dt: torch.Tensor,
                       a: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                       d_skip: torch.Tensor,
                       h0: Optional[torch.Tensor] = None):
    """xc, z: (B, S, Di); dt: (B, S, Di); a = -exp(A_log): (Di, N); bm/cm:
    (B, S, N); d_skip: (Di,); h0: None or (B, Di, N) -> ``(y (B, S, Di) in
    xc's dtype, h_last (B, Di, N))``, step by step in the compute dtype
    (fp32; fp64 for fp64 inputs): ``h_t = exp(dt_t a) h_{t-1} + (dt_t x_t)
    bm_t`` from ``h0`` (zeros when None), ``y_t = (sum_n h_t cm_t + d_skip
    x_t) silu(z_t)``.  The literal recurrence of JAX's sequential oracle
    (``tests/test_layers.py::_mamba_sequential_ref``) with ``h0``; JAX's
    ``selective_scan`` associates the same products in chunks."""
    b, s, di = xc.shape
    ct = _compute_dtype(dt)
    x, dtc, a = xc.to(ct), dt.to(ct), a.to(ct)
    bm, cm = bm.to(ct), cm.to(ct)
    h = (torch.zeros((b, di, a.shape[1]), dtype=ct, device=xc.device)
         if h0 is None else h0.to(ct))
    ys = []
    for t in range(s):
        h = torch.exp(dtc[:, t, :, None] * a) * h \
            + (dtc[:, t] * x[:, t])[..., None] * bm[:, t, None, :]
        ys.append((h * cm[:, t, None, :]).sum(-1))
    y = torch.stack(ys, dim=1) if s else x.new_zeros((b, 0, di))
    y = (y + d_skip.to(ct) * x) * torch.nn.functional.silu(z.to(ct))
    return y.to(xc.dtype), h


def selective_scan_bwd_ref(xc: torch.Tensor, z: torch.Tensor,
                           dt: torch.Tensor, a: torch.Tensor,
                           bm: torch.Tensor, cm: torch.Tensor,
                           d_skip: torch.Tensor,
                           h0: Optional[torch.Tensor], dy: torch.Tensor,
                           dh_last: Optional[torch.Tensor] = None):
    """The gradients of :func:`selective_scan_ref`, the reverse recurrence
    written out step by step (not autograd): its inputs, dy (B, S, Di) and
    dh_last None (zeros) or (B, Di, N) -> ``(dx, dz, ddt, da, dbm, dcm, dd,
    dh0)``, dx and dz in xc's dtype, the rest in the compute dtype (fp32;
    fp64 for fp64 inputs).  With g = silu(z), r_t = h_t . cm_t + d_skip
    x_t and e_t = dy_t g_t, from t = S-1 down to 0: ``dh_t = e_t cm_t +
    exp(dt_{t+1} a) dh_{t+1}`` (dh_last past the end), ``ddt_t = sum_n
    dh_t (a exp(dt_t a) h_{t-1} + x_t bm_t)``, ``da += dh_t dt_t exp(dt_t
    a) h_{t-1}``, ``dx_t = e_t d_skip + sum_n dh_t dt_t bm_t``, ``dbm_t =
    sum_d dh_t dt_t x_t``, ``dcm_t = sum_d h_t e_t``, ``dz_t = dy_t r_t
    silu'(z_t)``, ``dd = sum e_t x_t`` and ``dh0 = exp(dt_0 a) dh_0``.
    The states come from the forward recurrence, kept for every step
    ((B, S + 1, Di, N) in the compute dtype)."""
    b, s, di = xc.shape
    ct = _compute_dtype(dt)
    x, zc, dtc, a = xc.to(ct), z.to(ct), dt.to(ct), a.to(ct)
    bm, cm, dsk, dyc = bm.to(ct), cm.to(ct), d_skip.to(ct), dy.to(ct)
    n = a.shape[1]
    h = (torch.zeros((b, di, n), dtype=ct, device=xc.device)
         if h0 is None else h0.to(ct))
    hs = [h]
    for t in range(s):
        h = torch.exp(dtc[:, t, :, None] * a) * h \
            + (dtc[:, t] * x[:, t])[..., None] * bm[:, t, None, :]
        hs.append(h)
    hs = torch.stack(hs, dim=1)
    sig = torch.sigmoid(zc)
    e = dyc * zc * sig
    r = torch.einsum("btdn,btn->btd", hs[:, 1:], cm) + dsk * x
    dz = dyc * r * sig * (1.0 + zc * (1.0 - sig))
    dd = (e * x).sum(dim=(0, 1))
    dcm = torch.einsum("btdn,btd->btn", hs[:, 1:], e)
    dx = e * dsk
    ddt = torch.zeros_like(dtc)
    dbm = torch.zeros_like(bm)
    da = torch.zeros_like(a)
    carry = (torch.zeros((b, di, n), dtype=ct, device=xc.device)
             if dh_last is None else dh_last.to(ct))
    for t in range(s - 1, -1, -1):
        dh = e[:, t, :, None] * cm[:, t, None, :] + carry
        ea = torch.exp(dtc[:, t, :, None] * a)
        w = dh * ea * hs[:, t]
        ddt[:, t] = (w * a + dh * x[:, t, :, None] * bm[:, t, None, :]).sum(-1)
        da += (w * dtc[:, t, :, None]).sum(0)
        dx[:, t] += (dh * bm[:, t, None, :]).sum(-1) * dtc[:, t]
        dbm[:, t] = (dh * (dtc[:, t] * x[:, t])[..., None]).sum(1)
        carry = ea * dh
    return (dx.to(xc.dtype), dz.to(xc.dtype), ddt, da, dbm, dcm, dd, carry)
