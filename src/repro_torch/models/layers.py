"""Building blocks of the dense and MoE LMs, in PyTorch.

Ported from ``src/repro/models/layers.py``: ``rms_norm`` (:35), ``rope``
(:42), ``plain_attention`` (:77, the unmasked case the cross-attention
takes), ``blocked_causal_attention`` (:142),
``decode_attention`` (:246),
``init_attn``/``_qkv``/``attn_block``/``attn_decode_block`` (:270-349),
the whisper decoder's ``cross_attn_block``/``cross_kv`` (:356-370),
``init_mlp``/``mlp_block`` (:378-397; gated SwiGLU, or whisper's ungated
GELU with ``jax.nn.gelu``'s default tanh approximation), ``init_moe``/
``_moe_dispatch_ffn``/``moe_block`` (:406-504) and the mamba-1 block,
``init_mamba``/``_causal_conv``/``_ssm_params``/``selective_scan``/
``mamba_block``/``mamba_decode_block`` (:559-694).  Layouts are the JAX
package's: x (B, S, D), q (B, S, H, hd), k/v and the KV cache (B, S, K,
hd), weights (in, out) applied as ``x @ w``.
Query head h reads KV head ``h // G`` with ``G = H // K``
(``q.reshape(B, S, K, G, hd)``).

``blocked_causal_attention`` is the port's CUDA ``flash_attention`` kernel
on the card (its plain version, ``kernels/ref.py::causal_attention_ref``,
on the CPU) at every S, with ``window`` for a sliding-window config
(``attn_type="sliding"``): the JAX switch to ``plain_attention`` (:77) at
S <= 2048 and its padding to whole blocks change no result beyond
rounding.  For the p v product the bf16 kernel rounds p to bf16, as
``plain_attention`` rounds it to v's dtype; the fp32 kernel and the plain
version keep p in fp32.  ``decode_attention`` ignores the window, as
JAX's does: a sliding config's cache is a ring capped at the window.
``kv_stream_attention`` (:194) is the sequence-parallel branch of
``attn_block`` (:311-330): a rank's queries, at an offset, against the
keys and values gathered over ``model``; on the card the kernel's offset
mode, on the CPU JAX's online softmax over key blocks
(``kernels/ref.py::kv_stream_attention_ref``).  Over a decode cache
whose length lies on ``model`` (``shard_kv_seq``),
:func:`decode_attention_sharded` attends each rank's slots and combines
the ranks by their max and sum (JAX: GSPMD's reduction of the softmax
across the sharded length).  The MoE's dispatch over the data ranks of a
mesh, global or data-local (``_moe_dispatch_ffn_sharded``,
``local_dispatch``), runs on each rank's own tokens with collectives over
``data``; under a sequence split (served or trained) the global
dispatch is over every rank's tokens.
``attn_block(causal=False)`` is the encoder's self-attention (JAX's
``plain_attention(causal=False)``, XLA), the same
kernel with its unmasked instantiation; the cross-attention, whose queries
and keys differ in length, is ``plain_attention`` in PyTorch, as JAX's is
XLA.

``selective_scan`` is the port's CUDA ``selective_scan`` kernel on the
card (``kernels/ref.py::selective_scan_ref`` on the CPU): a sequential
recurrence over S in fp32, which needs no padding to whole
``ssm_chunk`` chunks (JAX pads with identity steps and associates within
chunks; the two agree within rounding).  Under autograd its backward is
the port's ``selective_scan_bwd`` kernel on the card (the plain
``selective_scan_bwd_ref`` on the CPU), and the windowed attention's is
``flash_attention_bwd`` with the window, so the SSM and hybrid families
train as the others do.

Tensor parallelism over ``model`` (``tp``, the model group, given by
``models/transformer.py`` for a sharded layer): the projections into
heads, ``w1``/``w3`` and the experts' ``w1``/``w3`` are column parallel
(this rank's output features; their input goes through Megatron's "f",
:func:`~repro_torch.distributed.collectives.copy_all_reduce_bwd`), and
``wo``, ``w2`` and the experts' ``w2`` row parallel (their partial
output summed by "g", :func:`~repro_torch.distributed.collectives.
all_reduce_identity_bwd`).  The attention then runs on the rank's heads:
``_qkv`` reads the head counts from the shapes it gets, and so do
``cross_kv`` and ``cross_attn_block``, whose ``wk``/``wv`` read the
encoder output through "f".  The mamba block is channel parallel: its
``in_proj`` (whose columns the caller has exchanged so that the rank holds
``xi`` and ``z`` of its own channels), the conv, ``dt_proj`` and the scan
on the rank's channels, ``out_proj`` row parallel through "g", and
``x_proj`` row parallel: its partial products are taken in fp32 (a
product of bf16 values is exact there), summed over the ranks in fp32
(:func:`~repro_torch.distributed.collectives.all_reduce_sum_bwd`: every
rank's channels read the whole sum) and rounded once to xc's dtype before
the split into dt-rank, B and C, where JAX rounds the whole product once
(:589).

Products whose JAX einsum asks for ``preferred_element_type=float32`` are
taken on fp32 copies of their inputs (a bf16 product is exact in fp32), so
bf16 scores are not rounded to bf16.  ``attn_decode_block`` writes the new
key and value into the cache in place (JAX returns updated copies); the
cache's position is a Python int.

The MoE's expert products are plain batched matrix products
(``torch.bmm``/``matmul``), as JAX leaves them to XLA outside any Pallas
kernel.  Its top-K is ``lax.top_k``'s: probabilities in descending order,
ties to the lower expert index (a stable descending sort; ``torch.topk``
promises no order on ties).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import mesh as M
from repro_torch.distributed.collectives import (all_reduce_identity_bwd,
                                                 all_reduce_sum_bwd,
                                                 copy_all_reduce_bwd)
from repro_torch.kernels import ops, ref

# ---------------------------------------------------------------------------
# Norms / rotary embeddings
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, half-split (not interleaved): x (..., S, H, hd);
    positions (..., S)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _gqa_scores(q: torch.Tensor, k: torch.Tensor,
                scale: float) -> torch.Tensor:
    """q: (B, bq, K, G, hd), k: (B, bk, K, hd) -> (B, K, G, bq, bk) fp32."""
    return torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale


def plain_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """JAX's ``plain_attention(causal=False)``, unmasked, materialising its
    (Sq, Sk) scores: q (B, Sq, H, hd), k/v (B, Sk, K, hd) -> q's shape, in
    v's dtype.  Scores and softmax in fp32, p rounded to v's dtype for the
    p v product (JAX's ``_gqa_out``)."""
    b, sq, h, hd = q.shape
    n_kv = k.shape[2]
    p = torch.softmax(_gqa_scores(q.reshape(b, sq, n_kv, h // n_kv, hd), k,
                                  1.0 / math.sqrt(hd)), dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype).float(),
                     v.float()).to(v.dtype)
    return o.reshape(b, sq, h, hd)


def blocked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             window: int = 0) -> torch.Tensor:
    """Causal attention, q (B, S, H, hd), k/v (B, S, K, hd) -> q's shape
    and dtype; ``window > 0`` limits query q to keys ``q - window < k <=
    q``: :func:`repro_torch.kernels.ops.flash_attention` (the CUDA kernel
    on the card)."""
    return ops.flash_attention(q, k, v, window)


def kv_stream_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: int = 0, bk: int = 512, q_offset: int = 0,
                        causal: bool = True) -> torch.Tensor:
    """JAX's ``kv_stream_attention`` (:194) with a query offset: q (B, Sq,
    H, hd), row i at position ``q_offset + i``, against k/v (B, Sk, K, hd)
    at 0 .. Sk - 1 (causal: ``q_offset + Sq <= Sk``; or unmasked) -> q's
    shape and dtype.  On the card the forward kernel's offset mode
    (:func:`repro_torch.kernels.ops.flash_attention`), on the CPU the
    online softmax over ``bk``-key blocks in JAX's order."""
    if q.is_cuda:
        return ops.flash_attention(q, k, v, window, causal, q_offset)
    return ref.kv_stream_attention_ref(q, k, v, window, bk, q_offset, causal)


def decode_attention_sharded(q: torch.Tensor, k_part: torch.Tensor,
                             v_part: torch.Tensor, n_valid: int, first: int,
                             group) -> torch.Tensor:
    """:func:`decode_attention` over a cache whose slots lie over
    ``group``'s ranks: q (B, 1, H, hd) every head; k_part/v_part (B, C_r,
    K, hd) slots ``[first, first + C_r)``; slots below ``n_valid`` are
    valid.  Each rank's scores give the max over the ranks, then the sum
    of exps; p (normalised, rounded to v's dtype as JAX rounds it) times
    the rank's values is an fp32 partial, summed over the ranks and rounded
    once.  Three all-reduces: max, sum, partial."""
    b, _, h, hd = q.shape
    c, n_kv = k_part.shape[1], k_part.shape[2]
    scores = _gqa_scores(q.reshape(b, 1, n_kv, h // n_kv, hd), k_part,
                         1.0 / math.sqrt(hd))[..., 0, :]  # (B, K, G, C_r)
    valid = torch.arange(first, first + c, device=q.device) < n_valid
    scores = scores.masked_fill(~valid, float("-inf"))
    mx = C.all_reduce_max(scores.amax(dim=-1), group)
    e = torch.exp(scores - mx[..., None])
    total = C.all_reduce_(e.sum(dim=-1), group)
    p = (e / total[..., None]).to(v_part.dtype)
    o = torch.einsum("bkgs,bskh->bkgh", p.float(), v_part.float())
    return C.all_reduce_(o, group).to(v_part.dtype).reshape(b, 1, h, hd)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """Single-token attention over a cache.  q: (B, 1, H, hd);
    k_cache/v_cache: (B, S, K, hd); ``pos``: number of valid entries (for a
    ring buffer the first ``min(pos, S)`` slots are valid).  The JAX
    function's ``window`` argument is accepted and unused there, and left
    out here."""
    b, _, h, hd = q.shape
    s, n_kv = k_cache.shape[1], k_cache.shape[2]
    g = h // n_kv
    scores = _gqa_scores(q.reshape(b, 1, n_kv, g, hd), k_cache,
                         1.0 / math.sqrt(hd))[..., 0, :]  # (B, K, G, S)
    valid = torch.arange(s, device=q.device) < min(pos, s)
    p = torch.softmax(scores.masked_fill(~valid, float("-inf")), dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype).float(),
                     v_cache.float()).to(v_cache.dtype)
    return o.reshape(b, 1, h, hd)


# ---------------------------------------------------------------------------
# Attention block (projections + norms + rope)
# ---------------------------------------------------------------------------


def _normal(g: torch.Generator, shape, scale: float, dt: torch.dtype,
            dev: torch.device) -> torch.Tensor:
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)


def init_attn(g: torch.Generator, cfg: ModelConfig, dt: torch.dtype,
              dev: torch.device, cross: bool = False
              ) -> Dict[str, torch.Tensor]:
    """The JAX ``init_attn`` draws (same shapes and scales), from ``g``; a
    cross-attention (``cross``) has no biases and no qk norms."""
    d, h, n_kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd
    sc = 1.0 / math.sqrt(d)
    p = {"wq": _normal(g, (d, h * hd), sc, dt, dev),
         "wk": _normal(g, (d, n_kv * hd), sc, dt, dev),
         "wv": _normal(g, (d, n_kv * hd), sc, dt, dev),
         "wo": _normal(g, (h * hd, d), 1.0 / math.sqrt(h * hd), dt, dev)}
    if cfg.qkv_bias and not cross:
        for name, n in (("bq", h), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros((n * hd,), dtype=dt, device=dev)
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=dev)
    return p


def _qkv(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """q (B, S, H, hd), k and v (B, S, K, hd), H and K as many heads as
    the projections hold (a tensor-parallel rank's)."""
    b, s, _ = x.shape
    hd = cfg.hd
    h, n_kv = p["wq"].shape[1] // hd, p["wk"].shape[1] // hd
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, n_kv, hd)
    v = v.reshape(b, s, n_kv, hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def attn_block(p, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, causal: bool = True, tp=None,
               seq: Optional[M.SeqSplit] = None):
    """Full-sequence (prefill or training) self-attention, in a sliding
    window when ``cfg.attn_type == "sliding"``; unmasked with
    ``causal=False`` (the encoder's); on this rank's heads, tensor parallel
    over ``tp``.  With ``seq`` (x this rank's positions of a sequence split
    over ``model``, rope at their absolute ``positions``) the keys and
    values are gathered over ``model`` (JAX's ``constrain_kv_gather``),
    whose backward sums the ranks' partial dK/dV and keeps the rank's
    positions, and the rank's queries attend them at their offset
    (:func:`kv_stream_attention`).  Returns ``(out, (k, v))``, k/v over the
    whole sequence under ``seq``."""
    q, k, v = _qkv(p, cfg, copy_all_reduce_bwd(x, tp), positions)
    if seq is not None:
        group, n = seq.mesh.model_group, seq.mesh.model
        k, v = (C.all_gather_reduce_scatter_bwd(t, group, 1, n)
                for t in (k, v))
        window = cfg.window if causal and cfg.attn_type == "sliding" else 0
        o = kv_stream_attention(q, k, v, window, q_offset=seq.offset,
                                causal=causal)
    elif causal:
        window = cfg.window if cfg.attn_type == "sliding" else 0
        o = blocked_causal_attention(q, k, v, window)
    else:
        o = ops.flash_attention(q, k, v, causal=False)
    out = o.reshape(*o.shape[:2], -1) @ p["wo"]
    return all_reduce_identity_bwd(out, tp), (k, v)


def attn_decode_block(p, cfg: ModelConfig, x: torch.Tensor,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      pos: int):
    """One-token self-attention.  x: (B, 1, D); the new key and value go to
    ring slot ``pos % S`` of the caches, in place.  Returns ``(out,
    k_cache, v_cache)``."""
    s = k_cache.shape[1]
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)
    slot = pos % s if s > 0 else 0
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]
    o = decode_attention(q, k_cache, v_cache, pos + 1)
    return o.reshape(*o.shape[:2], -1) @ p["wo"], k_cache, v_cache


# ---------------------------------------------------------------------------
# Cross attention (whisper decoder)
# ---------------------------------------------------------------------------


def cross_attn_block(p, cfg: ModelConfig, x: torch.Tensor,
                     k_enc: torch.Tensor, v_enc: torch.Tensor, tp=None):
    """x: (B, S, D); k_enc/v_enc: (B, Se, K, hd) from :func:`cross_kv`.
    Queries without rope over every encoder position; on this rank's
    heads, tensor parallel over ``tp``."""
    b, s, _ = x.shape
    q = (copy_all_reduce_bwd(x, tp) @ p["wq"]).reshape(b, s, -1, cfg.hd)
    o = plain_attention(q, k_enc, v_enc)
    return all_reduce_identity_bwd(o.reshape(b, s, -1) @ p["wo"], tp)


def cross_kv(p, cfg: ModelConfig, enc_out: torch.Tensor, tp=None):
    """enc_out (B, Se, D) -> the cross-attention's keys and values, (B, Se,
    K, hd) each (K this rank's heads under ``tp``), without rope."""
    b, se, _ = enc_out.shape
    enc_out = copy_all_reduce_bwd(enc_out, tp)
    return ((enc_out @ p["wk"]).reshape(b, se, -1, cfg.hd),
            (enc_out @ p["wv"]).reshape(b, se, -1, cfg.hd))


# ---------------------------------------------------------------------------
# MLP (SwiGLU for the LMs, GELU for whisper)
# ---------------------------------------------------------------------------


def init_mlp(g: torch.Generator, cfg: ModelConfig, dt: torch.dtype,
             dev: torch.device, gated: bool = True
             ) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    sc_in, sc_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"w1": _normal(g, (d, f), sc_in, dt, dev),
         "w2": _normal(g, (f, d), sc_out, dt, dev)}
    if gated:
        p["w3"] = _normal(g, (d, f), sc_in, dt, dev)
    return p


def mlp_block(p, x: torch.Tensor, tp=None) -> torch.Tensor:
    """SwiGLU (or whisper's GELU), on this rank's ``d_ff`` part, tensor
    parallel over ``tp``."""
    x = copy_all_reduce_bwd(x, tp)
    if "w3" in p:
        y = (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]
    else:
        y = F.gelu(x @ p["w1"], approximate="tanh") @ p["w2"]
    return all_reduce_identity_bwd(y, tp)


# ---------------------------------------------------------------------------
# MoE (capacity-based scatter dispatch; dense routing on decode)
# ---------------------------------------------------------------------------


def init_moe(g: torch.Generator, cfg: ModelConfig, dt: torch.dtype,
             dev: torch.device) -> Dict[str, torch.Tensor]:
    """The JAX ``init_moe`` draws: an fp32 router (D, E), ``w1``/``w3``
    (E, D, Fe) and ``w2`` (E, Fe, D) in ``dt``."""
    d, e, fe = cfg.d_model, cfg.n_experts, cfg.expert_ff
    sc_in, sc_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(fe)
    return {"router": _normal(g, (d, e), sc_in, torch.float32, dev),
            "w1": _normal(g, (e, d, fe), sc_in, dt, dev),
            "w3": _normal(g, (e, d, fe), sc_in, dt, dev),
            "w2": _normal(g, (e, fe, d), sc_out, dt, dev)}


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest in descending order,
    equal values in ascending index order.  Returns ``(values, indices)``."""
    idx = torch.sort(x, dim=-1, descending=True, stable=True).indices[
        ..., :k]
    return torch.gather(x, -1, idx), idx


def _route(p, cfg: ModelConfig, xf: torch.Tensor):
    """xf (T, D) -> ``(probs (T, E), top_p (T, K), top_e (T, K))``: the fp32
    router softmax, its top-K, and the top-K renormalised by ``max(sum,
    1e-9)``."""
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    top_p, top_e = _top_k(probs, cfg.top_k)
    return probs, top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), top_e


def _capacity_slots(flat_e: torch.Tensor, n_experts: int, capacity: int):
    """flat_e (T*K,) expert of each assignment, token-major -> ``(slot,
    keep)``: an assignment's rank among its expert's assignments is a
    cumulative count in that order; ranks below ``capacity`` go to slot
    ``e * capacity + rank``, the rest to the drop slot ``E * capacity``.
    The counts run along the last axis of an (E, T*K) indicator (JAX's
    one-hot transposed): a scan down the first axis of (T*K, E) runs one
    thread per expert on the card."""
    onehot = flat_e[None, :] == torch.arange(n_experts,
                                             device=flat_e.device)[:, None]
    rank = onehot.cumsum(dim=1, dtype=torch.int32).gather(
        0, flat_e[None, :])[0] - 1
    keep = rank < capacity
    slot = torch.where(keep, flat_e * capacity + rank,
                       n_experts * capacity)
    return slot, keep


def _split_tokens(top_e: torch.Tensor, seq: M.SeqSplit) -> torch.Tensor:
    """Every rank's top-K experts (T_r, K) of a sequence split, in the
    global batch's token order (b-major over (B, S)): rank (d, m) holds
    rows ``d`` and positions ``m`` of the (data, model) blocks."""
    mesh = seq.mesh
    k = top_e.shape[1]
    rows = top_e.shape[0] // seq.length
    parts = C.all_gather(top_e.reshape(1, rows, seq.length, k),
                         mesh.world_group, 0, mesh.data * mesh.model)
    return parts.reshape(mesh.data, mesh.model, rows, seq.length, k) \
        .permute(0, 2, 1, 3, 4).reshape(-1, k)


def _moe_dispatch_ffn(p, cfg: ModelConfig, xf: torch.Tensor,
                      mesh: Optional[M.Mesh] = None, tp=None,
                      seq: Optional[M.SeqSplit] = None):
    """Capacity dispatch and the expert SwiGLU.  xf (T, D) -> ``(out (T,
    D), aux)``, aux the Switch load-balance loss ``E * sum(me * ce)`` (ce
    counts every top-K assignment, dropped ones too).

    With ``mesh`` (data ranks > 1) the dispatch is global, as JAX's over
    the microbatch's tokens, which the data ranks hold in data order: the
    ranks' top-K, all-gathered, give every assignment's position within its
    expert, the capacity counts all the ranks' tokens, and ``me`` sums
    every rank's router probabilities (its backward sums over the ranks:
    each rank's loss holds the same aux and the step averages the ranks'
    gradients).  A token's expert output needs no other token, so the
    experts then run on this rank's kept tokens only.

    The tokens scatter into an (E*C+1, D) buffer whose last row takes every
    dropped assignment; which of those writes lands there is unspecified,
    and the row is discarded, so its gradient is zero (JAX's scatter
    transpose).  No (T, E, C) one-hot is built.

    With ``tp`` the experts run on this rank's ``moe_d_ff`` part: the
    tokens enter them through "f", and each token's rows of their partial
    outputs are summed by "g" before the router's weights scale them (so
    the weights' gradient sums every rank's part).

    With ``seq`` (a sequence split: a prefill, or a training step whose
    loss is the mean over every rank's tokens) the dispatch is over the
    tokens of every rank of the mesh, in the global batch's order (JAX's
    combined axes, ``partition.py:102-104``); ``me`` sums every rank's
    probabilities with an identity backward: each rank's loss is the
    whole step's, and the step sums the ranks' gradients."""
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    probs, top_p, top_e = _route(p, cfg, xf)
    if seq is not None:
        all_e = _split_tokens(top_e, seq)
        n_tok = all_e.shape[0]
        me = all_reduce_identity_bwd(probs.sum(dim=0),
                                     seq.mesh.world_group) / n_tok
    elif mesh is None:
        all_e, n_tok, me = top_e, t, probs.mean(dim=0)
    else:
        all_e = M.gather_batch(top_e, mesh)
        n_tok = all_e.shape[0]
        me = all_reduce_sum_bwd(probs.sum(dim=0), mesh.data_group) / n_tok
    ce = torch.bincount(all_e.reshape(-1), minlength=e).float() / (n_tok * k)
    aux = e * torch.sum(me * ce)

    c = max(1, int(math.ceil(cfg.capacity_factor * n_tok * k / e)))
    slot, _ = _capacity_slots(all_e.reshape(-1), e, c)
    if seq is not None:
        sm = seq.mesh
        rows = t // seq.length
        slot = slot.view(sm.data * rows, sm.model * seq.length, k)[
            sm.data_rank * rows:(sm.data_rank + 1) * rows,
            seq.offset:seq.offset + seq.length].reshape(-1)
    elif mesh is not None:
        slot = slot[mesh.data_rank * t * k:(mesh.data_rank + 1) * t * k]
    # Token-major copies of each token, one per assignment; the backward
    # sums them over K (no atomics).
    xd = copy_all_reduce_bwd(xf, tp)
    x_rep = xd[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = xf.new_zeros((e * c + 1, d)).index_put((slot,), x_rep)
    h = buf[:e * c].view(e, c, d)
    y = torch.bmm(F.silu(torch.bmm(h, p["w1"])) * torch.bmm(h, p["w3"]),
                  p["w2"])
    y_flat = torch.cat([y.reshape(e * c, d), y.new_zeros((1, d))])
    # index_select, whose backward adds into the rows (only the discarded
    # zero row takes several); indexing's backward sorts the slots and
    # walks the drop slot's duplicates one after another.
    gathered = all_reduce_identity_bwd(y_flat.index_select(0, slot), tp) \
        * top_p.reshape(-1, 1).to(y.dtype)
    return gathered.view(t, k, d).sum(dim=1), aux


def _data_mesh() -> Optional[M.Mesh]:
    """The active scope's batch mesh (:func:`repro_torch.distributed.mesh.
    batch_mesh`: every rank a data rank under ``"fsdp"``) when it has more
    than one data rank, else None."""
    mesh = M.active_mesh()
    if mesh is None:
        return None
    mesh = M.batch_mesh(mesh)
    return mesh if mesh.data > 1 else None


def moe_block(p, cfg: ModelConfig, x: torch.Tensor,
              dense_route: bool = False, local_dispatch: bool = False,
              tp=None, seq: Optional[M.SeqSplit] = None):
    """Top-K capacity-dispatched MoE.  x (B, S, D) -> ``(out, aux)``; the
    dispatched experts tensor parallel over ``tp``.

    Under a mesh scope with more than one data rank (x this rank's rows)
    the dispatch is global (:func:`_moe_dispatch_ffn`), or with
    ``local_dispatch`` JAX's ``_moe_dispatch_ffn_sharded``: each rank
    dispatches its own tokens with capacity ``ceil(cf * T_local * K / E)``
    and the aux is the mean of the ranks' (its backward sums over them).

    With ``seq`` (x this rank's positions of a sequence split, a prefill
    or a training step) the global dispatch takes every rank's tokens
    (data-local dispatch is not ported there).

    ``dense_route=True`` (decode: few tokens) runs every expert on every
    token and combines them with a (T, E) weight matrix holding each
    token's renormalised top-K probabilities: no token is dropped, and the
    aux loss is 0; under ``tp`` each rank's experts give a partial sum,
    summed over the ranks after the combine."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    if seq is not None and not dense_route:
        if local_dispatch:
            raise NotImplementedError(
                "moe_local_dispatch under a sequence split (fsdp_seq): "
                "the global dispatch is ported")
        out, aux = _moe_dispatch_ffn(p, cfg, xf, tp=tp, seq=seq)
        return out.view(b, s, d), aux
    if not dense_route:
        mesh = _data_mesh()
        if local_dispatch and mesh is not None:
            out, aux = _moe_dispatch_ffn(p, cfg, xf, tp=tp)
            aux = all_reduce_sum_bwd(aux, mesh.data_group) / mesh.data
        else:
            out, aux = _moe_dispatch_ffn(p, cfg, xf, mesh, tp)
        return out.view(b, s, d), aux
    _, top_p, top_e = _route(p, cfg, xf)
    xd = copy_all_reduce_bwd(xf, tp)
    g = torch.matmul(xd, p["w1"])  # (E, T, Fe)
    u = torch.matmul(xd, p["w3"])
    y = torch.matmul(F.silu(g) * u, p["w2"])  # (E, T, D)
    w = torch.zeros((b * s, cfg.n_experts), dtype=top_p.dtype,
                    device=x.device).scatter(1, top_e, top_p)
    out = torch.bmm(w.to(y.dtype)[:, None, :], y.transpose(0, 1))  # (T, 1, D)
    out = all_reduce_identity_bwd(out, tp)
    return out.view(b, s, d), torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# Mamba-1 (the selective scan: a CUDA kernel on the card)
# ---------------------------------------------------------------------------


def init_mamba(g: torch.Generator, cfg: ModelConfig, dt: torch.dtype,
               dev: torch.device) -> Dict[str, torch.Tensor]:
    """The JAX ``init_mamba`` draws (same shapes, scales and dtypes), from
    ``g``: ``in_proj`` (D, 2 Di), ``conv_w`` (W, Di), ``x_proj`` (Di, R +
    2N), ``dt_proj`` (R, Di) and ``out_proj`` (Di, D) normal in ``dt``;
    ``conv_b`` zeros in ``dt``; ``dt_bias`` -2, ``A_log`` = log(1..N) per
    channel and ``D_skip`` ones, all fp32."""
    d, di, n, r, w = (cfg.d_model, cfg.inner, cfg.ssm_state, cfg.dtrank,
                      cfg.conv_width)
    f32 = torch.float32
    a = torch.arange(1, n + 1, dtype=f32, device=dev).repeat(di, 1)
    return {"in_proj": _normal(g, (d, 2 * di), 1.0 / math.sqrt(d), dt, dev),
            "conv_w": _normal(g, (w, di), 0.5, dt, dev),
            "conv_b": torch.zeros((di,), dtype=dt, device=dev),
            "x_proj": _normal(g, (di, r + 2 * n), 1.0 / math.sqrt(di), dt,
                              dev),
            "dt_proj": _normal(g, (r, di), 1.0 / math.sqrt(r), dt, dev),
            "dt_bias": torch.full((di,), -2.0, dtype=f32, device=dev),
            "A_log": torch.log(a),
            "D_skip": torch.ones((di,), dtype=f32, device=dev),
            "out_proj": _normal(g, (di, d), 1.0 / math.sqrt(di), dt, dev)}


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` at its rounding points: ``x * (1 / (1 + exp(-x)))``,
    each operation in x's dtype (at bf16, ``F.silu`` rounds once and
    differs from JAX by an ulp in about a third of the elements)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x (B, S, Di), w (W, Di): JAX's shifted sum
    over the W taps in the order 0 .. W-1 (in x's dtype), then the bias."""
    n_taps, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, n_taps - 1, 0))
    out = 0
    for i in range(n_taps):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def _ssm_params(p, cfg: ModelConfig, xc: torch.Tensor, tp=None):
    """xc (B, S, Di) post-conv -> ``(dt (B, S, Di), Bm, Cm (B, S, N))``,
    fp32: the ``x_proj`` product in xc's dtype, then cast to fp32 (JAX
    :589), ``dt_proj`` in fp32, softplus.  Under ``tp`` xc holds the
    rank's channels: the partial products summed over the ranks in fp32
    and rounded once to xc's dtype."""
    n, r = cfg.ssm_state, cfg.dtrank
    if tp is None:
        proj = (xc @ p["x_proj"]).float()
    else:
        proj = all_reduce_sum_bwd(xc.float() @ p["x_proj"].float(), tp)
        proj = proj.to(xc.dtype).float()
    dtr, bm, cm = proj[..., :r], proj[..., r:r + n], proj[..., r + n:]
    dt = F.softplus(dtr @ p["dt_proj"].float() + p["dt_bias"])
    return dt, bm, cm


def selective_scan(p, cfg: ModelConfig, xc: torch.Tensor, z: torch.Tensor,
                   h0=None, tp=None):
    """The mamba-1 scan.  xc/z: (B, S, Di) (post-conv / gate; the rank's
    channels under ``tp``); h0: None (zeros) or (B, Di, N) fp32.  Returns
    ``(y (B, S, Di) in xc's dtype, h_last (B, Di, N) fp32)``, h_last the
    state after step S-1 (JAX's padded steps are identities, so it is
    JAX's too)."""
    dt, bm, cm = _ssm_params(p, cfg, xc, tp)
    a = -torch.exp(p["A_log"])
    return ops.selective_scan(xc, z, dt, a, bm, cm, p["D_skip"], h0)


def mamba_block(p, cfg: ModelConfig, x: torch.Tensor, tp=None):
    """Full-sequence mamba-1 block.  x: (B, S, D) -> ``(out, (conv_tail,
    h_last))``: conv_tail (B, W-1, Di) the last W-1 *pre-conv* inputs,
    left-padded with zeros when S < W-1 (the decode's conv state).  Under
    ``tp`` channel parallel: Di is the rank's channels (``in_proj``'s
    columns ``[xi | z]`` of them), and so are conv_tail and h_last."""
    s = x.shape[1]
    di, w = p["conv_w"].shape[1], cfg.conv_width
    xz = copy_all_reduce_bwd(x, tp) @ p["in_proj"]
    xi, z = xz[..., :di], xz[..., di:]
    xc = _silu(_causal_conv(xi, p["conv_w"], p["conv_b"]))
    y, h_last = selective_scan(p, cfg, xc, z, tp=tp)
    out = all_reduce_identity_bwd(y @ p["out_proj"], tp)
    conv_tail = (xi[:, s - (w - 1):] if s >= w - 1
                 else F.pad(xi, (0, 0, w - 1 - s, 0)))
    return out, (conv_tail, h_last)


def mamba_decode_block(p, cfg: ModelConfig, x: torch.Tensor,
                       conv_state: torch.Tensor, h: torch.Tensor, tp=None):
    """One-token mamba step, plain PyTorch (JAX leaves it to XLA).  x: (B,
    1, D); conv_state: (B, W-1, Di); h: (B, Di, N) fp32.  Returns ``(out,
    conv_state, h)``, the two states new tensors.  Under ``tp`` channel
    parallel, as :func:`mamba_block`: Di and both states are the rank's
    channels."""
    di = p["conv_w"].shape[1]
    xz = copy_all_reduce_bwd(x, tp) @ p["in_proj"]
    xi, z = xz[..., :di], xz[..., di:]  # (B, 1, Di)
    window = torch.cat([conv_state, xi], dim=1)  # (B, W, Di)
    xc = _silu(torch.einsum("bwd,wd->bd", window, p["conv_w"])
               + p["conv_b"])[:, None, :]
    dt, bm, cm = _ssm_params(p, cfg, xc, tp)
    a = -torch.exp(p["A_log"])
    xf = xc[:, 0].float()
    h = torch.exp(dt[:, 0, :, None] * a) * h \
        + (dt[:, 0] * xf)[..., None] * bm[:, 0, None, :]
    y = torch.einsum("bdn,bn->bd", h, cm[:, 0]) + p["D_skip"] * xf
    y = y * _silu(z[:, 0].float())
    out = all_reduce_identity_bwd(y.to(x.dtype) @ p["out_proj"], tp)
    return out[:, None, :], window[:, 1:], h
