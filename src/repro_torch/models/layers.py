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
across the sharded length).  The MoE's dispatch over the ranks of a
mesh, global or data-local (``_moe_dispatch_ffn_sharded``,
``local_dispatch``), runs the experts on each rank's own tokens with the
dispatch's collectives over the ranks that hold the batch's other tokens:
the axes its rows lie over and, under a sequence split (served or
trained), ``model``; the data-local dispatch's shards never cross a row
part, so it gathers over ``model`` only.
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
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import mesh as M
from repro_torch.distributed.collectives import (all_reduce_identity_bwd,
                                                 all_reduce_sum_bwd,
                                                 copy_all_reduce_bwd)
from repro_torch.kernels import ops, ref
from repro_torch.sharding import partition as SP

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
    shape and dtype.  On the card (and on ``meta``) the forward kernel's
    offset mode (:func:`repro_torch.kernels.ops.flash_attention`), on the
    CPU the
    online softmax over ``bk``-key blocks in JAX's order."""
    if q.device.type in ("cuda", "meta"):
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


@dataclass(frozen=True)
class _Tokens:
    """Where this rank's tokens, ``rows`` rows of ``length`` positions
    (b-major), lie in the (b, s) order of the step's or prefill's global
    batch: row part ``ri`` of ``nr`` over ``row_group`` (JAX's fitted
    batch entry; 1 part where the rows are replicated) and position part
    ``pi`` of ``np_`` over ``pos_group`` (a sequence split over
    ``model``).  ``split``: a statistic summed over the ranks passes its
    gradient through unchanged (under a sequence split each rank's loss is
    the step's and the step sums the ranks' gradients) rather than summed
    (the step averages the ranks' gradients)."""
    rows: int
    length: int
    nr: int = 1
    ri: int = 0
    row_group: Optional[dist.ProcessGroup] = None
    np_: int = 1
    pi: int = 0
    pos_group: Optional[dist.ProcessGroup] = None
    group: Optional[dist.ProcessGroup] = None
    split: bool = False

    def gather(self, x: torch.Tensor, block: bool = False) -> torch.Tensor:
        """x (rows * length, ...) of this rank -> every rank's in (b, s)
        order: of the whole batch, or with ``block`` of this rank's row
        part (gathered over the positions only)."""
        nr, group = (1, self.pos_group) if block else (self.nr, self.group)
        if nr * self.np_ == 1:
            return x
        rest = tuple(x.shape[1:])
        parts = C.all_gather(x.reshape((1, self.rows, self.length) + rest),
                             group, 0, nr * self.np_)
        return parts.reshape((nr, self.np_, self.rows, self.length) + rest) \
            .transpose(1, 2).reshape((-1,) + rest)

    def mine(self, xg: torch.Tensor, block: bool = False) -> torch.Tensor:
        """The inverse pick: this rank's tokens of ``xg`` (in
        :meth:`gather`'s order, a leading token dim)."""
        ri = 0 if block else self.ri
        rest = tuple(xg.shape[1:])
        v = xg.reshape((-1, self.np_ * self.length) + rest)
        return v[ri * self.rows:(ri + 1) * self.rows,
                 self.pi * self.length:(self.pi + 1) * self.length] \
            .reshape((-1,) + rest)

    def sum(self, x: torch.Tensor, group) -> torch.Tensor:
        """``x`` summed over ``group`` (one of the three), with the
        backward :attr:`split` asks for."""
        if group is None:
            return x
        return (all_reduce_identity_bwd(x, group) if self.split
                else all_reduce_sum_bwd(x, group))


def _tokens(b: int, s: int, seq: Optional[M.SeqSplit]) -> _Tokens:
    """The layout of x (b, s) under the active scope: its rows over the
    scope's row axes, its positions over ``model`` under ``seq``."""
    mesh = M.active_mesh()
    if mesh is None:
        return _Tokens(b, s)
    rows = seq.rows if seq is not None else M.row_axes()
    row_group, nr, ri = mesh.axes_group(rows)
    if seq is None:
        return _Tokens(b, s, nr, ri, row_group, group=row_group)
    return _Tokens(b, s, nr, ri, row_group, mesh.model, mesh.model_rank,
                   mesh.model_group, seq.group, split=True)


def _experts(p, xf: torch.Tensor, slot: torch.Tensor, top_p: torch.Tensor,
             n_experts: int, n_slots: int, tp=None) -> torch.Tensor:
    """The expert SwiGLU over the capacity buffer: each of this rank's
    T * K assignments (``slot``, token-major; ``n_slots`` the drop slot)
    scattered into an (n_slots + 1, D) buffer whose last row takes every
    dropped one (which write lands there is unspecified, and the row is
    discarded, so its gradient is zero: JAX's scatter transpose), the
    experts run on its (E, n_slots / E, D) view, and each token's outputs
    gathered back and weighted by its renormalised top-K probabilities.
    No (T, E, C) one-hot is built.  With ``tp`` the experts run on this
    rank's ``moe_d_ff`` part: the tokens enter them through "f", and each
    token's rows of their partial outputs are summed by "g" before the
    router's weights scale them (so the weights' gradient sums every
    rank's part)."""
    t, d = xf.shape
    k = top_p.shape[1]
    # Token-major copies of each token, one per assignment; the backward
    # sums them over K (no atomics).
    xd = copy_all_reduce_bwd(xf, tp)
    x_rep = xd[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = xf.new_zeros((n_slots + 1, d)).index_put((slot,), x_rep)
    h = buf[:n_slots].view(n_experts, n_slots // n_experts, d)
    y = torch.bmm(F.silu(torch.bmm(h, p["w1"])) * torch.bmm(h, p["w3"]),
                  p["w2"])
    y_flat = torch.cat([y.reshape(n_slots, d), y.new_zeros((1, d))])
    # index_select, whose backward adds into the rows (only the discarded
    # zero row takes several); indexing's backward sorts the slots and
    # walks the drop slot's duplicates one after another.
    gathered = all_reduce_identity_bwd(y_flat.index_select(0, slot), tp) \
        * top_p.reshape(-1, 1).to(y.dtype)
    return gathered.view(t, k, d).sum(dim=1)


def _bincount(x: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(x, minlength=n)`` of values below ``n``; on the
    ``meta`` device, which has no bincount, its shape: (n,) int64."""
    if x.is_meta:
        return x.new_empty((n,), dtype=torch.int64)
    return torch.bincount(x, minlength=n)


def _moe_dispatch_ffn(p, cfg: ModelConfig, xf: torch.Tensor, lay: _Tokens,
                      tp=None):
    """Capacity dispatch over the batch's every token, and the expert
    SwiGLU.  xf (T, D) this rank's tokens -> ``(out (T, D), aux)``, aux
    the Switch load-balance loss ``E * sum(me * ce)`` (ce counts every
    top-K assignment, dropped ones too).

    The dispatch is global, as JAX's over the step's or prefill's tokens
    (with a sequence split JAX's combined axes, ``partition.py:102-104``):
    the ranks' top-K, all-gathered over ``lay.group`` into the global
    (b, s) order, give every assignment's position within its expert, the
    capacity counts every token, and ``me`` sums every rank's router
    probabilities (:meth:`_Tokens.sum`).  Ranks whose rows are replicated
    hold the same tokens and gather nothing over that axis.  A token's
    expert output needs no other token, so the experts then run on this
    rank's kept tokens only."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    probs, top_p, top_e = _route(p, cfg, xf)
    all_e = lay.gather(top_e)
    n_tok = all_e.shape[0]
    me = (probs.mean(dim=0) if lay.group is None
          else lay.sum(probs.sum(dim=0), lay.group) / n_tok)
    ce = _bincount(all_e.reshape(-1), e).float() / (n_tok * k)
    aux = e * torch.sum(me * ce)
    c = max(1, int(math.ceil(cfg.capacity_factor * n_tok * k / e)))
    slot, _ = _capacity_slots(all_e.reshape(-1), e, c)
    slot = lay.mine(slot.view(n_tok, k)).reshape(t * k)
    return _experts(p, xf, slot, top_p, e, e * c, tp), aux


def _moe_dispatch_ffn_sharded(p, cfg: ModelConfig, xf: torch.Tensor,
                              lay: _Tokens, n_shards: int, tp=None):
    """JAX's data-local dispatch (``_moe_dispatch_ffn_sharded``,
    :507-556): the batch's T tokens in (b, s) order cut into ``n_shards``
    contiguous shards of T / n_shards, each dispatched on its own with
    capacity ``ceil(cf * T/n_shards * K / E)``, the aux the mean of the
    shards' (each over its own ``me`` and ``ce``).

    ``n_shards`` is the product of the variant's batch entry and the rows'
    parts a prefix of it, so a shard never crosses a row part: the ranks'
    top-K are gathered over the positions only (``model`` under a
    sequence split), each shard's ranks counted within it, and each of
    this rank's assignments goes to the buffer of its shard: expert ``e``,
    shard ``j`` of the shards this rank's tokens touch, at ``(e nt + j) C
    + rank`` (one shard a rank when each holds its own: JAX's shard's
    buffer).  The shards' ``me`` sum the ranks' probabilities over the
    positions; the aux is the mean over this row part's shards, summed
    over the row parts and divided by their count."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    probs, top_p, top_e = _route(p, cfg, xf)
    blk_e = lay.gather(top_e, block=True)  # this row part's tokens
    ns = n_shards // lay.nr  # shards within the row part
    tl = blk_e.shape[0] // ns
    shard = torch.arange(ns, device=xf.device).repeat_interleave(tl * k)
    virt = blk_e.reshape(-1) * ns + shard  # expert e of shard j: e ns + j
    ce = _bincount(virt, e * ns).float().view(e, ns).t() \
        / (tl * k)
    if ns == 1 and lay.pos_group is None:
        me = probs.mean(dim=0)[None]
    else:
        mine = lay.mine(torch.arange(blk_e.shape[0], device=xf.device),
                        block=True) // tl  # the shard of each token here
        onehot = (mine[None, :] == torch.arange(ns, device=xf.device)[
            :, None]).to(probs.dtype)
        me = lay.sum(onehot @ probs, lay.pos_group) / tl
    aux = lay.sum((e * (me * ce).sum(-1)).mean(), lay.row_group) / lay.nr
    c = max(1, int(math.ceil(cfg.capacity_factor * tl * k / e)))
    slot, _ = _capacity_slots(virt, e * ns, c)
    slot = lay.mine(slot.view(-1, k), block=True).reshape(t * k)
    # Keep the buffer of the shards this rank's tokens touch only.
    lo, width = lay.pi * lay.length, lay.np_ * lay.length
    touched = sorted({j for r in range(lay.rows)
                      for j in range((r * width + lo) // tl,
                                     (r * width + lo + lay.length - 1) // tl
                                     + 1)})
    nt = len(touched)
    if nt < ns:
        where = torch.full((ns,), -1, dtype=torch.int64, device=xf.device)
        where[touched] = torch.arange(nt, device=xf.device)
        kept = slot < e * ns * c
        ex, j, r = slot // (ns * c), (slot // c) % ns, slot % c
        slot = torch.where(kept, (ex * nt + where[j]) * c + r, e * nt * c)
    return _experts(p, xf, slot, top_p, e, e * nt * c, tp), aux


def moe_block(p, cfg: ModelConfig, x: torch.Tensor,
              dense_route: bool = False, local_dispatch: bool = False,
              tp=None, seq: Optional[M.SeqSplit] = None):
    """Top-K capacity-dispatched MoE.  x (B, S, D) -> ``(out, aux)``; the
    dispatched experts tensor parallel over ``tp``.

    Under a mesh scope (x this rank's rows, the scope's row axes; with
    ``seq`` its positions of a sequence split, a prefill or a training
    step) the dispatch is global over every rank's tokens
    (:func:`_moe_dispatch_ffn`), or with ``local_dispatch`` JAX's
    ``_moe_dispatch_ffn_sharded`` over as many shards as the variant's
    batch entry has ranks, when they divide the batch's tokens (else the
    global dispatch, as JAX falls back).

    ``dense_route=True`` (decode: few tokens) runs every expert on every
    token and combines them with a (T, E) weight matrix holding each
    token's renormalised top-K probabilities: no token is dropped, and the
    aux loss is 0; under ``tp`` each rank's experts give a partial sum,
    summed over the ranks after the combine."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    if not dense_route:
        lay = _tokens(b, s, seq)
        mesh, n_shards = M.active_mesh(), 1
        if local_dispatch and mesh is not None:
            for a in SP.batch_entry(mesh, M.active_variant()):
                n_shards *= mesh.size(a)
        n_tok = b * s * lay.nr * lay.np_
        if n_shards > 1 and n_tok % n_shards == 0:
            out, aux = _moe_dispatch_ffn_sharded(p, cfg, xf, lay, n_shards,
                                                 tp)
        else:
            out, aux = _moe_dispatch_ffn(p, cfg, xf, lay, tp)
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
