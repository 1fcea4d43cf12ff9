"""The whisper-style encoder-decoder LM in PyTorch: init, training loss,
prefill and decode.

Ported from ``src/repro/models/encdec.py``: ``init_enc_layer``/
``init_dec_layer``/``init_encdec`` (:23-61) as the ``nn.Module``
:class:`EncDecLM` with ``ModuleList``s of blocks in place of the stacked
``lax.scan``; ``encode`` (:70-92), ``_dec_layer`` (:100),
``decode_forward`` (:114), ``encdec_loss`` (:132), ``encdec_prefill``
(:142), ``init_encdec_cache`` (:160) and ``encdec_decode_step`` (:171).
The conv/mel frontend is a stub, as in JAX: the encoder reads
precomputed frame embeddings (B, Se, D).  The encoder's self-attention
is unmasked, JAX's ``plain_attention(causal=False)`` in XLA: here
``flash_attention``'s unmasked instantiation on the card (its plain
version on the CPU), forward and, under autograd, backward.  The
decoder's causal self-attention is the same kernel's causal path, and
its cross-attention over the encoder output ``plain_attention`` in
PyTorch (queries and keys of different lengths; XLA in JAX).  The MLPs
are whisper's ungated GELU.  Positions are rotary, as in JAX (the TPU-era
stand-in for whisper's learned and sinusoidal embeddings).

``remat="full"`` runs each encoder and decoder layer under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, as
:func:`repro_torch.models.transformer.backbone` does: the backward
recomputes the layer, so each layer's attention forward runs twice a
training step.

A sharded model (``build(..., mesh=)``) computes each sub-block as the
decoder-only LMs do (:mod:`repro_torch.models.transformer`'s views):
the self-attention and the cross-attention tensor parallel on the rank's
heads when ``model`` divides the heads (the cross-attention's ``wk`` and
``wv`` read the encoder output through Megatron's "f"), the GELU MLP on
the rank's part of ``d_ff``, the norms gathered; each layer's leaves are
gathered inside the (checkpointed) layer, so the backward gathers them
again.  Served over a mesh (:func:`encdec_prefill_sharded`,
:func:`encdec_decode_sharded`) each rank computes its part of the batch
by JAX's ``batch_pspecs`` (under ``"fsdp_seq"`` its decoder positions and
its encoder frames, each attention over every rank's keys) and holds its
part of the cache by ``cache_pspecs``: the cross-attention's xk/xv by
encoder position over ``model`` with ``shard_kv_seq``, their decode
combined over the ranks by max and sum.

The cache is ``{"pos": int, "k", "v": (L, B, C, K, hd), "xk", "xv": (L,
B, Se, K, hd)}`` in the compute dtype: the decoder's self-attention keys
(C slots, a ring as in the decoder-only LMs) and the cross-attention's
keys and values, computed once at prefill.  Decode writes each new key and
value into the cache in place and returns the same tensors with ``pos +
1``.  Prefill and decode run under ``torch.inference_mode()``.  Parameters
come from a seeded ``torch.Generator`` with JAX's shapes and scales (other
numbers); :func:`params_from_jax` carries JAX's parameters over for the
parity tests.  They are created with ``requires_grad=False``; training
switches them on.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.device import generator, resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed import mesh as M
from repro_torch.distributed.collectives import gather_leaf
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.dlrm import _tensor, torch_dtype
from repro_torch.sharding import partition as SP


class DecBlock(T.Block):
    """A decoder layer: ``ln1``, causal self-``attn``, ``lnx``, the
    cross-attention ``xattn`` (no biases, no qk norms), ``ln2`` and the
    GELU ``mlp``.  An encoder layer is a :class:`~repro_torch.models.
    transformer.Block` of ``ln1``, ``attn``, ``ln2`` and ``mlp``."""

    def __init__(self, ln1, attn, lnx, xattn, ln2, mlp):
        super().__init__(ln1, attn, mlp, ln2)
        self.lnx = nn.Parameter(lnx, requires_grad=False)
        self.xattn = T._params(xattn)


class EncDecLM(nn.Module):
    """``embed`` (V, D), ``enc_blocks``, ``dec_blocks``, ``enc_norm`` and
    ``final_norm`` (D,), ``lm_head`` (D, V)."""

    def __init__(self, cfg: ModelConfig, embed, enc_blocks, dec_blocks,
                 enc_norm, final_norm, lm_head):
        super().__init__()
        if not cfg.enc_dec:
            raise ValueError(f"{cfg.name} is not an encoder-decoder config")
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.dec_blocks = nn.ModuleList(dec_blocks)
        self.enc_norm = nn.Parameter(enc_norm, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.lm_head = nn.Parameter(lm_head, requires_grad=False)


def init_encdec(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> EncDecLM:
    """Random parameters on ``device`` from one seeded ``torch.Generator``,
    with the shapes and scales of the JAX ``init_encdec``: weights normal
    times ``1/sqrt(fan_in)``, the embedding normal times 0.02, norms
    ones."""
    dev = resolve_device(device)
    g = generator(dev, seed)
    dt = torch_dtype(cfg.param_dtype)
    ones = lambda: torch.ones((cfg.d_model,), dtype=dt, device=dev)  # noqa: E731
    enc = [T.Block(ones(), L.init_attn(g, cfg, dt, dev),
                   L.init_mlp(g, cfg, dt, dev, gated=False), ones())
           for _ in range(cfg.n_enc_layers)]
    dec = [DecBlock(ones(), L.init_attn(g, cfg, dt, dev), ones(),
                    L.init_attn(g, cfg, dt, dev, cross=True), ones(),
                    L.init_mlp(g, cfg, dt, dev, gated=False))
           for _ in range(cfg.n_layers)]
    embed = L._normal(g, (cfg.vocab, cfg.d_model), 0.02, dt, dev)
    head = L._normal(g, (cfg.d_model, cfg.vocab), 1.0 / math.sqrt(
        cfg.d_model), dt, dev)
    return EncDecLM(cfg, embed, enc, dec, ones(), ones(), head)


def params_from_jax(tree, cfg: ModelConfig, device="cuda") -> EncDecLM:
    """The JAX ``init_encdec`` pytree, as NumPy arrays (``{"embed",
    "enc_blocks", "dec_blocks"`` stacked on a leading L axis,
    ``"enc_norm", "final_norm", "lm_head"}``), as the port's model on
    ``device``: the L axes unstacked, same dtypes, same bits."""
    dev = resolve_device(device)

    def layer(stack, i):
        return {name: (_tensor(np.asarray(sub)[i], dev)
                       if not isinstance(sub, dict) else
                       {k: _tensor(np.asarray(a)[i], dev)
                        for k, a in sub.items()})
                for name, sub in stack.items()}

    enc = [layer(tree["enc_blocks"], i) for i in range(cfg.n_enc_layers)]
    dec = [layer(tree["dec_blocks"], i) for i in range(cfg.n_layers)]
    return EncDecLM(
        cfg, _tensor(tree["embed"], dev),
        [T.Block(e["ln1"], e["attn"], e["mlp"], e["ln2"]) for e in enc],
        [DecBlock(d["ln1"], d["attn"], d["lnx"], d["xattn"], d["ln2"],
                  d["mlp"]) for d in dec],
        _tensor(tree["enc_norm"], dev), _tensor(tree["final_norm"], dev),
        _tensor(tree["lm_head"], dev))


# ---------------------------------------------------------------------------
# Encoder and decoder
# ---------------------------------------------------------------------------


def _run_layers(blocks, run: RunConfig, fn, x: torch.Tensor,
                *extra) -> torch.Tensor:
    """x through ``fn(blk, x, *extra) -> x`` for each block, each
    recomputed in the backward under ``remat="full"``; ``fn`` gathers a
    sharded block's leaves itself (so the checkpoint gathers them again in
    the backward)."""
    for blk in blocks:
        if run.remat == "full":
            x = checkpoint(fn, blk, x, *extra, use_reentrant=False)
        else:
            x = fn(blk, x, *extra)
    return x


def _norm(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig):
    return L.rms_norm(x, gather_leaf(w), cfg.norm_eps)


def _mlp(blk, x: torch.Tensor) -> torch.Tensor:
    mlp, tp = T._ffn_view(blk.mlp, 1)
    return L.mlp_block(mlp, x, tp=tp)


def encode(model: EncDecLM, cfg: ModelConfig, run: RunConfig,
           frames: torch.Tensor, seq: Optional[M.SeqSplit] = None
           ) -> torch.Tensor:
    """frames (B, Se, D) precomputed stub embeddings -> (B, Se, D) in the
    compute dtype: pre-norm layers of unmasked self-attention and the GELU
    MLP, then ``enc_norm``.  ``seq``: frames hold this rank's positions of
    a sequence split (a served prefill or a training step under
    ``"fsdp_seq"``), whose attention sees every rank's."""
    lo = 0 if seq is None else seq.offset
    positions = torch.arange(lo, lo + frames.shape[1],
                             device=frames.device)[None, :]

    def layer(blk, x):
        attn, tp = T._attn_view(blk.attn, cfg)
        x = x + L.attn_block(attn, cfg, _norm(x, blk.ln1, cfg), positions,
                             causal=False, tp=tp, seq=seq)[0]
        return x + _mlp(blk, _norm(x, blk.ln2, cfg))

    x = _run_layers(model.enc_blocks, run, layer,
                    frames.to(torch_dtype(cfg.compute_dtype)))
    return _norm(x, model.enc_norm, cfg)


def _dec_layer(blk: DecBlock, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, enc_out: torch.Tensor,
               seq: Optional[M.SeqSplit] = None,
               enc_seq: Optional[M.SeqSplit] = None):
    """One decoder layer over the whole sequence: causal self-attention,
    cross-attention over ``enc_out``, the MLP.  Returns ``(x, {"k", "v",
    "xk", "xv"})``.  Under a sequence split, ``seq``: x holds this rank's
    positions; ``enc_seq`` (a served prefill): enc_out holds the rank's
    encoder positions, whose keys and values are gathered over ``model``
    for the attention (the returned xk/xv stay the rank's)."""
    attn, tp = T._attn_view(blk.attn, cfg)
    attn_out, (k, v) = L.attn_block(attn, cfg, _norm(x, blk.ln1, cfg),
                                    positions, tp=tp, seq=seq)
    x = x + attn_out
    xattn, tp = T._attn_view(blk.xattn, cfg)
    xk, xv = L.cross_kv(xattn, cfg, enc_out, tp)
    keys = (xk, xv) if enc_seq is None else tuple(
        C.all_gather(t, enc_seq.mesh.model_group, 1, enc_seq.mesh.model)
        for t in (xk, xv))
    x = x + L.cross_attn_block(xattn, cfg, _norm(x, blk.lnx, cfg), *keys,
                               tp)
    x = x + _mlp(blk, _norm(x, blk.ln2, cfg))
    return x, {"k": k, "v": v, "xk": xk, "xv": xv}


def decode_forward(model: EncDecLM, cfg: ModelConfig, run: RunConfig,
                   tokens: torch.Tensor, enc_out: torch.Tensor,
                   want_cache: bool = False,
                   seq: Optional[M.SeqSplit] = None):
    """tokens (B, S) over ``enc_out`` (B, Se, D) -> ``(x (B, S, D) after
    ``final_norm``, caches)``: with ``want_cache`` each layer's ``{"k",
    "v", "xk", "xv"}`` in a list (no remat), else None.  ``seq``: tokens
    hold this rank's positions of a training step's sequence split (rope
    at their absolute positions, the self-attention over every rank's
    keys), ``enc_out`` the whole encoder output."""
    lo = seq.offset if seq else 0
    positions = torch.arange(lo, lo + tokens.shape[1],
                             device=tokens.device)[None, :]
    x = T._embed(model, cfg, tokens)
    caches = None
    if want_cache:
        T._check_whole(model)
        caches = []
        for blk in model.dec_blocks:
            x, c = _dec_layer(blk, cfg, x, positions, enc_out)
            caches.append(c)
    else:
        x = _run_layers(
            model.dec_blocks, run,
            lambda blk, x_, e: _dec_layer(blk, cfg, x_, positions, e,
                                          seq)[0],
            x, enc_out)
    return _norm(x, model.final_norm, cfg), caches


def encdec_loss(model: EncDecLM, cfg: ModelConfig, run: RunConfig,
                tokens: torch.Tensor, labels: torch.Tensor,
                frames: torch.Tensor) -> torch.Tensor:
    """The decoder's LM loss over the encoded frames, fp32: tokens/labels
    (B, S) int, labels < 0 masked.

    In a scope that splits the sequence (a training step under
    ``"fsdp_seq"``) tokens and labels are this rank's positions, cut by
    the step; the rank encodes its part of the frames (the encoder's
    attention over every rank's, :func:`encode`), the encoder output is
    gathered over ``model`` for the cross-attention (its backward sums the
    ranks' gradients and keeps the rank's frames), and the loss is the
    mean over every rank's tokens (``transformer.head_loss``)."""
    seq = M.local_split(tokens.shape[1])
    if seq is None:
        x, _ = decode_forward(model, cfg, run, tokens,
                              encode(model, cfg, run, frames))
        return T.head_loss(model, cfg, x, labels)
    enc_seq = M.seq_split(frames.shape[1])
    if enc_seq is None:  # model does not divide the frames: whole
        enc_out = encode(model, cfg, run, frames)
    else:
        enc_out = C.all_gather_reduce_scatter_bwd(
            encode(model, cfg, run, enc_seq.part(frames), enc_seq),
            seq.mesh.model_group, 1, seq.mesh.model)
    x, _ = decode_forward(model, cfg, run, tokens, enc_out, seq=seq)
    return T.head_loss(model, cfg, x, labels, seq=seq)


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def init_encdec_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      dtype=None, device="cuda",
                      enc_len: Optional[int] = None) -> Dict:
    """Zeroed decode cache: ``cache_len`` self-attention slots and
    ``enc_len`` (``cfg.enc_len`` by default) cross-attention positions a
    layer, in the compute dtype."""
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.compute_dtype)
    n, kv, hd = cfg.n_layers, cfg.kv_heads, cfg.hd
    se = cfg.enc_len if enc_len is None else enc_len
    cache = {"pos": 0}
    for name, length in (("k", cache_len), ("v", cache_len), ("xk", se),
                         ("xv", se)):
        cache[name] = torch.zeros((n, batch, length, kv, hd), dtype=dt,
                                  device=dev)
    return cache


@torch.inference_mode()
def encdec_prefill(model: EncDecLM, cfg: ModelConfig, tokens: torch.Tensor,
                   frames: torch.Tensor, cache_len: Optional[int] = None):
    """tokens (B, S) and frames (B, Se, D) on the model's device ->
    ``(last-token logits (B, V) fp32, cache at pos = S)``.  The
    self-attention cache holds ``max(cache_len, S)`` slots, zero-padded past
    S (JAX pads a ``cache_len`` above S and keeps S below it)."""
    run = RunConfig()
    b, s = tokens.shape
    enc_out = encode(model, cfg, run, frames)
    x, caches = decode_forward(model, cfg, run, tokens, enc_out,
                               want_cache=True)
    cache = init_encdec_cache(cfg, b, max(cache_len or s, s), x.dtype,
                              tokens.device, enc_out.shape[1])
    for i, c in enumerate(caches):
        cache["k"][i, :, :s] = c["k"]
        cache["v"][i, :, :s] = c["v"]
        cache["xk"][i] = c["xk"]
        cache["xv"][i] = c["xv"]
    cache["pos"] = s
    return T._logits(model, cfg, x[:, -1:])[:, 0], cache


@torch.inference_mode()
def encdec_decode_step(model: EncDecLM, cfg: ModelConfig,
                       token: torch.Tensor, cache: Dict):
    """token (B, 1) -> ``(logits (B, V) fp32, cache)``: the new key and
    value of every layer written into slot ``pos % C`` in place, the
    cross-attention over the cached ``xk``/``xv``."""
    pos = cache["pos"]
    x = T._embed(model, cfg, token)
    for i, blk in enumerate(model.dec_blocks):
        h = L.rms_norm(x, blk.ln1, cfg.norm_eps)
        x = x + L.attn_decode_block(blk.attn, cfg, h, cache["k"][i],
                                    cache["v"][i], pos)[0]
        hx = L.rms_norm(x, blk.lnx, cfg.norm_eps)
        x = x + L.cross_attn_block(blk.xattn, cfg, hx, cache["xk"][i],
                                   cache["xv"][i])
        x = x + L.mlp_block(blk.mlp, L.rms_norm(x, blk.ln2, cfg.norm_eps))
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return T._logits(model, cfg, x)[:, 0], {**cache, "pos": pos + 1}


# ---------------------------------------------------------------------------
# Serving over a mesh
# ---------------------------------------------------------------------------


def _cache_dims(cfg: ModelConfig, b: int, cap: int, se: int, mesh: M.Mesh,
                run: RunConfig) -> Dict[str, tuple]:
    """``{leaf: (one layer's whole shape, cache_spec, its model dim)}``
    of the self-attention's k/v (``cap`` slots) and the cross-attention's
    xk/xv (``se`` encoder positions)."""
    out = {}
    for name, length in (("k", cap), ("v", cap), ("xk", se), ("xv", se)):
        shape = (b, length, cfg.kv_heads, cfg.hd)
        spec = SP.cache_spec(name, shape, mesh, run.shard_kv_seq)
        out[name] = (shape, spec, T._model_dim(spec))
    return out


def rank_cache(cfg: ModelConfig, run: RunConfig, mesh: M.Mesh, batch: int,
               cache_len: int, pos: int, device="cuda",
               enc_len: Optional[int] = None) -> Dict:
    """This rank's part of a zeroed decode cache of ``batch`` rows,
    ``cache_len`` slots and ``enc_len`` (``cfg.enc_len`` by default)
    encoder positions at ``pos``, laid out by ``cache_pspecs``: what
    :func:`encdec_prefill_sharded` fills and :func:`encdec_decode_sharded`
    takes."""
    se = cfg.enc_len if enc_len is None else enc_len
    dev, dt = resolve_device(device), torch_dtype(cfg.compute_dtype)
    cache = {"pos": pos, "cap": cache_len, "enc_len": se}
    for name, (shape, sp, _) in _cache_dims(cfg, batch, cache_len, se, mesh,
                                            run).items():
        cache[name] = torch.zeros(
            (cfg.n_layers,) + SP.shard_shape(shape, sp, mesh), dtype=dt,
            device=dev)
    return cache


@torch.inference_mode()
def encdec_prefill_sharded(model: EncDecLM, cfg: ModelConfig,
                           run: RunConfig, mesh: M.Mesh,
                           tokens: torch.Tensor, frames: torch.Tensor,
                           cache_len: Optional[int] = None):
    """:func:`encdec_prefill` on this rank's shards of a model served over
    ``mesh``, as :func:`repro_torch.models.transformer.prefill_sharded`
    serves a decoder-only LM: tokens (B, S) and frames (B, Se, D) the
    global batch, of which the rank computes its part by ``batch_pspecs``
    (under ``"fsdp_seq"`` its decoder positions and its encoder positions,
    the encoder's unmasked attention and the decoder's over every rank's
    keys).  Returns the rank's logits rows and its part of the cache by
    ``cache_pspecs``: k/v (L, B_c, C_c, K_c, hd) and the cross-attention's
    xk/xv (L, B_c, Se_c, K_c, hd), the encoder positions over ``model``
    with ``shard_kv_seq`` (a rank's own under the split); ``"pos"``,
    ``"cap"`` and ``"enc_len"`` Python ints."""
    T._check_serve(model, mesh)
    b, s = tokens.shape
    toks, rows_dim, seq, rows = T._rank_part(tokens, mesh, run)
    fr, _, enc_seq, _ = T._rank_part(frames, mesh, run)
    lo = seq.offset if seq else 0
    positions = torch.arange(lo, lo + toks.shape[1],
                             device=tokens.device)[None, :]
    cap, se = max(cache_len or s, s), frames.shape[1]
    dims = _cache_dims(cfg, b, cap, se, mesh, run)
    with M.activation_sharding(mesh, run.sharding, rows=rows):
        enc_out = encode(model, cfg, run, fr, enc_seq)
        x = T._embed(model, cfg, toks)
        cache = rank_cache(cfg, run, mesh, b, cap, s, x.device, se)
        for i, blk in enumerate(model.dec_blocks):
            x, c = _dec_layer(blk, cfg, x, positions, enc_out, seq, enc_seq)
            for name, (_, _, dst) in dims.items():
                t = T._ring(c[name], cap) if name in ("k", "v") else c[name]
                src = (1 if enc_seq is not None and name in ("xk", "xv")
                       else T._state_dim("k", t, cfg, rows_dim))
                cache[name][i] = T._reshard(t, src, dst, mesh)
        last = _norm(T._last_position(x, seq, mesh), model.final_norm, cfg)
        return T._serve_logits(model, cfg, last, mesh), cache


def _cross_decode_sharded(blk: DecBlock, cfg: ModelConfig, hx: torch.Tensor,
                          xk: torch.Tensor, xv: torch.Tensor, se: int,
                          mesh: M.Mesh, rows_dim: Optional[int],
                          dst: Optional[int]) -> torch.Tensor:
    """One token's cross-attention on this rank's part of xk/xv: the query
    brought to the cache's layout (its rows; its KV heads, or every head
    when the encoder positions lie over ``model`` and the ranks are
    combined by :func:`layers.decode_attention_sharded`), the output back
    to the view's layout for ``wo``."""
    xattn, tp = T._attn_view(blk.xattn, cfg)
    q = (hx @ xattn["wq"]).reshape(hx.shape[0], 1, -1, cfg.hd)
    src = 2 if q.shape[2] != cfg.n_heads else rows_dim
    at = 2 if dst == 2 else None
    q = T._reshard(q, src, at, mesh)
    if dst == 1:
        o = L.decode_attention_sharded(q, xk, xv, se,
                                       mesh.model_rank * xk.shape[1],
                                       mesh.model_group)
    else:
        o = L.plain_attention(q, xk, xv)
    o = T._reshard(o, at, src, mesh)
    return C.all_reduce_identity_bwd(o.reshape(o.shape[0], 1, -1)
                                     @ xattn["wo"], tp)


@torch.inference_mode()
def encdec_decode_sharded(model: EncDecLM, cfg: ModelConfig, run: RunConfig,
                          mesh: M.Mesh, token: torch.Tensor, cache: Dict):
    """:func:`encdec_decode_step` on this rank's shards and its part of
    the cache (:func:`encdec_prefill_sharded`'s), token (B, 1) the global
    batch; the cache written in place and returned with ``pos + 1``, the
    logits the rank's rows'."""
    T._check_serve(model, mesh)
    b = token.shape[0]
    tok, rows_dim, _, rows = T._rank_part(token, mesh, run)
    pos, se = cache["pos"], cache["enc_len"]
    dims = {k: d for k, (_, _, d) in _cache_dims(
        cfg, b, cache["cap"], se, mesh, run).items()}
    with M.activation_sharding(mesh, run.sharding, rows=rows):
        x = T._embed(model, cfg, tok)
        for i, blk in enumerate(model.dec_blocks):
            x = x + T._attn_decode_sharded(
                blk, cfg, _norm(x, blk.ln1, cfg),
                {"k": cache["k"][i], "v": cache["v"][i]}, pos, mesh,
                rows_dim, dims["k"])
            x = x + _cross_decode_sharded(
                blk, cfg, _norm(x, blk.lnx, cfg), cache["xk"][i],
                cache["xv"][i], se, mesh, rows_dim, dims["xk"])
            x = x + _mlp(blk, _norm(x, blk.ln2, cfg))
        x = _norm(x, model.final_norm, cfg)
        return T._serve_logits(model, cfg, x, mesh), {**cache, "pos": pos + 1}
