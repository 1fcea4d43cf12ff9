"""Decoder-only LMs in PyTorch (dense, MoE, VLM, SSM, hybrid): init,
training loss, prefill and decode.

Ported from ``src/repro/models/transformer.py``: ``init_layer``/
``init_lm`` (:30-66) as the ``nn.Module`` :class:`TransformerLM` with a
``ModuleList`` of blocks in place of the stacked ``lax.scan``, each block
holding what JAX's layer holds: a mamba-1 ``ssm`` alone (family ``ssm``),
or ``attn`` and a SwiGLU ``mlp`` or, with ``cfg.n_experts``, a ``moe``,
plus an ``ssm`` beside the attention (family ``hybrid``: the two read the
same normed input and their outputs are averaged);
``_layer_forward``/``_layer_decode`` (:74-130; the MoE decodes through
``dense_route``); ``_remat``, ``backbone`` (the layers' mean aux loss),
``_embed`` (a VLM's frontend embeddings spliced over the first positions),
``_logits``, ``_ce`` and ``lm_loss`` (``+ 0.01 * aux`` for the MoE)
(:133-231); ``init_cache``, ``prefill``, ``decode_step``,
``decode_step_embeds`` and ``_decode_from`` (:234-314).
``constrain_batch`` is a no-op without a mesh and is dropped; the MoE's
dispatch over the data ranks of a mesh (global, or data-local with
``RunConfig.moe_local_dispatch``) is :func:`layers.moe_block`'s.  Every
family trains: the SSM and hybrid LMs' gradients go through the scan's
backward kernel and, for the hybrid, the windowed attention's.

:func:`shard_model` cuts each leaf to this rank's shard of JAX's
``param_pspecs`` layout (:mod:`repro_torch.sharding.partition`) and tags
it with its :class:`~repro_torch.distributed.mesh.Placement`.  A sharded
model also serves (:func:`prefill_sharded`, :func:`decode_sharded`:
JAX's ``batch_pspecs`` and ``cache_pspecs`` layouts, ``fsdp_seq``'s
sequence split; the mamba decode channel parallel on the conv and SSM
states' channels over ``model``); :func:`prefill`/:func:`decode_step`
serve a whole model.  Each layer's leaves are
gathered inside ``_layer_forward``, so under ``remat="full"`` the
checkpoint gathers them again in the backward instead of keeping them.
Where a leaf's feature dim lies on ``model``, the layer computes tensor
parallel on this rank's part (Megatron's column- then row-parallel
products, ``layers.attn_block``/``mlp_block``/``moe_block``/
``mamba_block``'s ``tp``): attention when the model ranks each hold whole
heads of both q and kv (``H % model == K % model == 0``), the SwiGLU and
the experts when ``model`` divides ``d_ff``, the mamba block when it
divides ``Di`` (its channel leaves then lie on ``model``; ``in_proj``'s
columns are exchanged within ``model`` after the gather over ``data``,
:func:`_in_proj_channels`).  A hybrid layer takes the attention's view
and the mamba block's each on its own.  The other leaves are gathered
whole (an attention whose heads split, a block ``fit_spec`` kept off
``model``) and computed replicated over ``model``.  The embedding and
head are vocab parallel when ``model`` divides the vocab: each rank
looks up the ids of its vocab range and
the ranks' rows are summed, and the cross-entropy takes the max and the
sums of exps and gold logits over the ranks (:func:`_ce`).

``remat="full"`` runs each layer under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, the
counterpart of ``jax.checkpoint``: the backward recomputes the layer's
forward (so ``flash_attention`` runs twice per layer and step, and the
MoE routes the same tokens again).
``remat="dots"`` (an XLA checkpoint policy) is refused by
:class:`~repro_torch.configs.base.RunConfig`.

The cache is ``{"pos": int, "k": (L, B, C, K, hd), "v": ...}`` in the
compute dtype, a ring buffer (slot = pos % C; a sliding-window config
caps C at its window), plus, for the SSM and hybrid families, ``"conv"``
(L, B, W-1, Di) in the compute dtype and ``"h"`` (L, B, Di, N) in fp32;
an SSM has no ``k``/``v``.  Decode steps write each new key, value,
conv state and SSM state into it in place and return the same tensors
with ``pos + 1``.  Prefill and decode run under ``torch.inference_mode()``.
Parameters are drawn from a seeded ``torch.Generator`` (same shapes and
scales as ``jax.random``'s, other numbers); :func:`params_from_jax` carries
JAX's parameters over for the parity tests.  They are created with
``requires_grad=False`` (serving needs no graph); training switches them on
(:func:`repro_torch.launch.steps.make_train_step`).
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
from repro_torch.models import layers as L
from repro_torch.models.dlrm import _tensor, torch_dtype
from repro_torch.sharding import partition as SP


# The LM families this module builds: attention plus a feed-forward block
# (dense, moe, vlm), mamba-1 blocks alone (ssm), or both side by side
# (hybrid).
FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")
# The families whose decode state is a recurrence (conv and h).
SSM_FAMILIES = ("ssm", "hybrid")


def _check_family(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r}: this module's LMs are {FAMILIES} (the "
            "encoder-decoder LM is repro_torch.models.encdec)")


def _params(d: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=False)
                             for k, t in d.items()})


class Block(nn.Module):
    """One pre-norm layer: ``ln1`` and, as the family has them, ``attn``,
    ``ssm`` (mamba-1), ``ln2`` and the feed-forward block, ``mlp``
    (SwiGLU) or ``moe`` (router and experts), whichever ``ffn_name``
    says.  An SSM layer holds ``ln1`` and ``ssm`` only."""

    def __init__(self, ln1: torch.Tensor,
                 attn: Optional[Dict[str, torch.Tensor]] = None,
                 ffn: Optional[Dict[str, torch.Tensor]] = None,
                 ln2: Optional[torch.Tensor] = None, ffn_name: str = "mlp",
                 ssm: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        if ln2 is not None:
            self.ln2 = nn.Parameter(ln2, requires_grad=False)
        if attn is not None:
            self.attn = _params(attn)
        if ssm is not None:
            self.ssm = _params(ssm)
        if ffn is not None:
            setattr(self, ffn_name, _params(ffn))


class TransformerLM(nn.Module):
    """``embed`` (V, D), ``blocks``, ``final_norm`` (D,) and, without tied
    embeddings, ``lm_head`` (D, V).  The parameters are created without
    gradients; training turns them on."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor, blocks,
                 final_norm: torch.Tensor,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        _check_family(cfg)
        if (lm_head is None) != cfg.tie_embeddings:
            raise ValueError(f"{cfg.name}: lm_head must be given iff the "
                             "embeddings are not tied")
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=False))


def _ffn_name(cfg: ModelConfig) -> str:
    return "moe" if cfg.n_experts else "mlp"


def _init_block(g: torch.Generator, cfg: ModelConfig, dt: torch.dtype,
                dev: torch.device) -> Block:
    """One layer in JAX's ``init_layer`` order: ``ssm`` alone for an SSM;
    else ``attn``, the hybrid's ``ssm``, then ``moe`` or ``mlp``."""
    ones = lambda: torch.ones((cfg.d_model,), dtype=dt, device=dev)  # noqa: E731
    if cfg.family == "ssm":
        return Block(ones(), ssm=L.init_mamba(g, cfg, dt, dev))
    attn = L.init_attn(g, cfg, dt, dev)
    ssm = L.init_mamba(g, cfg, dt, dev) if cfg.family == "hybrid" else None
    init_ffn = L.init_moe if cfg.n_experts else L.init_mlp
    return Block(ones(), attn, init_ffn(g, cfg, dt, dev), ones(),
                 _ffn_name(cfg), ssm)


def init_lm(cfg: ModelConfig, seed: int = 0, device="cuda") -> TransformerLM:
    """Random parameters on ``device`` from one seeded ``torch.Generator``,
    with the shapes and scales of the JAX ``init_lm``: weights normal times
    ``1/sqrt(fan_in)`` (the MoE router in fp32), the embedding normal
    times 0.02, norms ones, biases zeros; mamba's fp32 ``dt_bias``,
    ``A_log`` and ``D_skip`` as :func:`repro_torch.models.layers.init_mamba`
    makes them."""
    _check_family(cfg)
    dev = resolve_device(device)
    g = generator(dev, seed)
    dt = torch_dtype(cfg.param_dtype)
    ones = lambda: torch.ones((cfg.d_model,), dtype=dt, device=dev)  # noqa: E731
    blocks = [_init_block(g, cfg, dt, dev) for _ in range(cfg.n_layers)]
    embed = L._normal(g, (cfg.vocab, cfg.d_model), 0.02, dt, dev)
    head = (None if cfg.tie_embeddings else L._normal(
        g, (cfg.d_model, cfg.vocab), 1.0 / math.sqrt(cfg.d_model), dt, dev))
    return TransformerLM(cfg, embed, blocks, ones(), head)


def params_from_jax(tree, cfg: ModelConfig, device="cuda") -> TransformerLM:
    """The JAX ``init_lm`` pytree, as NumPy arrays (``{"embed", "blocks":
    {"ln1", ["ln2", "attn": {...}, "mlp" or "moe": {...}], ["ssm":
    {...}]}`` stacked on a leading L axis, ``"final_norm"``,
    [``"lm_head"``]}), as the port's model on ``device``: the L axis
    unstacked, same dtypes, same bits."""
    dev = resolve_device(device)
    bl = tree["blocks"]
    ffn_name = _ffn_name(cfg)

    def layer(name, i):
        if name not in bl:
            return None
        sub = bl[name]
        if not isinstance(sub, dict):
            return _tensor(np.asarray(sub)[i], dev)
        return {k: _tensor(np.asarray(a)[i], dev) for k, a in sub.items()}

    blocks = [Block(layer("ln1", i), layer("attn", i), layer(ffn_name, i),
                    layer("ln2", i), ffn_name, layer("ssm", i))
              for i in range(cfg.n_layers)]
    head = tree.get("lm_head")
    return TransformerLM(cfg, _tensor(tree["embed"], dev), blocks,
                         _tensor(tree["final_norm"], dev),
                         None if head is None else _tensor(head, dev))


# ---------------------------------------------------------------------------
# Sharded storage
# ---------------------------------------------------------------------------


def shard_model(model: nn.Module, mesh: Optional[M.Mesh],
                sharding: str = "fsdp_tp") -> nn.Module:
    """Cuts each leaf of ``model`` (a whole, seeded or carried model) to
    this rank's shard of ``sharding``'s layout on ``mesh``, in place, and
    tags every leaf with its :class:`~repro_torch.distributed.mesh.
    Placement`; the whole tensors are freed.  ``"dp"``, or a mesh outside
    a process group (no groups), leaves the model as it is: every rank
    holds it whole, untagged."""
    if sharding == "dp" or mesh is None or mesh.data_group is None:
        return model
    specs = SP.param_specs(model, mesh, sharding)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if specs[name]:
                p.data = SP.shard_of(p.data, specs[name], mesh).clone(
                    memory_format=torch.contiguous_format)
            p.placement = M.Placement(mesh, specs[name], sharding)
    return model


def _check_whole(model: nn.Module) -> None:
    if any(M.placement(p) is not None for p in model.parameters()):
        raise NotImplementedError(
            "this model holds its rank's shards (shard_model): serve it "
            "through build(..., mesh=) (prefill_sharded, decode_sharded)")


def _on_model(p: torch.Tensor, dim: int) -> bool:
    """Whether ``p`` is a shard whose ``dim`` lies on ``model`` alone."""
    pl = M.placement(p)
    return pl is not None and len(pl.spec) > dim and pl.spec[dim] == "model"


def _tp_group(p: torch.Tensor):
    return M.placement(p).mesh.model_group


def view(sub, keep_model: bool = False) -> Dict[str, torch.Tensor]:
    """A sub-block's leaves as the compute uses them
    (:func:`repro_torch.distributed.collectives.gather_leaf`)."""
    return {k: C.gather_leaf(v, keep_model) for k, v in sub.items()}


def _attn_view(p, cfg: ModelConfig):
    """``(leaves, tp group)``: the model ranks' heads when each holds
    whole q and kv heads, else every leaf whole and no group."""
    mp = M.placement(p["wq"])
    if _on_model(p["wq"], 1) and cfg.n_heads % mp.mesh.model == 0 \
            and cfg.kv_heads % mp.mesh.model == 0:
        return view(p, True), _tp_group(p["wq"])
    return view(p), None


def _in_proj_channels(w: torch.Tensor, mesh: M.Mesh) -> torch.Tensor:
    """``in_proj``'s model shard (D, 2 Di/model) as JAX lays it out (the
    rank's two blocks of the fused columns) -> (D, 2 Di/model) holding
    ``[xi | z]`` of the rank's channels: the blocks sent to their channel
    ranks (:func:`repro_torch.sharding.partition.in_proj_blocks`) by one
    exchange within ``model``, whose backward sends the gradient's columns
    back."""
    n, m = mesh.model, mesh.model_rank
    di = w.shape[1] * n // 2
    mine = sorted(SP.in_proj_blocks(di, n, m), key=lambda b: b[0])
    send = [sum(hi - lo for d, _, lo, hi in mine if d == r)
            for r in range(n)]
    # What each rank sends here, in rank order: xi before z, since xi's
    # block m lies on rank m // 2, below z's block n + m on (n + m) // 2.
    recv = [sum(hi - lo for d, _, lo, hi in SP.in_proj_blocks(di, n, r)
                if d == m) for r in range(n)]
    x = torch.cat([w[:, lo:hi] for _, _, lo, hi in mine], dim=1)
    return C.all_to_all(x, mesh.model_group, 1, send, recv)


def _ssm_view(p):
    """``(leaves, tp group)``: the model ranks' channels when the block's
    channel leaves lie on ``model`` alone (``model`` divides Di), with
    ``in_proj`` exchanged to ``[xi | z]`` of them; else every leaf whole
    and no group."""
    if not _on_model(p["conv_w"], 1):
        return view(p), None
    leaves = view(p, True)
    leaves["in_proj"] = _in_proj_channels(
        leaves["in_proj"], M.placement(p["in_proj"]).mesh)
    return leaves, _tp_group(p["conv_w"])


def _ffn_view(p, model_dim: int):
    if _on_model(p["w1"], model_dim):
        return view(p, True), _tp_group(p["w1"])
    return view(p), None


def _vocab_view(p: torch.Tensor, dim: int):
    """``(table, group, first id)``: this rank's vocab range of ``p`` when
    ``dim`` lies on ``model``, else ``p`` whole."""
    if _on_model(p, dim):
        t = C.gather_leaf(p, True)
        return t, _tp_group(p), M.placement(p).mesh.model_rank * t.shape[dim]
    return C.gather_leaf(p), None, 0


# ---------------------------------------------------------------------------
# Per-layer bodies, embedding and head
# ---------------------------------------------------------------------------


def _layer_forward(blk: Block, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, local_dispatch: bool = False,
                   seq: Optional[M.SeqSplit] = None):
    """Full-sequence layer.  Returns ``(x, aux, cache)``: aux is the MoE's
    load-balance loss (``local_dispatch`` as :func:`layers.moe_block`
    takes it), or ``None`` for a layer without one (JAX's zero);
    cache is this layer's ``{"k", "v"}`` and, for the SSM and hybrid
    families, ``{"conv", "h"}`` (an SSM has no ``k``/``v``).  A sharded
    layer's leaves are gathered here (tensor parallel where they allow
    it).  ``seq``: x holds this rank's positions of a prefill's sequence
    split (the attention and the MoE's dispatch see every rank's)."""
    h = L.rms_norm(x, C.gather_leaf(blk.ln1), cfg.norm_eps)
    if cfg.family == "ssm":
        out, (conv_tail, h_last) = _mamba_forward(blk, cfg, h, seq)
        return x + out, None, {"conv": conv_tail, "h": h_last}
    attn, tp = _attn_view(blk.attn, cfg)
    attn_out, (k, v) = L.attn_block(attn, cfg, h, positions, tp=tp, seq=seq)
    cache = {"k": k, "v": v}
    if cfg.family == "hybrid":
        ssm_out, (conv_tail, h_last) = _mamba_forward(blk, cfg, h, seq)
        attn_out = (attn_out + ssm_out) * 0.5
        cache.update(conv=conv_tail, h=h_last)
    x = x + attn_out
    h2 = L.rms_norm(x, C.gather_leaf(blk.ln2), cfg.norm_eps)
    if cfg.n_experts:
        moe, tp = _ffn_view(blk.moe, 2)
        ff, aux = L.moe_block(moe, cfg, h2, local_dispatch=local_dispatch,
                              tp=tp, seq=seq)
        return x + ff, aux, cache
    mlp, tp = _ffn_view(blk.mlp, 1)
    return x + L.mlp_block(mlp, h2, tp=tp), None, cache


def _mamba_forward(blk: Block, cfg: ModelConfig, h: torch.Tensor,
                   seq: Optional[M.SeqSplit] = None):
    """The layer's mamba block (channel parallel where its view allows).
    Under ``seq`` (h this rank's positions of a sequence split) the block
    gathers the sequence over ``model``, computes it whole and keeps the
    rank's slice: the conv tail and the scan's state run across every
    rank's positions, and the states returned are the sequence's."""
    ssm, tp = _ssm_view(blk.ssm)
    if seq is None:
        return L.mamba_block(ssm, cfg, h, tp=tp)
    whole = C.all_gather(h, seq.mesh.model_group, 1, seq.mesh.model)
    out, states = L.mamba_block(ssm, cfg, whole, tp=tp)
    return out[:, seq.offset:seq.offset + seq.length], states


def _mamba_decode(blk: Block, cfg: ModelConfig, h: torch.Tensor,
                  cache: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The layer's mamba step; its conv and SSM states are written back
    into ``cache["conv"]`` and ``cache["h"]`` in place."""
    out, conv, hs = L.mamba_decode_block(blk.ssm, cfg, h, cache["conv"],
                                         cache["h"])
    cache["conv"].copy_(conv)
    cache["h"].copy_(hs)
    return out


def _layer_decode(blk: Block, cfg: ModelConfig, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor], pos: int) -> torch.Tensor:
    """One-token layer; ``cache`` holds this layer's slices of the decode
    cache (``k``, ``v``, ``conv``, ``h`` as the family has them), updated
    in place."""
    h = L.rms_norm(x, blk.ln1, cfg.norm_eps)
    if cfg.family == "ssm":
        return x + _mamba_decode(blk, cfg, h, cache)
    attn_out, _, _ = L.attn_decode_block(blk.attn, cfg, h, cache["k"],
                                         cache["v"], pos)
    if cfg.family == "hybrid":
        attn_out = (attn_out + _mamba_decode(blk, cfg, h, cache)) * 0.5
    x = x + attn_out
    h2 = L.rms_norm(x, blk.ln2, cfg.norm_eps)
    if cfg.n_experts:
        return x + L.moe_block(blk.moe, cfg, h2, dense_route=True)[0]
    return x + L.mlp_block(blk.mlp, h2)


def _embed(model: TransformerLM, cfg: ModelConfig, tokens: torch.Tensor,
           frontend_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, S) -> (B, S, D) rows of ``embed`` in the compute dtype
    (indexing then casting gives JAX's cast-then-index values).  With
    ``frontend_embeds`` (B, F, D) and a config that has a frontend, those
    embeddings, cast to the compute dtype, replace the first F positions
    (JAX's ``dynamic_update_slice(x, fe, (0, 0, 0))``); an S below F
    raises rather than clamp.  Vocab parallel (``embed``'s rows on
    ``model``), each rank adds its range's rows and zeros for the other
    ids, and the ranks' rows are summed (Megatron's "g")."""
    table, group, lo = _vocab_view(model.embed, 0)
    if group is None:
        x = table[tokens].to(torch_dtype(cfg.compute_dtype))
    else:
        local = tokens - lo
        mine = (local >= 0) & (local < table.shape[0])
        rows = table[local.clamp(0, table.shape[0] - 1)]
        x = torch.where(mine[..., None], rows, rows.new_zeros(()))
        x = C.all_reduce_identity_bwd(
            x.to(torch_dtype(cfg.compute_dtype)), group)
    if frontend_embeds is None or not cfg.n_frontend_tokens:
        return x
    n = frontend_embeds.shape[1]
    if frontend_embeds.shape[0] != x.shape[0] or \
            frontend_embeds.shape[2] != x.shape[2]:
        raise ValueError(f"frontend_embeds {tuple(frontend_embeds.shape)} "
                         f"for tokens {tuple(tokens.shape)} and d_model "
                         f"{x.shape[2]}")
    if n > x.shape[1]:
        raise ValueError(f"a sequence of {x.shape[1]} tokens cannot hold "
                         f"{n} frontend positions")
    return torch.cat([frontend_embeds.to(x.dtype), x[:, n:]], dim=1)


def _logits(model: TransformerLM, cfg: ModelConfig, x: torch.Tensor,
            head: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, S, D) -> (B, S, V) fp32: the head (``head``, by default the
    model's) in x's dtype, the products summed in fp32 (JAX's
    ``preferred_element_type=float32``)."""
    if head is None:
        head = model.embed.t() if model.lm_head is None else model.lm_head
    return x.float() @ head.to(x.dtype).float()


def _head_view(model: nn.Module):
    """``(head (D, V or V/model), group, first id)``: the tied embedding
    or ``lm_head``, vocab parallel where its vocab dim lies on
    ``model``."""
    if model.lm_head is None:
        table, group, lo = _vocab_view(model.embed, 0)
        return table.t(), group, lo
    return _vocab_view(model.lm_head, 1)


# ---------------------------------------------------------------------------
# Backbone and training loss
# ---------------------------------------------------------------------------


def backbone(model: TransformerLM, cfg: ModelConfig, run: RunConfig,
             x: torch.Tensor, positions: torch.Tensor):
    """The layers, each recomputed in the backward under ``remat="full"``,
    then the final norm: x (B, S, D) -> ``(x (B, S, D), aux)``, aux the
    layers' summed load-balance losses over ``n_layers`` (fp32, 0 for a
    dense model)."""

    def layer(blk, x_):
        x_, aux_, _ = _layer_forward(blk, cfg, x_, positions,
                                     run.moe_local_dispatch)
        return x_, aux_

    aux = torch.zeros((), device=x.device)
    for blk in model.blocks:
        if run.remat == "full":
            x, a = checkpoint(layer, blk, x, use_reentrant=False)
        else:
            x, a = layer(blk, x)
        if a is not None:
            aux = aux + a
    return (L.rms_norm(x, model.final_norm, cfg.norm_eps),
            aux / max(cfg.n_layers, 1))


class _VocabLogSumExp(torch.autograd.Function):
    """``logsumexp`` over the last axis of logits split over ``group``'s
    ranks by vocab: the max and the sum of exps over the ranks.  Its
    arithmetic and backward are ``torch.logsumexp``'s (ATen's
    ``logsumexp_out_impl`` and ``logsumexp_backward``), so one rank gives
    its bits; the backward is local (the loss is replicated over the
    group)."""

    @staticmethod
    def forward(ctx, logits, group):
        m = C.all_reduce_max(logits.amax(dim=-1), group)
        m = m.masked_fill(m.abs() == math.inf, 0)
        s = C.all_reduce_identity_bwd((logits - m[..., None]).exp().sum(-1),
                                      group)
        logz = s.log().add(m)
        ctx.save_for_backward(logits, logz)
        return logz

    @staticmethod
    def backward(ctx, grad):
        logits, logz = ctx.saved_tensors
        return grad[..., None] * (logits - logz[..., None]).exp(), None


def _ce(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
        group=None, lo: int = 0):
    """Summed masked negative log-likelihood and the mask's sum.  With
    ``group``, logits hold this rank's vocab range from id ``lo`` (vocab
    parallel): the log-partition over the ranks, and the gold logit
    summed over them (the one rank whose range holds it).  Without, the
    same arithmetic gives ``torch.logsumexp``'s and ``torch.gather``'s
    bits."""
    v = logits.shape[-1]
    logz = _VocabLogSumExp.apply(logits, group)
    local = labels - lo
    mine = (local >= 0) & (local < v)
    gold = torch.gather(logits, -1, local.clamp(0, v - 1)[..., None])[..., 0]
    gold = C.all_reduce_identity_bwd(
        torch.where(mine, gold, gold.new_zeros(())), group)
    return ((logz - gold) * mask).sum(), mask.sum()


def head_loss(model: nn.Module, cfg: ModelConfig, x: torch.Tensor,
              labels: torch.Tensor, chunk: int = 0) -> torch.Tensor:
    """The mean masked cross-entropy of the head over x (B, S, D), fp32:
    labels (B, S) int, labels < 0 masked; chunk by chunk of ``chunk``
    positions when it divides S (and is below it), as JAX's ``lax.scan``
    over chunks does.  A vocab-parallel head takes its input through
    Megatron's "f"."""
    s = x.shape[1]
    mask = (labels >= 0).float()
    labels_c = labels.clamp_min(0).long()
    head, group, lo = _head_view(model)

    def ce(sl):
        xc = C.copy_all_reduce_bwd(x[:, sl], group)
        return _ce(_logits(model, cfg, xc, head), labels_c[:, sl],
                   mask[:, sl], group, lo)

    if chunk and s > chunk and s % chunk == 0:
        num = den = torch.zeros((), device=x.device)
        for i in range(0, s, chunk):
            n, d = ce(slice(i, i + chunk))
            num, den = num + n, den + d
    else:
        num, den = ce(slice(None))
    return num / den.clamp_min(1.0)


def lm_loss(model: TransformerLM, cfg: ModelConfig, run: RunConfig,
            tokens: torch.Tensor, labels: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal LM loss, fp32: tokens/labels (B, S) int; labels < 0 are
    masked; ``frontend_embeds`` as :func:`_embed` takes them.  The logits
    and their cross-entropy go chunk by chunk of ``run.logits_chunk``
    positions when it divides S (and is below it), as JAX's ``lax.scan``
    over chunks does.  An MoE adds ``0.01 * aux``."""
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None, :]
    x, aux = backbone(model, cfg, run,
                      _embed(model, cfg, tokens, frontend_embeds), positions)
    loss = head_loss(model, cfg, x, labels, run.logits_chunk)
    if cfg.n_experts:
        loss = loss + 0.01 * aux
    return loss


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
               device="cuda") -> Dict:
    """Zeroed decode cache with room for ``cache_len`` positions (at most
    the window's for a sliding-window config; no keys for an SSM), plus the
    SSM and hybrid families' conv (compute dtype) and h (fp32) states."""
    _check_family(cfg)
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.compute_dtype)
    n = cfg.n_layers
    cache = {"pos": 0}
    if cfg.family != "ssm":
        cap = (min(cache_len, cfg.window) if cfg.attn_type == "sliding"
               else cache_len)
        shape = (n, batch, cap, cfg.kv_heads, cfg.hd)
        cache["k"] = torch.zeros(shape, dtype=dt, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dt, device=dev)
    if cfg.family in SSM_FAMILIES:
        cache["conv"] = torch.zeros((n, batch, cfg.conv_width - 1,
                                     cfg.inner), dtype=dt, device=dev)
        cache["h"] = torch.zeros((n, batch, cfg.inner, cfg.ssm_state),
                                 dtype=torch.float32, device=dev)
    return cache


@torch.inference_mode()
def prefill(model: TransformerLM, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: Optional[int] = None,
            frontend_embeds: Optional[torch.Tensor] = None):
    """tokens (B, S) on the model's device -> ``(last-token logits (B, V)
    fp32, cache at pos = S)``.  ``cache_len`` is the key cache's capacity
    C, capped at the window for a sliding-window config: above S the cache
    is padded with zeros, below S it keeps the last C keys rotated so that
    slot = pos % C (``transformer.py:266-278``).  The SSM and hybrid
    families also keep each layer's conv tail and last state.
    ``frontend_embeds`` as :func:`_embed` takes them (a VLM's image)."""
    _check_whole(model)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None, :]
    x = _embed(model, cfg, tokens, frontend_embeds)
    cap = cache_len or s
    if cfg.attn_type == "sliding":
        cap = min(cap, cfg.window)
    cache = init_cache(cfg, b, cap, x.dtype, tokens.device)
    for i, blk in enumerate(model.blocks):
        x, _, lc = _layer_forward(blk, cfg, x, positions)
        if "k" in lc:
            cache["k"][i] = _ring(lc["k"], cap)
            cache["v"][i] = _ring(lc["v"], cap)
        if "conv" in lc:
            cache["conv"][i] = lc["conv"]
            cache["h"][i] = lc["h"]
    x = L.rms_norm(x[:, -1:], model.final_norm, cfg.norm_eps)
    cache["pos"] = s
    return _logits(model, cfg, x)[:, 0], cache


@torch.inference_mode()
def decode_step(model: TransformerLM, cfg: ModelConfig, token: torch.Tensor,
                cache: Dict):
    """token (B, 1) -> ``(logits (B, V) fp32, cache)``."""
    return _decode_from(model, cfg, _embed(model, cfg, token), cache)


@torch.inference_mode()
def decode_step_embeds(model: TransformerLM, cfg: ModelConfig,
                       x: torch.Tensor, cache: Dict):
    """Decode from precomputed token embeddings x (B, 1, D) in the compute
    dtype: the tiered-vocab serving entry point, where the row comes from
    the fast-tier buffer (``repro_torch.core.tiered``) instead of the
    resident table."""
    ct = torch_dtype(cfg.compute_dtype)
    if x.dtype != ct:
        raise TypeError(f"decode_step_embeds takes rows in the compute "
                        f"dtype {ct}, got {x.dtype}: cast the store's rows")
    return _decode_from(model, cfg, x, cache)


def _decode_from(model: TransformerLM, cfg: ModelConfig, x: torch.Tensor,
                 cache: Dict):
    _check_whole(model)
    pos = cache["pos"]
    state = [k for k in cache if k != "pos"]
    for i, blk in enumerate(model.blocks):
        x = _layer_decode(blk, cfg, x, {k: cache[k][i] for k in state}, pos)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return _logits(model, cfg, x)[:, 0], {**cache, "pos": pos + 1}


# ---------------------------------------------------------------------------
# Serving over a mesh: each rank's shards, JAX's batch and cache layouts
# ---------------------------------------------------------------------------

def _check_serve(model: nn.Module, mesh: M.Mesh) -> None:
    for p in model.parameters():
        pl = M.placement(p)
        if pl is not None and pl.mesh.shape != mesh.shape:
            raise ValueError(f"a parameter placed on {pl.mesh.shape} served "
                             f"on {mesh.shape}")


def _rows_spec(mesh: M.Mesh, run: RunConfig, shape) -> tuple:
    """The batch's spec (JAX's ``batch_pspecs``) for a (B, S) batch;
    raises unless B splits over every axis of the variant's batch entry
    (JAX would replicate the rows over an axis that does not divide
    them; the port's MoE dispatch and cache layout count each row once)."""
    spec = SP.batch_spec(tuple(shape), mesh, run.sharding)
    want = SP.batch_entry(mesh, run.sharding)
    if SP.axes_of(spec[0] if spec else None) != want:
        raise ValueError(f"a batch of {shape[0]} rows does not split over "
                         f"{want} ({mesh.shape}) under {run.sharding!r}")
    return spec


def _rank_part(t: torch.Tensor, mesh: M.Mesh, run: RunConfig):
    """``(this rank's part of the global batch leaf t (B, S, ...) by
    batch_pspecs, the dim its rows lie over model or None, its sequence
    split or None)``."""
    spec = _rows_spec(mesh, run, tuple(t.shape))
    part = SP.shard_of(t, spec, mesh)
    seq = None
    if len(spec) > 1 and spec[1] == "model":
        n = part.shape[1]
        seq = M.SeqSplit(mesh, mesh.model_rank * n, n)
    return part, (0 if _model_dim(spec[:1]) == 0 else None), seq


def _last_position(x: torch.Tensor, seq: Optional[M.SeqSplit],
                   mesh: M.Mesh) -> torch.Tensor:
    """x (B_r, S_r, D) -> the sequence's last position (B_r, 1, D): this
    rank's, or under a sequence split the last model rank's."""
    last = x[:, -1:]
    if seq is None:
        return last
    if mesh.model_rank != mesh.model - 1:
        last = torch.zeros_like(last)
    return C.all_reduce_(last.contiguous(), mesh.model_group)


def _model_dim(spec) -> Optional[int]:
    """The dim a spec lays over ``model`` (alone or as the minor axis of
    a tuple), or None: replicated over ``model``."""
    for d, e in enumerate(spec):
        if "model" in SP.axes_of(e):
            return d
    return None


def _reshard(x: torch.Tensor, src: Optional[int], dst: Optional[int],
             mesh: M.Mesh) -> torch.Tensor:
    """``x`` split over ``model`` along ``src`` (None: whole on every model
    rank) -> along ``dst``: this rank's part, an all-gather or one
    exchange within ``model``."""
    n = mesh.model
    if src == dst or n == 1:
        return x
    if src is None:
        size = x.shape[dst] // n
        return x.narrow(dst, mesh.model_rank * size, size)
    if dst is None:
        return C.all_gather(x, mesh.model_group, src, n)
    return C.exchange_dims(x, mesh.model_group, n, dst, src)


# The decode state's leaves by family, and the dim of each (one layer's)
# that tensor parallelism splits: the KV heads, the mamba channels.
_SPLIT_DIM = {"k": 2, "v": 2, "conv": 2, "h": 1}


def _state_dim(name: str, t: torch.Tensor, cfg: ModelConfig,
               rows_dim: Optional[int]) -> Optional[int]:
    """Where a layer's computed state ``name`` lies over ``model``: its KV
    heads or mamba channels (tensor parallel), else the batch's rows
    (``"fsdp"``), else nowhere (whole on every model rank)."""
    d = _SPLIT_DIM[name]
    whole = cfg.kv_heads if name in ("k", "v") else cfg.inner
    return d if t.shape[d] != whole else rows_dim


def _cache_layout(cfg: ModelConfig, b: int, cap: int, mesh: M.Mesh,
                  run: RunConfig) -> Dict[str, tuple]:
    """``{leaf: (one layer's whole shape, its cache_spec, the dim it lies
    over model or None)}`` for the family's decode state."""
    shapes = {}
    if cfg.family != "ssm":
        shapes["k"] = shapes["v"] = (b, cap, cfg.kv_heads, cfg.hd)
    if cfg.family in SSM_FAMILIES:
        shapes["conv"] = (b, cfg.conv_width - 1, cfg.inner)
        shapes["h"] = (b, cfg.inner, cfg.ssm_state)
    out = {}
    for name, shape in shapes.items():
        spec = SP.cache_spec(name, shape, mesh, run.shard_kv_seq)
        out[name] = (shape, spec, _model_dim(spec))
    return out


def _ring(kv: torch.Tensor, cap: int) -> torch.Tensor:
    """(B, S, K, hd) -> the ring of ``cap`` slots at pos = S: the last
    ``cap`` keys rotated so slot = pos % cap, or zeros past S."""
    s = kv.shape[1]
    if s > cap:
        return torch.roll(kv[:, s - cap:], s % cap, dims=1)
    out = kv.new_zeros((kv.shape[0], cap) + tuple(kv.shape[2:]))
    out[:, :s] = kv
    return out


def _serve_logits(model: TransformerLM, cfg: ModelConfig,
                  x: torch.Tensor, mesh: M.Mesh) -> torch.Tensor:
    """x (B_r, 1, D) after the final norm -> logits (B_r, V) fp32 over the
    whole vocab (a vocab-parallel head's parts gathered over ``model``)."""
    head, group, _ = _head_view(model)
    logits = _logits(model, cfg, x, head)[:, 0]
    return logits if group is None else C.all_gather(
        logits, group, 1, mesh.model)


@torch.inference_mode()
def prefill_sharded(model: TransformerLM, cfg: ModelConfig, run: RunConfig,
                    mesh: M.Mesh, tokens: torch.Tensor,
                    cache_len: Optional[int] = None,
                    frontend_embeds: Optional[torch.Tensor] = None):
    """:func:`prefill` on this rank's shards (``shard_model`` under
    ``run.sharding``, or whole under ``"dp"``) of a model served over
    ``mesh``.  tokens (B, S) and ``frontend_embeds`` are the global
    batch; the rank computes its part by ``batch_pspecs``: its rows over
    the data axes (and ``model`` under ``"fsdp"``) and, under
    ``"fsdp_seq"`` where ``model`` divides S, its positions ``[m S/model,
    (m+1) S/model)`` (rope at the absolute positions, the frontend's
    rows spliced where they fall, K/V gathered over ``model`` each layer,
    the queries at their offset, the MoE's dispatch over every rank's
    tokens, the last position's hidden row taken from the last model
    rank).  Returns ``(logits (B_r, V) fp32 of the rank's rows, the rank's
    part of the cache)``: k/v (L, B_c, C_c, K_c, hd) laid out by
    ``cache_pspecs(run.shard_kv_seq)``, reached from the layout that
    computed them by one exchange or slice within ``model``; ``"pos"``
    and the ring's whole capacity ``"cap"`` are Python ints."""
    _check_serve(model, mesh)
    b, s = tokens.shape
    toks, rows_dim, seq = _rank_part(tokens, mesh, run)
    lo = seq.offset if seq else 0
    positions = torch.arange(lo, lo + toks.shape[1],
                             device=tokens.device)[None, :]
    fe = None
    if frontend_embeds is not None and cfg.n_frontend_tokens:
        fe = SP.shard_of(frontend_embeds, _rows_spec(mesh, run, (b, s))[:1],
                         mesh)[:, lo:lo + toks.shape[1]]
        fe = fe if fe.shape[1] else None
    cap = cache_len or s
    if cfg.attn_type == "sliding":
        cap = min(cap, cfg.window)
    layout = _cache_layout(cfg, b, cap, mesh, run)
    with M.activation_sharding(mesh, run.sharding):
        x = _embed(model, cfg, toks, fe)
        cache = {"pos": s, "cap": cap}
        for name, (shape, spec, _) in layout.items():
            dt = torch.float32 if name == "h" else x.dtype
            cache[name] = x.new_zeros(
                (cfg.n_layers,) + SP.shard_shape(shape, spec, mesh), dtype=dt)
        for i, blk in enumerate(model.blocks):
            x, _, lc = _layer_forward(blk, cfg, x, positions,
                                      run.moe_local_dispatch, seq)
            for name, (_, _, dst) in layout.items():
                t = _ring(lc[name], cap) if name in ("k", "v") else lc[name]
                cache[name][i] = _reshard(
                    t, _state_dim(name, t, cfg, rows_dim), dst, mesh)
        last = L.rms_norm(_last_position(x, seq, mesh),
                          C.gather_leaf(model.final_norm), cfg.norm_eps)
        return _serve_logits(model, cfg, last, mesh), cache


def _attn_decode_sharded(blk: Block, cfg: ModelConfig, h: torch.Tensor,
                         cache: Dict[str, torch.Tensor], pos: int,
                         mesh: M.Mesh, rows_dim: Optional[int],
                         dst: Optional[int]) -> torch.Tensor:
    """One token's self-attention on this rank's part of the cache, in
    place.  q/k/v are computed where the layer's view puts them (the rank's
    heads, its rows, or whole), then brought to the cache's layout (its
    model dim ``dst``): the cache's rows, and the rank's KV heads (heads
    over ``model``) or every head (slots over ``model``, or a cache whole
    over it).  With the slots over ``model`` the new key goes to the rank
    owning slot ``pos % C`` and the ranks' attentions are combined by
    :func:`layers.decode_attention_sharded`.  The output goes back to the
    view's layout for ``wo``."""
    attn, tp = _attn_view(blk.attn, cfg)
    positions = torch.full((1,), pos, dtype=torch.int64, device=h.device)
    q, k, v = L._qkv(attn, cfg, h, positions)
    src = _state_dim("k", k, cfg, rows_dim)
    at = 2 if dst == 2 else None
    q, k, v = (_reshard(t, src, at, mesh) for t in (q, k, v))
    kc, vc = cache["k"], cache["v"]
    c_r = kc.shape[1]
    if dst == 1:  # the ring's slots over model
        slot = pos % (c_r * mesh.model)
        first = mesh.model_rank * c_r
        if first <= slot < first + c_r:
            kc[:, slot - first] = k[:, 0]
            vc[:, slot - first] = v[:, 0]
        o = L.decode_attention_sharded(q, kc, vc,
                                       min(pos + 1, c_r * mesh.model), first,
                                       mesh.model_group)
    else:
        slot = pos % c_r if c_r > 0 else 0
        kc[:, slot] = k[:, 0]
        vc[:, slot] = v[:, 0]
        o = L.decode_attention(q, kc, vc, pos + 1)
    o = _reshard(o, at, src, mesh)
    out = o.reshape(*o.shape[:2], -1) @ attn["wo"]
    return C.all_reduce_identity_bwd(out, tp)


def _mamba_decode_sharded(blk: Block, cfg: ModelConfig, h: torch.Tensor,
                          cache: Dict[str, torch.Tensor], mesh: M.Mesh,
                          rows_dim: Optional[int],
                          dims: Dict[str, Optional[int]]) -> torch.Tensor:
    """One token's mamba step on this rank's part of the conv and SSM
    states (channels over ``model`` where ``cache_pspecs`` puts them),
    written back in place: channel parallel when the block's view is, on
    the rank's channels; else the whole block on the cache's rows, the
    states gathered over ``model`` and the rank's channels kept."""
    ssm, tp = _ssm_view(blk.ssm)
    conv, hs = cache["conv"], cache["h"]
    if tp is not None:  # the view's channels are the cache's
        out, conv_new, h_new = L.mamba_decode_block(ssm, cfg, h, conv, hs,
                                                    tp)
        conv.copy_(conv_new)
        hs.copy_(h_new)
        return out
    out, conv_new, h_new = L.mamba_decode_block(
        ssm, cfg, _reshard(h, rows_dim, None, mesh),
        _reshard(conv, dims["conv"], None, mesh),
        _reshard(hs, dims["h"], None, mesh))
    conv.copy_(_reshard(conv_new, None, dims["conv"], mesh))
    hs.copy_(_reshard(h_new, None, dims["h"], mesh))
    return _reshard(out, None, rows_dim, mesh)


@torch.inference_mode()
def decode_sharded(model: TransformerLM, cfg: ModelConfig, run: RunConfig,
                   mesh: M.Mesh, token: torch.Tensor, cache: Dict):
    """:func:`decode_step` on this rank's shards and its part of the cache
    (:func:`prefill_sharded`'s): token (B, 1) the global batch, of which
    the rank computes its rows (``batch_pspecs``; a one-position step is
    never split by sequence).  The cache is written in place and returned
    with ``pos + 1``; the logits (B_r, V) fp32 are the rank's rows'."""
    _check_serve(model, mesh)
    b = token.shape[0]
    tok, rows_dim, _ = _rank_part(token, mesh, run)
    pos = cache["pos"]
    dims = {name: dim for name, (_, _, dim) in _cache_layout(
        cfg, b, cache["cap"], mesh, run).items()}
    state = list(dims)
    with M.activation_sharding(mesh, run.sharding):
        x = _embed(model, cfg, tok)
        for i, blk in enumerate(model.blocks):
            lc = {k: cache[k][i] for k in state}
            h = L.rms_norm(x, C.gather_leaf(blk.ln1), cfg.norm_eps)
            if cfg.family == "ssm":
                x = x + _mamba_decode_sharded(blk, cfg, h, lc, mesh,
                                              rows_dim, dims)
                continue
            out = _attn_decode_sharded(blk, cfg, h, lc, pos, mesh, rows_dim,
                                       dims["k"])
            if cfg.family == "hybrid":
                out = (out + _mamba_decode_sharded(blk, cfg, h, lc, mesh,
                                                   rows_dim, dims)) * 0.5
            x = x + out
            h2 = L.rms_norm(x, C.gather_leaf(blk.ln2), cfg.norm_eps)
            if cfg.n_experts:
                moe, tp = _ffn_view(blk.moe, 2)
                x = x + L.moe_block(moe, cfg, h2, dense_route=True,
                                    tp=tp)[0]
            else:
                mlp, tp = _ffn_view(blk.mlp, 1)
                x = x + L.mlp_block(mlp, h2, tp=tp)
        x = L.rms_norm(x, C.gather_leaf(model.final_norm), cfg.norm_eps)
        return _serve_logits(model, cfg, x, mesh), {**cache, "pos": pos + 1}
