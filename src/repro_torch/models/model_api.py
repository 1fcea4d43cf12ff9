"""Facade tying configs to model functions: ``build(cfg)``.

Counterpart of ``src/repro/models/model_api.py``.  The bundle is bound to a
device (``"cuda"`` by default): each of its functions resolves it when
called, so on a machine without CUDA they raise unless the bundle was
built with ``device="cpu"``.  Every family of the JAX package: the LMs
``dense``, ``moe``, ``vlm``, ``ssm`` and ``hybrid`` (``init``, ``loss`` =
``lm_loss`` under the bundle's ``RunConfig``, ``prefill``, ``decode``;
``loss`` and ``prefill`` pass the batch's ``"frontend"``, when it has one,
as the VLM's frontend embeddings), the encoder-decoder LM (``enc_dec``:
``encdec_loss``, ``encdec_prefill`` and ``encdec_decode_step``, ``loss``
and ``prefill`` reading the audio frames from ``batch["frontend"]``) and
``dlrm`` (``init``, ``loss`` = ``dlrm_loss``, ``prefill`` = the forward;
both take ``RunConfig.dlrm_sharded_lookup``, as JAX's do: the
row-sharded lookup on the active mesh).
``n_params`` and ``n_active_params`` count from the config without
allocating, ``param_struct`` builds the parameters on the ``meta`` device
(shapes and dtypes, JAX's ``eval_shape`` of ``init``), and
``batch_struct`` gives a shape cell's batch as ``{name: (shape,
dtype)}`` and ``cache_struct`` its decode cache on the ``meta`` device
(JAX's names and stacked shapes: ``k``, ``v``, ``xk``, ``xv``, ``conv``,
``h`` (L, ...) and a 0-d int32 ``pos``).

``build(..., mesh=)`` makes ``init`` give this rank's shards of an LM or
of the encoder-decoder LM: the whole model drawn from the seed, then cut by
:func:`repro_torch.models.transformer.shard_model` under
``run.sharding`` (``"dp"`` under ``run.grad_compression``: the
compressed all-reduce takes whole gradients), so every rank's shard has
the bits of the same whole model.  DLRM's ``init`` gives the rank its rows
of ``run.emb_rows``'s layout (:func:`repro_torch.models.dlrm.init_placed`,
the MLPs whole) under ``"fsdp_tp"``, ``"tp"`` and ``"fsdp"`` (whose
batch splits over both axes: the lookup gathers the ids over every axis
both the rows and the batch lie on); under ``"dp"`` (and so under
``run.grad_compression``) the tables stay whole.

With a mesh inside a process group, an LM's ``prefill(params, batch,
cache_len)`` and ``decode(params, token, cache)`` serve this rank's
shards (:func:`repro_torch.models.transformer.prefill_sharded` and
``decode_sharded``; whisper's :func:`repro_torch.models.encdec.
encdec_prefill_sharded` and ``encdec_decode_sharded``): the batch is the
global one, of which the rank computes its part by ``batch_pspecs`` (the
sequence split under ``"fsdp_seq"``), and the cache is the rank's part by
``cache_pspecs(run.shard_kv_seq)``; the logits are the rank's rows'.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.mesh import Mesh
from repro_torch.models import dlrm as D
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T


def _on(x, dev: torch.device, dtype=None) -> torch.Tensor:
    """``x`` (array or tensor) as a tensor on ``dev``."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=dev, dtype=dtype)


@dataclass
class ModelBundle:
    cfg: ModelConfig
    device: str
    init: Callable[..., Any]  # init(seed=0) -> params on the device
    loss: Callable[..., Any]  # loss(params, batch) -> scalar fp32
    prefill: Callable[..., Any]  # prefill(params, batch[, cache_len])
    decode: Optional[Callable[..., Any]]  # decode(params, token, cache)
    n_params: Callable[[], int]
    # The MoE's experts count at top_k / n_experts; equal to n_params else.
    n_active_params: Callable[[], int]
    param_struct: Callable[[], Any]  # the parameters on the meta device
    run: RunConfig = RunConfig()

    def cache_struct(self, shape: ShapeConfig) -> Optional[Dict]:
        """The decode cache of one shape cell on the ``meta`` device: JAX's
        ``cache_struct`` (the cache of ``shape.global_batch`` rows and
        ``shape.seq_len`` slots, a sliding window's capped), ``pos`` a 0-d
        int32 tensor; None for DLRM."""
        cfg, b, c = self.cfg, shape.global_batch, shape.seq_len
        if cfg.family == "dlrm":
            return None
        cache = (ED.init_encdec_cache(cfg, b, c, device="meta")
                 if cfg.enc_dec else T.init_cache(cfg, b, c, device="meta"))
        cache["pos"] = torch.zeros((), dtype=torch.int32, device="meta")
        return cache

    def batch_struct(self, shape: ShapeConfig
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """The batch of one shape cell as ``{name: (shape, dtype)}``, JAX's
        ``batch_struct`` without its JAX types."""
        cfg, b = self.cfg, shape.global_batch
        if cfg.family == "dlrm":
            d = {"dense": ((b, cfg.dense_features), torch.float32),
                 "sparse": ((b, cfg.n_tables, cfg.multi_hot), torch.int32)}
            if shape.kind == "train":
                d["label"] = ((b,), torch.float32)
            return d
        if shape.kind == "decode":
            return {"token": ((b, 1), torch.int32)}
        d = {"tokens": ((b, shape.seq_len), torch.int32)}
        if shape.kind == "train":
            d["labels"] = ((b, shape.seq_len), torch.int32)
        if cfg.frontend == "vision":
            d["frontend"] = ((b, cfg.n_frontend_tokens, cfg.d_model),
                             D.torch_dtype(cfg.compute_dtype))
        elif cfg.frontend == "audio":
            d["frontend"] = ((b, cfg.enc_len, cfg.d_model),
                             D.torch_dtype(cfg.compute_dtype))
        return d


def _lm_n_params(cfg: ModelConfig, active: bool = False) -> int:
    """Parameter count of :func:`repro_torch.models.transformer.init_lm`'s
    shapes, computed without allocating them.  ``active``: each of an
    MoE's three expert weights, stacked over the layers, counts at
    ``int(n * top_k / n_experts)`` as JAX's ``n_active_params`` counts it;
    the router counts fully.  An SSM layer is ``ln1`` and a mamba block; a
    hybrid layer adds a mamba block to the attention layer."""
    d, h, n_kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd,
                         cfg.d_ff)
    di, n, r = cfg.inner, cfg.ssm_state, cfg.dtrank
    # in_proj, conv_w + conv_b, x_proj, dt_proj + dt_bias, A_log, D_skip,
    # out_proj.
    mamba = (d * 2 * di + (cfg.conv_width + 1) * di + di * (r + 2 * n)
             + (r + 1) * di + di * n + di + di * d)
    head = 0 if cfg.tie_embeddings else d * cfg.vocab
    if cfg.family == "ssm":
        return cfg.n_layers * (d + mamba) + cfg.vocab * d + d + head
    attn = 2 * d * h * hd + 2 * d * n_kv * hd
    if cfg.qkv_bias:
        attn += (h + 2 * n_kv) * hd
    if cfg.qk_norm:
        attn += 2 * hd
    per_layer = attn + 2 * d
    if cfg.family == "hybrid":
        per_layer += mamba
    experts = 0
    if cfg.n_experts:
        per_layer += d * cfg.n_experts  # the router
        experts = cfg.n_layers * cfg.n_experts * d * cfg.expert_ff
        if active:
            experts = int(experts * cfg.top_k / cfg.n_experts)
        experts *= 3
    else:
        per_layer += 3 * d * f
    return cfg.n_layers * per_layer + experts + cfg.vocab * d + d + head


def _encdec_n_params(cfg: ModelConfig) -> int:
    """Parameter count of :func:`repro_torch.models.encdec.init_encdec`'s
    shapes: encoder layers of two norms, self-attention and the ungated
    MLP; decoder layers adding a norm and the cross-attention (no biases,
    no qk norms); the embedding, ``lm_head`` and the two final norms."""
    d, h, n_kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd
    cross = 2 * d * h * hd + 2 * d * n_kv * hd
    attn = cross + (h + 2 * n_kv) * hd * cfg.qkv_bias + 2 * hd * cfg.qk_norm
    mlp = 2 * d * cfg.d_ff
    return (cfg.n_enc_layers * (2 * d + attn + mlp)
            + cfg.n_layers * (3 * d + attn + cross + mlp)
            + 2 * cfg.vocab * d + 2 * d)


def _dlrm_n_params(cfg: ModelConfig) -> int:
    def mlp(dims):
        return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    return (cfg.n_tables * cfg.rows_per_table * cfg.emb_dim
            + mlp((cfg.dense_features,) + tuple(cfg.bottom_mlp))
            + mlp((cfg.emb_dim + D.num_interactions(cfg),)
                  + tuple(cfg.top_mlp)))


def build(cfg: ModelConfig, device="cuda",
          run: Optional[RunConfig] = None,
          mesh: Optional[Mesh] = None) -> ModelBundle:
    run = run or RunConfig()
    common = dict(cfg=cfg, device=device, run=run)
    sharding = "dp" if run.grad_compression else run.sharding
    served = mesh is not None and mesh.data_group is not None

    def sharded(init):
        return lambda seed=0: T.shard_model(init(seed), mesh, sharding)

    if cfg.family == "dlrm":
        def loss(params, batch):
            dev = resolve_device(device)
            return D.dlrm_loss(params, cfg, _on(batch["dense"], dev),
                               _on(batch["sparse"], dev),
                               _on(batch["label"], dev, torch.float32),
                               run.dlrm_sharded_lookup)

        def serve(params, batch):
            dev = resolve_device(device)
            return D.dlrm_forward(params, cfg, _on(batch["dense"], dev),
                                  _on(batch["sparse"], dev),
                                  run.dlrm_sharded_lookup)

        def dlrm_init(seed=0):
            if mesh is None or mesh.data_group is None or sharding == "dp":
                return D.init_dlrm(cfg, seed, device)
            return D.init_placed(cfg, seed, device, mesh, sharding,
                                 run.emb_rows)

        return ModelBundle(
            init=dlrm_init, loss=loss, prefill=serve, decode=None,
            n_params=lambda: _dlrm_n_params(cfg),
            n_active_params=lambda: _dlrm_n_params(cfg),
            param_struct=lambda: D.init_dlrm(cfg, 0, "meta"), **common)

    if cfg.enc_dec:
        def ed_loss(params, batch):
            dev = resolve_device(device)
            return ED.encdec_loss(params, cfg, run,
                                  _on(batch["tokens"], dev, torch.int64),
                                  _on(batch["labels"], dev, torch.int64),
                                  _on(batch["frontend"], dev))

        def ed_prefill(params, batch, cache_len=None):
            dev = resolve_device(device)
            tokens = _on(batch["tokens"], dev, torch.int64)
            frames = _on(batch["frontend"], dev)
            if served:
                return ED.encdec_prefill_sharded(params, cfg, run, mesh,
                                                 tokens, frames, cache_len)
            return ED.encdec_prefill(params, cfg, tokens, frames, cache_len)

        def ed_decode(params, token, cache):
            dev = resolve_device(device)
            token = _on(token, dev, torch.int64)
            if served:
                return ED.encdec_decode_sharded(params, cfg, run, mesh,
                                                token, cache)
            return ED.encdec_decode_step(params, cfg, token, cache)

        return ModelBundle(
            init=sharded(lambda seed: ED.init_encdec(cfg, seed, device)),
            loss=ed_loss, prefill=ed_prefill, decode=ed_decode,
            n_params=lambda: _encdec_n_params(cfg),
            n_active_params=lambda: _encdec_n_params(cfg),
            param_struct=lambda: ED.init_encdec(cfg, 0, "meta"), **common)

    if cfg.family not in T.FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r}: the port has DLRM, the encoder-decoder "
            f"LM and the LM families {T.FAMILIES}")

    def frontend(batch, dev):
        fe = batch.get("frontend")
        return None if fe is None else _on(fe, dev)

    def loss(params, batch):
        dev = resolve_device(device)
        return T.lm_loss(params, cfg, run,
                         _on(batch["tokens"], dev, torch.int64),
                         _on(batch["labels"], dev, torch.int64),
                         frontend(batch, dev))

    def prefill_fn(params, batch, cache_len=None):
        dev = resolve_device(device)
        tokens = _on(batch["tokens"], dev, torch.int64)
        if served:
            return T.prefill_sharded(params, cfg, run, mesh, tokens,
                                     cache_len, frontend(batch, dev))
        return T.prefill(params, cfg, tokens, cache_len,
                         frontend(batch, dev))

    def decode_fn(params, token, cache):
        dev = resolve_device(device)
        token = _on(token, dev, torch.int64)
        if served:
            return T.decode_sharded(params, cfg, run, mesh, token, cache)
        return T.decode_step(params, cfg, token, cache)

    return ModelBundle(
        init=sharded(lambda seed: T.init_lm(cfg, seed, device)),
        loss=loss, prefill=prefill_fn, decode=decode_fn,
        n_params=lambda: _lm_n_params(cfg),
        n_active_params=lambda: _lm_n_params(cfg, active=True),
        param_struct=lambda: T.init_lm(cfg, 0, "meta"), **common)

