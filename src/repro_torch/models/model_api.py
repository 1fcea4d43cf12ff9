"""Facade tying configs to model functions: ``build(cfg)``.

Counterpart of ``src/repro/models/model_api.py``.  The bundle is bound to a
device (``"cuda"`` by default): each of its functions resolves it when
called, so on a machine without CUDA they raise unless the bundle was
built with ``device="cpu"``.  Ported families: ``dense`` (``init``,
``loss`` = ``lm_loss`` under the bundle's ``RunConfig``, ``prefill``,
``decode``) and ``dlrm`` (``init``, ``loss`` = ``dlrm_loss``, ``prefill`` =
the forward).  Every other family (encoder-decoder, MoE, SSM, hybrid, VLM)
raises ``NotImplementedError`` naming ROADMAP A11c.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.device import resolve_device
from repro_torch.models import dlrm as D
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


def _lm_n_params(cfg: ModelConfig) -> int:
    """Parameter count of :func:`repro_torch.models.transformer.init_lm`'s
    shapes, computed without allocating them."""
    d, h, n_kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd,
                         cfg.d_ff)
    attn = 2 * d * h * hd + 2 * d * n_kv * hd
    if cfg.qkv_bias:
        attn += (h + 2 * n_kv) * hd
    if cfg.qk_norm:
        attn += 2 * hd
    per_layer = attn + 3 * d * f + 2 * d
    head = 0 if cfg.tie_embeddings else d * cfg.vocab
    return cfg.n_layers * per_layer + cfg.vocab * d + d + head


def _dlrm_n_params(cfg: ModelConfig) -> int:
    def mlp(dims):
        return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    return (cfg.n_tables * cfg.rows_per_table * cfg.emb_dim
            + mlp((cfg.dense_features,) + tuple(cfg.bottom_mlp))
            + mlp((cfg.emb_dim + D.num_interactions(cfg),)
                  + tuple(cfg.top_mlp)))


def build(cfg: ModelConfig, device="cuda",
          run: Optional[RunConfig] = None) -> ModelBundle:
    run = run or RunConfig()
    if cfg.family == "dlrm":
        def loss(params, batch):
            dev = resolve_device(device)
            return D.dlrm_loss(params, cfg, _on(batch["dense"], dev),
                               _on(batch["sparse"], dev),
                               _on(batch["label"], dev, torch.float32))

        def serve(params, batch):
            dev = resolve_device(device)
            return D.dlrm_forward(params, cfg, _on(batch["dense"], dev),
                                  _on(batch["sparse"], dev))

        return ModelBundle(
            cfg=cfg, device=device,
            init=lambda seed=0: D.init_dlrm(cfg, seed, device),
            loss=loss, prefill=serve, decode=None,
            n_params=lambda: _dlrm_n_params(cfg))

    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: the port has the dense LM and DLRM "
            "only (MoE, SSM, hybrid, encoder-decoder, VLM: ROADMAP A11c)")

    def loss(params, batch):
        dev = resolve_device(device)
        return T.lm_loss(params, cfg, run,
                         _on(batch["tokens"], dev, torch.int64),
                         _on(batch["labels"], dev, torch.int64))

    def prefill_fn(params, batch, cache_len=None):
        dev = resolve_device(device)
        return T.prefill(params, cfg, _on(batch["tokens"], dev, torch.int64),
                         cache_len)

    def decode_fn(params, token, cache):
        dev = resolve_device(device)
        return T.decode_step(params, cfg, _on(token, dev, torch.int64), cache)

    return ModelBundle(
        cfg=cfg, device=device,
        init=lambda seed=0: T.init_lm(cfg, seed, device),
        loss=loss, prefill=prefill_fn, decode=decode_fn,
        n_params=lambda: _lm_n_params(cfg))

