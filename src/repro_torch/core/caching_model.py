"""RecMG caching model (paper §V-A).

Ported from ``src/repro/core/caching_model.py`` (lines 1-167), batch-first:
the JAX package writes the model for one window and ``vmap``s it; here
every function takes (B, T) inputs.  The parameters live in
:class:`CachingModel`, whose state-dict keys are the JAX tree's paths
(``table_emb``, ``enc.w``, ``attn.wa``, ``w_out``, ...), so
:func:`repro_torch.core.lstm.params_from_jax` carries a JAX tree over
one to one.  Every LSTM step runs :func:`repro_torch.kernels.ops.lstm_cell`
(the CUDA kernel on the card).

One seq2seq LSTM stack + attention, ~37K params.  Input: a chunk of prior
accesses; output: a *binary* priority per input element (1 = keep in buffer
with high priority) — the paper's key labeling trick that collapses the
billion-way placement problem to two labels.  Trained with cross-entropy
against Belady/optgen keep bits.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.core import lstm as LS
from repro_torch.core.features import ROW_BUCKETS, WindowData
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamW, OptConfig

# Window fields fed to the models, by batch key.
_X_FIELDS = (("xt", "x_table"), ("xr1", "x_row1"), ("xr2", "x_row2"),
             ("xn", "x_norm"), ("xf", "x_freq"), ("xrc", "x_rec"))
_INT_KEYS = ("xt", "xr1", "xr2", "wt", "wr1", "wr2", "page", "off")


@dataclass(frozen=True)
class CachingModelConfig:
    n_tables: int = 856
    table_emb: int = 8
    row_emb: int = 8
    hidden: int = 40
    in_len: int = 15
    n_scalar: int = 3  # normalized id + online log-freq + log-recency


class CachingModel(nn.Module):
    """The caching model's parameters, drawn from a ``torch.Generator``
    seeded with ``seed`` (the JAX package draws from ``PRNGKey(seed)``:
    same distributions, other numbers)."""

    def __init__(self, cfg: CachingModelConfig, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        f = cfg.table_emb + 2 * cfg.row_emb + cfg.n_scalar
        hid = cfg.hidden
        self.table_emb = nn.Parameter(
            torch.randn(cfg.n_tables, cfg.table_emb, generator=gen) * 0.1)
        self.row_emb1 = nn.Parameter(
            torch.randn(ROW_BUCKETS[0], cfg.row_emb, generator=gen) * 0.1)
        self.row_emb2 = nn.Parameter(
            torch.randn(ROW_BUCKETS[1], cfg.row_emb, generator=gen) * 0.1)
        self.enc = LS.lstm_init(LS.LSTMLayer(f, hid), gen)
        self.dec = LS.lstm_init(LS.LSTMLayer(2 * hid, hid), gen)
        self.attn = LS.attn_init(LS.Attention(hid), gen)
        self.w_out = nn.Parameter(
            torch.randn(2 * hid, generator=gen) / math.sqrt(2 * hid))
        self.b_out = nn.Parameter(torch.zeros(()))


def window_tensors(data: WindowData, device, with_labels: bool = True
                   ) -> Dict[str, torch.Tensor]:
    """A window set's inputs (and keep labels) as tensors on ``device``:
    int64 ids, fp32 scalars."""
    out = {}
    for key, field in _X_FIELDS:
        a = np.asarray(getattr(data, field))
        out[key] = torch.from_numpy(a.astype(np.int64) if key in _INT_KEYS
                                    else a.astype(np.float32)).to(device)
    if with_labels and data.y_keep is not None:
        out["y"] = torch.from_numpy(
            np.asarray(data.y_keep, np.float32)).to(device)
    return out


def _featurize(m: CachingModel, xt, xr1, xr2, xn, xf, xrc):
    """(B, T) ids and scalars -> (B, T, f) embeddings."""
    return torch.cat([m.table_emb[xt], m.row_emb1[xr1], m.row_emb2[xr2],
                      xn[..., None], xf[..., None], xrc[..., None]], dim=-1)


def caching_logits(m: CachingModel, xt, xr1, xr2, xn, xf, xrc):
    """(B, T) windows -> (B, T) per-element keep logits.  Each decoder step
    attends with the decoder's previous h, steps on ``[enc_h_t, ctx]`` and
    reads its logit from ``[h', ctx]``."""
    feats = _featurize(m, xt, xr1, xr2, xn, xf, xrc)
    enc_hs, (h, c) = LS.lstm_seq(m.enc, feats)
    logits = []
    for t in range(enc_hs.shape[1]):
        ctx = LS.attend(m.attn, h, enc_hs)
        (h, c), _ = LS.lstm_step(m.dec, (h, c),
                                 torch.cat([enc_hs[:, t], ctx], dim=-1))
        logits.append(torch.cat([h, ctx], dim=-1) @ m.w_out + m.b_out)
    return torch.stack(logits, dim=1)


def _logits_of(m: CachingModel, batch: Mapping[str, torch.Tensor]):
    return caching_logits(m, *(batch[k] for k, _ in _X_FIELDS))


def bce_loss(m: CachingModel, batch: Mapping[str, torch.Tensor]):
    logits = _logits_of(m, batch)
    y = batch["y"]
    # Stable sigmoid BCE (the paper's cross-entropy over {keep, evict}).
    loss = (torch.clamp(logits, min=0) - logits * y
            + torch.log1p(torch.exp(-logits.abs())))
    return loss.mean()


def opt_config(lr: float, total: int) -> OptConfig:
    """The training loops' optimizer: no weight decay, warmup of a tenth
    of the steps (1..50)."""
    return OptConfig(lr=lr, weight_decay=0.0,
                     warmup_steps=max(1, min(50, total // 10)),
                     total_steps=total)


def train_step(m: nn.Module, opt: AdamW, loss_fn, batch) -> torch.Tensor:
    """One update; returns the detached loss (no host sync)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(m, batch)
    loss.backward()
    opt.step()
    return loss.detach()


def _batch(tensors: Mapping[str, torch.Tensor], idx: np.ndarray):
    i = torch.from_numpy(np.asarray(idx, np.int64)).to(
        next(iter(tensors.values())).device)
    return {k: v[i] for k, v in tensors.items()}


def train_caching_model(data: WindowData, cfg: CachingModelConfig,
                        epochs: int = 3, batch_size: int = 256,
                        lr: float = 3e-3, seed: int = 0, log=None,
                        device="cuda"):
    """Train from ``seed`` on ``device``: the JAX loop's batches (the same
    NumPy permutation per epoch, full batches only) and optimizer.
    Returns ``(model, losses)``."""
    device = resolve_device(device)
    m = CachingModel(cfg, seed).to(device)
    total = max(2, epochs * (len(data) // batch_size))
    opt = AdamW(m.parameters(), opt_config(lr, total))
    tensors = window_tensors(data, device)
    rng = np.random.default_rng(seed)
    losses = []
    for ep in range(epochs):
        idx = rng.permutation(len(data))
        ep_losses = [train_step(m, opt, bce_loss,
                                _batch(tensors, idx[i: i + batch_size]))
                     for i in range(0, len(idx) - batch_size + 1,
                                    batch_size)]
        if ep_losses:
            losses.extend(torch.stack(ep_losses).cpu().tolist())
        if log:
            log(f"caching epoch {ep}: loss {np.mean(losses[-50:]):.4f}")
    return m, losses


@torch.no_grad()
def logits_for(m: CachingModel, data: WindowData,
               batch_size: int = 4096) -> np.ndarray:
    """(N, T) fp32 keep logits of every window, ``batch_size`` windows per
    call on the model's device."""
    dev = m.w_out.device
    outs = []
    for i in range(0, len(data), batch_size):
        b = window_tensors(data.batch(np.arange(i, min(i + batch_size,
                                                       len(data)))),
                           dev, with_labels=False)
        outs.append(_logits_of(m, b).cpu().numpy())
    if not outs:
        return np.zeros((0, m.cfg.in_len), np.float32)
    return np.concatenate(outs, axis=0)


def evaluate_caching_model(m: CachingModel, data: WindowData,
                           batch_size: int = 1024) -> float:
    """Accuracy vs Belady labels (paper: ~83%)."""
    pred = logits_for(m, data, batch_size) > 0
    return float((pred == (data.y_keep > 0.5)).sum()) / max(pred.size, 1)


def predict_bits(m: CachingModel, data: WindowData,
                 batch_size: int = 4096) -> np.ndarray:
    """Keep-bits for every window, vectorized.  (N, T) bool."""
    return logits_for(m, data, batch_size) > 0
