"""Voyager-style hierarchical classification prefetcher [71] — the paper's
other ML baseline, implemented to *demonstrate its scaling failure* on
embedding traces (paper §VII-B: one-hot labeling over millions of vectors
OOMs even on a 512GB host).

Ported from ``src/repro/core/voyager.py`` (lines 1-149), batch-first; its
encoder steps through :func:`repro_torch.core.lstm.lstm_step`, so the CUDA
``lstm_cell`` kernel carries it on the card.  The parameters live in
:class:`Voyager`, whose state-dict keys are the JAX tree's paths.

Voyager decomposes an address into (page, offset) and predicts each with a
softmax.  Mapped to embedding ids: page = gid // page_size, offset =
gid % page_size.  The output layers are (hidden x n_pages) and (hidden x
page_size): at production scale (62M vectors / 256 = 242K pages) the page
softmax alone is ~10M params and the training labels are one-hot over it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch.core import lstm as LS
from repro_torch.core.caching_model import (_X_FIELDS, _batch, opt_config,
                                            train_step, window_tensors)
from repro_torch.core.features import ROW_BUCKETS, WindowData
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamW


@dataclass(frozen=True)
class VoyagerConfig:
    n_vectors: int = 480_000
    page_size: int = 256
    hidden: int = 40
    in_len: int = 15
    table_emb: int = 8
    row_emb: int = 8

    @property
    def n_pages(self) -> int:
        return (self.n_vectors + self.page_size - 1) // self.page_size


class Voyager(nn.Module):
    """Voyager's parameters, drawn from a ``torch.Generator`` seeded with
    ``seed``."""

    def __init__(self, cfg: VoyagerConfig, n_tables: int, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        f = cfg.table_emb + 2 * cfg.row_emb + 1
        hid = cfg.hidden

        def randn(*shape):
            return torch.randn(*shape, generator=gen)

        self.table_emb = nn.Parameter(randn(n_tables, cfg.table_emb) * 0.1)
        self.row_emb1 = nn.Parameter(randn(ROW_BUCKETS[0], cfg.row_emb) * 0.1)
        self.row_emb2 = nn.Parameter(randn(ROW_BUCKETS[1], cfg.row_emb) * 0.1)
        self.enc = LS.lstm_init(LS.LSTMLayer(f, hid), gen)
        # The two classification heads — the scaling bottleneck.
        self.w_page = nn.Parameter(randn(hid, cfg.n_pages) / math.sqrt(hid))
        self.w_off = nn.Parameter(randn(hid, cfg.page_size) / math.sqrt(hid))


def voyager_logits(m: Voyager, cfg: VoyagerConfig, xt, xr1, xr2, xn):
    """(B, T) windows -> (page logits (B, n_pages), offset logits (B,
    page_size)) from the encoder's final h."""
    feats = torch.cat([m.table_emb[xt], m.row_emb1[xr1], m.row_emb2[xr2],
                       xn[..., None]], dim=-1)
    _, (h, _) = LS.lstm_seq(m.enc, feats)
    return h @ m.w_page, h @ m.w_off


def voyager_loss(m: Voyager, cfg: VoyagerConfig, batch):
    pl_, ol = voyager_logits(m, cfg, batch["xt"], batch["xr1"], batch["xr2"],
                             batch["xn"])
    lp = torch.log_softmax(pl_, dim=-1)
    lo = torch.log_softmax(ol, dim=-1)
    npage = torch.gather(lp, 1, batch["page"][:, None])[:, 0]
    noff = torch.gather(lo, 1, batch["off"][:, None])[:, 0]
    return -(npage + noff).mean()


def train_voyager(data: WindowData, cfg: VoyagerConfig, n_tables: int,
                  epochs: int = 3, batch_size: int = 512, lr: float = 5e-3,
                  seed: int = 0, device="cuda"):
    """Targets: the NEXT access's (page, offset) after each window.
    Returns ``(model, losses)``."""
    device = resolve_device(device)
    m = Voyager(cfg, n_tables, seed).to(device)
    total = max(2, epochs * (len(data) // batch_size))
    opt = AdamW(m.parameters(), opt_config(lr, total))
    gid_next = np.round(data.y_window[:, 0] * cfg.n_vectors).astype(np.int64)
    tensors = window_tensors(data, device, with_labels=False)
    tensors["page"] = torch.from_numpy(gid_next // cfg.page_size).to(device)
    tensors["off"] = torch.from_numpy(gid_next % cfg.page_size).to(device)
    rng = np.random.default_rng(seed)

    def loss_fn(mod, batch):
        return voyager_loss(mod, cfg, batch)

    losses = []
    for _ in range(epochs):
        idx = rng.permutation(len(data))
        ep_losses = [train_step(m, opt, loss_fn,
                                _batch(tensors, idx[i: i + batch_size]))
                     for i in range(0, len(idx) - batch_size + 1,
                                    batch_size)]
        if ep_losses:
            losses.extend(torch.stack(ep_losses).cpu().tolist())
    return m, losses


@torch.no_grad()
def predict_next(m: Voyager, cfg: VoyagerConfig, data: WindowData,
                 batch_size: int = 4096) -> np.ndarray:
    """Top-1 predicted next vector id per window."""
    dev = m.w_off.device
    outs = []
    for i in range(0, len(data), batch_size):
        b = window_tensors(data.batch(np.arange(i, min(i + batch_size,
                                                       len(data)))),
                           dev, with_labels=False)
        pl_, ol = voyager_logits(m, cfg, *(b[k] for k, _ in _X_FIELDS[:4]))
        page = torch.argmax(pl_, -1).cpu().numpy()
        off = torch.argmax(ol, -1).cpu().numpy()
        outs.append(page.astype(np.int64) * cfg.page_size + off)
    return np.concatenate(outs) if outs else np.zeros(0, np.int64)
