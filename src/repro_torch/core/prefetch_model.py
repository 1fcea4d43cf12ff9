"""RecMG prefetch model (paper §V-B).

Ported from ``src/repro/core/prefetch_model.py`` (lines 1-408),
batch-first: every function takes (B, T) inputs where the JAX package
``vmap``s a per-window function.  The parameters live in
:class:`PrefetchModel`, whose state-dict keys are the JAX tree's paths.
Every LSTM step runs :func:`repro_torch.kernels.ops.lstm_cell` and the
Chamfer loss runs :func:`repro_torch.kernels.ops.chamfer` (the CUDA
kernels on the card).  The nearest-candidate decode is a matmul plus an
argmin, as in the JAX package, outside any kernel.

``backbone="transformer"`` (the TransFetch-class baseline: the same
featurization, loss and decode with two small self-attention blocks in
place of the LSTM stacks; the JAX package's lines 88-124 and 153-156) is
plain ``torch.matmul``/``torch.softmax`` and the tanh-approximated GELU
that ``jax.nn.gelu`` defaults to: JAX computes it outside any Pallas
kernel too.  Its ``dec2`` still runs ``lstm_cell`` and its loss
``chamfer``.

Two seq2seq LSTM stacks + attention (~74K params).  Input: the same access
chunk as the caching model.  Output: a *sequence* of |PO| = 5 predicted
embedding-vector coordinates in the model's dense representation space,
which is how RecMG sidesteps the million-way classification that OOMs
Voyager-style one-hot labeling (§VII-B).

Training: bidirectional Chamfer distance (Eq. 5, alpha=0.7) between the
predicted set PO and the representations of the decoupled evaluation window
W of the next |W| = 3*|PO| accesses.  Target representations are
stop-gradiented; the fixed normalized-index coordinate anchors the space.
At deployment the predicted points snap to the nearest candidate vector by
squared-L2 (a matmul), giving concrete indices to prefetch.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.core import lstm as LS
from repro_torch.core.caching_model import (_X_FIELDS, _batch, opt_config,
                                            train_step, window_tensors)
from repro_torch.core.chamfer import chamfer_bidirectional_vec, l2_truncated_vec
from repro_torch.core.features import (ROW_BUCKETS, WindowData,
                                       _stack_windows, access_stats,
                                       make_windows)
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamW


@dataclass(frozen=True)
class PrefetchModelConfig:
    n_tables: int = 856
    table_emb: int = 8
    row_emb: int = 8
    hidden: int = 40
    in_len: int = 15
    out_len: int = 5  # |PO|
    window: int = 15  # |W| = 3 * |PO| (paper Fig. 12 sensitivity)
    alpha: float = 0.7
    n_stacks: int = 2
    backbone: str = "lstm"  # lstm (RecMG) | transformer (TransFetch-class
    #   baseline: same featurization/loss/decode, transformer encoder)
    loss: str = "chamfer"  # chamfer | l2 (ablation baseline)
    norm_weight: float = 4.0  # weight of the fixed index coordinate
    stat_weight: float = 2.0  # weight of the online freq/recency coords
    diversity_weight: float = 0.1  # repulsion between predicted points
    diversity_tau: float = 0.5

    @property
    def rep_dim(self) -> int:
        # Output/decode representation space: stable per-id coordinates only.
        return self.table_emb + 2 * self.row_emb + 1

    @property
    def in_dim(self) -> int:
        # Encoder input: rep coords + online freq/recency.
        return self.rep_dim + 2


class TransformerBlock(nn.Module):
    """One self-attention block of the transformer backbone: ``wq``,
    ``wk``, ``wv``, ``wo`` (H, H), ``w1`` (H, 2H), ``w2`` (2H, H), each
    ~ N(0, 1) / sqrt(fan-in)."""

    def __init__(self, hidden: int, gen: torch.Generator):
        super().__init__()

        def w(fan_in, fan_out):
            return nn.Parameter(torch.randn(fan_in, fan_out, generator=gen)
                                / math.sqrt(fan_in))

        self.wq, self.wk = w(hidden, hidden), w(hidden, hidden)
        self.wv, self.wo = w(hidden, hidden), w(hidden, hidden)
        self.w1, self.w2 = w(hidden, 2 * hidden), w(2 * hidden, hidden)


class PrefetchModel(nn.Module):
    """The prefetch model's parameters, drawn from a ``torch.Generator``
    seeded with ``seed``.  The LSTM backbone has ``enc1``/``dec1``/
    ``attn1`` (and ``enc2`` with two stacks); the transformer backbone
    has ``in_proj``, ``pos_emb`` and ``tblocks`` (two
    :class:`TransformerBlock`), as the JAX tree does.  The JAX init draws
    ``wq``/``w1`` and ``wk``/``w2`` of a block from one key each; the
    port draws every tensor anew, so parity is held on carried
    parameters."""

    def __init__(self, cfg: PrefetchModelConfig, seed: int = 0):
        super().__init__()
        if cfg.backbone not in ("lstm", "transformer"):
            raise ValueError(f"unknown backbone {cfg.backbone!r} "
                             "(lstm | transformer)")
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        f, fin, hid = cfg.rep_dim, cfg.in_dim, cfg.hidden

        def randn(*shape):
            return torch.randn(*shape, generator=gen)

        self.table_emb = nn.Parameter(randn(cfg.n_tables, cfg.table_emb)
                                      * 0.3)
        self.row_emb1 = nn.Parameter(randn(ROW_BUCKETS[0], cfg.row_emb) * 0.3)
        self.row_emb2 = nn.Parameter(randn(ROW_BUCKETS[1], cfg.row_emb) * 0.3)
        self.enc1 = self.dec1 = self.attn1 = self.enc2 = None
        self.tblocks = None
        if cfg.backbone == "transformer":
            # TransFetch-class encoder: small self-attention blocks over
            # the chunk in place of the LSTM stacks.
            self.in_proj = nn.Parameter(randn(fin, hid) / math.sqrt(fin))
            self.pos_emb = nn.Parameter(randn(cfg.in_len, hid) * 0.1)
            self.tblocks = nn.ModuleList(TransformerBlock(hid, gen)
                                         for _ in range(2))
        else:
            # Stack 1: encoder/decoder refining the access sequence.
            self.enc1 = LS.lstm_init(LS.LSTMLayer(fin, hid), gen)
            self.dec1 = LS.lstm_init(LS.LSTMLayer(2 * hid, hid), gen)
            self.attn1 = LS.attn_init(LS.Attention(hid), gen)
        # Output embedding layer (paper Fig. 5b): FC + projection into the
        # representation space.
        self.w_fc = nn.Parameter(randn(2 * hid, hid) / math.sqrt(2 * hid))
        self.b_fc = nn.Parameter(torch.zeros(hid))
        self.w_proj = nn.Parameter(randn(hid, f) / math.sqrt(hid))
        self.b_proj = nn.Parameter(torch.zeros(f))
        self.y_in = nn.Parameter(randn(f, 8) / math.sqrt(f))
        if cfg.backbone == "lstm" and cfg.n_stacks >= 2:
            self.enc2 = LS.lstm_init(LS.LSTMLayer(hid, hid), gen)
        self.dec2 = LS.lstm_init(LS.LSTMLayer(8 + hid, hid), gen)
        self.attn2 = LS.attn_init(LS.Attention(hid), gen)


def _transformer_encode(m: PrefetchModel, feats: torch.Tensor):
    """feats: (B, T, fin) -> hs (B, T, H) via the two self-attention
    blocks (unmasked; ``jax.nn.gelu``'s default tanh approximation)."""
    h = feats @ m.in_proj + m.pos_emb[: feats.shape[1]]
    for blk in m.tblocks:
        q, k, v = h @ blk.wq, h @ blk.wk, h @ blk.wv
        s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
        h = h + torch.softmax(s, dim=-1) @ v @ blk.wo
        h = h + F.gelu(h @ blk.w1, approximate="tanh") @ blk.w2
    return h


def access_reps(m: PrefetchModel, cfg: PrefetchModelConfig, xt, xr1, xr2,
                xn):
    """Stable representation-space coordinates of vector ids.
    (..., T) ints -> (..., T, F).  This is the space Chamfer compares in and
    nearest-neighbor decode searches in."""
    return torch.cat([m.table_emb[xt], m.row_emb1[xr1], m.row_emb2[xr2],
                      (xn * cfg.norm_weight)[..., None]], dim=-1)


def input_feats(m: PrefetchModel, cfg: PrefetchModelConfig, xt, xr1, xr2,
                xn, xf, xrc):
    """Encoder inputs: rep coords + online freq/recency scalars."""
    reps = access_reps(m, cfg, xt, xr1, xr2, xn)
    return torch.cat([reps, (xf * cfg.stat_weight)[..., None],
                      (xrc * cfg.stat_weight)[..., None]], dim=-1)


def prefetch_predict(m: PrefetchModel, cfg: PrefetchModelConfig, xt, xr1,
                     xr2, xn, xf, xrc):
    """(B, T) windows -> (B, out_len, F) predicted representation points.

    LSTM backbone: enc1 runs from zeros; dec1 starts from enc1's final
    state and attends over enc1's states; enc2 runs over dec1's outputs
    from *zeros*.  Transformer backbone: the blocks encode the chunk, and
    dec2 starts from the last position's state with a zero cell.  dec2
    starts with a zero first ``prev``, attends over the encoder's states
    and feeds each step's point back as the next ``prev``."""
    feats = input_feats(m, cfg, xt, xr1, xr2, xn, xf, xrc)
    if cfg.backbone == "transformer":
        hs2 = _transformer_encode(m, feats)
        h = hs2[:, -1]
        c = torch.zeros_like(h)
    else:
        hs1, (h, c) = LS.lstm_seq(m.enc1, feats)
        ds = []
        for t in range(hs1.shape[1]):
            ctx = LS.attend(m.attn1, h, hs1)
            (h, c), out = LS.lstm_step(m.dec1, (h, c),
                                       torch.cat([hs1[:, t], ctx], dim=-1))
            ds.append(out)
        ds1 = torch.stack(ds, dim=1)
        if m.enc2 is not None:
            hs2, (h, c) = LS.lstm_seq(m.enc2, ds1)
        else:
            hs2 = ds1
    prev = feats.new_zeros((feats.shape[0], cfg.rep_dim))
    ys = []
    for _ in range(cfg.out_len):
        ctx = LS.attend(m.attn2, h, hs2)
        x = torch.cat([prev @ m.y_in, ctx], dim=-1)
        (h, c), _ = LS.lstm_step(m.dec2, (h, c), x)
        feat = torch.tanh(torch.cat([h, ctx], dim=-1) @ m.w_fc + m.b_fc)
        prev = feat @ m.w_proj + m.b_proj
        ys.append(prev)
    return torch.stack(ys, dim=1)


def _points_of(m: PrefetchModel, batch: Mapping[str, torch.Tensor]):
    return prefetch_predict(m, m.cfg, *(batch[k] for k, _ in _X_FIELDS))


def prefetch_loss(m: PrefetchModel, cfg: PrefetchModelConfig, batch):
    po = prefetch_predict(m, cfg, *(batch[k] for k, _ in _X_FIELDS))
    wlen = cfg.window if cfg.loss == "chamfer" else cfg.out_len
    with torch.no_grad():  # stop-gradient on the targets
        w = access_reps(m, cfg, batch["wt"][:, :wlen], batch["wr1"][:, :wlen],
                        batch["wr2"][:, :wlen], batch["wn"][:, :wlen])
    if cfg.loss == "l2":
        return l2_truncated_vec(po, w).mean()
    loss = chamfer_bidirectional_vec(po, w, cfg.alpha).mean()
    if cfg.diversity_weight:
        # Repulsion between predicted points: counters the duplicate-output
        # collapse the paper's reverse Chamfer term fights (§V-B).
        d = po[:, :, None, :] - po[:, None, :, :]
        d2 = (d * d).sum(-1)
        n_p = po.shape[1]
        off = 1.0 - torch.eye(n_p, dtype=po.dtype, device=po.device)
        rep = ((torch.exp(-d2 / cfg.diversity_tau) * off).sum(-1).sum(-1)
               / (n_p * (n_p - 1)))
        loss = loss + cfg.diversity_weight * rep.mean()
    return loss


def window_int_features(trace, starts, wlen, stats=None):
    """Raw int features of the future window for target representations."""
    row = trace.row_id
    freq, rec = stats if stats is not None else access_stats(trace.global_id)
    return {
        "wt": _stack_windows(trace.table_id.astype(np.int32), starts, wlen),
        "wr1": _stack_windows((row % ROW_BUCKETS[0]).astype(np.int32),
                              starts, wlen),
        "wr2": _stack_windows(((row // ROW_BUCKETS[0])
                               % ROW_BUCKETS[1]).astype(np.int32),
                              starts, wlen),
        "wn": _stack_windows(
            (trace.global_id / max(trace.n_vectors, 1)).astype(np.float32),
            starts, wlen),
        "wf": _stack_windows(freq, starts, wlen),
        "wrc": _stack_windows(rec, starts, wlen),
    }


@dataclass
class PrefetchData:
    """WindowData + raw int features of each future window."""

    base: WindowData
    w_feats: Dict[str, np.ndarray]

    def __len__(self):
        return len(self.base)

    def tensors(self, device) -> Dict[str, torch.Tensor]:
        """Every window's inputs and future-window features as tensors on
        ``device`` (int64 ids, fp32 scalars)."""
        out = window_tensors(self.base, device, with_labels=False)
        for k, v in self.w_feats.items():
            v = np.asarray(v)
            out[k] = torch.from_numpy(
                v.astype(np.int64) if np.issubdtype(v.dtype, np.integer)
                else v.astype(np.float32)).to(device)
        return out

    def batch_dict(self, idx, device="cpu") -> Dict[str, torch.Tensor]:
        idx = np.asarray(idx, np.int64)
        sub = PrefetchData(self.base.batch(idx),
                           {k: v[idx] for k, v in self.w_feats.items()})
        return sub.tensors(device)


def make_prefetch_data(trace, in_len=15, window=15, stride=5,
                       miss_mask: Optional[np.ndarray] = None) -> PrefetchData:
    """miss_mask: per-access OPT-miss bits — when given, the ground-truth
    window W is the next `window` *missing* accesses (the paper's prefetch
    trace: "embedding vectors leading to cache misses", §VI-A)."""
    stats = access_stats(trace.global_id)
    base = make_windows(trace, in_len=in_len, out_window=window, stride=stride,
                        stats=stats)
    starts = np.arange(in_len, len(trace) - window - 1, stride,
                       dtype=np.int64)[: len(base)]
    if miss_mask is None:
        return PrefetchData(base, window_int_features(trace, starts, window,
                                                      stats))

    # Gather the first `window` miss positions at/after each start.
    mpos = np.nonzero(miss_mask)[0]
    j = np.searchsorted(mpos, starts)
    keep = j < max(len(mpos) - window, 1)  # aligned with base rows
    j = j[keep]
    idx = np.minimum(j[:, None] + np.arange(window)[None, :], len(mpos) - 1)
    flat = mpos[idx]  # (N, window) absolute access positions of misses

    row = trace.row_id
    gid = trace.global_id
    freq, rec = stats
    w_feats = {
        "wt": trace.table_id.astype(np.int32)[flat],
        "wr1": (row % ROW_BUCKETS[0]).astype(np.int32)[flat],
        "wr2": ((row // ROW_BUCKETS[0]) % ROW_BUCKETS[1]).astype(np.int32)[flat],
        "wn": (gid / max(trace.n_vectors, 1)).astype(np.float32)[flat],
        "wf": freq[flat],
        "wrc": rec[flat],
    }
    base = base.batch(np.nonzero(keep)[0])
    return PrefetchData(base, w_feats)


def train_prefetch_model(data: PrefetchData, cfg: PrefetchModelConfig,
                         epochs: int = 3, batch_size: int = 256,
                         lr: float = 3e-3, seed: int = 0, log=None,
                         device="cuda"):
    """Train from ``seed`` on ``device``: the JAX loop's batches and
    optimizer.  Returns ``(model, losses)``."""
    device = resolve_device(device)
    m = PrefetchModel(cfg, seed).to(device)
    total = max(2, epochs * max(1, len(data) // batch_size))
    opt = AdamW(m.parameters(), opt_config(lr, total))
    tensors = data.tensors(device)
    rng = np.random.default_rng(seed)

    def loss_fn(mod, batch):
        return prefetch_loss(mod, cfg, batch)

    losses = []
    for ep in range(epochs):
        idx = rng.permutation(len(data))
        ep_losses = [train_step(m, opt, loss_fn,
                                _batch(tensors, idx[i: i + batch_size]))
                     for i in range(0, len(idx) - batch_size + 1,
                                    batch_size)]
        if ep_losses:
            losses.extend(torch.stack(ep_losses).cpu().tolist())
        if log:
            log(f"prefetch epoch {ep}: loss {np.mean(losses[-50:]):.5f}")
    return m, losses


# ---------------------------------------------------------------------------
# Deployment: snap predicted points to real vector ids + quality metrics
# ---------------------------------------------------------------------------


def candidate_reps(m: PrefetchModel, cfg: PrefetchModelConfig,
                   cand_ids: np.ndarray, trace) -> torch.Tensor:
    """Representation matrix of candidate vector ids, (C, F), on the
    model's device."""
    dev = m.y_in.device
    offs = trace.table_offsets
    t = np.searchsorted(offs, cand_ids, side="right") - 1
    row = cand_ids - offs[t]
    xn = cand_ids / max(trace.n_vectors, 1)

    def on(a, dt):
        return torch.from_numpy(np.asarray(a).astype(dt)).to(dev)

    with torch.no_grad():
        return access_reps(m, cfg, on(t, np.int64),
                           on(row % ROW_BUCKETS[0], np.int64),
                           on((row // ROW_BUCKETS[0]) % ROW_BUCKETS[1],
                              np.int64),
                           on(xn, np.float32))


def _nn_dist(points: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """points: (N, F), cand: (C, F) -> (N, C) squared L2 (via matmul)."""
    p2 = (points * points).sum(-1, keepdim=True)
    c2 = (cand * cand).sum(-1)
    return p2 + c2[None, :] - 2.0 * points @ cand.t()


def _nn_decode(points: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """points: (N, F), cand: (C, F) -> (N,) argmin squared-L2 (first index
    on ties)."""
    return torch.argmin(_nn_dist(points, cand), dim=1)


@torch.no_grad()
def decode_to_ids(m: PrefetchModel, cfg: PrefetchModelConfig,
                  po_points: np.ndarray, cand_ids: np.ndarray, trace,
                  chunk: int = 65536) -> np.ndarray:
    """po_points: (N, P, F) -> (N, P) vector ids (nearest candidate)."""
    cand = candidate_reps(m, cfg, cand_ids, trace)
    flat = np.asarray(po_points, np.float32).reshape(-1, po_points.shape[-1])
    outs = [_nn_decode(torch.from_numpy(flat[i: i + chunk]).to(cand.device),
                       cand).cpu().numpy()
            for i in range(0, len(flat), chunk)]
    nn_idx = np.concatenate(outs) if outs else np.zeros(0, np.int64)
    return cand_ids[nn_idx].reshape(po_points.shape[:-1])


@torch.no_grad()
def predict_sequences(m: PrefetchModel, cfg: PrefetchModelConfig, data,
                      batch_size: int = 4096) -> np.ndarray:
    """(N, P, F) predicted representation points for every window."""
    base = data.base if isinstance(data, PrefetchData) else data
    dev = m.y_in.device
    outs = []
    for i in range(0, len(base), batch_size):
        b = window_tensors(base.batch(np.arange(i, min(i + batch_size,
                                                       len(base)))),
                           dev, with_labels=False)
        outs.append(prefetch_predict(
            m, cfg, *(b[k] for k, _ in _X_FIELDS)).cpu().numpy())
    if not outs:
        return np.zeros((0, cfg.out_len, cfg.rep_dim), np.float32)
    return np.concatenate(outs, axis=0)


def sequence_metrics(po_ids: np.ndarray, gt_windows: np.ndarray) -> dict:
    """Correctness (frac of PO appearing in the window) + coverage (Eq. 2)."""
    correct = 0
    covered = 0
    gt_unique_total = 0
    for po, w in zip(po_ids, gt_windows):
        ws = set(int(x) for x in w)
        correct += sum(int(p) in ws for p in po)
        covered += len(set(int(p) for p in po) & ws)
        gt_unique_total += len(ws)
    return {
        "correctness": correct / max(po_ids.size, 1),
        "coverage": covered / max(gt_unique_total, 1),
    }
