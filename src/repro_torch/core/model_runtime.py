"""Learned RecMG serving runtime: the trained dual models on the hot path.

Ported from ``src/repro/core/model_runtime.py``: ``LearnedModelConfig``
(lines 66-92), ``LearnedRecMGModel`` (lines 118-325), ``OutputsRef``
(lines 328-336) and ``voyager_outputs`` (lines 394-442).  The models train
and infer on one device (``"cuda"`` by default; it raises when CUDA is
absent), where every LSTM step runs the CUDA ``lstm_cell`` kernel and the
prefetch loss the CUDA ``chamfer`` kernel.

* :class:`LearnedRecMGModel` owns both trained models and the candidate
  pool.  ``train_from_trace`` is the compact entry point (Belady ground
  truth on a trace prefix, window featurization, both training loops).
  Inference slices the windows into ``infer_batch``-row batches on the
  device.  It needs no padding to a power of two: the JAX package pads
  (``_bucket`` / ``_pad_rows``) only to bound XLA's recompiles, and eager
  PyTorch compiles nothing.
* :func:`voyager_outputs` is the Voyager-class ML-prefetcher baseline as a
  serving arm (LRU store + top-``out_len`` predicted prefetches per chunk):
  :func:`train_voyager_arm` trains it, :func:`voyager_arm_outputs` reads
  its prefetch ids out on the model's device.

``LearnedController`` (the drift-adaptation loop that fine-tunes the
caching model on every drift refresh) wraps ``runtime/drift.py``'s
``AdaptiveController`` and waits for the pipelined runtime (ROADMAP A12);
``LearnedRecMGModel.finetune`` is its model half and is ported.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core import caching_model as CM
from repro_torch.core import prefetch_model as PM
from repro_torch.core.belady import belady_labels
from repro_torch.core.cache_sim import top_ids_by_count
from repro_torch.core.features import WindowData, make_windows
from repro_torch.core.recmg import RecMGOutputs
from repro_torch.core.trace import Trace
from repro_torch.device import resolve_device, synchronize
from repro_torch.optim.adamw import AdamW, OptConfig


@dataclass(frozen=True)
class LearnedModelConfig:
    """Training + inference + online-finetune knobs for the learned policy.

    The defaults are tuned for the scenario-matrix scale (a few thousand
    vectors, ~8K accesses): small hidden size, many epochs over densely
    strided windows, candidate pool = the buffer capacity's hottest ids."""

    hidden: int = 32
    in_len: int = 15
    out_len: int = 5
    caching_epochs: int = 30
    prefetch_epochs: int = 15
    batch_size: int = 128
    lr: float = 1e-2
    train_stride: int = 2     # window stride over the training prefix
    seed: int = 0
    n_candidates: int = 0     # prefetch candidate pool size; 0 -> capacity
    infer_batch: int = 4096   # windows per inference call
    # Online fine-tune (per drift refresh): bounded, seeded.
    finetune_steps: int = 8
    finetune_batch: int = 64
    finetune_lr: float = 2e-3
    finetune_stride: int = 4


class LearnedRecMGModel:
    """The trained caching + prefetch models behind one serving interface.

    ``predict_logits`` / ``predict_bits`` / ``predict_points`` /
    ``decode_points`` run batched inference on the models' device;
    ``outputs_for`` packages a whole trace's chunk grid into
    :class:`RecMGOutputs` (the same grid ``frequency_outputs`` uses, so the
    serving loops are interchangeable); ``finetune`` takes one bounded
    online training pass on a live access window."""

    def __init__(self, cfg: LearnedModelConfig, mcfg: CM.CachingModelConfig,
                 pcfg: PM.PrefetchModelConfig, cmodel: CM.CachingModel,
                 pmodel: PM.PrefetchModel, cand_ids: np.ndarray,
                 capacity: int, geom: Trace, caching_losses=None,
                 prefetch_losses=None):
        self.cfg = cfg
        self.mcfg = mcfg
        self.pcfg = pcfg
        self.cmodel = cmodel
        self.pmodel = pmodel
        self.cand_ids = np.asarray(cand_ids, np.int64)
        self.capacity = int(capacity)
        # Table geometry reference (table_offsets / rows_per_table /
        # n_vectors) for candidate featurization and window re-derivation.
        self.geom = geom
        self.caching_losses = list(caching_losses or [])
        self.prefetch_losses = list(prefetch_losses or [])
        # Seconds of each training stage (train_from_trace fills it).
        self.timings: dict = {}
        # ---- online-finetune state + telemetry ----
        self._ft_opt: Optional[AdamW] = None
        self.finetunes = 0
        self.finetune_steps_run = 0

    @property
    def device(self) -> torch.device:
        return self.cmodel.w_out.device

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    @classmethod
    def train_from_trace(cls, trace: Trace, capacity: int,
                         cfg: Optional[LearnedModelConfig] = None, *,
                         profile_upto: Optional[int] = None,
                         log=None, device="cuda") -> "LearnedRecMGModel":
        """Train both models on a trace prefix (the paper's §VI-A offline
        workflow in one call): Belady keep bits on the prefix label the
        caching model, the prefix's future windows supervise the prefetch
        model, and the prefix's ``capacity`` hottest ids seed the prefetch
        candidate pool.  ``profile_upto`` freezes training on a prefix."""
        dev = resolve_device(device)
        cfg = cfg or LearnedModelConfig()
        prefix = (trace if profile_upto is None
                  else trace.slice(0, int(profile_upto)))
        capacity = max(1, int(capacity))
        timings = {}
        t0 = time.perf_counter()
        labels, _, _ = belady_labels(prefix.global_id, capacity)
        timings["belady_s"] = time.perf_counter() - t0
        mcfg = CM.CachingModelConfig(n_tables=trace.n_tables,
                                     hidden=cfg.hidden, in_len=cfg.in_len)
        t0 = time.perf_counter()
        data = make_windows(prefix, in_len=cfg.in_len, labels=labels,
                            stride=cfg.train_stride)
        cmodel, closs = CM.train_caching_model(
            data, mcfg, epochs=cfg.caching_epochs, batch_size=cfg.batch_size,
            lr=cfg.lr, seed=cfg.seed, log=log, device=dev)
        synchronize(dev)
        timings["caching_train_s"] = time.perf_counter() - t0
        pcfg = PM.PrefetchModelConfig(n_tables=trace.n_tables,
                                      hidden=cfg.hidden, in_len=cfg.in_len,
                                      out_len=cfg.out_len)
        t0 = time.perf_counter()
        pdata = PM.make_prefetch_data(prefix, in_len=cfg.in_len,
                                      stride=cfg.train_stride)
        pmodel, ploss = PM.train_prefetch_model(
            pdata, pcfg, epochs=cfg.prefetch_epochs,
            batch_size=cfg.batch_size, lr=cfg.lr, seed=cfg.seed, log=log,
            device=dev)
        synchronize(dev)
        timings["prefetch_train_s"] = time.perf_counter() - t0
        n_cand = cfg.n_candidates or capacity
        cand = np.sort(top_ids_by_count(prefix.global_id, max(1, n_cand)))
        model = cls(cfg, mcfg, pcfg, cmodel, pmodel, cand, capacity, trace,
                    closs, ploss)
        model.timings = timings
        return model

    def to(self, device) -> "LearnedRecMGModel":
        """A copy of this model whose two networks live on ``device``
        (same parameters, losses and candidate pool)."""
        import copy

        dev = resolve_device(device)
        out = copy.copy(self)
        out.cmodel = copy.deepcopy(self.cmodel).to(dev)
        out.pmodel = copy.deepcopy(self.pmodel).to(dev)
        out._ft_opt = None
        return out

    # ------------------------------------------------------------------
    # Batched inference on the models' device
    # ------------------------------------------------------------------

    def predict_logits(self, data: WindowData) -> np.ndarray:
        """Keep logits for every window.  (N, in_len) fp32."""
        return CM.logits_for(self.cmodel, data, self.cfg.infer_batch)

    def predict_bits(self, data: WindowData) -> np.ndarray:
        """Keep-bits for every window (``logit > 0``).  (N, in_len) bool."""
        return self.predict_logits(data) > 0

    def predict_points(self, data: WindowData) -> np.ndarray:
        """Predicted PO representation points.  (N, out_len, rep_dim) f32."""
        return PM.predict_sequences(self.pmodel, self.pcfg, data,
                                    self.cfg.infer_batch)

    @torch.no_grad()
    def decode_points(self, points: np.ndarray, return_margins: bool = False):
        """Snap predicted points to candidate-pool ids.  (N, P) int64; with
        ``return_margins`` also the (N, P) fp32 gap between the nearest and
        the second-nearest candidate's squared distance (inf with one
        candidate), which says how close a decision is to flipping."""
        shape = points.shape[:-1]
        if points.size == 0:
            ids = np.zeros(shape, np.int64)
            return (ids, np.zeros(shape, np.float32)) if return_margins \
                else ids
        cand = PM.candidate_reps(self.pmodel, self.pcfg, self.cand_ids,
                                 self.geom)
        flat = np.asarray(points, np.float32).reshape(-1, points.shape[-1])
        idx, gaps = [], []
        for i in range(0, len(flat), self.cfg.infer_batch):
            seg = torch.from_numpy(flat[i: i + self.cfg.infer_batch]).to(
                cand.device)
            d = PM._nn_dist(seg, cand)
            idx.append(torch.argmin(d, dim=1).cpu().numpy())
            if return_margins:
                if d.shape[1] > 1:
                    two = torch.topk(d, 2, dim=1, largest=False).values
                    gaps.append((two[:, 1] - two[:, 0]).cpu().numpy())
                else:
                    gaps.append(np.full(len(seg), np.inf, np.float32))
        ids = self.cand_ids[np.concatenate(idx)].reshape(shape)
        if return_margins:
            return ids, np.concatenate(gaps).reshape(shape)
        return ids

    def serving_windows(self, trace: Trace):
        """The serving chunk grid (stride = in_len): ``(windows,
        chunk_starts)``, the grid ``precompute_outputs`` /
        ``frequency_outputs`` emit."""
        cfg = self.cfg
        data = make_windows(trace, in_len=cfg.in_len,
                            out_window=cfg.out_len, stride=cfg.in_len)
        starts = np.arange(cfg.in_len, len(trace) - cfg.out_len - 1,
                           cfg.in_len)[: len(data)]
        return data, starts

    def outputs_for(self, trace: Trace) -> RecMGOutputs:
        """Model outputs on the serving chunk grid."""
        data, starts = self.serving_windows(trace)
        bits = self.predict_bits(data)
        ids = self.decode_points(self.predict_points(data))
        return RecMGOutputs(starts, bits, ids)

    # ------------------------------------------------------------------
    # Online adaptation
    # ------------------------------------------------------------------

    def refresh_candidates(self, ids: np.ndarray) -> None:
        """Re-derive the prefetch candidate pool from a live window."""
        ids = np.asarray(ids, np.int64).ravel()
        if ids.size:
            self.cand_ids = np.sort(
                top_ids_by_count(ids, max(1, len(self.cand_ids))))

    def finetune(self, recent_ids: np.ndarray) -> int:
        """One bounded online fine-tune pass of the caching model on the
        most recent accesses (<= ``finetune_steps`` steps of
        ``finetune_batch`` windows at ``finetune_lr``; Adam state persists
        across calls).  Belady labels are re-derived on the window — the
        same supervision as offline training, just on live data.  Also
        refreshes the prefetch candidate pool.  Returns steps taken."""
        cfg = self.cfg
        recent = np.asarray(recent_ids, np.int64).ravel()
        self.finetunes += 1
        self.refresh_candidates(recent)
        if recent.size <= cfg.in_len * 2:
            return 0
        offs = self.geom.table_offsets
        t = np.searchsorted(offs, recent, side="right") - 1
        row = recent - offs[t]
        wtrace = Trace(t.astype(np.int32), row.astype(np.int64),
                       self.geom.rows_per_table)
        wlabels, _, _ = belady_labels(recent, self.capacity)
        wdata = make_windows(wtrace, in_len=cfg.in_len, labels=wlabels,
                             stride=cfg.finetune_stride)
        if len(wdata) < cfg.finetune_batch:
            return 0
        if self._ft_opt is None:
            self._ft_opt = AdamW(self.cmodel.parameters(),
                                 OptConfig(lr=cfg.finetune_lr,
                                           weight_decay=0.0, warmup_steps=1,
                                           total_steps=10 ** 6))
        rng = np.random.default_rng(1000 + cfg.seed + self.finetunes)
        idx = rng.permutation(len(wdata))[: cfg.finetune_steps
                                          * cfg.finetune_batch]
        tensors = CM.window_tensors(wdata, self.device)
        steps = 0
        for i in range(0, len(idx) - cfg.finetune_batch + 1,
                       cfg.finetune_batch):
            CM.train_step(self.cmodel, self._ft_opt, CM.bce_loss,
                          CM._batch(tensors, idx[i: i + cfg.finetune_batch]))
            steps += 1
        self.finetune_steps_run += steps
        return steps

    def telemetry(self) -> dict:
        return {
            "caching_loss": (round(float(np.mean(self.caching_losses[-20:])),
                                   4) if self.caching_losses else None),
            "prefetch_loss": (round(float(np.mean(self.prefetch_losses[-20:])),
                                    5) if self.prefetch_losses else None),
            "n_candidates": int(len(self.cand_ids)),
            "finetunes": self.finetunes,
            "finetune_steps": self.finetune_steps_run,
        }


@dataclass
class OutputsRef:
    """Mutable holder for the live :class:`RecMGOutputs` — the serving
    loops read through it so an online refresh swaps the outputs without
    re-wiring the loop (the chunk grid is identical, so the loop's chunk
    pointer stays valid)."""

    outputs: Optional[RecMGOutputs] = field(default=None)


def train_voyager_arm(trace: Trace, capacity: int, in_len: int = 15, *,
                      profile_upto: Optional[int] = None, epochs: int = 8,
                      batch_size: int = 128, lr: float = 5e-3,
                      train_stride: int = 2, page_size: int = 64,
                      hidden: int = 32, seed: int = 0,
                      n_candidates: int = 0, device="cuda"):
    """Train the Voyager classifier on the trace prefix (next-access
    targets) and pick its candidate pool, the prefix's ``n_candidates``
    (default ``capacity``) hottest ids.  Returns ``(model, candidates,
    losses)``."""
    from repro_torch.core.voyager import VoyagerConfig, train_voyager

    dev = resolve_device(device)
    prefix = (trace if profile_upto is None
              else trace.slice(0, int(profile_upto)))
    vcfg = VoyagerConfig(n_vectors=trace.n_vectors, page_size=page_size,
                         hidden=hidden, in_len=in_len)
    data = make_windows(prefix, in_len=in_len, out_window=1,
                        stride=train_stride)
    vmodel, losses = train_voyager(data, vcfg, trace.n_tables, epochs=epochs,
                                   batch_size=batch_size, lr=lr, seed=seed,
                                   device=dev)
    cand = np.sort(top_ids_by_count(
        prefix.global_id, max(1, n_candidates or int(capacity))))
    return vmodel, cand, losses


@torch.no_grad()
def voyager_arm_outputs(vmodel, cand: np.ndarray, trace: Trace,
                        out_len: int = 5, return_margins: bool = False):
    """Per-chunk top-``out_len`` prefetch ids of a trained Voyager model
    over the candidate pool, scored ``page_logit[page(c)] +
    offset_logit[offset(c)]`` on the model's device.  With
    ``return_margins`` also each chunk's smallest gap between consecutive
    scores among its top ``out_len + 1`` (inf when the pool is that
    small): how close the ranking is to flipping."""
    from repro_torch.core.voyager import voyager_logits

    vcfg = vmodel.cfg
    in_len = vcfg.in_len
    dev = vmodel.w_off.device
    sdata = make_windows(trace, in_len=in_len, out_window=out_len,
                         stride=in_len)
    starts = np.arange(in_len, len(trace) - out_len - 1,
                       in_len)[: len(sdata)]
    pages = torch.from_numpy(cand // vcfg.page_size).to(dev)
    offs = torch.from_numpy(cand % vcfg.page_size).to(dev)
    k = min(out_len, len(cand))
    ids = np.zeros((len(sdata), out_len), np.int64)
    gaps = np.full(len(sdata), np.inf, np.float32)
    for i in range(0, len(sdata), 4096):
        b = CM.window_tensors(
            sdata.batch(np.arange(i, min(i + 4096, len(sdata)))), dev,
            with_labels=False)
        pl, ol = voyager_logits(vmodel, vcfg, b["xt"], b["xr1"], b["xr2"],
                                b["xn"])
        score = pl[:, pages] + ol[:, offs]  # (B, C) over the pool
        kk = min(k + 1, len(cand)) if return_margins else k
        top = torch.topk(score, kk, dim=1)
        got = cand[top.indices[:, :k].cpu().numpy()]
        if return_margins and kk > 1:
            v = top.values
            gaps[i: i + len(got)] = (v[:, :-1] - v[:, 1:]).amin(
                dim=1).cpu().numpy()
        if k < out_len:  # tiny pools: repeat to fill the grid
            got = np.pad(got, ((0, 0), (0, out_len - k)), mode="edge")
        ids[i: i + len(got)] = got
    out = RecMGOutputs(starts, None, ids)
    return (out, gaps) if return_margins else out


def voyager_outputs(trace: Trace, capacity: int, in_len: int = 15,
                    out_len: int = 5, *,
                    profile_upto: Optional[int] = None, epochs: int = 8,
                    batch_size: int = 128, lr: float = 5e-3,
                    train_stride: int = 2, page_size: int = 64,
                    hidden: int = 32, seed: int = 0,
                    n_candidates: int = 0, device="cuda") -> RecMGOutputs:
    """Voyager-class ML-prefetcher serving arm (paper §VII-B baseline).

    Trains the hierarchical page/offset classifier on the trace prefix
    (:func:`train_voyager_arm`), then emits per-chunk top-``out_len``
    prefetch ids over the candidate pool (:func:`voyager_arm_outputs`, the
    decomposed softmax read out over real ids).  No caching bits — Voyager
    only prefetches, so the serving arm is an LRU store + this prefetch
    stream."""
    vmodel, cand, _ = train_voyager_arm(
        trace, capacity, in_len, profile_upto=profile_upto, epochs=epochs,
        batch_size=batch_size, lr=lr, train_stride=train_stride,
        page_size=page_size, hidden=hidden, seed=seed,
        n_candidates=n_candidates, device=device)
    return voyager_arm_outputs(vmodel, cand, trace, out_len)
