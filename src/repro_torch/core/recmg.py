"""RecMG end-to-end policy: the two models co-managing the buffer.

Ported from ``src/repro/core/recmg.py`` (lines 1-226): ``RecMGOutputs``,
``frequency_outputs``, ``run_recmg`` and ``run_lru_pf`` are NumPy and
copied; ``precompute_outputs`` runs the port's models
(:mod:`repro_torch.core.caching_model`,
:mod:`repro_torch.core.prefetch_model`) on their device.

The buffer-state never feeds back into the *models* (they condition only on
the access history), so model inference over a whole trace is vectorized in
one pass — exactly the paper's CPU-side pipelined deployment, where
predictions for chunk t are computed while the accelerator serves chunk t-1
(``pipelined=True`` applies outputs one chunk late to model that skew).

Trace replay goes **chunk-at-a-time**: accesses between two chunk
boundaries are served in one ``RecMGBuffer.access_chunk`` /
``FALRU.access_many`` call (the bulk API), and Algorithm 1 is applied once
per boundary — same semantics as the per-access loop, without per-access
driver dispatch.

``run_recmg`` produces the Figure-14-style access breakdown: buffer hits due
to the caching policy, hits due to prefetch, and on-demand fetches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.buffer_manager import RecMGBuffer
from repro_torch.core.cache_sim import (FALRU, SimResult,
                                        attribute_prefetch_hits, isin_sorted,
                                        top_ids_by_count)
from repro_torch.core.caching_model import predict_bits
from repro_torch.core.features import make_windows
from repro_torch.core.prefetch_model import decode_to_ids, predict_sequences
from repro_torch.core.trace import Trace


@dataclass
class RecMGOutputs:
    """Precomputed model outputs for every chunk of a trace."""

    chunk_starts: np.ndarray  # (C,) index of first access of each chunk
    caching_bits: Optional[np.ndarray]  # (C, in_len) bool
    prefetch_ids: Optional[np.ndarray]  # (C, out_len) int64


def precompute_outputs(trace: Trace, caching=None, prefetch=None,
                       in_len: int = 15, out_len: int = 5,
                       n_candidates: int = 5000) -> RecMGOutputs:
    """Vectorized model inference over all chunks (stride = in_len).

    ``caching`` / ``prefetch`` are ``(model, cfg)`` pairs of the port's
    :class:`~repro_torch.core.caching_model.CachingModel` and
    :class:`~repro_torch.core.prefetch_model.PrefetchModel` (the JAX
    package passes ``(params, cfg)``); inference runs on the models'
    device.  Prefetch decode snaps predicted representation points to the
    nearest of the ``n_candidates`` most-frequent vectors (the
    deployment's candidate pool — cold vectors aren't worth
    prefetching)."""
    data = make_windows(trace, in_len=in_len, out_window=out_len,
                        stride=in_len)
    starts = np.arange(in_len, len(trace) - out_len - 1, in_len)[: len(data)]

    bits = None
    if caching is not None:
        model, _cfg = caching
        bits = predict_bits(model, data)

    ids = None
    if prefetch is not None:
        model, pcfg = prefetch
        po = predict_sequences(model, pcfg, data)
        gid = trace.global_id
        vals, counts = np.unique(gid, return_counts=True)
        top = np.argsort(counts)[::-1][:n_candidates]
        cand = np.sort(vals[top])
        ids = decode_to_ids(model, pcfg, po, cand, trace)
    return RecMGOutputs(starts, bits, ids)


def frequency_outputs(trace: Trace, capacity: int, in_len: int = 15,
                      out_len: int = 5, *,
                      profile_upto: Optional[int] = None) -> RecMGOutputs:
    """Frequency-heuristic RecMG outputs — a stand-in for the trained
    models that needs no training and is fully deterministic.

    The "model" is the access-frequency profile of the trace prefix up to
    ``profile_upto`` (default: the whole trace): keep-bits mark trunk keys
    that sit in the profile's ``capacity`` hottest ids, and each chunk
    prefetches the next ``out_len`` ids of the hot list in heat order
    (round-robin, so the hottest are re-prefetched most often).

    Two jobs: (a) the scenario matrix's cheap recmg arm — on stationary
    skewed regimes this protects the power-law head and beats LRU, like
    the paper's trained caching model does; (b) the drift experiments'
    *frozen phase-1 model* — profile only the pre-switch prefix
    (``profile_upto``; 0 means an *empty* profile, i.e. a model that has
    seen nothing) and the outputs keep ranking/prefetching stale rows
    after the regime switches, reproducing the decay ``--adapt`` must
    recover from.

    ``profile_upto`` is keyword-only: a positional mixup with ``out_len``
    would silently profile past the freeze point (i.e. train on
    post-switch data) instead of failing loudly."""
    keys = trace.global_id.astype(np.int64)
    n = len(keys)
    prof = keys if profile_upto is None else keys[: profile_upto]
    hot = top_ids_by_count(prof, max(1, int(capacity)))
    hot_sorted = np.sort(hot)

    # Only chunks whose trunk window fits entirely inside the trace (same
    # chunk grid as precompute_outputs); a trace shorter than in_len has
    # zero chunks rather than a ragged first one.  The stride equals the
    # window, so chunk ci's trunk is exactly keys[ci*in_len:(ci+1)*in_len]
    # and all bits come out of one membership pass.
    starts = np.arange(in_len, n - out_len - 1, in_len)
    c = len(starts)
    bits = isin_sorted(hot_sorted, keys[: c * in_len].reshape(c, in_len))
    if hot.size == 0:  # empty profile: nothing to rank or prefetch
        return RecMGOutputs(starts, bits, np.zeros((c, 0), np.int64))
    pf_idx = (np.arange(c)[:, None] * out_len
              + np.arange(out_len)[None, :]) % hot.size
    return RecMGOutputs(starts, bits, hot[pf_idx])


def _replay_segment(access, seg: np.ndarray, res: SimResult,
                    prefetched: set):
    """Serve one chunk of demand accesses through a bulk-access callable
    (``seg -> hit mask``), attributing hits/misses and first-touch
    prefetch hits (vectorized ``searchsorted`` membership)."""
    if not len(seg):
        return
    hits = access(seg)
    nh = int(np.count_nonzero(hits))
    res.accesses += len(seg)
    res.hits += nh
    res.on_demand += len(seg) - nh
    if prefetched:  # only non-empty between a prefetch issue and first use
        n_pf = attribute_prefetch_hits(seg, hits, prefetched)
        res.prefetch_hits += n_pf
        res.prefetch_useful += n_pf


def run_recmg(trace: Trace, capacity: int, outputs: RecMGOutputs,
              eviction_speed: int = 4, pipelined: bool = True,
              use_caching: bool = True, use_prefetch: bool = True,
              oracle_bits: Optional[np.ndarray] = None) -> SimResult:
    """Replay a trace through the RecMG-managed buffer, chunk at a time.

    Accesses between two chunk boundaries are served in one
    ``RecMGBuffer.access_chunk`` call (the bulk path); Algorithm 1 for the
    chunk ending at each boundary is applied right after its segment, one
    chunk late when ``pipelined`` (the paper's CPU-side skew).

    oracle_bits: per-access Belady keep labels — upper-bound variant used by
    benchmarks ("what if the caching model were perfect").
    """
    keys = trace.global_id.astype(np.int64)
    n = len(keys)
    buf = RecMGBuffer(capacity, eviction_speed)
    res = SimResult()
    prefetched = set()

    in_len = (
        outputs.caching_bits.shape[1]
        if outputs.caching_bits is not None
        else 15
    )

    access = lambda seg: buf.access_chunk(seg, eviction_speed)  # noqa: E731
    pending = None  # (trunk, bits, prefetch) applied at next chunk boundary
    seg_start = 0
    for ci, s in enumerate(np.asarray(outputs.chunk_starts,
                                      np.int64).tolist()):
        if s >= n:
            break
        # Segment = accesses up to and including the boundary access s.
        _replay_segment(access, keys[seg_start: s + 1], res, prefetched)
        seg_start = s + 1
        # Chunk boundary: run Algorithm 1 for the *previous* chunk.
        trunk = keys[max(0, s - in_len): s]
        if oracle_bits is not None:
            bits = oracle_bits[max(0, s - in_len): s]
        elif outputs.caching_bits is not None and use_caching:
            bits = outputs.caching_bits[ci]
        else:
            bits = np.zeros(len(trunk), dtype=np.int64)
        pf = (
            outputs.prefetch_ids[ci]
            if (outputs.prefetch_ids is not None and use_prefetch)
            else np.empty(0, np.int64)
        )
        item = (trunk, np.asarray(bits).astype(np.int64),
                np.asarray(pf, np.int64))
        if pipelined:
            item, pending = pending, item
            if item is None:
                continue
        t_, b_, p_ = item
        for p in p_.tolist():
            if not buf.contains(p):
                prefetched.add(p)
                res.prefetch_issued += 1
        buf.load_embeddings(t_, b_, p_)
    _replay_segment(access, keys[seg_start:], res, prefetched)
    return res


def run_lru_pf(trace: Trace, capacity: int, outputs: RecMGOutputs) -> SimResult:
    """LRU + our prefetch model (the paper's single-model ablation LRU+PF),
    replayed chunk-at-a-time through the cache's bulk ``access_many``."""
    keys = trace.global_id.astype(np.int64)
    n = len(keys)
    cache = FALRU(capacity)
    res = SimResult()
    prefetched = set()
    seg_start = 0
    for ci, s in enumerate(np.asarray(outputs.chunk_starts,
                                      np.int64).tolist()):
        if s >= n:
            break
        _replay_segment(cache.access_many, keys[seg_start: s + 1],
                        res, prefetched)
        seg_start = s + 1
        if outputs.prefetch_ids is not None:
            for p in outputs.prefetch_ids[ci]:
                p = int(p)
                if not cache.contains(p):
                    cache.insert_prefetch(p)
                    prefetched.add(p)
                    res.prefetch_issued += 1
    _replay_segment(cache.access_many, keys[seg_start:], res, prefetched)
    return res
