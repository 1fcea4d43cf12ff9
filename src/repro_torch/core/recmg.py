"""RecMG model outputs that the serving loop stages into the store.

Ported from ``src/repro/core/recmg.py`` (``RecMGOutputs`` at lines 33-39 and
``frequency_outputs`` at lines 71-115), both NumPy only.  That module is
copied in part rather than imported because it pulls in the JAX models at
import time.  ``precompute_outputs`` and ``run_recmg`` come with the
learned models.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.cache_sim import isin_sorted, top_ids_by_count
from repro_torch.core.trace import Trace


@dataclass
class RecMGOutputs:
    """Precomputed model outputs for every chunk of a trace."""

    chunk_starts: np.ndarray  # (C,) index of first access of each chunk
    caching_bits: Optional[np.ndarray]  # (C, in_len) bool
    prefetch_ids: Optional[np.ndarray]  # (C, out_len) int64


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
