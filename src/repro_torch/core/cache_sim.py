"""Id-stream helpers that the frequency-heuristic RecMG outputs need.

Copied from ``src/repro/core/cache_sim.py`` (``top_ids_by_count`` at line
406 and ``isin_sorted`` at line 419, NumPy only).  The cache simulators of
that module are not on the serving path and are not ported.
"""
from __future__ import annotations

import numpy as np


def top_ids_by_count(ids: np.ndarray, k: int) -> np.ndarray:
    """The ``k`` most frequent ids of a stream, heat-ordered (hottest
    first) with a deterministic tie-break on the id — the shared "what is
    hot" definition used by the drift detector, the adaptation
    controller's pool refresh and the frequency-heuristic model
    (:func:`repro.core.recmg.frequency_outputs`); they must agree or the
    detector and the refresh silently diverge."""
    vals, counts = np.unique(np.asarray(ids, np.int64).ravel(),
                             return_counts=True)
    order = np.lexsort((vals, -counts))
    return vals[order[: max(int(k), 0)]]


def isin_sorted(sorted_vals: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Vectorized membership of ``keys`` in an already-sorted id array
    (one ``searchsorted`` pass; empty-safe)."""
    keys = np.asarray(keys, np.int64)
    if sorted_vals.size == 0:
        return np.zeros(keys.shape, bool)
    pos = np.minimum(np.searchsorted(sorted_vals, keys),
                     sorted_vals.size - 1)
    return sorted_vals[pos] == keys
