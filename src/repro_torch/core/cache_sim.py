"""Cache-simulation pieces that the RecMG outputs and replay drivers need.

Copied from ``src/repro/core/cache_sim.py`` (NumPy and stdlib only):
``FALRU`` (lines 27-90, with ``CacheBase``'s ``insert_prefetch`` folded
in: it is the only cache here), ``attribute_prefetch_hits``
(line 383), ``top_ids_by_count`` (line 406), ``isin_sorted`` (line 419) and
``SimResult`` (line 431).  The other simulators of that module (set-
associative, RRIP, Hawkeye, Belady caches) are not on the serving path and
are not ported.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np


class FALRU:
    """Fully-associative LRU."""

    def __init__(self, capacity):
        self.capacity = max(1, int(capacity))
        self.od = OrderedDict()

    def contains(self, key):
        return key in self.od

    def access(self, key):
        hit = key in self.od
        if hit:
            self.od.move_to_end(key)
        else:
            if len(self.od) >= self.capacity:
                self.od.popitem(last=False)
            self.od[key] = True
        return hit

    def insert_prefetch(self, key) -> None:
        """A prefetch inserts like a demand miss (no touch)."""
        if not self.contains(key):
            self.access(key)

    def access_many(self, keys):
        # Tight chunk loop: bound methods hoisted, no per-access dispatch.
        od, cap = self.od, self.capacity
        move, pop = od.move_to_end, od.popitem
        out = np.empty(len(keys), dtype=bool)
        for i, k in enumerate(keys.tolist() if isinstance(keys, np.ndarray)
                              else keys):
            if k in od:
                move(k)
                out[i] = True
            else:
                if len(od) >= cap:
                    pop(last=False)
                od[k] = True
                out[i] = False
        return out


def attribute_prefetch_hits(seg: np.ndarray, hits: np.ndarray,
                            prefetched: set) -> int:
    """Vectorized first-touch prefetch attribution over one replayed chunk.

    For every key of ``seg`` that sits in ``prefetched``, its *first*
    occurrence decides (hit -> one attributed prefetch hit) and the key is
    retired from the set — identical to the per-key loop the replay
    drivers used, but as one ``searchsorted`` membership pass against the
    sorted prefetched ids.  Returns the number of attributed hits and
    mutates ``prefetched`` in place."""
    if not prefetched:
        return 0
    pf = np.fromiter(prefetched, np.int64, len(prefetched))
    pf.sort()
    present = np.flatnonzero(isin_sorted(pf, seg))
    if present.size == 0:
        return 0
    u, first = np.unique(seg[present], return_index=True)
    n_hit = int(np.count_nonzero(hits[present[first]]))
    prefetched.difference_update(u.tolist())
    return n_hit


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


@dataclass
class SimResult:
    accesses: int = 0
    hits: int = 0  # total buffer hits
    prefetch_hits: int = 0  # first-touch hits on prefetched entries
    on_demand: int = 0  # misses -> on-demand fetches from slow tier
    prefetch_issued: int = 0
    prefetch_useful: int = 0  # prefetched entries demanded before eviction

    @property
    def hit_rate(self):
        return self.hits / max(self.accesses, 1)

    @property
    def cache_hits(self):
        return self.hits - self.prefetch_hits

    @property
    def prefetch_accuracy(self):
        return self.prefetch_useful / max(self.prefetch_issued, 1)

    def as_dict(self):
        return {
            "accesses": self.accesses, "hits": self.hits,
            "cache_hits": self.cache_hits, "prefetch_hits": self.prefetch_hits,
            "on_demand": self.on_demand, "hit_rate": round(self.hit_rate, 4),
            "prefetch_issued": self.prefetch_issued,
            "prefetch_accuracy": round(self.prefetch_accuracy, 4),
        }
