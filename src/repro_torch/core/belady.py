"""Belady's MIN (OPT) cache simulator + optgen-style label generation.

The paper trains its caching model on ground-truth labels from optgen [35]
(Hawkeye's liveness-interval implementation of Belady).  We implement the
exact MIN policy directly with a lazy max-heap over next-use times — same
decisions, simpler code — including *bypass* (if the incoming line's next use
is farther than everything cached, OPT doesn't insert it), which is required
for true optimality.

Label semantics (paper §VI-A): the "caching trace" marks, per access, whether
the vector should stay in the buffer — i.e. whether its NEXT use hits under
OPT.  ``belady_labels`` returns exactly that bit per access, plus the
hit/miss outcome stream.  The "prefetch trace" is derived as the accesses
that miss under OPT (vectors OPT could not keep).

Copied from ``src/repro/core/belady.py`` (lines 1-101, NumPy and heapq
only): the port imports nothing of the JAX package, so it keeps its own
copy.
"""
from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np

INF = np.iinfo(np.int64).max


def next_use_times(keys: np.ndarray) -> np.ndarray:
    """next_use[i] = index of next access to keys[i] (INF if none)."""
    n = len(keys)
    nxt = np.full(n, INF, dtype=np.int64)
    last = {}
    for i in range(n - 1, -1, -1):
        k = keys[i]
        j = last.get(k)
        if j is not None:
            nxt[i] = j
        last[k] = i
    return nxt


def belady_sim(keys: np.ndarray, capacity: int,
               bypass: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Exact MIN.  Returns (hits bool (N,), kept bool (N,)).

    ``kept[i]`` is True iff the vector stays in cache from access i until its
    next use (equivalently: its next use is a hit *because of* access i) —
    this is the optgen caching-trace label.
    """
    n = len(keys)
    nxt = next_use_times(keys)
    hits = np.zeros(n, dtype=bool)
    kept = np.zeros(n, dtype=bool)

    cache = {}  # key -> current next-use time
    prev_idx = {}  # key -> index of the access that (re)inserted/touched it
    heap = []  # (-next_use, key, next_use) lazy entries

    for i in range(n):
        k = int(keys[i])
        cur = cache.get(k)
        if cur is not None and cur == i:
            hits[i] = True
            kept[prev_idx[k]] = True
            cache[k] = int(nxt[i])
            prev_idx[k] = i
            heapq.heappush(heap, (-nxt[i], k))
            continue

        # Miss.
        if capacity <= 0:
            continue
        if len(cache) >= capacity:
            if bypass and nxt[i] == INF:
                continue  # never reused: OPT bypasses
            # Find the valid cached key with the farthest next use.
            while heap:
                negnu, kk = heap[0]
                if cache.get(kk) == -negnu:
                    break
                heapq.heappop(heap)
            if heap and bypass and -heap[0][0] <= nxt[i]:
                continue  # incoming is the farthest: bypass
            if len(cache) >= capacity:
                negnu, kk = heapq.heappop(heap)
                del cache[kk]
                prev_idx.pop(kk, None)
        cache[k] = int(nxt[i])
        prev_idx[k] = i
        heapq.heappush(heap, (-nxt[i], k))
    return hits, kept


def belady_labels(keys: np.ndarray, capacity: int):
    """(caching_labels (N,) uint8, hits (N,) bool, prefetch_mask (N,) bool).

    caching_labels: 1 -> keep with high priority (next use hits under OPT).
    prefetch_mask: accesses that miss under OPT — the prefetch model's
    ground-truth targets (paper: "embedding vectors leading to cache
    misses").
    """
    hits, kept = belady_sim(keys, capacity)
    return kept.astype(np.uint8), hits, ~hits
