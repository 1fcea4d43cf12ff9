"""Cache-policy simulators at embedding-vector granularity.

Copied from ``src/repro/core/cache_sim.py`` (NumPy and stdlib only): the
port imports nothing of the JAX package, so it keeps its own copy of the
whole module — the policies (``CacheBase`` through ``BeladyCache``, with
their seeded RNGs and signature tables), ``POLICIES``, ``make_cache``,
``simulate`` and the helpers the serving path shares.  ``simulate`` takes
the port's prefetchers (:mod:`repro_torch.core.prefetchers`).

The paper evaluates LRU/LFU (fully- and 32-way set-associative), SRRIP,
DRRIP, Hawkeye, Mockingjay-style reuse predictors, and Belady's OPT, all
treating an embedding vector as the atomic replacement unit (ChampSim in the
paper; reimplemented natively here — see DESIGN.md §7).

All policies implement ``access(key) -> bool`` (True = hit),
``insert_prefetch(key)``, and a bulk ``access_many(keys) -> hit mask`` used
for chunk-at-a-time replay; a unified ``simulate`` loop attributes hits
to {caching policy, prefetcher} and counts on-demand fetches, reproducing
the paper's Figure 14 breakdown.
"""
from __future__ import annotations

from collections import Counter, OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.belady import belady_sim

INF = np.iinfo(np.int64).max


class CacheBase:
    name = "base"

    def __init__(self, capacity: int):
        self.capacity = max(1, int(capacity))

    def access(self, key) -> bool:  # demand access
        raise NotImplementedError

    def contains(self, key) -> bool:
        raise NotImplementedError

    def insert_prefetch(self, key) -> None:
        """Default: prefetch inserts like a demand miss (no touch)."""
        if not self.contains(key):
            self.access(key)

    def access_many(self, keys: np.ndarray) -> np.ndarray:
        """Bulk demand-access path: serve a chunk of keys, return a hit
        mask.  Policies override this with a tighter loop; the default just
        removes per-access dispatch from the replay loop."""
        access = self.access
        return np.fromiter((access(int(k)) for k in keys), dtype=bool,
                           count=len(keys))


class FALRU(CacheBase):
    """Fully-associative LRU."""

    name = "lru_fa"

    def __init__(self, capacity):
        super().__init__(capacity)
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


class SetAssoc(CacheBase):
    """k-way set-associative base; subclasses define victim choice."""

    def __init__(self, capacity, ways: int = 32):
        super().__init__(capacity)
        self.ways = min(ways, self.capacity)  # never exceed total capacity
        self.n_sets = max(1, self.capacity // self.ways)
        self.sets: List[Dict] = [dict() for _ in range(self.n_sets)]

    def _set(self, key):
        return self.sets[hash(key) % self.n_sets]

    def contains(self, key):
        return key in self._set(key)

    def on_hit(self, s, key):
        raise NotImplementedError

    def on_fill(self, s, key):
        raise NotImplementedError

    def victim(self, s):
        raise NotImplementedError

    def access(self, key):
        s = self._set(key)
        if key in s:
            self.on_hit(s, key)
            return True
        if len(s) >= self.ways:
            del s[self.victim(s)]
        self.on_fill(s, key)
        return False


class SALRU(SetAssoc):
    name = "lru_32w"

    def __init__(self, capacity, ways=32):
        super().__init__(capacity, ways)
        self.clock = 0

    def on_hit(self, s, key):
        self.clock += 1
        s[key] = self.clock

    on_fill = on_hit

    def victim(self, s):
        return min(s, key=s.get)


class SALFU(SetAssoc):
    name = "lfu_32w"

    def on_hit(self, s, key):
        s[key] = s.get(key, 0) + 1

    def on_fill(self, s, key):
        s[key] = 1

    def victim(self, s):
        return min(s, key=s.get)


class SRRIP(SetAssoc):
    """Static RRIP [38]: 2-bit re-reference interval prediction."""

    name = "srrip"
    MAX = 3
    insert_rrpv = 2

    def on_hit(self, s, key):
        s[key] = 0

    def on_fill(self, s, key):
        s[key] = self.insert_rrpv

    def victim(self, s):
        while True:
            for k, v in s.items():
                if v >= self.MAX:
                    return k
            for k in s:
                s[k] += 1


class BRRIP(SRRIP):
    """Bimodal RRIP: mostly distant (MAX), occasionally long (MAX-1)."""

    name = "brrip"

    def __init__(self, capacity, ways=32, seed=0):
        super().__init__(capacity, ways)
        self.rng = np.random.default_rng(seed)

    def on_fill(self, s, key):
        s[key] = self.MAX - 1 if self.rng.random() < 1 / 32 else self.MAX


class DRRIP(SetAssoc):
    """Dynamic RRIP via set dueling between SRRIP and BRRIP inserts."""

    name = "drrip"
    MAX = 3

    def __init__(self, capacity, ways=32, seed=0):
        super().__init__(capacity, ways)
        self.rng = np.random.default_rng(seed)
        n = self.n_sets
        self.leader_s = set(range(0, n, 32))
        self.leader_b = set(range(1, n, 32))
        self.psel = 512

    def _set_idx(self, key):
        return hash(key) % self.n_sets

    def access(self, key):
        idx = self._set_idx(key)
        s = self.sets[idx]
        if key in s:
            s[key] = 0
            return True
        # PSEL bookkeeping: leader-set misses move the selector.
        if idx in self.leader_s:
            self.psel = min(1023, self.psel + 1)
        elif idx in self.leader_b:
            self.psel = max(0, self.psel - 1)
        if len(s) >= self.ways:
            while True:
                vic = next((k for k, v in s.items() if v >= self.MAX), None)
                if vic is not None:
                    del s[vic]
                    break
                for k in s:
                    s[k] += 1
        use_brrip = (
            idx in self.leader_b
            or (idx not in self.leader_s and self.psel >= 512)
        )
        if use_brrip:
            s[key] = self.MAX - 1 if self.rng.random() < 1 / 32 else self.MAX
        else:
            s[key] = 2
        return False

    def contains(self, key):
        return key in self.sets[self._set_idx(key)]


class HawkeyeLite(SetAssoc):
    """Hawkeye [36] adapted to embedding traces: the PC proxy is the table
    id (paper §VII-A); an online Belady emulation over a sampled window
    trains a per-table cache-friendly/averse predictor that drives
    RRIP-style insertion."""

    name = "hawkeye"
    MAX = 7

    def __init__(self, capacity, ways=32, table_of=None):
        super().__init__(capacity, ways)
        self.table_of = table_of or (lambda k: k >> 40)
        self.pred: Counter = Counter()
        self.last_use: Dict = {}
        self.occ = 0  # crude occupancy proxy for the sampled OPT emulation
        self.window = 8 * self.capacity

    def access(self, key):
        s = self._set(key)
        t = self.table_of(key)
        # OPTgen-lite: if the key was used within `capacity` distinct-ish
        # accesses, OPT would have hit -> the table is cache-friendly.
        self.occ += 1
        lu = self.last_use.get(key)
        if lu is not None:
            if self.occ - lu <= self.capacity:
                self.pred[t] = min(7, self.pred[t] + 1)
            else:
                self.pred[t] = max(-8, self.pred[t] - 1)
        self.last_use[key] = self.occ
        if len(self.last_use) > 4 * self.capacity:
            # Bound metadata: drop oldest half.
            items = sorted(self.last_use.items(), key=lambda kv: kv[1])
            self.last_use = dict(items[len(items) // 2:])

        if key in s:
            s[key] = 0 if self.pred[t] >= 0 else self.MAX
            return True
        if len(s) >= self.ways:
            vic = max(s.items(), key=lambda kv: kv[1])[0]
            del s[vic]
        s[key] = 0 if self.pred[t] >= 0 else self.MAX
        for k in list(s):
            if k != key and s[k] < self.MAX:
                s[k] += 1
        return False


class MockingjayLite(SetAssoc):
    """Mockingjay [69] adapted to embedding traces: predict each line's
    reuse distance from a sampled per-(table, row-bucket) history and evict
    the line with the largest predicted time-to-reuse.  The paper finds this
    class of PC-keyed predictors underperforms on user-driven embedding
    accesses — reproduced in fig15."""

    name = "mockingjay"

    def __init__(self, capacity, ways=32, table_of=None, bucket: int = 512):
        super().__init__(capacity, ways)
        self.table_of = table_of or (lambda k: k >> 40)
        self.bucket = bucket
        self.ewma: Dict = {}  # signature -> predicted reuse distance
        self.last_use: Dict = {}
        self.clock = 0

    def _sig(self, key):
        return (self.table_of(key), key % self.bucket)

    def _observe(self, key):
        self.clock += 1
        lu = self.last_use.get(key)
        if lu is not None:
            d = self.clock - lu
            sig = self._sig(key)
            prev = self.ewma.get(sig, d)
            self.ewma[sig] = 0.8 * prev + 0.2 * d
        self.last_use[key] = self.clock
        if len(self.last_use) > 8 * self.capacity:
            items = sorted(self.last_use.items(), key=lambda kv: kv[1])
            self.last_use = dict(items[len(items) // 2:])

    def _predicted_next_use(self, key):
        return self.last_use.get(key, self.clock) + self.ewma.get(
            self._sig(key), 4 * self.capacity)

    def on_hit(self, s, key):
        s[key] = self._predicted_next_use(key)

    on_fill = on_hit

    def access(self, key):
        self._observe(key)
        return super().access(key)

    def victim(self, s):
        return max(s, key=s.get)  # farthest predicted reuse


class BeladyCache(CacheBase):
    """OPT replay (needs the whole key stream up front)."""

    name = "belady"

    def __init__(self, capacity, keys: np.ndarray):
        super().__init__(capacity)
        self.hits, _ = belady_sim(keys, capacity)
        self.i = 0

    def contains(self, key):
        return bool(self.hits[self.i])

    def access(self, key):
        h = bool(self.hits[self.i])
        self.i += 1
        return h


POLICIES = {
    "lru_fa": FALRU,
    "lru_32w": SALRU,
    "lfu_32w": SALFU,
    "srrip": SRRIP,
    "brrip": BRRIP,
    "drrip": DRRIP,
    "hawkeye": HawkeyeLite,
    "mockingjay": MockingjayLite,
}


def make_cache(name: str, capacity: int, keys: Optional[np.ndarray] = None):
    if name == "belady":
        return BeladyCache(capacity, keys)
    return POLICIES[name](capacity)


# ---------------------------------------------------------------------------
# Unified simulation with prefetch attribution (paper Fig. 14 breakdown)
# ---------------------------------------------------------------------------


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
    (:func:`repro_torch.core.recmg.frequency_outputs`); they must agree or the
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


def simulate(keys: np.ndarray, cache: CacheBase, prefetcher=None,
             max_inflight_per_access: int = 8) -> SimResult:
    """Drive a key stream through (cache, prefetcher).

    Without a prefetcher the whole trace replays through the cache's bulk
    ``access_many`` (chunk-at-a-time); prefetchers need per-access candidate
    generation, so that path stays access-at-a-time."""
    if prefetcher is None:
        hits = cache.access_many(np.asarray(keys))
        res = SimResult()
        res.accesses = len(keys)
        res.hits = int(np.count_nonzero(hits))
        res.on_demand = res.accesses - res.hits
        return res
    res = SimResult()
    prefetched = set()  # resident-and-not-yet-demanded prefetch fills
    for key in keys:
        key = int(key)
        hit = cache.access(key)
        res.accesses += 1
        if hit:
            res.hits += 1
            if key in prefetched:
                res.prefetch_hits += 1
                res.prefetch_useful += 1
                prefetched.discard(key)
        else:
            res.on_demand += 1
            prefetched.discard(key)
        if prefetcher is not None:
            cands = prefetcher.on_access(key, hit)
            for c in cands[:max_inflight_per_access]:
                c = int(c)
                if not cache.contains(c):
                    cache.insert_prefetch(c)
                    prefetched.add(c)
                    res.prefetch_issued += 1
    return res
