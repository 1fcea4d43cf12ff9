"""The RecMG buffer manager — Algorithms 1 & 2 of the paper, with the RRIP
semantics the paper cites.

Copied from ``src/repro/core/buffer_manager.py`` (NumPy and stdlib only): the
port imports nothing of the JAX package, so it keeps its own copy.

Each buffer entry carries an integer priority (``eviction_speed = 4``):
the caching model's keep-bit puts just-accessed vectors in the
cache-friendly class (priority = eviction_speed) or the cache-averse class
(priority = 0, evict-next) — Hawkeye-style insertion; prefetched vectors
enter at eviction_speed.  ``populate`` (Algorithm 2) evicts the minimum-
priority entry, aging everyone *on demand* — only as far as needed to bring
that minimum to zero, which is the RRIP scan the paper says it builds on.
(The pseudocode's literal decay-by-1-per-eviction with priorities in
{ev, ev+1} degenerates to LRU under buffer-scale eviction pressure; see
EXPERIMENTS.md §Faithfulness notes — both readings are implemented and
tested.)

The priority order lives in the **array-backed engine** of
:mod:`repro_torch.core.priority_engine` instead of a Python min-heap: dense
``key -> (score, seq)`` NumPy state with lazy epoch aging and batched
victim selection, so the bulk surface — ``set_priorities``, ``fetch_many``,
``populate_many``, ``access_chunk``, ``load_embeddings`` — runs as O(chunk)
vectorized passes with no per-key heap operations.  Eviction-interleaved
chunks (``access_chunk``/``fetch_many``/``load_embeddings`` at capacity)
take an optimistic vectorized plan and fall back to an exact per-key
replay only when a victim is re-accessed inside the same chunk (rare:
victims are the lowest-priority entries).  The original heap
implementation is preserved verbatim in
:mod:`repro.core.buffer_manager_reference`; the property suite proves
victim-for-victim identical eviction order and identical hit masks
against it and against ``SlowRecMGBuffer`` (the literal O(capacity)
transcription below).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch.core.priority_engine import ArrayPriorityEngine


def _as_int_array(keys: Iterable[int]) -> np.ndarray:
    if isinstance(keys, np.ndarray):
        return keys.astype(np.int64, copy=False).ravel()
    return np.asarray(list(keys), np.int64).ravel()


class RecMGBuffer:
    def __init__(self, capacity: int, eviction_speed: int = 4,
                 n_keys_hint: int = 1024):
        self.capacity = max(1, int(capacity))
        self.ev = int(eviction_speed)
        self.engine = ArrayPriorityEngine(n_keys_hint)

    # ---------------- introspection (seed-compatible surface) ----------

    @property
    def epoch(self) -> int:
        return self.engine.epoch

    @property
    def seq(self) -> int:
        return self.engine.seq

    @property
    def score(self) -> Dict[int, int]:
        """Dict view of ``key -> stored_priority + epoch_at_set`` (the
        heap's ``score`` map; rebuilt from the dense arrays — tests and
        debugging only, O(key space))."""
        eng = self.engine
        live = np.flatnonzero(eng._live)
        return {int(k): int(s) for k, s in zip(live, eng._score[live])}

    def __len__(self):
        return self.engine.count

    def contains(self, key: int) -> bool:
        return self.engine.contains(int(key))

    # ---------------- single-key API ----------------

    def set_priority(self, key: int, priority: int):
        """Insert ``key`` or refresh its priority (public single-key API)."""
        self.engine.set_one(key, priority)

    # Backwards-compatible alias; callers should use ``set_priority``.
    _set_priority = set_priority

    def populate(self) -> Optional[int]:
        """Algorithm 2 with RRIP aging semantics: evict the minimum-priority
        entry; decay everyone only as far as needed to bring that minimum to
        zero (the RRIP "age until a victim exists" scan, via the epoch).

        The paper's pseudocode decays by exactly 1 per call; under buffer-
        sized eviction pressure that makes the recency epoch swamp the 0..5
        priority range and the policy degenerates to LRU (±0.4% in our
        measurements).  Age-on-demand keeps the caching model's bit decisive
        — which is the behavior of the RRIP family the paper says it builds
        on, and the only reading that reproduces its Fig. 8 gains.  See
        EXPERIMENTS.md §Faithfulness notes.
        """
        return self.engine.pop_min()

    def _make_room(self):
        eng = self.engine
        while eng.count >= self.capacity:
            if eng.pop_min() is None:
                break

    def fetch(self, key: int, priority: int):
        """Insert (or re-prioritize) a vector."""
        if not self.engine.contains(int(key)):
            self._make_room()
        self.set_priority(key, priority)

    # ---------------- bulk (chunk-at-a-time) API ----------------

    def set_priorities(self, keys: Iterable[int], priority: int,
                       only_new: bool = False):
        """Batched :meth:`set_priority` over a chunk of keys — one
        vectorized engine pass.

        ``only_new=True`` skips keys that already hold an entry (the
        admission-time insert of the tiered store, which must not demote a
        key the caching model just ranked)."""
        self.engine.set_many(_as_int_array(keys), int(priority),
                             only_new=only_new)

    def _fits_without_eviction(self, keys: np.ndarray) -> bool:
        """True when inserting ``keys`` cannot trigger an eviction.  The
        distinct new-key count is upper-bounded first (duplicate dead keys
        counted twice — cheap) and deduped only when the bound is tight."""
        eng = self.engine
        n_new = int(np.count_nonzero(~eng._live[keys]))
        if n_new and eng.count + n_new > self.capacity:
            n_new = int(np.unique(keys[~eng._live[keys]]).size)
        return eng.count + n_new <= self.capacity

    def fetch_many(self, keys: Iterable[int], priority: int):
        """Batched :meth:`fetch`: insert a chunk, evicting as needed.
        Fully vectorized when the chunk fits without eviction; otherwise
        an exact per-key replay (evictions interleave with refreshes that
        can change the victim order mid-chunk)."""
        keys = _as_int_array(keys)
        if not keys.size:
            return
        self.engine._ensure(int(keys.max()))
        if self._fits_without_eviction(keys):
            self.engine.set_many(keys, int(priority))
            return
        for k in keys.tolist():
            self.fetch(k, priority)

    def populate_many(self, n: int) -> List[int]:
        """Evict up to ``n`` victims in one call (Algorithm 2, batched —
        vectorized prefix pops instead of n heap scans)."""
        return self.engine.pop_min_many(int(n))

    def access_chunk(self, keys: np.ndarray, priority: int) -> np.ndarray:
        """Serve a chunk of demand accesses; returns a per-access hit mask.

        A miss fetches the key at ``priority`` (the tiered runtime's
        on-demand insert).  Vectorized: hit/miss partition in one pass;
        misses admit through the engine's interleaved batched eviction.
        The optimistic plan assumes no victim is re-accessed later in the
        same span — when one is (the only case where an eviction changes
        a later hit), the plan is undone and the longest conflict-free
        prefix commits instead, restarting from the re-access.  Each span
        is one vectorized pass, so a chunk costs O(1 + conflicts)
        passes."""
        keys = np.asarray(keys, np.int64).ravel()
        n = keys.size
        hits = np.empty(n, dtype=bool)
        if n == 0:
            return hits
        eng = self.engine
        eng._ensure(int(keys.max()))
        if n <= 16:
            # Tiny chunks (the simulators' 15-access segments): the exact
            # per-key replay through the engine's scalar fast path beats
            # the fixed cost of the vectorized plan.
            at_cap = self.capacity <= eng.count + n
            pr = int(priority)
            for i, k in enumerate(keys.tolist()):
                h = eng.contains(k)
                hits[i] = h
                if not h:
                    if at_cap:
                        self._make_room()
                    eng.set_one(k, pr)
            return hits
        lo = 0
        while lo < n:
            lo += self._access_span(keys[lo:], int(priority), hits[lo:])
        return hits

    def _access_span(self, keys: np.ndarray, priority: int,
                     hits: np.ndarray) -> int:
        """Optimistically plan the whole span, commit the longest
        conflict-free prefix; fill ``hits`` for it and return its
        length (>= 1)."""
        eng = self.engine
        n = keys.size
        at_cap = self.capacity <= eng.count + n  # may need room
        live0 = eng._live[keys].copy()
        u, first = np.unique(keys, return_index=True)
        is_first = np.zeros(n, bool)
        is_first[first] = True
        miss_first_pos = np.flatnonzero(is_first & ~live0)
        miss_keys = keys[miss_first_pos]
        if not at_cap:
            eng.set_many(miss_keys, priority)
            hits[:n] = live0 | ~is_first
            return n
        n_no_evict = max(0, self.capacity - eng.count)
        # Refresh-only APIs never evict, so replay can run over capacity;
        # the first miss's _make_room then drains the whole overflow.
        pre_drain = max(0, eng.count - self.capacity) if miss_keys.size else 0
        victims, own, kept, token = eng.admit_interleaved(
            miss_keys, priority, n_no_evict, undoable=True,
            pre_drain=pre_drain)
        if victims.size:
            # Conflict check: drained victims fall at the first miss;
            # interleaved eviction t is triggered by the miss at span
            # position miss_first_pos[n_no_evict + t].  A victim whose key
            # re-appears later than that invalidates the optimistic hits
            # from that re-access on.
            vpos = np.empty(victims.size, np.int64)
            vpos[:pre_drain] = miss_first_pos[0]
            vpos[pre_drain:] = miss_first_pos[
                n_no_evict + np.arange(victims.size - pre_drain)]
            last_rev = np.unique(keys[::-1], return_index=True)[1]
            last_occ = n - 1 - last_rev  # aligned with sorted-unique u
            pos_u = np.searchsorted(u, victims)
            pos_c = np.minimum(pos_u, u.size - 1)
            confl = (u[pos_c] == victims) & (last_occ[pos_c] > vpos)
            if np.any(confl):
                # Earliest re-access of any victim after its eviction: the
                # plan is exact strictly before it.  (A victim's eviction
                # position precedes any of its re-accesses, so q_star >= 1
                # and the restart always makes progress.)
                order = np.argsort(keys, kind="stable")
                ks = keys[order]
                left = np.searchsorted(ks, victims, side="left")
                right = np.searchsorted(ks, victims, side="right")
                q_star = n
                for i in np.flatnonzero(confl).tolist():
                    span = order[left[i]:right[i]]
                    j = int(np.searchsorted(span, vpos[i], side="right"))
                    if j < span.size:
                        q_star = min(q_star, int(span[j]))
                eng.undo(token)
                # The victim sequence of the shorter prefix is a prefix of
                # this plan's, so the re-run is conflict-free by q_star's
                # minimality and commits in one pass.
                return self._access_span(keys[:q_star], priority,
                                         hits[:q_star])
        hits[:n] = live0 | ~is_first
        return n

    def load_embeddings(self, trunk: Iterable[int], caching_bits: Iterable[int],
                        prefetch_keys: Iterable[int],
                        scaled_bits: bool = True):
        """Algorithm 1.  ``trunk`` = the most recently accessed chunk (already
        fetched on demand); caching_bits = the caching model's output C.

        ``scaled_bits=True`` gives the keep/evict classes RRIP-separated
        priorities (keep -> eviction_speed, evict -> 0/evict-next — Hawkeye's
        cache-friendly/averse insertion, which the paper builds on).  The
        paper's literal ``C[i] + eviction_speed`` keeps both classes within
        1 of each other and measures within noise of LRU; see EXPERIMENTS.md
        §Faithfulness notes.

        Vectorized whenever the chunk fits without eviction — which is
        always the case in the tiered store, whose ranking buffer is
        unbounded; the at-capacity simulator path replays per key because
        refreshes there can re-order victims mid-chunk."""
        trunk = _as_int_array(trunk)
        bits = (caching_bits if isinstance(caching_bits, np.ndarray)
                else np.asarray(list(caching_bits)))
        bits = bits.astype(np.int64, copy=False).ravel()
        pf = _as_int_array(prefetch_keys)
        m = min(trunk.size, bits.size)  # zip semantics: shorter side wins
        trunk, bits = trunk[:m], bits[:m]
        prs = bits * self.ev if scaled_bits else bits + self.ev
        eng = self.engine
        both = np.concatenate((trunk, pf))
        if both.size:
            eng._ensure(int(both.max()))
        if not both.size or self._fits_without_eviction(both):
            if trunk.size:
                eng.set_many(trunk, prs)
            if pf.size:
                eng.set_many(pf, self.ev, only_new=True)
            return
        for k, pr in zip(trunk.tolist(), prs.tolist()):
            if eng.contains(k):
                self.set_priority(k, pr)
            else:
                self.fetch(k, pr)
        for k in pf.tolist():
            if not eng.contains(k):
                self.fetch(k, self.ev)
                # paper: priority[P[i]] = eviction_speed ("high" so the
                # prefetch survives until its use)


class SlowRecMGBuffer:
    """Literal transcription of Algorithms 1 & 2 (O(capacity) eviction) —
    used to validate RecMGBuffer in tests.

    ``clamp`` is the paper's ``max(0, p-1)``; it only compresses ties among
    long-decayed entries (the paper doesn't specify tie order).  The O(log n)
    epoch formulation is order-identical to ``clamp=False``."""

    def __init__(self, capacity: int, eviction_speed: int = 4,
                 clamp: bool = True):
        self.capacity = max(1, int(capacity))
        self.ev = int(eviction_speed)
        self.clamp = clamp
        self.priority: Dict[int, int] = {}
        self.order: Dict[int, int] = {}
        self.seq = 0

    def __len__(self):
        return len(self.priority)

    def contains(self, key):
        return key in self.priority

    def populate(self):
        victim = min(
            self.priority, key=lambda k: (self.priority[k], self.order[k])
        )
        # RRIP aging: decay everyone by the victim's priority (age until a
        # zero-priority victim exists), then evict it.
        dec = max(0, self.priority[victim])
        lo = 0 if self.clamp else -(1 << 60)
        if dec:
            for k in self.priority:
                self.priority[k] = max(lo, self.priority[k] - dec)
        del self.priority[victim]
        del self.order[victim]
        return victim

    def fetch(self, key, priority):
        if key not in self.priority:
            while len(self.priority) >= self.capacity:
                self.populate()
        self.priority[key] = priority
        self.seq += 1
        self.order[key] = self.seq

    def load_embeddings(self, trunk, caching_bits, prefetch_keys,
                        scaled_bits: bool = True):
        for key, c in zip(trunk, caching_bits):
            pr = int(c) * self.ev if scaled_bits else int(c) + self.ev
            self.fetch(key, pr)
        for key in prefetch_keys:
            if key not in self.priority:
                self.fetch(key, self.ev)
