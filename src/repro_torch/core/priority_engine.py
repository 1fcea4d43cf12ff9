"""Vectorized array-backed RRIP/priority engine — the structure behind
:class:`~repro.core.buffer_manager.RecMGBuffer`.

Copied from ``src/repro/core/priority_engine.py`` (NumPy and stdlib only): the
port imports nothing of the JAX package, so it keeps its own copy.

The seed kept the RecMG priority order in a lazy min-heap: every
insert/refresh/eviction was one Python ``heapq`` operation, which made the
paper's ML-guided policy ~4.5x slower per serving batch than plain LRU even
though the *modeled* fetch cost was near-identical — the bookkeeping, not
the slow tier, was the bottleneck.  This engine replaces the heap with
dense NumPy state so every bulk operation is an O(chunk) vectorized pass:

* ``_score``  (K,) int64 — ``stored_priority + epoch_at_set`` per key (the
  same epoch trick as the heap: age-by-d == ``epoch += d``; effective
  priority = ``_score[k] - epoch`` and eviction order is the *static* key
  ``(_score[k], _seq[k])``, so aging never rewrites per-key state).
* ``_seq``    (K,) int64 — insertion sequence of the key's live entry
  (admission-order tie-break, identical to the heap's ``seq``).
* ``_live``   (K,) bool  — membership.  ``K`` grows geometrically with the
  largest key seen (keys are embedding ids: dense non-negative ints).

Victim *order* is found through sorted **candidate runs** — a
log-structured merge hierarchy: ``set_many`` appends O(chunk) pending
``_dirty`` chunks (each born sorted: batch inserts share one score and
carry ascending seqs), which fold into a new run before any eviction
(``_consolidate``); runs then collapse binary-counter style (a run merges
with its predecessor whenever it has grown at least as large), so there
are O(log n) runs and every entry is merged O(log n) times total.
Entries are validated lazily against ``_seq`` — a refresh leaves its
stale older copies in the runs, and pops skip them exactly like the
heap's lazy invalidation.

Batched victim selection (``pop_min_many``, ``admit_interleaved``) pops
vectorized *prefixes*: the run holding the global minimum surrenders every
entry below the other runs' heads in one ``searchsorted`` pass, so a batch
of ``n`` evictions costs O(runs + n) instead of n heap pops.
``admit_interleaved`` additionally replays the tiered store's admission
loop — one eviction before each insert once the buffer is full — and
resolves **own-batch evictions** (an inserted key evicted by a later key
of the same batch) vectorially, by treating the batch itself as a third
sorted run whose scores are materialized incrementally as the epoch
evolves.  ``tests/test_property_equivalence.py`` proves victim-for-victim
equality against the heap reference
(:mod:`repro.core.buffer_manager_reference`) and the literal
``SlowRecMGBuffer`` transcription.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

_EMPTY = np.empty(0, np.int64)
_EMPTY_B = np.empty(0, bool)


class _Run:
    """One sorted candidate run: entries ordered by ``(score, seq)``,
    consumed from ``head``.  Stale entries (superseded by a refresh or
    already popped) are detected lazily via the dense ``_seq`` array."""

    __slots__ = ("keys", "scores", "seqs", "head")

    def __init__(self, keys: np.ndarray, scores: np.ndarray,
                 seqs: np.ndarray, head: int = 0):
        self.keys = keys
        self.scores = scores
        self.seqs = seqs
        self.head = head

    def __len__(self):
        return len(self.keys) - self.head


class ArrayPriorityEngine:
    """Dense ``key -> (score, seq)`` priority map with batched min-pops.

    Keys must be non-negative integers (embedding ids).  All mutating
    operations accept chunks; per-key Python appears only on the lazy
    stale-skip at run heads (amortized O(1) per superseded entry).
    """

    def __init__(self, n_keys_hint: int = 1024):
        n = max(16, int(n_keys_hint))
        self._score = np.zeros(n, np.int64)
        self._seq = np.zeros(n, np.int64)
        self._live = np.zeros(n, bool)
        self.epoch = 0
        self.seq = 0
        self.count = 0
        # Sorted candidate runs, largest first (binary-counter LSM: a
        # newly consolidated chunk merges with the previous run whenever
        # it has grown at least as large, so there are O(log n) runs and
        # every entry participates in O(log n) merges overall).
        self._runs: List[_Run] = []
        self._dirty: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._n_dirty = 0
        # Scalar nursery: single-key sets append plain (key, score, seq)
        # tuples here — no per-key array allocation — and ``pop_min``
        # scans it directly, so the interleaved set/pop regime of the
        # trace simulators never pays a consolidation per pop.
        self._sdirty: List[Tuple[int, int, int]] = []

    # ---------------- dense state ----------------

    def _ensure(self, kmax: int):
        n = self._live.size
        if kmax < n:
            return
        new = 1 << int(kmax + 1).bit_length()
        for name in ("_score", "_seq"):
            a = np.zeros(new, np.int64)
            a[:n] = getattr(self, name)
            setattr(self, name, a)
        live = np.zeros(new, bool)
        live[:n] = self._live
        self._live = live

    def contains(self, key: int) -> bool:
        return 0 <= key < self._live.size and bool(self._live[key])

    def contains_many(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, np.int64).ravel()
        if keys.size:
            self._ensure(int(keys.max()))
        return self._live[keys]

    def live_keys(self) -> np.ndarray:
        """All live keys (introspection; O(K))."""
        return np.flatnonzero(self._live)

    def _valid(self, keys: np.ndarray, seqs: np.ndarray) -> np.ndarray:
        return self._live[keys] & (self._seq[keys] == seqs)

    # ---------------- inserts / refreshes ----------------

    def set_one(self, key: int, priority: int):
        """Scalar insert/refresh — the no-array fast path for per-key
        callers (``set_priority``/``fetch`` and the simulators' exact
        replay segments)."""
        key = int(key)
        self._ensure(key)
        s = int(priority) + self.epoch
        self.seq += 1
        if not self._live[key]:
            self._live[key] = True
            self.count += 1
        self._score[key] = s
        self._seq[key] = self.seq
        self._sdirty.append((key, s, self.seq))
        if len(self._sdirty) > 64:
            self._consolidate()

    def set_many(self, keys, priorities, only_new: bool = False):
        """Batched insert/refresh: ``score = priority + epoch`` and a fresh
        seq per *occurrence* (duplicates: the last occurrence wins, exactly
        like the sequential loop).  ``only_new=True`` skips keys already
        live (and within-chunk re-occurrences), consuming no seq for them.
        ``priorities`` is a scalar or a per-key array."""
        keys = np.asarray(keys, np.int64).ravel()
        if keys.size == 0:
            return
        self._ensure(int(keys.max()))
        scalar = np.ndim(priorities) == 0
        if not scalar:
            priorities = np.asarray(priorities, np.int64).ravel()[:keys.size]
        owned = False  # the dirty queue must own its key arrays: a caller
        # may reuse/mutate its buffer after we return (mask/fancy indexing
        # below always produces a fresh array, so those paths are owned).
        if only_new:
            alive = self._live[keys]
            keys = keys[~alive]
            if not scalar:
                priorities = priorities[~alive]
            owned = True
            if keys.size > 1:
                u, first = np.unique(keys, return_index=True)
                if u.size < keys.size:
                    sel = np.sort(first)
                    keys = keys[sel]
                    if not scalar:
                        priorities = priorities[sel]
            if keys.size == 0:
                return
        m = keys.size
        if scalar:
            scores = np.full(m, int(priorities) + self.epoch, np.int64)
        else:
            scores = priorities + self.epoch
        seqs = np.arange(self.seq + 1, self.seq + 1 + m, dtype=np.int64)
        self.seq += m
        if only_new:
            self.count += m
        elif m == 1:
            self.count += 0 if self._live[keys[0]] else 1
        else:
            dead = keys[~self._live[keys]]
            if dead.size:  # dedup only the (typically tiny) dead subset
                self.count += (1 if dead.size == 1
                               else int(np.unique(dead).size))
        self._score[keys] = scores
        self._seq[keys] = seqs
        self._live[keys] = True
        if not owned:
            keys = keys.copy()  # dirty parts are re-sorted at consolidation
        self._dirty.append((keys, scores, seqs))
        self._n_dirty += m

    # ---------------- run maintenance ----------------

    def _sorted_run(self, parts) -> _Run:
        """Concatenate (keys, scores, seqs) parts, drop stale entries,
        and lexsort into one run."""
        k = np.concatenate([p[0] for p in parts])
        s = np.concatenate([p[1] for p in parts])
        q = np.concatenate([p[2] for p in parts])
        v = self._valid(k, q)
        k, s, q = k[v], s[v], q[v]
        order = np.lexsort((q, s))
        return _Run(k[order], s[order], q[order])

    def _append_run(self, new: _Run):
        """Append a sorted run, then cascade binary-counter merges: while
        the newest run has grown at least as large as its predecessor,
        the two collapse into one (with stale filtering).  Keeps the run
        count at O(log n) and amortizes every merge to O(log n) per
        entry — a per-chunk append never touches the big runs until
        enough small ones have piled up."""
        self._runs = runs = [r for r in self._runs if len(r)]
        if len(new):
            runs.append(new)
        while len(runs) > 1 and len(runs[-1]) >= len(runs[-2]):
            b, a = runs.pop(), runs.pop()
            merged = self._sorted_run([
                (a.keys[a.head:], a.scores[a.head:], a.seqs[a.head:]),
                (b.keys[b.head:], b.scores[b.head:], b.seqs[b.head:]),
            ])
            if len(merged):
                runs.append(merged)

    def _consolidate(self, scalars: bool = True):
        """Fold pending dirty chunks (and, by default, the scalar
        nursery) into the run hierarchy."""
        if scalars and self._sdirty:
            arr = np.array(self._sdirty, np.int64).reshape(-1, 3)
            self._dirty.append((arr[:, 0], arr[:, 1], arr[:, 2]))
            self._n_dirty += arr.shape[0]
            self._sdirty = []
        if not self._n_dirty:
            return
        parts, self._dirty = self._dirty, []
        self._n_dirty = 0
        self._append_run(self._sorted_run(parts))

    def _peek(self, r: _Run) -> Optional[Tuple[int, int]]:
        """Advance past stale entries; return the head's (score, seq)."""
        k, q = r.keys, r.seqs
        live, dseq = self._live, self._seq
        h, n = r.head, len(k)
        while h < n and not (live[k[h]] and dseq[k[h]] == q[h]):
            h += 1
        r.head = h
        if h >= n:
            return None
        return int(r.scores[h]), int(q[h])

    def _pop_prefix(self, r: _Run, thr: Optional[Tuple[int, int]],
                    cap_n: int,
                    incl_bound: Optional[int] = None,
                    resident_fn=None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pop up to ``cap_n`` valid entries from ``r`` strictly below
        ``thr`` (a (score, seq) bound; None = unbounded) in one vectorized
        pass.  ``incl_bound`` additionally caps the stretch at entries with
        ``score <= incl_bound`` (inclusive — used by ``admit_interleaved``,
        where the first insert appended during the stretch competes with
        every later pop at exactly that score but a larger seq).

        ``resident_fn`` (keys -> bool mask) mirrors the seed store's
        ``_pick_victim_recmg`` skip-loop: live entries whose key is no
        longer resident are popped *and discarded* on the way to each
        victim — they don't count toward ``cap_n`` and are returned
        separately (third element) so the caller can fix up ``count``.

        Marks everything consumed dead and advances the head (stale
        entries inside the window are skipped forever).  Returns (victim
        keys, victim scores, discarded keys) in pop order."""
        h, k, s, q = r.head, r.keys, r.scores, r.seqs
        n = len(k)
        if thr is None:
            bound = n
        else:
            ts, tq = thr
            lo = h + int(np.searchsorted(s[h:], ts, side="left"))
            span = h + int(np.searchsorted(s[h:], ts, side="right"))
            bound = lo + int(np.searchsorted(q[lo:span], tq, side="left"))
        if incl_bound is not None:
            bound = min(bound, h + int(np.searchsorted(
                s[h:], incl_bound, side="right")))
        if bound <= h:  # caller guarantees head < thr; defensive single pop
            bound = h + 1
        vm = self._valid(k[h:bound], q[h:bound])
        if resident_fn is None:
            res_m = vm
        else:
            res_m = np.zeros(vm.size, bool)
            res_m[vm] = resident_fn(k[h:bound][vm])
        cnt = int(np.count_nonzero(res_m))
        # With a residency filter the stretch must stop AT the cap_n-th
        # victim: stales past it are only discarded en route to a *later*
        # victim (the seed pops them inside _pick_victim_recmg, which is
        # not called again once the batch has all its victims).
        if cnt > cap_n or (cnt == cap_n and resident_fn is not None):
            cut = h + int(np.searchsorted(np.cumsum(res_m), cap_n)) + 1
            vm = vm[: cut - h]
            res_m = res_m[: cut - h]
        else:
            cut = bound
        victims = k[h:cut][res_m]
        vscores = s[h:cut][res_m]
        discard = k[h:cut][vm & ~res_m] if resident_fn is not None else _EMPTY
        self._live[victims] = False
        if discard.size:
            self._live[discard] = False
        r.head = cut
        return victims, vscores, discard

    # ---------------- eviction ----------------

    def pop_min(self) -> Optional[int]:
        """Evict the live (score, seq) minimum; age the epoch up to its
        score (the heap's ``populate`` semantics).  None when empty.
        Scans the scalar nursery in place — the interleaved set/pop
        regime never consolidates."""
        if self._n_dirty:
            self._consolidate(scalars=False)
        best, br = None, None
        for r in self._runs:
            pk = self._peek(r)
            if pk is not None and (best is None or pk < best):
                best, br = pk, r
        sbest, sidx = None, -1
        live, dseq = self._live, self._seq
        for i, (k, s, q) in enumerate(self._sdirty):
            if live[k] and dseq[k] == q and (sbest is None or (s, q) < sbest):
                sbest, sidx = (s, q), i
        if sbest is not None and (best is None or sbest < best):
            key = self._sdirty.pop(sidx)[0]
            score = sbest[0]
        elif br is not None:
            key = int(br.keys[br.head])
            br.head += 1
            score = best[0]
        else:
            return None
        self._live[key] = False
        self.count -= 1
        if score > self.epoch:
            self.epoch = score
        return key

    def pop_min_many(self, n: int) -> List[int]:
        """Evict up to ``n`` victims in vectorized prefix stretches."""
        if n <= 0:
            return []
        if self._n_dirty or self._sdirty:
            self._consolidate()
        out: List[np.ndarray] = []
        got = 0
        while got < n:
            peeks = []
            for r in self._runs:
                pk = self._peek(r)
                if pk is not None:
                    peeks.append((pk, r))
            if not peeks:
                break
            peeks.sort(key=lambda x: x[0])
            br = peeks[0][1]
            thr = peeks[1][0] if len(peeks) > 1 else None
            victims, vscores, _ = self._pop_prefix(br, thr, n - got)
            if victims.size == 0:
                continue
            if int(vscores[-1]) > self.epoch:
                self.epoch = int(vscores[-1])
            out.append(victims)
            got += victims.size
        self.count -= got
        return [int(x) for a in out for x in a]

    def admit_interleaved(self, keys, priority: int, n_no_evict: int,
                          undoable: bool = False, pre_drain: int = 0,
                          resident_fn=None):
        """Replay the tiered store's admission loop in vectorized
        stretches: insert ``keys`` in order at ``priority``; before each
        insert past the first ``n_no_evict``, evict the live (score, seq)
        minimum.  The minimum may be a key inserted earlier in this very
        batch (own-batch eviction): the batch is treated as a third sorted
        run whose scores materialize as the epoch evolves.

        ``pre_drain`` pops that many extra victims *before* the first
        insert — the ``_make_room`` overflow drain when the structure
        holds more entries than its nominal capacity (priority refreshes
        never evict, so replay can run over).

        ``resident_fn`` (keys -> bool mask): live entries that are no
        longer resident in the caller's store are popped-and-discarded on
        the way to each victim, exactly like the seed's
        ``_pick_victim_recmg`` skip-loop (they consume no eviction).

        Returns ``(victims, own, kept)`` — victims in eviction order
        (drained first), ``own[i]`` True where victim ``i`` came from this
        batch, ``kept`` a mask over ``keys`` of the inserts still live at
        the end — plus an opaque undo token when ``undoable=True`` (see
        :meth:`undo`).  Every key must be absent (the store admits only
        non-resident keys); keys must be unique."""
        keys = np.asarray(keys, np.int64).ravel()
        m = keys.size
        pr = int(priority)
        n_no_evict = max(0, min(int(n_no_evict), m))
        need = m - n_no_evict
        if m:
            self._ensure(int(keys.max()))
        if need <= 0:
            self.set_many(keys, pr, only_new=True)
            res = (_EMPTY, _EMPTY_B, np.ones(m, bool))
            return res + (None,) if undoable else res  # token=None: no-op undo
        self._consolidate()
        assert not self._live[keys].any(), \
            "admit_interleaved requires absent keys (engine out of sync)"
        E = self.epoch
        epoch0, seq0, count0 = self.epoch, self.seq, self.count
        self.seq += m
        runs0 = list(self._runs)
        heads0 = [r.head for r in runs0]
        kept = np.ones(m, bool)
        vict_parts: List[np.ndarray] = []
        own_parts: List[np.ndarray] = []
        disc_parts: List[np.ndarray] = []
        drained = 0
        while drained < int(pre_drain):
            peeks = []
            for r in self._runs:
                pk = self._peek(r)
                if pk is not None:
                    peeks.append((pk, r))
            if not peeks:
                break
            peeks.sort(key=lambda x: x[0])
            thr = peeks[1][0] if len(peeks) > 1 else None
            victims, vscores, disc = self._pop_prefix(
                peeks[0][1], thr, int(pre_drain) - drained,
                resident_fn=resident_fn)
            if disc.size:
                disc_parts.append(disc)
            if victims.size == 0:
                continue
            vict_parts.append(victims)
            own_parts.append(np.zeros(victims.size, bool))
            E = max(E, int(vscores[-1]))
            drained += victims.size
        ins_scores = np.empty(m, np.int64)
        ins_scores[:n_no_evict] = pr + E
        n_ins = n_no_evict     # batch inserts materialized so far
        i_head = 0             # head of the own-batch run
        done = 0
        while done < need:
            peeks = []
            for r in self._runs:
                pk = self._peek(r)
                if pk is not None:
                    peeks.append((pk, r))
            peeks.sort(key=lambda x: x[0])
            best, br = peeks[0] if peeks else (None, None)
            second = peeks[1][0] if len(peeks) > 1 else None
            ih = ((int(ins_scores[i_head]), seq0 + 1 + i_head)
                  if i_head < n_ins else None)
            if ih is not None and (best is None or ih < best):
                # Own-batch stretch: inserted entries below the engine's
                # best head get evicted before it (scores ascending, and
                # their seqs are the largest, so ties go to the engine).
                if best is None:
                    hi = n_ins
                else:
                    hi = i_head + int(np.searchsorted(
                        ins_scores[i_head:n_ins], best[0], side="left"))
                c = max(1, min(hi - i_head, need - done))
                new_e = np.maximum(E, ins_scores[i_head:i_head + c])
                vict_parts.append(keys[i_head:i_head + c])
                own_parts.append(np.ones(c, bool))
                kept[i_head:i_head + c] = False
                ins_scores[n_ins:n_ins + c] = pr + new_e
                E = int(new_e[-1])
                i_head += c
                n_ins += c
                done += c
            elif br is not None:
                thr = second if ih is None else (
                    min(second, ih) if second is not None else ih)
                # The first insert appended during this stretch enters at
                # pr + max(E, head score) with the largest seq: engine
                # entries at exactly that score still pop first (smaller
                # seq), anything above waits — hence the inclusive cap.
                victims, vscores, disc = self._pop_prefix(
                    br, thr, need - done, incl_bound=pr + max(E, best[0]),
                    resident_fn=resident_fn)
                if disc.size:
                    disc_parts.append(disc)
                c = victims.size
                if c == 0:
                    continue
                new_e = np.maximum(E, vscores)
                vict_parts.append(victims)
                own_parts.append(np.zeros(c, bool))
                ins_scores[n_ins:n_ins + c] = pr + new_e
                E = int(new_e[-1])
                n_ins += c
                done += c
            else:
                raise RuntimeError(
                    "priority engine exhausted during admission")
        kidx = np.flatnonzero(kept)
        kk = keys[kidx]
        kscores = ins_scores[kidx]
        kseqs = seq0 + 1 + kidx
        self._score[kk] = kscores
        self._seq[kk] = kseqs
        self._live[kk] = True
        victims = np.concatenate(vict_parts) if vict_parts else _EMPTY
        own = np.concatenate(own_parts) if own_parts else _EMPTY_B
        discards = np.concatenate(disc_parts) if disc_parts else _EMPTY
        n_ext = int(np.count_nonzero(~own))
        self.count += int(kk.size) - n_ext - int(discards.size)
        self.epoch = E
        self._append_run(_Run(kk, kscores, kseqs))
        if undoable:
            token = (runs0, heads0, seq0, epoch0,
                     np.concatenate((victims[~own], discards)), kk, count0)
            return victims, own, kept, token
        return victims, own, kept

    def undo(self, token):
        """Revert one ``admit_interleaved(..., undoable=True)`` call.
        Only the admission is reverted; the consolidation it triggered is
        semantically neutral and stays.  Run arrays are immutable (pops
        only advance heads; merges build new runs), so restoring the
        pre-admit run list and head positions is a full rollback."""
        (runs0, heads0, seq0, epoch0, ext, kk, count0) = token
        self._live[kk] = False
        self._live[ext] = True
        for r, h in zip(runs0, heads0):
            r.head = h
        self._runs = runs0
        self.seq = seq0
        self.epoch = epoch0
        self.count = count0
