"""Rule-based prefetcher baselines, at embedding-vector granularity.

Copied from ``src/repro/core/prefetchers.py`` (NumPy and stdlib only): the
port imports nothing of the JAX package, so it keeps its own copy.

The paper compares RecMG against a temporal prefetcher (Domino [8]), a
spatial prefetcher (Bingo [10]), and offset/delta prefetchers (BOP [52],
Berti [55]).  All of those are hardware cache-line prefetchers; per the
paper's methodology (§VII-A) we treat each embedding-vector index as a
memory address and the table id as the PC/IP proxy.

Interface: ``on_access(key, hit) -> list[key]`` of prefetch candidates.
"""
from __future__ import annotations

from collections import OrderedDict, defaultdict, deque
from typing import Dict, List

import numpy as np


class Prefetcher:
    name = "none"

    def on_access(self, key: int, hit: bool) -> List[int]:
        return []


class DominoLite(Prefetcher):
    """Temporal prefetching: record miss-history correlations
    (addr, next-addr) with a two-deep history (Domino's (a,b)->c scheme) and
    replay chains on re-occurrence."""

    name = "domino"

    def __init__(self, metadata_entries: int = 200_000, degree: int = 4):
        self.pair: "OrderedDict[tuple, int]" = OrderedDict()
        self.single: "OrderedDict[int, int]" = OrderedDict()
        self.meta = metadata_entries
        self.degree = degree
        self.hist = deque(maxlen=2)

    def _put(self, table, k, v):
        if k in table:
            table.move_to_end(k)
        table[k] = v
        if len(table) > self.meta:
            table.popitem(last=False)

    def on_access(self, key, hit):
        out = []
        h = tuple(self.hist)
        if len(h) == 2:
            self._put(self.pair, h, key)
        if self.hist:
            self._put(self.single, self.hist[-1], key)
        self.hist.append(key)

        # Predict a chain starting from the current context.
        ctx2 = (self.hist[0], self.hist[-1]) if len(self.hist) == 2 else None
        nxt = self.pair.get(ctx2) if ctx2 else None
        if nxt is None:
            nxt = self.single.get(key)
        depth = 0
        seen = set()
        while nxt is not None and depth < self.degree and nxt not in seen:
            out.append(nxt)
            seen.add(nxt)
            nxt = self.single.get(nxt)
            depth += 1
        return out


class BingoLite(Prefetcher):
    """Spatial footprint prefetching: regions of the (table-major) index
    space; on region re-entry, replay the recorded footprint keyed by
    (PC=table-proxy, trigger offset)."""

    name = "bingo"

    def __init__(self, region: int = 64, table_entries: int = 100_000,
                 pc_of=None):
        self.region = region
        self.hist: "OrderedDict[tuple, set]" = OrderedDict()
        self.active: Dict[int, set] = {}
        self.active_order = deque()
        self.table_entries = table_entries
        self.pc_of = pc_of or (lambda k: k >> 40)

    def on_access(self, key, hit):
        r, off = divmod(key, self.region)
        pc = self.pc_of(key)
        out = []
        if r not in self.active:
            # Region entry: replay footprint if we've seen this trigger.
            fp = self.hist.get((pc, off))
            if fp:
                base = r * self.region
                out = [base + o for o in fp if o != off]
            self.active[r] = (off, set())
            self.active_order.append(r)
            if len(self.active_order) > 16:
                old_r = self.active_order.popleft()
                self.active.pop(old_r, None)
        trigger, foot = self.active[r]
        foot.add(off)
        # Continuously publish the footprint (Bingo's history table update).
        self.hist[(pc, trigger)] = foot
        if len(self.hist) > self.table_entries:
            self.hist.popitem(last=False)
        return out


class BOP(Prefetcher):
    """Best-Offset Prefetcher [52]: score candidate offsets by whether
    (addr - offset) was recently requested; prefetch addr + best offset."""

    name = "bop"

    OFFSETS = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64,
               -1, -2, -3, -4, -8, -16, -32]

    def __init__(self, rr_size: int = 4096, rounds: int = 32,
                 bad_score: int = 1):
        self.rr: "OrderedDict[int, bool]" = OrderedDict()
        self.rr_size = rr_size
        self.scores = {o: 0 for o in self.OFFSETS}
        self.best = 1
        self.tests = 0
        self.round_len = rounds * len(self.OFFSETS)
        self.idx = 0
        self.bad = bad_score

    def _rr_add(self, key):
        self.rr[key] = True
        if len(self.rr) > self.rr_size:
            self.rr.popitem(last=False)

    def on_access(self, key, hit):
        # Learning phase: test one offset per access round-robin.
        o = self.OFFSETS[self.idx % len(self.OFFSETS)]
        self.idx += 1
        if key - o in self.rr:
            self.scores[o] += 1
        self.tests += 1
        if self.tests >= self.round_len:
            self.best, s = max(self.scores.items(), key=lambda kv: kv[1])
            self.scores = {k: 0 for k in self.scores}
            self.tests = 0
            if s <= self.bad:
                self.best = 0  # too noisy: stop prefetching this round
        self._rr_add(key)
        if self.best:
            return [key + self.best]
        return []


class BertiLite(Prefetcher):
    """Berti-style local-delta prefetcher: per-PC (table) best recent delta
    learned from timely hits."""

    name = "berti"

    def __init__(self, pc_of=None, hist_per_pc: int = 16):
        self.pc_of = pc_of or (lambda k: k >> 40)
        self.last: Dict[int, deque] = defaultdict(
            lambda: deque(maxlen=hist_per_pc)
        )
        self.delta_score: Dict[int, defaultdict] = defaultdict(
            lambda: defaultdict(int)
        )

    def on_access(self, key, hit):
        pc = self.pc_of(key)
        hist = self.last[pc]
        for prev in hist:
            d = key - prev
            if d != 0 and abs(d) < 512:
                self.delta_score[pc][d] += 1
        hist.append(key)
        scores = self.delta_score[pc]
        if not scores:
            return []
        best, s = max(scores.items(), key=lambda kv: kv[1])
        if len(scores) > 256:
            self.delta_score[pc] = defaultdict(
                int, dict(sorted(scores.items(), key=lambda kv: -kv[1])[:64])
            )
        return [key + best] if s >= 4 else []


class MABLite(Prefetcher):
    """Micro-Armed-Bandit [30]: epsilon-greedy coordinator that picks among
    simple prefetchers per epoch based on observed usefulness."""

    name = "mab"

    def __init__(self, seed=0, epoch=2048, eps=0.1):
        self.arms = [Prefetcher(), BOP(), BertiLite(), DominoLite(50_000, 2)]
        self.rng = np.random.default_rng(seed)
        self.q = np.zeros(len(self.arms))
        self.n = np.zeros(len(self.arms)) + 1e-6
        self.eps = eps
        self.epoch = epoch
        self.t = 0
        self.cur = 1
        self.issued_by_cur = 0
        self.hits_in_epoch = 0

    def on_access(self, key, hit):
        self.t += 1
        self.hits_in_epoch += hit
        if self.t % self.epoch == 0:
            reward = self.hits_in_epoch / self.epoch
            self.q[self.cur] += (reward - self.q[self.cur]) / (
                self.n[self.cur] + 1
            )
            self.n[self.cur] += 1
            self.hits_in_epoch = 0
            if self.rng.random() < self.eps:
                self.cur = int(self.rng.integers(len(self.arms)))
            else:
                self.cur = int(np.argmax(self.q))
        outs = []
        for i, arm in enumerate(self.arms):
            o = arm.on_access(key, hit)
            if i == self.cur:
                outs = o
        return outs


PREFETCHERS = {
    "none": Prefetcher,
    "domino": DominoLite,
    "bingo": BingoLite,
    "bop": BOP,
    "berti": BertiLite,
    "mab": MABLite,
}


def make_prefetcher(name: str, **kw) -> Prefetcher:
    return PREFETCHERS[name](**kw)


# ---------------------------------------------------------------------------
# Sequence-prediction metrics (paper Figs. 9/10)
# ---------------------------------------------------------------------------


def prediction_metrics(keys: np.ndarray, prefetcher: Prefetcher,
                       window: int = 15) -> dict:
    """Correctness = frac of issued prefetches that appear in the next
    `window` accesses; coverage per Eq. (2) over those windows."""
    n = len(keys)
    issued = 0
    correct = 0
    covered = 0
    gt_total = 0
    step = window
    for i in range(0, n - window, step):
        future = set(int(k) for k in keys[i + 1 : i + 1 + window])
        preds = []
        # Feed the window's accesses one at a time (online).
        for j in range(i, min(i + step, n)):
            preds.extend(prefetcher.on_access(int(keys[j]), True))
        preds = preds[:window]
        issued += len(preds)
        correct += sum(p in future for p in preds)
        covered += len(set(preds) & future)
        gt_total += len(future)
    return {
        "issued": issued,
        "correctness": correct / max(issued, 1),
        "coverage": covered / max(gt_total, 1),
    }
