"""Shard placement planning for multi-worker tiered serving.

Copied from ``src/repro/sharding/embedding_shard.py`` (NumPy only): the
port imports nothing of the JAX package, so it keeps its own copy.

RecShard (Sethi et al.) and Software-Defined Memory (Ardestani et al.)
both show that *where* an embedding-table shard lands — across workers
and across memory tiers — dominates end-to-end DLRM latency.  This
module turns a (tables, rows, capacity) description into a
:class:`ShardPlan`: a dense, vectorized mapping from the trace's global
vector ids onto ``n_shards`` simulated workers, plus a fast-tier row
budget per shard.
:class:`~repro_torch.core.sharded_serving.ShardedTieredStore` executes the
plan with one per-shard :class:`~repro_torch.core.tiered.
TieredEmbeddingStore`.

Placement policies (``PLACEMENTS``):

* ``"table"`` — table-wise: whole tables land on one shard, packed by a
  greedy longest-processing-time bin-pack over row counts (the classic
  TorchRec/RecShard baseline; cheap routing, but a hot table skews one
  worker).
* ``"row"``   — row-wise round-robin: ``shard = global_id % n_shards``
  (fine-grained striping; near-perfect load balance, every batch touches
  every shard).
* ``"hash"``  — row-wise keyed hash (Knuth multiplicative): decorrelates
  shard choice from table layout and trace structure.
* ``"freq"``  — frequency-aware (RecShard-style): given per-row access
  frequencies from a profiling sample, the hottest ``sum(capacities)``
  rows are spread across shards by weighted round-robin **proportional to
  each shard's fast-tier budget** — hot rows pack onto fast-tier-rich
  shards and every hot row can be fast-tier resident — while cold rows
  are dealt out to equalize per-shard row counts.

Every placement numbers a shard's local rows in ascending global-id
order, so with ``n_shards=1`` each policy degenerates to the identity
mapping and the sharded store reproduces the single-store counters
byte-for-byte (the equivalence contract tested in
``tests/test_property_equivalence.py``, and for the port in
``tests/test_torch_sharded_serving.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

PLACEMENTS = ("table", "row", "hash", "freq")

_KNUTH = 2654435761  # multiplicative hash constant (same as trace gen)


@dataclass
class ShardPlan:
    """A placement decision: global id -> (shard, local row) + budgets.

    ``global_ids[s]`` is sorted ascending, so ``local_of`` is the rank of
    a global id within its shard's set and ``host[global_ids[s]]`` is the
    shard's local host-tier table.
    """

    placement: str
    n_shards: int
    shard_of: np.ndarray        # (n_vectors,) int32: global id -> shard
    local_of: np.ndarray        # (n_vectors,) int64: global id -> local row
    global_ids: List[np.ndarray]  # per shard: local row -> global id
    capacities: np.ndarray      # (n_shards,) int64: fast-tier rows
    # Hot-row replication (RecShard's CDF lever): the top-k rows by
    # profiled frequency, resident on *every* shard in addition to their
    # home shard.  None/empty == no replication.  The facade serves a
    # dead shard's replicated rows from this set with exact bytes.
    replicated_ids: Optional[np.ndarray] = None

    @property
    def n_vectors(self) -> int:
        return len(self.shard_of)

    @property
    def shard_rows(self) -> np.ndarray:
        return np.asarray([len(g) for g in self.global_ids], np.int64)

    def route(self, global_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                     np.ndarray]:
        """Vectorized routing: (gid, shard, local) for a flat id batch."""
        gid = np.asarray(global_ids, np.int64).ravel()
        return gid, self.shard_of[gid], self.local_of[gid]

    def check(self):
        """Plan invariants (used by tests): the shard/local maps and the
        per-shard id lists are exact inverses, budgets are sane."""
        assert len(self.global_ids) == self.n_shards
        seen = 0
        for s, g in enumerate(self.global_ids):
            assert np.all(np.diff(g) > 0)  # sorted ascending, unique
            assert np.all(self.shard_of[g] == s)
            assert np.array_equal(self.local_of[g], np.arange(len(g)))
            assert 1 <= self.capacities[s] <= max(len(g), 1)
            seen += len(g)
        assert seen == self.n_vectors
        if self.replicated_ids is not None and len(self.replicated_ids):
            r = self.replicated_ids
            assert np.all(np.diff(r) > 0)  # sorted ascending, unique
            assert 0 <= r[0] and r[-1] < self.n_vectors

    def replica_mask(self) -> np.ndarray:
        """(n_vectors,) bool: True where the row is hot-replicated."""
        m = np.zeros(self.n_vectors, bool)
        if self.replicated_ids is not None:
            m[self.replicated_ids] = True
        return m


def trace_frequencies(global_ids: np.ndarray, n_vectors: int,
                      sample_frac: float = 0.25) -> np.ndarray:
    """Per-row access counts from a trace prefix (the profiling sample a
    frequency-aware planner would collect online)."""
    gid = np.asarray(global_ids, np.int64).ravel()
    n = max(1, int(len(gid) * sample_frac))
    return np.bincount(gid[:n], minlength=n_vectors).astype(np.int64)


def make_plan(rows_per_table: Sequence[int], n_shards: int, capacity: int,
              placement: str = "table",
              frequencies: Optional[np.ndarray] = None,
              fast_weights: Optional[Sequence[float]] = None,
              replicate_hot: int = 0) -> ShardPlan:
    """Build a :class:`ShardPlan`.

    ``capacity`` is the *total* fast-tier row budget across shards, split
    proportionally to ``fast_weights`` (default: assigned rows for
    table/row/hash, uniform for freq) with a one-row floor per shard.
    ``frequencies`` (required for ``"freq"``) are per-global-id access
    counts, e.g. from :func:`trace_frequencies`.

    ``replicate_hot`` marks the top-k rows by ``frequencies`` (required
    when k > 0) as replicated on every shard: RecShard's per-table CDFs
    show a tiny hot set covers most traffic, which is exactly the set
    that must stay answerable from survivors when a shard dies.  Routing
    is unchanged (each row keeps one home shard); ``replicated_ids`` is
    the failover layer's exact-answer set.
    """
    if placement not in PLACEMENTS:
        raise ValueError(f"unknown placement {placement!r}; "
                         f"expected one of {PLACEMENTS}")
    rows = np.asarray(rows_per_table, np.int64)
    n_vectors = int(rows.sum())
    n_shards = int(n_shards)
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    if n_vectors < n_shards:
        raise ValueError(f"{n_vectors} vectors cannot span {n_shards} shards")
    capacity = max(n_shards, min(int(capacity), n_vectors))

    if placement == "freq":
        if frequencies is None:
            raise ValueError('placement "freq" needs per-row frequencies '
                             "(see trace_frequencies)")
        freq = np.asarray(frequencies, np.float64).ravel()
        if len(freq) != n_vectors:
            raise ValueError(f"frequencies cover {len(freq)} rows, "
                             f"tables hold {n_vectors}")
        caps = _split_budget(capacity,
                             np.asarray(fast_weights, np.float64)
                             if fast_weights is not None
                             else np.ones(n_shards),
                             np.full(n_shards, n_vectors, np.int64))
        shard_of = _assign_freq(freq, caps, n_shards)
    else:
        if placement == "table":
            shard_of = np.repeat(_pack_tables(rows, n_shards), rows)
        elif placement == "row":
            shard_of = (np.arange(n_vectors, dtype=np.int64)
                        % n_shards).astype(np.int32)
        else:  # hash
            gid = np.arange(n_vectors, dtype=np.uint64)
            h = (gid * np.uint64(_KNUTH)) % np.uint64(1 << 32)
            # High bits: the multiplicative hash's low bits pass the id
            # through (K is odd), which would degenerate to round-robin
            # for power-of-two shard counts.
            shard_of = ((h >> np.uint64(16))
                        % np.uint64(n_shards)).astype(np.int32)
            # Tiny tables can leave a shard hashless; rebalance by moving
            # the fullest shard's highest ids (deterministic, and only
            # ever triggers when n_vectors is within a few x of n_shards).
            counts = np.bincount(shard_of, minlength=n_shards)
            for s in np.flatnonzero(counts == 0).tolist():
                big = int(np.argmax(counts))
                shard_of[np.flatnonzero(shard_of == big)[-1]] = s
                counts[big] -= 1
                counts[s] += 1
        shard_rows = np.bincount(shard_of, minlength=n_shards)
        if shard_rows.min() == 0:
            raise ValueError(
                f"placement {placement!r} left a shard empty: table-wise "
                f"placement cannot use more shards ({n_shards}) than "
                f"tables ({len(rows)})")
        caps = _split_budget(capacity,
                             np.asarray(fast_weights, np.float64)
                             if fast_weights is not None
                             else shard_rows.astype(np.float64),
                             shard_rows)

    # Local numbering: rank within the shard's ascending global-id set
    # (flatnonzero returns sorted indices), so n_shards=1 is the identity.
    local_of = np.empty(n_vectors, np.int64)
    global_ids = []
    for s in range(n_shards):
        g = np.flatnonzero(shard_of == s)
        local_of[g] = np.arange(len(g))
        global_ids.append(g)
    caps = np.minimum(caps, np.asarray([max(len(g), 1)
                                        for g in global_ids], np.int64))

    replicated = None
    if replicate_hot > 0:
        if frequencies is None:
            raise ValueError("replicate_hot needs per-row frequencies "
                             "(see trace_frequencies)")
        freq = np.asarray(frequencies, np.float64).ravel()
        if len(freq) != n_vectors:
            raise ValueError(f"frequencies cover {len(freq)} rows, "
                             f"tables hold {n_vectors}")
        k = min(int(replicate_hot), n_vectors)
        # Same stable hotness order as _assign_freq: frequency descending,
        # global id ascending — the replica set is deterministic.
        hot_order = np.lexsort((np.arange(n_vectors), -freq))
        replicated = np.sort(hot_order[:k]).astype(np.int64)
    return ShardPlan(placement, n_shards, shard_of.astype(np.int32),
                     local_of, global_ids, caps, replicated_ids=replicated)


def _pack_tables(rows: np.ndarray, n_shards: int) -> np.ndarray:
    """Greedy LPT bin-pack: biggest table first onto the lightest shard
    (deterministic: ties break to the lowest shard id).  Returns the
    shard id per table."""
    order = np.argsort(-rows, kind="stable")
    load = np.zeros(n_shards, np.int64)
    shard_of_table = np.empty(len(rows), np.int32)
    for t in order.tolist():
        s = int(np.argmin(load))  # argmin ties -> lowest index
        shard_of_table[t] = s
        load[s] += rows[t]
    return shard_of_table


def _split_budget(capacity: int, weights: np.ndarray,
                  shard_rows: np.ndarray) -> np.ndarray:
    """Proportional fast-tier split with a one-row floor, clamped to the
    rows a shard actually holds, excess clawed back largest-first (the
    same deterministic scheme as the multi-table facade)."""
    w = np.maximum(np.asarray(weights, np.float64), 1e-12)
    caps = np.maximum(1, np.floor(capacity * w / w.sum())).astype(np.int64)
    caps = np.minimum(caps, shard_rows)
    excess = int(caps.sum() - capacity)
    while excess > 0:
        i = int(np.argmax(caps))
        take = min(excess, int(caps[i]) - 1)
        if take <= 0:
            break
        caps[i] -= take
        excess -= take
    # Leftover budget (rounding) tops up the largest-weight shards.
    short = int(capacity - caps.sum())
    order = np.argsort(-w, kind="stable")
    while short > 0:
        gave = 0
        for i in order.tolist():
            if short == 0:
                break
            if caps[i] < shard_rows[i]:
                caps[i] += 1
                short -= 1
                gave += 1
        if gave == 0:
            break  # every shard is at its row count: budget > n_vectors
    return caps


def _assign_freq(freq: np.ndarray, caps: np.ndarray,
                 n_shards: int) -> np.ndarray:
    """RecShard-style frequency-aware assignment.

    Hot set = the ``sum(caps)`` most-accessed rows (ties -> lower global
    id).  Hot rows are dealt by weighted round-robin proportional to each
    shard's fast-tier budget — shard ``s`` receives exactly ``caps[s]``
    hot rows, interleaved by rank so expected hot *traffic* is spread in
    the same proportion (a fast-tier-rich shard gets both more and hotter
    rows, never only the tail).  Cold rows fill per-shard quotas chosen
    to equalize total row counts.
    """
    n_vectors = len(freq)
    # Stable hotness order: frequency descending, global id ascending.
    order = np.lexsort((np.arange(n_vectors), -freq))
    n_hot = int(caps.sum())
    hot, cold = order[:n_hot], order[n_hot:]

    shard_of = np.empty(n_vectors, np.int32)
    # Weighted round-robin: shard s occupies virtual positions (k+1)/caps[s]
    # — sorting them interleaves shards proportionally to budget (ties ->
    # lower shard id via the secondary key).
    seq = np.repeat(np.arange(n_shards), caps)
    pos = np.concatenate([(np.arange(c) + 1) / max(c, 1) for c in caps])
    shard_of[hot] = seq[np.lexsort((seq, pos))].astype(np.int32)

    if cold.size:
        # Equalize totals: shard quota = balanced total minus hot count.
        target = np.full(n_shards, n_vectors // n_shards, np.int64)
        target[: n_vectors % n_shards] += 1
        quota = np.maximum(target - caps, 0)
        short = int(cold.size - quota.sum())
        # Rounding/clamping remainder goes to the least-loaded shards.
        order_q = np.argsort(caps + quota, kind="stable")
        i = 0
        while short > 0:
            quota[order_q[i % n_shards]] += 1
            short -= 1
            i += 1
        while short < 0:
            s = int(order_q[(i - 1) % n_shards])
            if quota[s] > 0:
                quota[s] -= 1
                short += 1
            i -= 1
        # Deal cold rows coldest-last in contiguous per-shard blocks
        # (cold rows rarely drive load; determinism matters more).
        shard_of[cold] = np.repeat(np.arange(n_shards), quota)
    return shard_of
