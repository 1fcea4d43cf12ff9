"""Batched tiered-memory embedding store of the port (paper §VI).

Ported from ``src/repro/core/tiered.py``.  Fast tier: a buffer of
embedding rows in device memory (a torch tensor on ``device``).  Slow tier:
the full host table, a NumPy array.  A miss fetches the row on demand.

What is the same as the JAX store, verbatim: the array-backed residency
state (``_slot_map`` / ``_slot_key`` / ``_free`` / ``_last_use`` /
``_admit_seq`` / ``_pf_flag``), batched LRU and RecMG admission and
eviction through the priority engine, the hit/miss partition by
``np.unique``, the RecMG staging hooks, the counters and the tracer spans.
All of that stays NumPy, so the counters equal the JAX store's byte for
byte.

What changed with the device:

* Admitted rows are scattered with an in-place ``index_copy_`` (the JAX
  store's donated ``_JIT_SCATTER``).
* The read is one call of :func:`repro_torch.kernels.ops.gather_rows_expand`:
  on the card one CUDA launch gathers the unique rows' slots, expands them
  to request order and folds in overflow rows staged from the host (the
  JAX store's ``_JIT_GATHER`` / ``_JIT_GATHER_OV`` programs).  On the CPU
  the plain PyTorch version runs.
* ``quantize=True`` keeps the fast tier as one byte per element (int8, or
  fp8 e4m3 with ``row_format="fp8"``) plus one fp32 scale per row, ``D + 4``
  bytes a row.  An admit is one :func:`~repro_torch.kernels.ops.
  quantize_scatter` (per-row scale, codes and both scatters in one launch:
  the JAX store's ``_kernel_scatter_q`` / ``_JIT_SCATTER_Q``), a read one
  :func:`~repro_torch.kernels.ops.gather_rows_dequant_expand` that returns
  fp32 rows, overflow rows staged in fp32 (``_JIT_GATHER_Q`` /
  ``_JIT_GATHER_Q_OV``).  The codes equal the JAX store's; the scales
  equal its jnp reference's, from which its jitted quantizer can differ by
  one ulp.
* The power-of-two padding of both index vectors and of the scatter is
  gone: it existed only to stop XLA from recompiling per batch shape, and
  PyTorch runs eagerly.
* ``lookup`` ends in ``torch.cuda.synchronize`` on the card, so
  ``gather_s`` keeps its meaning (host-side dispatch plus device time).
* The degraded read of an over-deadline request
  (``lookup_resident_device``) is one call of the same fused read, with the
  non-resident ids marked as overflow and zero rows staged on the device;
  the JAX store indexed a NumPy copy of its buffer.  ``lookup_resident``
  copies that read to the host.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.buffer_manager import RecMGBuffer
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ROW_FORMATS
from repro_torch.obs.tracing import get_tracer


def fast_row_bytes(d: int, host_dtype, quantize: bool,
                   row_format: str = "int8") -> int:
    """Per-row fast-tier footprint in bytes: ``d * itemsize`` for fp32
    rows, ``d * 1 + 4`` for the quantized formats (1-byte elements + one
    fp32 scale) — the accounting the byte-budget facades split on."""
    if quantize:
        if row_format not in ROW_FORMATS:
            raise ValueError(f"unknown row_format {row_format!r} "
                             f"(expected one of {sorted(ROW_FORMATS)})")
        return d + 4
    return d * np.dtype(host_dtype).itemsize


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``.  The copy is synchronous: the arrays are
    pageable NumPy buffers, so no ``non_blocking``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@dataclass
class TierStats:
    batches: int = 0
    lookups: int = 0
    hits: int = 0
    misses: int = 0  # request-level fast-tier misses (hits + misses == lookups)
    prefetch_hits: int = 0
    on_demand_rows: int = 0
    evictions: int = 0
    fetch_s: float = 0.0  # measured host->device copy time
    gather_s: float = 0.0  # device gather time
    model_s: float = 0.0  # CPU-side model inference time (off critical path)
    modeled_fetch_s: float = 0.0  # analytic slow-tier penalty

    @property
    def hit_rate(self):
        return self.hits / max(self.lookups, 1)

    def as_dict(self):
        # ``hits`` is emitted raw alongside the rounded ``hit_rate``:
        # serve/bench JSON must stay lossless for cross-run aggregation
        # (summing rounded rates across runs is meaningless).
        return {
            "batches": self.batches, "lookups": self.lookups,
            "hits": self.hits, "misses": self.misses,
            "hit_rate": round(self.hit_rate, 4),
            "prefetch_hits": self.prefetch_hits,
            "on_demand_rows": self.on_demand_rows,
            "evictions": self.evictions,
            "fetch_s": round(self.fetch_s, 4),
            "gather_s": round(self.gather_s, 4),
            "model_s": round(self.model_s, 4),
            "modeled_fetch_s": round(self.modeled_fetch_s, 4),
        }

    def merge(self, other: "TierStats") -> "TierStats":
        """Aggregate (for the multi-table facade)."""
        for f in ("batches", "lookups", "hits", "misses", "prefetch_hits",
                  "on_demand_rows", "evictions"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        for f in ("fetch_s", "gather_s", "model_s", "modeled_fetch_s"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        return self

    def publish(self, reg, prefix: str = "store"):
        """Publish into a :class:`repro.obs.MetricsRegistry` under the
        ``store.*`` namespace (see docs/architecture.md)."""
        for key, val in (
            ("batches", self.batches), ("lookups", self.lookups),
            ("fast.hits", self.hits), ("fast.misses", self.misses),
            ("fast.prefetch_hits", self.prefetch_hits),
            ("fast.on_demand_rows", self.on_demand_rows),
            ("fast.evictions", self.evictions),
            ("time.fetch_s", self.fetch_s),
            ("time.gather_s", self.gather_s),
            ("time.model_s", self.model_s),
            ("time.modeled_fetch_s", self.modeled_fetch_s),
        ):
            reg.counter(f"{prefix}.{key}").inc(val)
        reg.gauge(f"{prefix}.fast.hit_rate").set(self.hit_rate)
        return reg


class TieredEmbeddingStore:
    """Host table (N, D) + device buffer (C, D) with pluggable policy."""

    def __init__(self, host_table: np.ndarray, capacity: int,
                 policy: str = "lru", eviction_speed: int = 4,
                 fetch_us_per_row: float = 10.0, fetch_us_fixed: float = 30.0,
                 quantize: bool = False, row_format: Optional[str] = None,
                 warmup_batch: int = 0, device="cuda"):
        """``device``: where the fast tier lives; ``"cuda"`` by default,
        and it raises when CUDA is absent (pass ``"cpu"`` explicitly).

        ``quantize=True``: quantized rows plus one fp32 scale each in the
        fast tier, ``D + 4`` bytes per resident row instead of ``D *
        itemsize``; ``lookup`` then returns fp32 rows.  ``row_format``
        picks the storage format (``"int8"`` by default, or ``"fp8"`` =
        float8_e4m3fn); passing it without ``quantize=True`` is an error.

        ``warmup_batch``: load (or build) the kernels and launch them once
        at this batch size at construction, off the measured path (see
        :meth:`warmup`); 0 skips the warmup."""
        self.device = resolve_device(device)
        self.host = host_table
        n, d = host_table.shape
        self.capacity = max(1, int(capacity))  # same clamp as RecMGBuffer
        self.quantize = quantize
        if row_format is not None and not quantize:
            raise ValueError("row_format requires quantize=True "
                             "(fp32 rows have no storage format knob)")
        self.row_format = row_format or "int8"
        if self.row_format not in ROW_FORMATS:
            raise ValueError(f"unknown row_format {self.row_format!r} "
                             f"(expected one of {sorted(ROW_FORMATS)})")
        if quantize:
            self.buffer = torch.zeros((self.capacity, d),
                                      dtype=ROW_FORMATS[self.row_format][0],
                                      device=self.device)
            self.scales = torch.zeros((self.capacity,), dtype=torch.float32,
                                      device=self.device)
        else:
            self.buffer = torch.zeros(
                (self.capacity, d),
                dtype=torch.from_numpy(np.zeros(0, host_table.dtype)).dtype,
                device=self.device)
            self.scales = None
        # -------- array-backed residency state (see module docstring) -----
        self._slot_map = np.full(n, -1, np.int32)
        self._slot_key = np.full(self.capacity, -1, np.int64)
        self._free = np.arange(self.capacity - 1, -1, -1, dtype=np.int32)
        self._n_free = self.capacity
        self._last_use = np.zeros(self.capacity, np.int64)
        self._admit_seq = np.zeros(self.capacity, np.int64)
        self._pf_flag = np.zeros(self.capacity, bool)
        self._clock = 1
        self.policy = policy
        # The store owns RESIDENCY (_slot_map); the RecMG structure only
        # ranks priorities, so it gets unbounded capacity and never
        # self-evicts — under recmg its live set mirrors the resident set
        # exactly (checked in check_invariants), which is what lets
        # ``_admit`` rank a whole victim batch in one engine pass.
        self.recmg = RecMGBuffer(1 << 40, eviction_speed, n_keys_hint=n)
        self.fetch_us_per_row = fetch_us_per_row
        self.fetch_us_fixed = fetch_us_fixed
        self.stats = TierStats()
        self._staged: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._out_np_dtype = np.dtype(
            np.float32 if quantize else host_table.dtype)
        if warmup_batch:
            self.warmup(warmup_batch)

    # ---------------- compat / introspection ----------------

    @property
    def slot_of(self) -> Dict[int, int]:
        """Dict view of key -> slot residency (seed-compatible read API)."""
        res = np.flatnonzero(self._slot_key >= 0)
        return {int(self._slot_key[s]): int(s) for s in res}

    @property
    def n_resident(self) -> int:
        return self.capacity - self._n_free

    def resident_mask(self, ids: np.ndarray) -> np.ndarray:
        """Vectorized residency probe: True where ``ids`` are in the fast
        tier right now (public API for the serving runtime's cancel-
        before-issue and for tests; does not touch recency state)."""
        return self._slot_map[np.asarray(ids, np.int64).ravel()] >= 0

    def lookup_resident(self, ids: np.ndarray):
        """Degraded read for over-deadline requests: ``(rows, n_default)``
        where resident ids get their current (possibly stale) fast-tier
        row and slow-tier misses get a zero default row — never a wrong
        shape, never a slow-tier fetch.  Pure read: no recency update, no
        admission/eviction, no stats mutation, so the main accounting
        identities are untouched.  ``rows`` is a NumPy array: the read of
        :meth:`lookup_resident_device` copied to the host once."""
        rows, n_default = self.lookup_resident_device(ids)
        return rows.cpu().numpy(), n_default

    def lookup_resident_device(self, ids: np.ndarray):
        """:meth:`lookup_resident` with ``rows`` left on the store's device
        (the pipelined runtime assembles a degraded batch there).  One call
        of the store's own fused read: each unique id's slot, expanded to
        request order, with the non-resident ids marked as overflow whose
        staged rows are zeros made on the device."""
        ids = np.asarray(ids, np.int64).ravel()
        dev = self.device
        dtype = torch.float32 if self.quantize else self.buffer.dtype
        if not ids.size:
            return torch.zeros((0, self.host.shape[1]), dtype=dtype,
                               device=dev), 0
        uniq, inv = np.unique(ids, return_inverse=True)
        slots_u = self._slot_map[uniq]
        default = slots_u < 0
        n_default = int(np.count_nonzero(default[inv]))
        args = [_to_device(np.maximum(slots_u, 0).astype(np.int32), dev),
                _to_device(inv.astype(np.int32), dev)]
        if n_default:
            args += [_to_device(default, dev),
                     torch.zeros((uniq.size, self.host.shape[1]),
                                 dtype=dtype, device=dev)]
        if self.quantize:
            rows = ops.gather_rows_dequant_expand(self.buffer, self.scales,
                                                  *args)
        else:
            rows = ops.gather_rows_expand(self.buffer, *args)
        return rows, n_default

    def check_invariants(self):
        """Residency invariants (used by tests): the slot map and slot->key
        array are exact inverses, the free stack covers the rest, and under
        recmg the priority engine's live set mirrors residency exactly."""
        res = np.flatnonzero(self._slot_key >= 0)
        keys = self._slot_key[res]
        assert np.array_equal(self._slot_map[keys], res.astype(np.int32))
        assert len(res) == self.capacity - self._n_free
        assert np.count_nonzero(self._slot_map >= 0) == len(res)
        free = self._free[: self._n_free]
        assert np.all(self._slot_key[free] < 0)
        if self.policy == "recmg":
            # Every resident key holds a live ranking entry; the engine may
            # additionally hold *stale* entries for non-resident keys
            # (prefetch rankings that outlived their row — the seed's heap
            # had the same, drained lazily during victim selection).
            eng = self.recmg.engine
            live = eng.live_keys()
            assert eng.count == live.size
            assert np.all(np.isin(keys, live))

    def warmup(self, batch_hint: int):
        """Load (or build) the gather kernel and launch it once, expanding
        slot 0 to ``batch_hint`` rows, and run one scatter that changes no
        stored value, so the library load, the module load and the first
        allocation of a batch-sized output land here instead of inside a
        measured batch.  The JAX store compiled its shape buckets here.

        The fp32 scatter rewrites slot 0 with its own row.  The quantized
        one quantizes slot 0's dequantized row into a one-row scratch
        buffer, so no stored code or scale changes."""
        dev = self.device
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        inv = torch.zeros(max(int(batch_hint), 1), dtype=torch.int32,
                          device=dev)
        if self.quantize:
            row0 = ops.gather_rows_dequant_expand(self.buffer, self.scales,
                                                  zero, inv)[:1].clone()
            ops.quantize_scatter(torch.empty_like(self.buffer[:1]),
                                 torch.empty_like(self.scales[:1]), zero,
                                 row0, self.row_format)
        else:
            ops.gather_rows_expand(self.buffer, zero, inv)
            self.buffer.index_copy_(0, zero.long(), self.buffer[0:1].clone())
        synchronize(dev)

    # ---------------- slot allocation / eviction ----------------

    def _alloc(self, m: int) -> np.ndarray:
        slots = self._free[self._n_free - m: self._n_free][::-1].copy()
        self._n_free -= m
        return slots

    def _release(self, slots: np.ndarray):
        k = len(slots)
        self._free[self._n_free: self._n_free + k] = slots[::-1]
        self._n_free += k

    def _evict_slots(self, victim_slots: np.ndarray):
        """Batched eviction: clear residency + prefetch flags, free slots."""
        vk = self._slot_key[victim_slots]
        self._slot_map[vk] = -1
        self._slot_key[victim_slots] = -1
        self._pf_flag[victim_slots] = False
        self.stats.evictions += len(victim_slots)
        self._release(np.asarray(victim_slots, np.int32))

    def _pick_victim_recmg(self) -> int:
        victim = self.recmg.populate()
        while victim is not None and self._slot_map[victim] < 0:
            victim = self.recmg.populate()  # stale non-resident entry
        if victim is None:  # priorities exhausted: oldest-admitted resident
            res = np.flatnonzero(self._slot_key >= 0)
            victim = int(self._slot_key[res[np.argmin(self._admit_seq[res])]])
        return victim

    def _bind(self, keys: np.ndarray, slots: np.ndarray):
        """Point keys at slots and stamp admission order / recency."""
        m = len(keys)
        self._slot_map[keys] = slots
        self._slot_key[slots] = keys
        self._admit_seq[slots] = self._clock + np.arange(m)
        self._last_use[slots] = self._clock + np.arange(m)
        self._clock += m

    def _admit(self, missing: np.ndarray) -> np.ndarray:
        """Assign slots for all missing keys at once, evicting as needed.

        Returns a bool mask over ``missing``: True where the key is resident
        after the batch (False = overflow: the working set exceeded the
        buffer, so the row is served straight from the host tier).
        """
        m = len(missing)
        kept = np.ones(m, bool)
        if self.policy == "recmg":
            if m <= self._n_free:
                slots = self._alloc(m)
                self._bind(missing, slots)
                self.recmg.set_priorities(missing, self.recmg.ev,
                                          only_new=True)
            elif self.recmg.engine.contains_many(missing).any():
                # Resurrection: a missing key still holds a stale ranking
                # entry (it was prefetch-ranked after being evicted in its
                # own admission batch).  Re-admitting it must *keep* that
                # old entry (the seed's only_new semantics), and the old
                # entry can even be chosen as a victim mid-batch — exact
                # only in the per-key oracle.  Rare: requires a stale key
                # to be demand-missed while its entry survives.
                self._admit_recmg_sequential(missing, kept)
            else:
                self._admit_recmg_batched(missing, kept)
            return kept
        # ---- LRU: fully batched ----
        if m >= self.capacity:
            # Every old resident gets evicted, then the first m-C missing
            # keys are themselves evicted by later ones in admit order:
            # only the last C keys of the (sorted-unique) batch survive.
            old = np.flatnonzero(self._slot_key >= 0)
            if len(old):
                self._evict_slots(old)
            kept[: m - self.capacity] = False
            # The seed admitted those m-C keys and then evicted each one;
            # count them so the eviction stat matches the reference.
            self.stats.evictions += m - self.capacity
            new = missing[m - self.capacity:]
            self._bind(new, self._alloc(self.capacity))
            return kept
        need = m - self._n_free
        if need > 0:
            res = np.flatnonzero(self._slot_key >= 0)
            if need >= len(res):
                victims = res
            else:  # rank all victims in one pass
                victims = res[np.argpartition(self._last_use[res],
                                              need - 1)[:need]]
            self._evict_slots(victims)
        self._bind(missing, self._alloc(m))
        return kept

    def _admit_recmg_batched(self, missing: np.ndarray, kept: np.ndarray):
        """Fully batched recmg admission under eviction pressure: the
        engine ranks all victims in one vectorized pass
        (:meth:`~repro.core.priority_engine.ArrayPriorityEngine.
        admit_interleaved`), resolving own-batch evictions (a key of this
        batch evicted by a later one) vectorially.  Counter- and
        victim-identical to :meth:`_admit_recmg_sequential` (the property
        suite fuzzes both against the seed reference)."""
        m = len(missing)
        slot_map = self._slot_map
        victims, own, kept_eng = self.recmg.engine.admit_interleaved(
            missing, self.recmg.ev, self._n_free,
            resident_fn=lambda kk: slot_map[kk] >= 0)
        ext = victims[~own]
        if ext.size:
            vs = self._slot_map[ext]
            self._slot_map[ext] = -1
            self._slot_key[vs] = -1
            self._pf_flag[vs] = False
            self._release(vs.astype(np.int32, copy=False))
        # Own-batch victims were bound and then evicted by the sequential
        # loop; both count as evictions and both consumed a clock tick.
        self.stats.evictions += int(victims.size)
        kidx = np.flatnonzero(kept_eng)
        kk = missing[kidx]
        slots = self._alloc(kidx.size)
        self._slot_map[kk] = slots
        self._slot_key[slots] = kk
        self._admit_seq[slots] = self._clock + kidx
        self._last_use[slots] = self._clock + kidx
        self._clock += m
        kept[:] = kept_eng

    def _admit_recmg_sequential(self, missing: np.ndarray, kept: np.ndarray):
        """Seed-faithful per-key admission under recmg eviction pressure
        (the equivalence oracle for :meth:`_admit_recmg_batched`)."""
        slot_map, slot_key = self._slot_map, self._slot_key
        pos = {int(k): i for i, k in enumerate(missing.tolist())}
        for i, k in enumerate(missing.tolist()):
            if self._n_free == 0:
                v = self._pick_victim_recmg()
                vs = slot_map[v]
                slot_map[v] = -1
                slot_key[vs] = -1
                self._pf_flag[vs] = False
                self.stats.evictions += 1
                self._release(np.asarray([vs], np.int32))
                j = pos.get(v)
                if j is not None and j < i:
                    kept[j] = False  # own-batch key evicted mid-batch
            slot = int(self._alloc(1)[0])
            slot_map[k] = slot
            slot_key[slot] = k
            self._admit_seq[slot] = self._clock
            self._last_use[slot] = self._clock
            self._clock += 1
            if not self.recmg.contains(k):
                self.recmg.set_priority(k, self.recmg.ev)

    # ---------------- main path ----------------

    def lookup(self, ids: np.ndarray) -> torch.Tensor:
        """ids: (M,) int64 -> (M, D) embeddings from the fast tier,
        fetching misses on demand.  One vectorized pass: hit/miss partition
        via the slot map, batched admission, one scatter and one fused
        gather.  The result stays on the device (feed it straight into the
        forward); facades that merge sub-results host-side should use
        :meth:`lookup_host` instead.
        """
        out, t0 = self._lookup_device(ids)
        synchronize(self.device)
        self.stats.gather_s += time.perf_counter() - t0
        return out

    def lookup_host(self, ids: np.ndarray) -> np.ndarray:
        """:meth:`lookup` materialized as a NumPy array in one transfer —
        the multi-table and sharded facades reassemble per-store results
        on the host.  Counters are identical to :meth:`lookup`."""
        out, t0 = self._lookup_device(ids)
        out = out.cpu().numpy()
        self.stats.gather_s += time.perf_counter() - t0
        return out

    def _lookup_device(self, ids: np.ndarray):
        """Shared lookup pipeline; returns (device rows, gather timer
        start) — callers sync."""
        self._drain_staged()
        tr = get_tracer()
        if tr.enabled:  # off cost: one global read + attr check per batch
            t_span = tr.clock.now()
            ev0 = self.stats.evictions
        ids = np.asarray(ids).ravel()
        self.stats.batches += 1
        self.stats.lookups += ids.size
        uniq, inv = np.unique(ids, return_inverse=True)
        slots_u = self._slot_map[uniq]
        miss_mask = slots_u < 0
        n_hit = int(np.count_nonzero(~miss_mask[inv]))
        self.stats.hits += n_hit
        self.stats.misses += int(ids.size) - n_hit
        hit_slots = slots_u[~miss_mask]
        pf = self._pf_flag[hit_slots]
        n_pf = int(np.count_nonzero(pf))
        if n_pf:  # first-touch prefetch attribution
            self.stats.prefetch_hits += n_pf
            self._pf_flag[hit_slots] = False

        missing = uniq[miss_mask]
        if missing.size:
            t0 = time.perf_counter()
            if tr.enabled:
                t_admit = tr.clock.now()
            rows = self.host[missing]
            kept = self._admit(missing)
            wkeys = missing[kept]
            self._write_rows(self._slot_map[wkeys], rows[kept])
            # No sync here: the scatter is queued ahead of the gather on
            # the same stream and both finish by the one device sync in
            # ``lookup`` (fetch_s holds the host-side admit, the synchronous
            # host->device copy of the rows and the dispatch; the device's
            # execution lands in gather_s).
            self.stats.fetch_s += time.perf_counter() - t0
            self.stats.on_demand_rows += int(missing.size)
            self.stats.modeled_fetch_s += (
                self.fetch_us_fixed + self.fetch_us_per_row * missing.size
            ) * 1e-6
            if tr.enabled:
                tr.add_span("store", "admit", t_admit,
                            tr.clock.now() - t_admit, track="store",
                            args={"miss_rows": int(missing.size)})
            slots_u = self._slot_map[uniq]  # refresh post-admission

        if self.policy == "lru":
            # Batched touch: every resident key of this batch moves to the
            # MRU end, ordered by sorted-unique position (seed order).
            res = slots_u >= 0
            rs = slots_u[res]
            self._last_use[rs] = self._clock + np.flatnonzero(res)
            self._clock += uniq.size

        t0 = time.perf_counter()
        if tr.enabled:
            t_gather = tr.clock.now()
        # One fused read: the kernel gathers each unique key's slot,
        # expands to request order through ``inv`` and, where the batch's
        # unique working set overflowed the buffer, takes the row staged
        # from the host tier instead (already counted as on-demand).
        u = uniq.size
        m_ids = ids.size
        dev = self.device
        slots = np.maximum(slots_u, 0).astype(np.int32)
        overflow = slots_u < 0
        args = [_to_device(slots, dev), _to_device(inv.astype(np.int32), dev)]
        if overflow.any():
            # Overflow rows come straight from the host tier, in the
            # output's dtype (fp32 under quantize: never quantized).
            hrows = np.zeros((u, self.host.shape[1]), self._out_np_dtype)
            hrows[overflow] = self.host[uniq[overflow]]
            args += [_to_device(overflow, dev), _to_device(hrows, dev)]
        if self.quantize:
            out = ops.gather_rows_dequant_expand(self.buffer, self.scales,
                                                 *args)
        else:
            out = ops.gather_rows_expand(self.buffer, *args)
        if tr.enabled:
            tr.add_span("store", "gather", t_gather,
                        tr.clock.now() - t_gather, track="store",
                        args={"uniq": int(u)})
            # Span args carry the batch's exact counter deltas — the trace
            # <-> metrics reconciliation sums these over all lookup spans.
            tr.add_span("store", "lookup", t_span, tr.clock.now() - t_span,
                        track="store", args={
                            "ids": m_ids, "uniq": int(u),
                            "hit_ids": n_hit, "miss_ids": m_ids - n_hit,
                            "miss_rows": int(missing.size),
                            "evictions": self.stats.evictions - ev0,
                        })
        return out, t0

    def _write_rows(self, slots: np.ndarray, rows: np.ndarray):
        # In-place scatter of the admitted rows.  The JAX store padded it
        # to a power-of-two length only to stop XLA from recompiling.
        if not len(slots):
            return
        if self.quantize:
            # Quantize and scatter codes and scales in one launch.
            ops.quantize_scatter(
                self.buffer, self.scales,
                _to_device(np.asarray(slots, np.int32), self.device),
                _to_device(np.asarray(rows, np.float32), self.device),
                self.row_format)
            return
        self.buffer.index_copy_(
            0, _to_device(np.asarray(slots, np.int64), self.device),
            _to_device(rows, self.device))

    # ---------------- RecMG co-management hooks ----------------

    def stage_model_outputs(self, trunk: np.ndarray, bits: np.ndarray,
                            prefetch_ids: np.ndarray):
        """Double-buffered Algorithm 1: queue the model outputs now, apply
        them at the next batch boundary, so the producer never blocks an
        in-flight lookup.  Serving loops should call :meth:`flush_staged`
        in the gap between batches (off the latency-measured path); the
        next ``lookup`` drains any remainder as a fallback."""
        self._staged.append((np.asarray(trunk), np.asarray(bits),
                             np.asarray(prefetch_ids)))

    def flush_staged(self):
        """Apply all staged model outputs now (the inter-batch gap)."""
        self._drain_staged()

    def _drain_staged(self):
        if self._staged:
            staged, self._staged = self._staged, []
            for trunk, bits, pf in staged:
                self.apply_model_outputs(trunk, bits, pf)

    def apply_model_outputs(self, trunk: np.ndarray, bits: np.ndarray,
                            prefetch_ids: np.ndarray):
        """Algorithm 1, invoked between batches (pipelined)."""
        tr = get_tracer()
        if tr.enabled:
            t_pop = tr.clock.now()
            ev0 = self.stats.evictions
        trunk = np.asarray(trunk, np.int64).ravel()
        bits = np.asarray(bits).ravel()
        m = min(trunk.size, bits.size)  # zip semantics: shorter side wins
        trunk, bits = trunk[:m], bits[:m]
        pf_ids = np.asarray(prefetch_ids, np.int64).ravel()
        if self.policy != "recmg":
            # LRU+PF mode: only prefetch insertion applies.
            pf = self._new_prefetch_keys(pf_ids)
            if pf.size:
                self._fetch_prefetch(pf)
        else:
            t0 = time.perf_counter()
            # Only rank RESIDENT keys (pipelined outputs can reference
            # vectors already evicted; ranking them would desync
            # priorities/residency).
            res = self._slot_map[trunk] >= 0
            self.recmg.load_embeddings(trunk[res], bits[res], [])
            pf = self._new_prefetch_keys(pf_ids)
            if pf.size:
                self._fetch_prefetch(pf)
                self.recmg.set_priorities(pf, self.recmg.ev)
            self.stats.model_s += time.perf_counter() - t0
        if tr.enabled:
            tr.add_span("store", "populate", t_pop,
                        tr.clock.now() - t_pop, track="store", args={
                            "trunk": int(trunk.size), "pf_rows": int(pf.size),
                            "evictions": self.stats.evictions - ev0})

    def _new_prefetch_keys(self, pf_ids: np.ndarray) -> np.ndarray:
        """Non-resident prefetch targets, deduplicated, first-occurrence
        order preserved (the seed admitted duplicates twice, leaking a
        buffer slot per duplicate; the batched engine dedupes)."""
        if not pf_ids.size:
            return pf_ids
        pf = pf_ids[self._slot_map[pf_ids] < 0]
        if pf.size > 1:
            _, first = np.unique(pf, return_index=True)
            pf = pf[np.sort(first)]
        return pf

    def _fetch_prefetch(self, keys: np.ndarray):
        rows = self.host[keys]
        kept = self._admit(keys)
        wkeys = keys[kept]
        slots = self._slot_map[wkeys]
        self._write_rows(slots, rows[kept])
        self._pf_flag[slots] = True

    def modeled_batch_ms(self) -> float:
        """Analytic per-batch latency contribution of the slow tier."""
        return 1e3 * self.stats.modeled_fetch_s / max(self.stats.batches, 1)

    def publish_metrics(self, reg):
        """Publish this store's counters under ``store.*`` (uniform
        facade/store surface for the serving entry points)."""
        return self.stats.publish(reg, prefix="store")
