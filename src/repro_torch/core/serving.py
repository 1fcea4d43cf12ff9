"""Multi-table tiered serving facade — one batched store per sparse feature.

Ported from ``src/repro/core/serving.py``.  Industrial DLRM serving
(Software-Defined Memory, RecShard) manages residency per embedding table:
tables differ wildly in size and skew, so a single global buffer lets one
hot table starve the rest.  This facade owns one
:class:`~repro_torch.core.tiered.TieredEmbeddingStore` per table under a
**shared byte budget**, split proportionally to table size (rows), and
routes batched lookups on *global* vector ids (the trace id space:
``global_id = table_offset + row_id``) to the right store with one
``searchsorted`` pass.

The budget split, the routing, the model-output routing, the aggregated
accounting and the degraded read follow the source line by line, so
capacities and counters equal the JAX facade's.  What changed: every
sub-store lives on ``device`` (``"cuda"`` by default), each reads its rows
with its own fused kernel launch and copies them to the host
(``lookup_host``), and ``lookup`` returns the reassembled rows as a torch
tensor on ``device``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.tiered import (TierStats, TieredEmbeddingStore,
                                     fast_row_bytes)
from repro_torch.device import resolve_device


class MultiTableTieredStore:
    """Per-table batched stores under a shared byte budget.

    Parameters
    ----------
    host_tables: per-table host-tier arrays, each (N_t, D).
    capacity:    total fast-tier rows across all tables (mutually exclusive
                 with ``byte_budget``).
    byte_budget: total fast-tier bytes, split with *per-table* row
                 footprints (``D * itemsize`` for full-precision rows —
                 mixed-dtype table sets pay their own rate — or ``D + 4``
                 for the quantized tier).
    weights:     optional per-table split weights (default: table rows).
    device:      where every sub-store's fast tier lives.
    """

    def __init__(self, host_tables: Sequence[np.ndarray],
                 capacity: Optional[int] = None,
                 byte_budget: Optional[int] = None,
                 policy: str = "lru", quantize: bool = False,
                 row_format: Optional[str] = None,
                 weights: Optional[Sequence[float]] = None,
                 min_capacity: int = 4, fetch_us_fixed: float = 30.0,
                 device="cuda", **store_kw):
        if (capacity is None) == (byte_budget is None):
            raise ValueError("pass exactly one of capacity / byte_budget")
        self.device = resolve_device(device)
        rows = np.array([t.shape[0] for t in host_tables], np.int64)
        d = host_tables[0].shape[1]
        # Budget split in the unit the caller budgeted in: bytes-per-row
        # per table under ``byte_budget`` (tables can differ in dtype, so
        # a shared scalar row size would over/under-run the budget), a
        # unit cost of 1 under row ``capacity`` (same algorithm, rows).
        rb = np.array([fast_row_bytes(t.shape[1], t.dtype, quantize,
                                      row_format or "int8")
                       for t in host_tables], np.int64)
        unit = rb if capacity is None else np.ones(len(rb), np.int64)
        budget = int(byte_budget) if capacity is None else int(capacity)
        if int((np.minimum(1, rows) * unit).sum()) > budget:
            # Below one row per store the budget cannot be honored (stores
            # clamp to capacity >= 1); fail loudly instead of overrunning.
            raise ValueError(
                f"budget of {budget} cannot give {len(host_tables)} "
                "tables one row each")
        w = np.asarray(weights if weights is not None else rows, np.float64)
        # The per-table floor must never be allowed to overrun the shared
        # budget: when the budget cannot afford ``min_capacity`` rows for
        # every table, the effective floor drops to an equal split (at
        # least one row — the irreducible store minimum).
        floor = max(1, min(int(min_capacity), budget // int(unit.sum())))
        caps = np.maximum(floor, np.floor(
            budget * (w / w.sum()) / unit)).astype(np.int64)
        caps = np.minimum(caps, rows)  # never exceed the table itself
        # Lifting small tables to the floor can still overrun the budget;
        # claw the excess back from the biggest spender (in budget units)
        # still above the floor, largest-first — deterministic, and since
        # every table at the floor fits the budget by construction, this
        # always converges to ``sum(caps * unit) <= budget``.
        excess = int((caps * unit).sum()) - budget
        while excess > 0:
            above = np.flatnonzero(caps > floor)
            if not above.size:
                break
            i = int(above[np.argmax((caps * unit)[above])])
            take = min(-(-excess // int(unit[i])), int(caps[i]) - floor)
            caps[i] -= take
            excess -= take * int(unit[i])
        self.offsets = np.concatenate(([0], np.cumsum(rows)))
        self.capacity = int(caps.sum())
        self.row_bytes_per_table = rb
        self.row_bytes = int(rb.max())  # worst-case scalar (back-compat)
        self.byte_budget = (int(byte_budget) if byte_budget is not None
                            else int((caps * rb).sum()))
        # Sub-stores model only the per-row slow-tier cost; the fixed
        # per-batch overhead is charged once per *facade* batch with a miss
        # (matching the monolithic store's accounting, so the bench
        # comparison measures policy quality, not aggregation artifacts).
        self.fetch_us_fixed = float(fetch_us_fixed)
        self._fixed_fetch_s = 0.0
        self.stores: List[TieredEmbeddingStore] = [
            TieredEmbeddingStore(t, int(c), policy=policy, quantize=quantize,
                                 row_format=row_format,
                                 fetch_us_fixed=0.0, device=self.device,
                                 **store_kw)
            for t, c in zip(host_tables, caps)
        ]
        self.emb_dim = d
        # Quantized stores dequantize to f32; otherwise the host dtype
        # flows through, matching what the single-store lookup returns.
        self.out_dtype = self.stores[0]._out_np_dtype
        self.batches = 0

    @classmethod
    def from_global_table(cls, host: np.ndarray, rows_per_table: np.ndarray,
                          **kw) -> "MultiTableTieredStore":
        """Split a monolithic (sum_rows, D) host table laid out in
        global-id order into per-table views (zero-copy slices)."""
        offs = np.concatenate(([0], np.cumsum(rows_per_table)))
        tables = [host[offs[t]: offs[t + 1]] for t in
                  range(len(rows_per_table))]
        return cls(tables, **kw)

    # ---------------- routing ----------------

    def _route(self, global_ids: np.ndarray):
        gid = np.asarray(global_ids, np.int64).ravel()
        table = np.searchsorted(self.offsets, gid, side="right") - 1
        return gid, table, gid - self.offsets[table]

    def resident_mask(self, global_ids: np.ndarray) -> np.ndarray:
        """Vectorized residency probe across all per-table stores (the
        serving runtime's cancel-before-issue hook)."""
        gid, table, local = self._route(global_ids)
        mask = np.zeros(len(gid), bool)
        for t in np.unique(table).tolist():
            m = table == t
            mask[m] = self.stores[t].resident_mask(local[m])
        return mask

    def lookup_resident(self, global_ids: np.ndarray):
        """Degraded read (single-store API parity): ``(rows, n_default)``
        — stale-but-resident rows per table, zero default for misses; no
        stats mutation and no slow-tier traffic on any sub-store.  ``rows``
        is :meth:`lookup_resident_device`'s read copied to the host once."""
        rows, n_default = self.lookup_resident_device(global_ids)
        return rows.cpu().numpy(), n_default

    def lookup_resident_device(self, global_ids: np.ndarray):
        """:meth:`lookup_resident` with ``rows`` on the facade's device:
        each table's sub-store reads its rows with its own fused read, and
        one device-side index puts them in request order."""
        gid, table, local = self._route(global_ids)
        dtype = torch.from_numpy(np.zeros(0, self.out_dtype)).dtype
        parts, order, n_default = [], [], 0
        for t in np.unique(table).tolist():
            m = np.flatnonzero(table == t)
            rows, nd = self.stores[t].lookup_resident_device(local[m])
            parts.append(rows.to(dtype))
            order.append(m)
            n_default += nd
        out = torch.empty((len(gid), self.emb_dim), dtype=dtype,
                          device=self.device)
        if parts:
            out.index_copy_(0, torch.from_numpy(np.concatenate(order)).to(
                self.device), torch.cat(parts))
        return out, n_default

    # ---------------- single-store-compatible API ----------------

    def lookup(self, global_ids: np.ndarray) -> torch.Tensor:
        """(M,) global ids -> (M, D) on the facade's device; one batched
        sub-lookup per table hit by this batch, reassembled in request
        order on the host."""
        gid, table, local = self._route(global_ids)
        self.batches += 1
        out = np.empty((len(gid), self.emb_dim), self.out_dtype)
        missed = False
        for t in np.unique(table).tolist():
            m = table == t
            st = self.stores[t]
            od0 = st.stats.on_demand_rows
            # lookup_host: sub-results merge on the host anyway, so the
            # store materializes in one transfer.
            out[m] = st.lookup_host(local[m])
            missed = missed or st.stats.on_demand_rows > od0
        if missed:
            self._fixed_fetch_s += self.fetch_us_fixed * 1e-6
        return torch.from_numpy(out).to(self.device)

    def _route_outputs(self, trunk, bits, prefetch_ids, staged: bool):
        trunk, t_tab, t_loc = self._route(trunk)
        bits = np.asarray(bits).ravel()[: len(trunk)]  # zip truncation
        t_tab, t_loc = t_tab[: len(bits)], t_loc[: len(bits)]
        _, p_tab, p_loc = self._route(prefetch_ids)
        for t in np.unique(np.concatenate((t_tab, p_tab))).tolist():
            tm, pm = t_tab == t, p_tab == t
            store = self.stores[t]
            fn = store.stage_model_outputs if staged \
                else store.apply_model_outputs
            fn(t_loc[tm], bits[tm], p_loc[pm])

    def apply_model_outputs(self, trunk: np.ndarray, bits: np.ndarray,
                            prefetch_ids: np.ndarray):
        """Route Algorithm 1 outputs (global-id keyed) to each table."""
        self._route_outputs(trunk, bits, prefetch_ids, staged=False)

    def stage_model_outputs(self, trunk: np.ndarray, bits: np.ndarray,
                            prefetch_ids: np.ndarray):
        """Double-buffered apply: route now, land at each store's next
        lookup boundary."""
        self._route_outputs(trunk, bits, prefetch_ids, staged=True)

    def flush_staged(self):
        """Apply all staged outputs now (the inter-batch gap)."""
        for s in self.stores:
            s.flush_staged()

    def warmup(self, batch_hint: int):
        """Launch every sub-store's kernels once at ``batch_hint`` rows
        (single-store API parity).  Alternatively pass ``warmup_batch=`` at
        construction — it flows to every sub-store."""
        for s in self.stores:
            s.warmup(batch_hint)

    # ---------------- aggregated accounting ----------------

    @property
    def stats(self) -> TierStats:
        agg = TierStats()
        for s in self.stores:
            agg.merge(s.stats)
        agg.batches = self.batches  # facade batches, not per-store sum
        agg.modeled_fetch_s += self._fixed_fetch_s
        return agg

    def modeled_batch_ms(self) -> float:
        return 1e3 * self.stats.modeled_fetch_s / max(self.batches, 1)

    def per_table_hit_rates(self) -> List[float]:
        return [s.stats.hit_rate for s in self.stores]

    def publish_metrics(self, reg):
        """Publish the aggregate ``store.*`` view plus one
        ``table.<t>.store.*`` namespace per sparse feature."""
        self.stats.publish(reg, prefix="store")
        reg.gauge("tables.n_tables").set(len(self.stores))
        for t, st in enumerate(self.stores):
            st.stats.publish(reg, prefix=f"table.{t}.store")
        return reg
