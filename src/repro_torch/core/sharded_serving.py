"""Sharded multi-worker tiered serving: N simulated workers, one batched
tiered store (+ inline prefetch engine) each, all-to-all-style gather.

Ported from ``src/repro/core/sharded_serving.py``.  The routing, the
per-shard inline prefetch engines, the fault layer (kill, recover, slow,
flaky, hot-row replicas, bounded recovery), the telemetry and the ``ft.*``
accounting follow the source line by line, so counters and
:meth:`ShardedTieredStore.shard_telemetry` equal the JAX store's.  What
changed with the device:

* Every shard's store lives on ``device`` (``"cuda"`` by default; it
  raises when CUDA is absent).  A batch is **assembled on the device**:
  each shard's slice comes back as device rows — the primary path
  ``st.lookup`` (the store's fused gather kernel), a retry episode's
  ``st.lookup`` inside its attempt, a dead shard's replica rows (kept on
  the device) plus ``st.lookup_resident_device`` — and one ``index_copy_``
  puts them in request order.  The JAX store merged them into a NumPy
  array on the host (``lookup_host``) and copied the batch back.  The rows
  are copies, so they stay bit-equal to the JAX store's.
* :meth:`ShardedTieredStore.lookup_resident_device` is the degraded read
  with rows left on the device (the pipelined runtime assembles a degraded
  batch there); :meth:`ShardedTieredStore.lookup_resident` is its host
  copy.
* Recovery counts its modeled int8 wire bytes with the port's
  :func:`repro_torch.distributed.compression.quantize_int8` on the device;
  the codes stay there.

:class:`ShardedTieredStore` executes a
:class:`~repro_torch.sharding.embedding_shard.ShardPlan`: every worker owns
the host-tier rows the plan assigned to it and a fast-tier buffer sized by
the plan's per-shard budget.  A batch of global ids is routed
shard-locally in one vectorized pass (``plan.route``), each touched shard
runs one batched :class:`~repro_torch.core.tiered.TieredEmbeddingStore`
lookup on its local ids, and the results merge back into request order —
the simulated equivalent of the all-to-all that follows per-worker
embedding lookups in distributed DLRM serving.

Model outputs (Algorithm 1 triples, global-id keyed) route the same way,
through one **per-shard inline** :class:`~repro_torch.runtime.
prefetch_engine.PrefetchEngine` each: the engine dedups in-flight prefetch
ids, cancels ids that became resident before issue, models each worker's
private background fetch channel (timeliness), and applies synchronously.

Telemetry goes beyond the merged :class:`~repro_torch.core.tiered.
TierStats`:

* **load / skew** — per-shard routed-id counts, aggregate and worst
  single-batch imbalance (``max shard load / mean shard load``);
* **stall** — per-shard modeled slow-tier time, plus the *critical-path*
  view: per batch, workers fetch in parallel, so the batch pays the max
  over shards, not the sum.  ``parallel_fetch_speedup`` is the ratio.

**Fault tolerance** (``arm_faults`` / ``fault_plan=``): a deterministic
:class:`~repro_torch.runtime.faults.FaultInjector` drives per-shard health
on the shared virtual clock.  A dead shard's rows are answered from the
plan's hot-row replica set when replicated (exact bytes), else through the
degraded ``lookup_resident`` contract (stale-but-resident row or zero
default — never a wrong vector, never a hang); transient fetch failures
retry through a clock-driven deadline-aware wrapper; recovery rebuilds the
shard store and streams the lost resident set back in bounded background
chunks through the shard's prefetch channel.  Everything is accounted in
the exactly-reconciled ``ft.*`` namespace
(:func:`repro_torch.obs.reconcile.check_ft`).  With no plan armed, the
serving path is the same as without this layer.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.tiered import (TierStats, TieredEmbeddingStore,
                                     _to_device, fast_row_bytes)
from repro_torch.device import resolve_device, synchronize
from repro_torch.distributed.compression import quantize_int8
from repro_torch.distributed.fault_tolerance import (RetryDeadlineExceeded,
                                                     retry_step)
from repro_torch.obs.tracing import get_tracer
from repro_torch.runtime.clock import VirtualClock
from repro_torch.runtime.faults import (FaultInjector, FaultPlan, FtStats,
                                        TransientFetchError)
from repro_torch.runtime.prefetch_engine import PrefetchEngine
from repro_torch.runtime.telemetry import RuntimeTelemetry
from repro_torch.sharding.embedding_shard import (ShardPlan, make_plan,
                                                  trace_frequencies)


class ShardedTieredStore:
    """N per-shard batched stores behind one single-store-compatible API.

    Parameters
    ----------
    host:  (n_vectors, D) global host-tier table in global-id order.
    plan:  a :class:`ShardPlan` (see :func:`ShardedTieredStore.build` for
           the convenience constructor that makes one).
    with_engines: route ``apply_model_outputs`` through per-shard inline
           prefetch engines (dedup/cancel/timeliness telemetry).  The
           apply semantics are identical either way.
    device: where every shard's fast tier and the assembled batch live.
    """

    def __init__(self, host: np.ndarray, plan: ShardPlan,
                 policy: str = "lru", quantize: bool = False,
                 row_format: Optional[str] = None,
                 fetch_us_fixed: float = 30.0, with_engines: bool = True,
                 fault_plan=None, fault_horizon: Optional[int] = None,
                 device="cuda", **store_kw):
        if host.shape[0] != plan.n_vectors:
            raise ValueError(f"host has {host.shape[0]} rows, "
                             f"plan covers {plan.n_vectors}")
        self.device = resolve_device(device)
        self.plan = plan
        self.n_shards = plan.n_shards
        self.emb_dim = host.shape[1]
        # Kept for the fault layer: replica rows come from here, and a
        # recovered shard's replacement store is rebuilt over host[g].
        self._host = np.asarray(host)
        self._policy = policy
        self._quantize = quantize
        self._row_format = row_format
        self._store_kw = dict(store_kw)
        # Per-shard stores model the per-row slow-tier cost; the fixed
        # per-batch overhead is charged at the facade (once per batch with
        # a miss for the sum view, once per missing *shard* for the
        # critical-path view) so policy comparisons aren't aggregation
        # artifacts — same scheme as the multi-table facade.
        self.fetch_us_fixed = float(fetch_us_fixed)
        self.stores: List[TieredEmbeddingStore] = [
            TieredEmbeddingStore(host[g], int(c), policy=policy,
                                 quantize=quantize, row_format=row_format,
                                 fetch_us_fixed=0.0, device=self.device,
                                 **store_kw)
            for g, c in zip(plan.global_ids, plan.capacities)
        ]
        # Quantized stores dequantize to fp32; otherwise the host dtype
        # flows through, as the single-store lookup returns it.
        self.out_dtype = torch.float32 if quantize \
            else self.stores[0].buffer.dtype
        self.batches = 0
        self._fixed_fetch_s = 0.0
        # ---- load / critical-path telemetry ----
        self._shard_lookups = np.zeros(self.n_shards, np.int64)
        self._max_batch_imbalance = 0.0
        self._critical_fetch_s = 0.0   # sum over batches of max-over-shards
        self._engines = None
        if with_engines:
            self.clock = VirtualClock()
            self.engine_telemetry = [RuntimeTelemetry()
                                     for _ in range(self.n_shards)]
            self._engines = [
                PrefetchEngine(st, telemetry=tel, clock=self.clock,
                               scheduler="inline",
                               fetch_us_per_row=st.fetch_us_per_row,
                               fetch_us_fixed=self.fetch_us_fixed,
                               trace_track=f"pf-shard-{s}")
                for s, (st, tel) in enumerate(zip(self.stores,
                                                  self.engine_telemetry))
            ]
        # ---- hot-row replication (exact failover answers) ----
        self._replica_index = None   # global id -> replica row (-1: none)
        self._replica_rows = None    # (k, D) exact host bytes, on device
        rep = plan.replicated_ids
        if rep is not None and len(rep):
            rep = np.asarray(rep, np.int64)
            self._replica_index = np.full(plan.n_vectors, -1, np.int64)
            self._replica_index[rep] = np.arange(len(rep))
            self._replica_rows = _to_device(self._host[rep], self.device)
        # ---- fault layer (off by default) ----
        self._injector = None
        self._ft = None
        self._lost_rows = {}    # shard -> local ids resident at kill time
        self._recovery = {}     # shard -> list of pending local-id chunks
        if fault_plan is not None:
            self.arm_faults(fault_plan, fault_horizon)

    @classmethod
    def build(cls, host: np.ndarray, rows_per_table: Sequence[int],
              n_shards: int, placement: str = "table",
              capacity: Optional[int] = None,
              byte_budget: Optional[int] = None,
              frequencies: Optional[np.ndarray] = None,
              fast_weights: Optional[Sequence[float]] = None,
              profile_ids: Optional[np.ndarray] = None,
              replicate_hot: int = 0,
              **kw) -> "ShardedTieredStore":
        """Plan + store in one call.  ``profile_ids`` (a trace sample)
        stands in for explicit ``frequencies`` under ``"freq"`` and for
        ``replicate_hot`` (top-k hot rows resident on every shard).
        ``byte_budget`` (mutually exclusive with ``capacity``) budgets the
        total fast tier in bytes, converted with the quantization-aware
        per-row footprint before the planner splits rows across shards."""
        if capacity is not None and byte_budget is not None:
            raise ValueError("pass at most one of capacity / byte_budget")
        if byte_budget is not None:
            rb = fast_row_bytes(host.shape[1], host.dtype,
                                kw.get("quantize", False),
                                kw.get("row_format") or "int8")
            capacity = int(byte_budget) // rb
        if capacity is None:
            raise ValueError("capacity (total fast-tier rows) or "
                             "byte_budget is required")
        if frequencies is None and profile_ids is not None:
            frequencies = trace_frequencies(profile_ids, host.shape[0])
        plan = make_plan(rows_per_table, n_shards, int(capacity),
                         placement, frequencies=frequencies,
                         fast_weights=fast_weights,
                         replicate_hot=replicate_hot)
        return cls(host, plan, **kw)

    def arm_faults(self, fault_plan, horizon_batches: Optional[int] = None,
                   seed: int = 0):
        """Arm deterministic fault injection (a :class:`~repro_torch.
        runtime.faults.FaultPlan` or its CLI string form, e.g. ``"kill:1@
        mid,recover:1@75%"``).  ``horizon_batches`` resolves fractional
        event times.  Returns the :class:`~repro_torch.runtime.faults.
        FaultInjector`."""
        if self._engines is None:
            raise ValueError("fault injection needs with_engines=True "
                             "(the shared virtual clock drives the "
                             "fault timeline)")
        if isinstance(fault_plan, str):
            fault_plan = FaultPlan.parse(fault_plan, seed=seed)
        self._injector = FaultInjector(fault_plan, self.n_shards,
                                       horizon_batches)
        self._ft = FtStats(n_shards=self.n_shards)
        return self._injector

    @property
    def ft_stats(self):
        """The ``ft.*`` counters (None until :meth:`arm_faults`)."""
        return self._ft

    # ---------------- routing + merge (the all-to-all) ----------------

    def _assemble(self, n: int, parts, order) -> torch.Tensor:
        """One ``index_copy_`` of the shards' device rows into request
        order: ``parts[i]`` are the rows of request positions
        ``order[i]``."""
        out = torch.empty((n, self.emb_dim), dtype=self.out_dtype,
                          device=self.device)
        if parts:
            out.index_copy_(0, _to_device(np.concatenate(order), self.device),
                            torch.cat([p.to(self.out_dtype) for p in parts]))
        return out

    def lookup(self, global_ids: np.ndarray) -> torch.Tensor:
        """(M,) global ids -> (M, D) on the device: scatter ids
        shard-locally, one batched per-shard lookup each, gather back in
        request order on the device."""
        inj = self._injector
        if inj is not None:
            # Fault timeline first: events scheduled for this batch index
            # fire before any routing, then each recovering shard streams
            # one bounded background chunk (serving never halts).
            self._poll_faults(self.batches)
            self._pump_recovery()
        gid, shard, local = self.plan.route(global_ids)
        self.batches += 1
        loads = np.bincount(shard, minlength=self.n_shards)
        self._shard_lookups += loads
        self._max_batch_imbalance = max(
            self._max_batch_imbalance,
            float(loads.max() / max(loads.mean(), 1e-12)))
        parts, order = [], []
        missed_any = False
        critical_us = 0.0
        tr = get_tracer()
        if inj is not None:
            self._ft.served += int(len(gid))
        for s in np.flatnonzero(loads).tolist():
            m = np.flatnonzero(shard == s)
            st = self.stores[s]
            if inj is not None and not inj.up[s]:
                # Dead shard: replicas / degraded contract, no slow-tier
                # work, zero critical-path contribution (bounded stall).
                self._serve_failover(s, gid[m], local[m], m, parts, order)
                continue
            f0, od0 = st.stats.modeled_fetch_s, st.stats.on_demand_rows
            if tr.enabled:
                t_s = tr.clock.now()
            # Timeliness probe only when this shard's channel has fetches
            # in flight — skips the per-batch unique() on cold paths.
            if self._engines is not None and self._engines[s]._pf_eta:
                self._engines[s].observe_demand(np.unique(local[m]),
                                                self.clock.now())
            extra_us = 0.0
            if (inj is not None and inj.flaky[s] > 0.0
                    and bool((~st.resident_mask(local[m])).any())):
                # The slice needs the slow tier and the channel is flaky:
                # fetch through the clock-driven retry wrapper.  Exhausted
                # episodes fall back to the degraded contract for this
                # slice — the slow tier stays un-touched, never hung on.
                rows, extra_us, ok = self._fetch_with_retry(s, st, local[m])
                self._ft.retry_overhead_ms += extra_us * 1e-3
                if ok:
                    self._ft.primary += int(loads[s])
                else:
                    rows, nd = st.lookup_resident_device(local[m])
                    self._ft.failover_degraded += int(loads[s])
                    self._ft.degraded_default += int(nd)
            else:
                rows = st.lookup(local[m])
                if inj is not None:
                    self._ft.primary += int(loads[s])
            parts.append(rows)
            order.append(m)
            d_us = (st.stats.modeled_fetch_s - f0) * 1e6 + extra_us
            if st.stats.on_demand_rows > od0:
                missed_any = True
                d_us += self.fetch_us_fixed
            if inj is not None and inj.slow[s] != 1.0:
                # Congested / throttled host: its fetch window stretches.
                self._ft.slow_ms += d_us * (inj.slow[s] - 1.0) * 1e-3
                d_us *= inj.slow[s]
            critical_us = max(critical_us, d_us)
            if tr.enabled:
                # Per-shard route+gather window on this worker's track.
                tr.add_span("shard", "lookup", t_s, tr.clock.now() - t_s,
                            track=f"shard-{s}", args={
                                "shard": s, "rows": int(loads[s]),
                                "miss_rows": st.stats.on_demand_rows - od0})
        if missed_any:
            self._fixed_fetch_s += self.fetch_us_fixed * 1e-6
        self._critical_fetch_s += critical_us * 1e-6
        if self._engines is not None:
            # Workers fetch in parallel; modeled time moves by the batch's
            # critical path (what timeliness is measured against).
            self.clock.advance(critical_us)
        out = self._assemble(len(gid), parts, order)
        synchronize(self.device)
        return out

    # ---------------- fault handling (armed via arm_faults) ----------------

    def _poll_faults(self, batch: int):
        """Fire the injector's due transitions and apply their store-side
        effects; every edge gets a span instant on the shard's track."""
        tr = get_tracer()
        for e, clear in self._injector.poll(batch, self.clock.now()):
            if tr.enabled:
                name = f"ft.{e.kind}" + ("_clear" if clear else "")
                tr.add_instant("ft", name, ts=self.clock.now(),
                               track=f"shard-{e.shard}",
                               args={"shard": e.shard, "batch": batch,
                                     "factor": e.factor})
            if e.kind == "kill" and not clear:
                self._on_kill(e.shard)
            elif e.kind == "recover" and not clear:
                self._on_recover(e.shard)

    def _on_kill(self, s: int):
        """The shard process dies.  Its store object survives only as a
        read-only stale standby snapshot (the facade's last-known-good
        view, what `lookup_resident` answers from); in-flight prefetch
        work is cancelled with the ``pf.shard_down`` fate and staged
        model outputs are discarded — nothing may mutate a dead shard."""
        self._ft.kills += 1
        st = self.stores[s]
        # The resident set at kill time is what recovery must restore.
        self._lost_rows[s] = np.flatnonzero(st._slot_map >= 0).astype(
            np.int64)
        for item in st._staged:
            self._ft.staged_dropped += int(np.asarray(item[2]).size)
        st._staged.clear()
        self._engines[s].set_down(True)

    def _on_recover(self, s: int):
        """A replacement worker comes up *empty*: rebuild the shard store
        fresh over the surviving host-tier slice on the same device
        (cumulative counters carry over — the shard's history did happen),
        point its prefetch engine at it and re-open it, and queue the lost
        resident set for bounded background restoration."""
        inj, ft = self._injector, self._ft
        old = self.stores[s]
        kw = dict(self._store_kw)
        kw.pop("warmup_batch", None)  # the kernels are already loaded
        g = self.plan.global_ids[s]
        new = TieredEmbeddingStore(self._host[g], int(old.capacity),
                                   policy=self._policy,
                                   quantize=self._quantize,
                                   row_format=self._row_format,
                                   fetch_us_fixed=0.0, device=self.device,
                                   **kw)
        new.stats = old.stats
        self.stores[s] = new
        self._engines[s].store = new
        self._engines[s].set_down(False)
        ft.down_us[s] += inj.close_downtime(s, self.clock.now())
        ft.recoveries += 1
        lost = self._lost_rows.pop(s, None)
        if lost is not None and lost.size:
            chunk = max(1, int(inj.plan.recovery_chunk))
            self._recovery[s] = [lost[i:i + chunk]
                                 for i in range(0, lost.size, chunk)]

    def _pump_recovery(self):
        """One bounded chunk per recovering shard per batch: the lost
        resident set streams back through the shard's prefetch channel as
        int8 row transfers (accounted on the modeled wire: the codes stay
        on the device), with exact values re-materialized from the
        surviving host tier — recovery can never introduce a wrong
        vector."""
        if not self._recovery:
            return
        ft, tr = self._ft, get_tracer()
        for s in sorted(self._recovery):
            chunks = self._recovery[s]
            loc = chunks.pop(0)
            rows = self.stores[s].host[loc]
            q, _scale = quantize_int8(_to_device(rows, self.device))
            ft.recovery_bytes += int(q.numel()) + 4       # int8 + scale
            ft.recovery_bytes_raw += int(loc.size) * self.emb_dim * 4
            eng = self._engines[s]
            eng.submit(np.empty(0, np.int64), np.empty(0, np.int64), loc,
                       now_us=self.clock.now())
            eng.drain()
            ft.recovery_rows += int(loc.size)
            ft.recovery_chunks += 1
            if not chunks:
                del self._recovery[s]
                if tr.enabled:
                    tr.add_instant("ft", "ft.recovery_complete",
                                   ts=self.clock.now(), track=f"shard-{s}",
                                   args={"shard": s,
                                         "rows": ft.recovery_rows})

    def _serve_failover(self, s: int, g: np.ndarray, loc: np.ndarray,
                        m: np.ndarray, parts, order):
        """Answer a dead shard's slice (request positions ``m``):
        replicated rows exactly from the hot-row replica set on the
        device, the rest via the degraded stale-resident / zero-default
        contract on the standby snapshot."""
        ft = self._ft
        if self._replica_index is not None:
            rep_loc = self._replica_index[g]
            is_rep = rep_loc >= 0
        else:
            is_rep = np.zeros(len(g), bool)
        if is_rep.any():
            parts.append(self._replica_rows.index_select(
                0, _to_device(rep_loc[is_rep], self.device)))
            order.append(m[is_rep])
            ft.failover_replica += int(np.count_nonzero(is_rep))
        miss = ~is_rep
        if miss.any():
            rows, nd = self.stores[s].lookup_resident_device(loc[miss])
            parts.append(rows)
            order.append(m[miss])
            ft.failover_degraded += int(np.count_nonzero(miss))
            ft.degraded_default += int(nd)

    def _fetch_with_retry(self, s: int, st, loc: np.ndarray):
        """One retry *episode* around a flaky shard's fetch: each failed
        attempt costs the plan's timeout, backoffs charge modeled time
        (never a wall-clock sleep), and the whole episode is bounded by
        the retry deadline.  Returns ``(device rows, extra_us, ok)``; the
        store mutates exactly once, on the successful attempt."""
        inj, ft = self._injector, self._ft
        fp = inj.plan
        extra = [0.0]
        failures = [0]

        def attempt():
            if inj.draw_failure(s):
                failures[0] += 1
                extra[0] += fp.retry_timeout_us
                raise TransientFetchError(
                    f"shard {s}: injected fetch timeout")
            return st.lookup(loc)

        try:
            rows = retry_step(
                attempt, retries=fp.max_retries,
                backoff_s=fp.retry_backoff_us * 1e-6,
                retryable=(TransientFetchError,),
                sleep=lambda sec: extra.__setitem__(0, extra[0] + sec * 1e6),
                now=lambda: extra[0] * 1e-6,
                deadline_s=fp.retry_deadline_us * 1e-6)
            if failures[0]:
                ft.retries += 1
                ft.retry_succeeded += 1
            return rows, extra[0], True
        except (TransientFetchError, RetryDeadlineExceeded):
            ft.retries += 1
            ft.retry_exhausted += 1
            return None, extra[0], False

    def resident_mask(self, global_ids: np.ndarray) -> np.ndarray:
        gid, shard, local = self.plan.route(global_ids)
        mask = np.zeros(len(gid), bool)
        for s in np.unique(shard).tolist():
            m = shard == s
            mask[m] = self.stores[s].resident_mask(local[m])
        return mask

    def lookup_resident(self, global_ids: np.ndarray):
        """Degraded read (single-store API parity): ``(rows, n_default)``
        routed shard-locally — stale-but-resident rows, zero default for
        misses; no stats mutation, no slow-tier traffic, and no load/
        imbalance accounting (this is the answer a shard gives when it is
        *not* allowed to do work).  ``rows`` is
        :meth:`lookup_resident_device`'s read copied to the host once."""
        rows, n_default = self.lookup_resident_device(global_ids)
        return rows.cpu().numpy(), n_default

    def lookup_resident_device(self, global_ids: np.ndarray):
        """:meth:`lookup_resident` with ``rows`` on the device: each
        shard's store reads its slice with its own fused read, and one
        device-side index puts them in request order."""
        gid, shard, local = self.plan.route(global_ids)
        parts, order, n_default = [], [], 0
        for s in np.unique(shard).tolist():
            m = np.flatnonzero(shard == s)
            rows, nd = self.stores[s].lookup_resident_device(local[m])
            parts.append(rows)
            order.append(m)
            n_default += nd
        return self._assemble(len(gid), parts, order), n_default

    def _route_outputs(self, trunk, bits, prefetch_ids, staged: bool):
        trunk, t_shard, t_loc = self.plan.route(trunk)
        bits = np.asarray(bits).ravel()[: len(trunk)]  # zip truncation
        t_shard, t_loc = t_shard[: len(bits)], t_loc[: len(bits)]
        _, p_shard, p_loc = self.plan.route(prefetch_ids)
        for s in np.unique(np.concatenate((t_shard, p_shard))).tolist():
            tm, pm = t_shard == s, p_shard == s
            if (staged and self._injector is not None
                    and not self._injector.up[s]):
                # Dead shard, direct staging path (bypasses the engine):
                # discard with its own non-identity counter — these rows
                # were never pf.submitted, so they must not take a
                # pf-fate; the engine path below accounts its own drops
                # as pf.shard_down.
                self._ft.staged_dropped += int(np.count_nonzero(pm))
                continue
            if staged:
                self.stores[s].stage_model_outputs(t_loc[tm], bits[tm],
                                                   p_loc[pm])
            elif self._engines is not None:
                # Inline engine: dedup/cancel/channel accounting, then a
                # synchronous apply — store state matches a direct call.
                self._engines[s].submit(t_loc[tm], bits[tm], p_loc[pm],
                                        now_us=self.clock.now())
                self._engines[s].drain()
            else:
                self.stores[s].apply_model_outputs(t_loc[tm], bits[tm],
                                                   p_loc[pm])

    def apply_model_outputs(self, trunk: np.ndarray, bits: np.ndarray,
                            prefetch_ids: np.ndarray):
        """Route Algorithm 1 outputs (global-id keyed) to each worker's
        engine (or store, with engines disabled)."""
        self._route_outputs(trunk, bits, prefetch_ids, staged=False)

    def stage_model_outputs(self, trunk: np.ndarray, bits: np.ndarray,
                            prefetch_ids: np.ndarray):
        """Double-buffered apply: route now, land at each shard store's
        next lookup boundary."""
        self._route_outputs(trunk, bits, prefetch_ids, staged=True)

    def flush_staged(self):
        for s, st in enumerate(self.stores):
            if self._injector is not None and not self._injector.up[s]:
                continue  # a dead shard's standby snapshot must not mutate
            st.flush_staged()

    def warmup(self, batch_hint: int):
        """Launch every shard store's kernels once at ``batch_hint`` rows
        (single-store API parity).  Alternatively pass ``warmup_batch=``
        at construction — it flows to every per-shard store."""
        for st in self.stores:
            st.warmup(batch_hint)

    # ---------------- aggregated accounting ----------------

    @property
    def capacity(self) -> int:
        return int(sum(st.capacity for st in self.stores))

    @property
    def stats(self) -> TierStats:
        agg = TierStats()
        for st in self.stores:
            agg.merge(st.stats)
        agg.batches = self.batches  # facade batches, not per-shard sum
        agg.modeled_fetch_s += self._fixed_fetch_s
        return agg

    def modeled_batch_ms(self) -> float:
        """Sum view (comparable to the single store / facade)."""
        return 1e3 * self.stats.modeled_fetch_s / max(self.batches, 1)

    def critical_batch_ms(self) -> float:
        """Parallel view: per batch, the slowest shard's fetch."""
        return 1e3 * self._critical_fetch_s / max(self.batches, 1)

    def load_imbalance(self) -> float:
        """Aggregate max-shard load / mean-shard load (1.0 = perfect)."""
        total = self._shard_lookups
        return float(total.max() / max(total.mean(), 1e-12))

    def shard_telemetry(self) -> dict:
        """Per-shard load / skew / stall plus engine counters."""
        fetch_s = self.stats.modeled_fetch_s
        d = {
            "n_shards": self.n_shards,
            "placement": self.plan.placement,
            "per_shard_rows": self.plan.shard_rows.tolist(),
            "per_shard_capacity": [int(st.capacity) for st in self.stores],
            "per_shard_lookups": self._shard_lookups.tolist(),
            "per_shard_hit_rate": [round(st.stats.hit_rate, 4)
                                   for st in self.stores],
            "per_shard_evictions": [st.stats.evictions
                                    for st in self.stores],
            "per_shard_fetch_ms": [round(st.stats.modeled_fetch_s * 1e3, 3)
                                   for st in self.stores],
            "load_imbalance": round(self.load_imbalance(), 4),
            "max_batch_imbalance": round(self._max_batch_imbalance, 4),
            "modeled_fetch_ms_sum": round(fetch_s * 1e3, 3),
            "modeled_fetch_ms_critical": round(
                self._critical_fetch_s * 1e3, 3),
            "parallel_fetch_speedup": round(
                fetch_s / max(self._critical_fetch_s, 1e-12), 3),
        }
        if self._engines is not None:
            for k in ("pf_submitted", "pf_deduped", "pf_cancelled_resident",
                      "pf_shard_down", "pf_issued", "pf_timely", "pf_late"):
                d[f"per_shard_{k}"] = [getattr(t, k)
                                       for t in self.engine_telemetry]
        if self._injector is not None:
            d["shard_up"] = self._injector.up.tolist()
            d["ft"] = self._ft.as_dict()
        return d

    def per_shard_hit_rates(self) -> List[float]:
        return [st.stats.hit_rate for st in self.stores]

    def publish_metrics(self, reg):
        """Publish the aggregate ``store.*`` view, every worker's
        ``shard.<i>.store.*`` / ``shard.<i>.rt.*`` namespaces, and the
        facade load/skew gauges — the layout
        :func:`repro_torch.obs.reconcile.check_sharded` reconciles
        (aggregate == sum of shards)."""
        self.stats.publish(reg, prefix="store")
        reg.gauge("sharded.n_shards").set(self.n_shards)
        reg.gauge("sharded.load_imbalance").set(self.load_imbalance())
        reg.gauge("sharded.max_batch_imbalance").set(
            self._max_batch_imbalance)
        reg.counter("sharded.critical_fetch_ms").inc(
            self._critical_fetch_s * 1e3)
        mean_load = max(float(self._shard_lookups.mean()), 1e-12)
        for s, st in enumerate(self.stores):
            st.stats.publish(reg, prefix=f"shard.{s}.store")
            reg.gauge(f"shard.{s}.imbalance").set(
                float(self._shard_lookups[s]) / mean_load)
            if self._engines is not None:
                self._engines[s].publish(reg, prefix=f"shard.{s}.rt")
        if self._ft is not None:
            # Fold any still-open downtime window into the per-shard
            # gauges without mutating the accumulated counters.
            saved = self._ft.down_us
            self._ft.down_us = saved + np.asarray(
                [self._injector.down_time_us(s, self.clock.now())
                 for s in range(self.n_shards)])
            self._ft.publish(reg)
            self._ft.down_us = saved
        return reg
