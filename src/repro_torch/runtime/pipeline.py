"""Micro-batching request pipeline with a double-buffered fetch/compute
timeline.

Ported from ``src/repro/runtime/pipeline.py``; the batcher, the admission
dispatch and the modeled timeline are a copy.  What changed: a batch with
over-deadline requests is assembled on the device.  The degraded rows are
read by the store's own fused gather kernel
(:meth:`~repro_torch.core.tiered.TieredEmbeddingStore.
lookup_resident_device`, under ``engine.lock`` like the lookup), and the
live and degraded rows are put in request order by one device-side
concatenation; nothing goes through the host.

Requests (one query's embedding ids each) enter an **admission queue**;
a size/deadline **micro-batcher** closes a batch when ``max_batch``
requests are waiting or the oldest has waited ``deadline_us``.  Batches
then flow through a two-stage pipeline modeled on the paper's deployment
(Fig. 6): the *host* stage drains staged model outputs, runs the tiered
lookup and pays the slow-tier on-demand fetch; the *device* stage runs the
dense forward.  With ``pipeline_depth >= 2`` the host may run ahead of the
device, so batch *k*'s slow-tier fetch overlaps batch *k-1*'s dense
forward — the fetch only **stalls** the device for the part that outlasts
the overlap window:

    host_start[k]   = max(host_free, close[k], compute_done[k - depth])
    fetch_done[k]   = host_start[k] + fetch_us[k]
    compute_start[k]= max(fetch_done[k], compute_done[k-1])
    stall[k]        = max(0, fetch_done[k] - max(compute_done[k-1],
                                                 host_start[k]))

``pipeline_depth=1`` degenerates to the synchronous runtime
(``stall == demand fetch``, exactly the store's ``modeled_fetch_s``).

Determinism contract: with the inline scheduler and a
:class:`~repro_torch.runtime.clock.VirtualClock`, the store sees *exactly* the
same sequence of drains, lookups and model-output applications as the
synchronous serving loop — hit/miss/eviction counters reproduce
byte-for-byte — while the timeline above moves fetch time off the modeled
critical path.  Only the accounting changes, never the residency math.
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs.tracing import get_tracer
from repro_torch.runtime.admission import (AdmissionConfig, AdmissionQueue,
                                           AdmissionStats)
from repro_torch.runtime.clock import Clock, VirtualClock
from repro_torch.runtime.prefetch_engine import PrefetchEngine
from repro_torch.runtime.telemetry import RuntimeTelemetry


@dataclass
class Request:
    """One inference query's embedding-id vector.

    ``priority`` / ``deadline_us`` only matter on the admission-control
    path (``RuntimeConfig.admission``): class index 0 is the most
    important, and the deadline is *absolute* modeled time (arrival plus
    the class latency budget).  The defaults keep the plain micro-batched
    path byte-identical to before."""

    rid: int
    ids: np.ndarray
    arrival_us: float = 0.0
    priority: int = 0
    deadline_us: float = float("inf")


@dataclass
class RuntimeConfig:
    max_batch: int = 32              # micro-batcher size trigger (queries)
    deadline_us: float = float("inf")  # micro-batcher age trigger
    pipeline_depth: int = 2          # host may run this many batches ahead
    interarrival_us: float = 0.0     # >0: open-loop arrivals at this rate
    fetch_us_per_row: float = 10.0   # slow-tier cost model (matches store)
    fetch_us_fixed: float = 30.0
    compute_us: Optional[float] = None  # None: use measured compute
    scheduler: str = "inline"        # "inline" (deterministic) | "thread"
    max_queue: int = 64              # prefetch work-queue bound
    coalesce_rows: int = 4096        # populate coalescing cap
    admission: Optional[AdmissionConfig] = None  # overload-control path

    def __post_init__(self):
        if self.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        # NaN comparisons are all False, so a NaN deadline would make
        # MicroBatcher.ready() silently never fire — reject it here with
        # the other nonsensical timing values.  inf deadline (size-only
        # batching) stays legal.
        if math.isnan(self.deadline_us) or self.deadline_us < 0:
            raise ValueError(
                f"deadline_us must be >= 0 (inf ok), got {self.deadline_us}")
        if math.isnan(self.interarrival_us) or self.interarrival_us < 0 \
                or math.isinf(self.interarrival_us):
            raise ValueError("interarrival_us must be finite and >= 0, "
                             f"got {self.interarrival_us}")


class MicroBatcher:
    """Size/deadline micro-batcher over an admission queue."""

    def __init__(self, max_batch: int, deadline_us: float = float("inf")):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        deadline_us = float(deadline_us)
        if math.isnan(deadline_us) or deadline_us < 0:
            raise ValueError(
                f"deadline_us must be >= 0 (inf ok), got {deadline_us}")
        self.max_batch = int(max_batch)
        self.deadline_us = deadline_us
        self._queue: List[Request] = []

    def __len__(self):
        return len(self._queue)

    @property
    def oldest_arrival_us(self) -> float:
        return self._queue[0].arrival_us if self._queue else float("inf")

    def push(self, req: Request):
        self._queue.append(req)

    def ready(self, now_us: float) -> bool:
        """A batch should close: full, or the oldest request timed out."""
        if len(self._queue) >= self.max_batch:
            return True
        return bool(self._queue) and \
            now_us - self.oldest_arrival_us >= self.deadline_us

    def pop(self) -> Tuple[List[Request], float]:
        """Close one batch; returns (requests, close time).  A full batch
        closes when its last member arrived; a deadline batch when the
        oldest request's patience ran out.  With ``deadline_us=inf`` a
        partial batch can only be popped by an explicit caller decision,
        so its close time clamps to the last arrival — an infinite close
        time would poison every latency percentile downstream."""
        take, self._queue = (self._queue[: self.max_batch],
                             self._queue[self.max_batch:])
        if not take:
            raise ValueError("pop on empty micro-batcher queue")
        last_arrival = max(r.arrival_us for r in take)
        if len(take) == self.max_batch:
            close = last_arrival
        else:
            close = take[0].arrival_us + self.deadline_us
            if not math.isfinite(close):
                close = last_arrival
        return take, close

    def flush(self, now_us: float = 0.0) -> Tuple[List[Request], float]:
        """End-of-stream: close whatever is waiting at its last arrival.
        An empty queue flushes to ``([], now_us)`` instead of raising —
        overload runs legitimately drain to empty before end-of-stream."""
        take, self._queue = self._queue[: self.max_batch], \
            self._queue[self.max_batch:]
        if not take:
            return [], float(now_us)
        return take, max(r.arrival_us for r in take)


class PipelinedRuntime:
    """Asynchronous pipelined serving runtime over a tiered store.

    Drives ``store.lookup`` through the micro-batcher and the modeled
    double-buffered timeline, with the :class:`PrefetchEngine` applying
    staged model outputs at deterministic drain points (inline scheduler)
    or on the background worker (thread scheduler).
    """

    def __init__(self, store, cfg: Optional[RuntimeConfig] = None,
                 clock: Optional[Clock] = None, batch_hook=None):
        """``batch_hook(ids, hits, batch_index) -> [(trunk, bits,
        prefetch_ids), ...]`` is called once per processed batch with the
        batch's ids and its fast-tier hit count; returned items are
        submitted through the prefetch engine like staged model outputs.
        The drift-adaptive serving path passes
        :meth:`~repro_torch.runtime.drift.AdaptiveController.on_batch` here."""
        self.store = store
        self.cfg = cfg or RuntimeConfig()
        self.clock = clock or VirtualClock()
        self._batch_hook = batch_hook
        self.telemetry = RuntimeTelemetry()
        self.engine = PrefetchEngine(
            store, telemetry=self.telemetry, clock=self.clock,
            scheduler=self.cfg.scheduler, max_queue=self.cfg.max_queue,
            coalesce_rows=self.cfg.coalesce_rows,
            fetch_us_per_row=self.cfg.fetch_us_per_row,
            fetch_us_fixed=self.cfg.fetch_us_fixed)
        self.batcher = MicroBatcher(self.cfg.max_batch, self.cfg.deadline_us)
        # ---- admission-control state (None on the plain path) ----
        self.admission_stats: Optional[AdmissionStats] = None
        self._adm_queue: Optional[AdmissionQueue] = None
        self._bp_on = False
        if self.cfg.admission is not None:
            self.admission_stats = AdmissionStats(
                n_classes=self.cfg.admission.n_classes)
            self._adm_queue = AdmissionQueue(self.cfg.admission,
                                             self.admission_stats)
        # ---- modeled timeline state ----
        self._host_free_us = 0.0
        self._compute_done_us: List[float] = []   # per finished batch
        self._batch_index = 0
        self._next_rid = 0
        self.wall_batch_s: List[float] = []       # measured, per batch

    # ---------------- request admission ----------------

    def _arrival(self) -> float:
        if self.cfg.interarrival_us > 0:
            return self._next_rid * self.cfg.interarrival_us
        return 0.0  # closed loop: latency measured from admission

    def _make_request(self, ids: np.ndarray, priority: int = 0) -> Request:
        arrival = self._arrival()
        deadline = float("inf")
        if self.cfg.admission is not None:
            deadline = self.cfg.admission.deadline_for(priority, arrival)
        req = Request(self._next_rid, np.asarray(ids, np.int64).ravel(),
                      arrival, priority=priority, deadline_us=deadline)
        self._next_rid += 1
        return req

    def submit(self, ids: np.ndarray, priority: int = 0) -> Request:
        req = self._make_request(ids, priority)
        self.batcher.push(req)
        return req

    # ---------------- pipeline core ----------------

    def run(self, id_stream: Iterable[np.ndarray],
            step_fn: Callable[[int, object], Tuple[float, List[tuple]]]):
        """Serve a stream of per-query id vectors end to end.

        ``step_fn(batch_index, embeddings) -> (compute_seconds, staged)``
        runs the dense forward for one closed batch and returns its
        measured compute time plus the list of ``(trunk, bits,
        prefetch_ids)`` model outputs to stage for later batches.

        With ``cfg.admission`` set, stream items may also be
        ``(ids, priority)`` pairs and dispatch goes through the bounded
        EDF admission queue (:meth:`_run_admission`) instead of the
        FIFO micro-batcher; the plain path below is byte-identical to
        the pre-admission runtime.
        """
        if self.cfg.admission is not None:
            return self._run_admission(id_stream, step_fn)
        for ids in id_stream:
            arrival = self._arrival()
            # A waiting partial batch whose deadline expires before this
            # request arrives must close without it.
            while self.batcher.ready(arrival):
                reqs, close = self.batcher.pop()
                self._process(reqs, close, step_fn)
            self.submit(ids)
            while len(self.batcher) >= self.batcher.max_batch:
                reqs, close = self.batcher.pop()
                self._process(reqs, close, step_fn)
        while len(self.batcher):
            reqs, close = self.batcher.flush()
            self._process(reqs, close, step_fn)
        self.engine.close()
        return self.telemetry

    # ---------------- admission-control dispatch ----------------

    def _server_free_us(self) -> float:
        """Earliest modeled time the host can start the next batch (the
        same lower bound :meth:`_process` computes as ``max(host_free,
        gate)`` — close time is then the dispatch decision on top)."""
        b, done = self._batch_index, self._compute_done_us
        gate = done[b - self.cfg.pipeline_depth] \
            if b >= self.cfg.pipeline_depth else 0.0
        return max(self._host_free_us, gate)

    def _update_backpressure(self):
        """Queue-occupancy hysteresis driving the prefetch engine's
        issue-suppression signal (on above hi, off below lo — no
        flapping when occupancy hovers at one threshold)."""
        adm = self.cfg.admission
        occ = self._adm_queue.occupancy
        if not self._bp_on and occ >= adm.backpressure_hi:
            self._bp_on = True
            self.engine.set_backpressure(True)
        elif self._bp_on and occ <= adm.backpressure_lo:
            self._bp_on = False
            self.engine.set_backpressure(False)

    def _run_admission(self, id_stream, step_fn):
        """Overload-aware dispatch: arrivals flow through the bounded
        :class:`AdmissionQueue`; whenever the modeled server is free and
        work is queued, a batch closes in EDF order.  The server is
        work-conserving — under light load batches run partial, under
        overload the queue saturates, excess is shed lowest-priority-
        first, and over-deadline requests take the degraded path inside
        :meth:`_process`.  Fully deterministic on the VirtualClock."""
        aq, cfg = self._adm_queue, self.cfg
        pending = deque()
        for item in id_stream:
            if isinstance(item, tuple):
                ids, pri = item
            else:
                ids, pri = item, 0
            pending.append(self._make_request(ids, int(pri)))
        while pending or len(aq):
            t_free = self._server_free_us()
            # Admit everything that arrived while the server was busy, in
            # arrival order — shedding decisions happen at arrival time.
            while pending and pending[0].arrival_us <= t_free:
                aq.offer(pending.popleft())
                self._update_backpressure()
            if not len(aq):
                # Idle server: wait for (and admit) the next arrival.
                aq.offer(pending.popleft())
                self._update_backpressure()
                continue
            reqs = aq.pop(cfg.max_batch)
            self._update_backpressure()
            close = max(t_free, max(r.arrival_us for r in reqs))
            self._process(reqs, close, step_fn)
        self.engine.close()
        self.admission_stats.check()
        return self.telemetry

    def _split_degraded(self, reqs: List[Request], host_start: float):
        """Partition a closing batch into live requests (full-quality
        lookup) and over-deadline requests (degraded answer)."""
        adm = self.cfg.admission
        if adm is None or not adm.degrade:
            return reqs, []
        live = [r for r in reqs if r.deadline_us >= host_start]
        deg = [r for r in reqs if r.deadline_us < host_start]
        return live, deg

    def _assemble_degraded(self, reqs, live, degraded, emb_live):
        """Reassemble a batch's embedding matrix in request order when
        some requests took the degraded path: live rows come from the
        full lookup, degraded rows from residency-only reads (stale rows
        for what happens to be in the fast tier, a zero default row per
        slow-tier miss) — the answer always has the full batch shape.
        Both stay on the store's device: one read by the store's gather
        kernel, one concatenation."""
        deg_ids = np.concatenate([r.ids for r in degraded])
        with self.engine.lock:
            deg_rows, n_default = self.store.lookup_resident_device(deg_ids)
        st = self.admission_stats
        st.degraded_rows_default += n_default
        st.degraded_rows_stale += int(deg_ids.size) - n_default
        deg_set = {r.rid for r in degraded}
        parts, li, di = [], 0, 0
        for r in reqs:
            n = int(r.ids.size)
            if r.rid in deg_set:
                parts.append(deg_rows[di: di + n])
                di += n
            else:
                parts.append(emb_live[li: li + n])
                li += n
        return torch.cat(parts)

    def _process(self, reqs: List[Request], close_us: float, step_fn):
        cfg, tel = self.cfg, self.telemetry
        b = self._batch_index
        tr = get_tracer()
        if tr.enabled:
            tr.set_batch(b)  # correlates store/pf/rt events for this batch
        done = self._compute_done_us
        prev_done = done[-1] if done else 0.0
        # Back-pressure: at depth d the host may only run while batch
        # b-d's output buffer has been consumed (double buffering at d=2).
        gate = done[b - cfg.pipeline_depth] if b >= cfg.pipeline_depth \
            else 0.0
        host_start = max(self._host_free_us, close_us, gate)

        ids = np.concatenate([r.ids for r in reqs])
        live, degraded = self._split_degraded(reqs, host_start)
        live_ids = np.concatenate([r.ids for r in live]) if live \
            else np.empty(0, np.int64)
        if live:
            self.engine.observe_demand(np.unique(live_ids), host_start)
        if cfg.scheduler == "inline":
            self.engine.drain()  # the deterministic pre-lookup drain point
        pre_fetch_s = self.store.stats.modeled_fetch_s
        pre_hits = self.store.stats.hits
        # Wall timing covers lookup + the reported forward time only, so
        # the measured window matches the synchronous loop, which stages,
        # packages and flushes model outputs outside its timed window.
        lookup_wall_s = 0.0
        emb = None
        if live:
            t_wall = time.perf_counter()
            with self.engine.lock:
                emb = self.store.lookup(live_ids)
            lookup_wall_s = time.perf_counter() - t_wall
        fetch_us = (self.store.stats.modeled_fetch_s - pre_fetch_s) * 1e6
        if degraded:
            emb = self._assemble_degraded(reqs, live, degraded, emb)

        fetch_done = host_start + fetch_us
        stall = max(0.0, fetch_done - max(prev_done, host_start))
        compute_start = max(fetch_done, prev_done)

        compute_s, staged = step_fn(b, emb)
        compute_us = cfg.compute_us if cfg.compute_us is not None \
            else compute_s * 1e6
        compute_done = compute_start + compute_us
        self.wall_batch_s.append(lookup_wall_s + compute_s)
        if tr.enabled:
            # Modeled-timeline lanes, fully explicit timestamps: the host
            # lane carries the on-demand fetch window, the device lane the
            # stall (the part of the fetch the overlap could not hide)
            # followed by the dense forward.
            rid0 = reqs[0].rid
            tr.add_span("rt", "fetch", host_start, fetch_us, track="host",
                        args={"rid0": rid0, "n_req": len(reqs)})
            if stall > 0.0:
                tr.add_span("rt", "stall", max(prev_done, host_start),
                            stall, track="device", args={"rid0": rid0})
            tr.add_span("rt", "compute", compute_start, compute_us,
                        track="device",
                        args={"rid0": rid0, "n_req": len(reqs)})

        # ---- bookkeeping ----
        if self.admission_stats is not None:
            st = self.admission_stats
            for r in live:
                st.served[r.priority] += 1
            for r in degraded:
                st.degraded[r.priority] += 1
        tel.batches += 1
        tel.requests += len(reqs)
        tel.demand_fetch_ms += fetch_us * 1e-3
        tel.stall_ms += stall * 1e-3
        tel.compute_ms += compute_us * 1e-3
        for r in reqs:
            arrive = r.arrival_us if cfg.interarrival_us > 0 else host_start
            tel.latencies_us.append(compute_done - arrive)
        self._host_free_us = fetch_done
        done.append(compute_done)
        self._batch_index = b + 1
        if hasattr(self.clock, "advance_to"):
            self.clock.advance_to(compute_done)
        # Stage the model outputs this batch produced (the CPU models run
        # pipelined during the batch; their outputs land afterwards).
        for trunk, bits, pf in staged:
            self.engine.submit(trunk, bits, pf, now_us=compute_done)
        # Drift-adaptation hook: refresh items land after the model's, so
        # fresh re-ranks override stale ones at the next drain.
        if self._batch_hook is not None:
            hits = self.store.stats.hits - pre_hits
            for trunk, bits, pf in self._batch_hook(ids, hits, b) or ():
                self.engine.submit(trunk, bits, pf, now_us=compute_done)

    # ---------------- results ----------------

    def results(self) -> dict:
        d = self.telemetry.as_dict()
        if self.admission_stats is not None:
            d["admission"] = self.admission_stats.as_dict(self.cfg.admission)
        return d

    def publish(self, reg, prefix: str = "rt"):
        """Publish runtime telemetry + engine live-state gauges into a
        :class:`repro_torch.obs.MetricsRegistry` (the engine shares this
        runtime's telemetry object, so one call covers both).  With
        admission control active the ``adm.*`` namespace rides along."""
        self.engine.publish(reg, prefix)
        if self.admission_stats is not None:
            self.admission_stats.publish(reg, prefix="adm",
                                         cfg=self.cfg.admission)
        return reg
