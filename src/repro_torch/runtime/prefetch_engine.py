"""Background prefetch engine: bounded work queue + worker that turns
prediction streams into batched ``populate`` traffic on a tiered store.

Ported from ``src/repro/runtime/prefetch_engine.py``; the queueing,
dedup, cancel, coalesce and timeliness logic is a copy.  What changed: the
thread scheduler's worker launches the store's kernels (the admit's
``quantize_scatter`` or row scatter) from a thread of its own, and
PyTorch's current CUDA device and stream are per thread.  So the worker
applies under the store's device and on the stream that was current on
the thread that built the engine (the one the lookups run on);
``engine.lock`` orders the two threads' launches on that stream.  An
error raised in the worker, a refused kernel launch included, surfaces at
the next :meth:`PrefetchEngine.drain` barrier.

Producers (the RecMG models via :class:`~repro_torch.core.recmg.RecMGOutputs`,
or any rule-based :class:`~repro_torch.core.prefetchers.Prefetcher` through
:func:`heuristic_prediction_stream`) submit work items — ``(trunk, bits,
prefetch_ids)`` triples in the store's public id space.  The engine

* **deduplicates in-flight keys**: a prefetch id already queued but not
  yet issued is dropped (the first issue will make it resident, the store
  would filter the duplicate anyway);
* **cancels before issue**: ids that became resident between submission
  and issue (demand-fetched first) are cancelled, and priority rankings
  for ids evicted before issue are dropped by the store's resident
  filter — both are counted in telemetry;
* **coalesces** consecutive prefetch-only items into one batched
  ``apply_model_outputs`` populate call (one fused admit + scatter
  instead of many small ones);
* models **timeliness** on a single background fetch channel: each issue
  costs ``fetch_us_fixed + fetch_us_per_row * rows`` of modeled time, and
  a later demand access is classified timely (completed before the
  demand) or late.

Two schedulers share the same apply path:

* ``"inline"`` — the caller *is* the worker: queued items are applied at
  explicit :meth:`drain` points (the serving pipeline drains before every
  lookup).  Fully deterministic; this is the mode the equivalence tests
  replay byte-for-byte against the synchronous path.
* ``"thread"`` — a daemon worker pulls from a bounded ``queue.Queue`` and
  applies under the shared store lock, overlapping wall-clock time with
  the caller.  Store state stays consistent (the lock), but apply timing
  relative to lookups is scheduler-dependent, so counters may differ
  from the synchronous replay.
"""
from __future__ import annotations

import contextlib
import queue
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs.tracing import get_tracer
from repro_torch.runtime.clock import Clock, VirtualClock
from repro_torch.runtime.telemetry import RuntimeTelemetry

_STOP = object()
_EMPTY = np.empty(0, np.int64)


def _device_context(store):
    """A factory of the context the thread worker applies under: the
    store's CUDA device and the stream current on the calling thread now,
    or no context for a store on the CPU (or one with no ``device``)."""
    dev = getattr(store, "device", None)
    if dev is None or torch.device(dev).type != "cuda":
        return contextlib.nullcontext
    stream = torch.cuda.current_stream(dev)

    def ctx():
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(dev))
        stack.enter_context(torch.cuda.stream(stream))
        return stack

    return ctx


@dataclass
class WorkItem:
    """One staged model-output application."""

    trunk: np.ndarray          # ids to (re-)rank with caching bits
    bits: np.ndarray           # keep/evict bits for ``trunk``
    prefetch: np.ndarray       # ids to populate into the fast tier
    submit_us: float = 0.0     # modeled submission time

    @property
    def prefetch_only(self) -> bool:
        return self.trunk.size == 0 and self.prefetch.size > 0


class PrefetchEngine:
    """Consume prediction streams, issue batched populates on ``store``.

    ``store`` is any object with the tiered-store co-management surface:
    ``apply_model_outputs(trunk, bits, prefetch_ids)`` and
    ``resident_mask(ids)`` (both :class:`TieredEmbeddingStore` and
    :class:`MultiTableTieredStore`).
    """

    def __init__(self, store, telemetry: Optional[RuntimeTelemetry] = None,
                 clock: Optional[Clock] = None, scheduler: str = "inline",
                 max_queue: int = 64, coalesce_rows: int = 4096,
                 fetch_us_per_row: float = 10.0, fetch_us_fixed: float = 30.0,
                 lock: Optional[threading.Lock] = None,
                 trace_track: str = "pf"):
        if scheduler not in ("inline", "thread"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        self.store = store
        # Each engine models its own fetch channel, so each needs its own
        # trace track — two engines sharing one track would interleave
        # non-monotone span ends.
        self.trace_track = trace_track
        self.telemetry = telemetry if telemetry is not None \
            else RuntimeTelemetry()
        self.clock = clock or VirtualClock()
        self.scheduler = scheduler
        self.coalesce_rows = int(coalesce_rows)
        self.fetch_us_per_row = float(fetch_us_per_row)
        self.fetch_us_fixed = float(fetch_us_fixed)
        self.lock = lock or threading.Lock()
        self._inflight: set = set()
        self._pf_eta: Dict[int, float] = {}   # key -> modeled completion us
        self._channel_free_us = 0.0           # background fetch channel
        self._backpressure = False            # admission-control signal
        self._down = False                    # target shard dead (failover)
        self._closed = False
        self._worker_exc = None               # thread-mode failure, if any
        if scheduler == "thread":
            self._device_ctx = _device_context(store)
            self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
            self._worker = threading.Thread(
                target=self._worker_loop, name="prefetch-engine", daemon=True)
            self._worker.start()
        else:
            self._q = None
            self._pending: List[WorkItem] = []
            self._max_pending = int(max_queue)

    # ---------------- producer side ----------------

    def submit(self, trunk, bits, prefetch_ids, now_us: Optional[float] = None):
        """Stage one model-output application (Algorithm 1 triple).

        Prefetch ids are deduplicated against the in-flight set and
        scheduled on the modeled background channel immediately — the
        worker would start fetching as soon as the prediction lands.
        """
        if self._closed:
            raise RuntimeError("engine is closed")
        now = self.clock.now() if now_us is None else float(now_us)
        trunk = np.asarray(trunk, np.int64).ravel()
        bits = np.asarray(bits).ravel()
        pf = np.asarray(prefetch_ids, np.int64).ravel()
        tel = self.telemetry
        tel.pf_submitted += int(pf.size)
        if self._down:
            # Target shard is dead (failover): nothing can be populated or
            # ranked there.  The whole item is cancelled with its own fate
            # (``pf.shard_down`` extends the submitted identity) rather
            # than raising into the serving path or vanishing uncounted.
            tel.pf_shard_down += int(pf.size)
            return
        if self._backpressure and pf.size:
            # Admission-control pressure: the serving queue is backed up,
            # so background prefetch traffic would only steal slow-tier
            # bandwidth from demand fetches.  Drop the prefetch ids (the
            # ranking trunk still applies — it is bookkeeping, not
            # traffic) and account them so the fate identity closes:
            # submitted == suppressed + deduped + cancelled + issued +
            # queued.
            tel.pf_suppressed += int(pf.size)
            pf = _EMPTY
        if pf.size:
            # In-flight dedup (first occurrence wins, within and across
            # queued items): the store would filter the duplicate against
            # residency at apply time anyway, so dropping it here is
            # behavior-preserving and saves queue/channel traffic.
            # Within-chunk duplicates collapse vectorially first, so the
            # locked set probe (coherent with the worker's _retire in
            # thread mode) only walks the unique ids.
            u, first = np.unique(pf, return_index=True)
            cand = pf[np.sort(first)] if u.size < pf.size else pf
            seen = self._inflight
            with self.lock:
                fresh = np.fromiter((k not in seen for k in cand.tolist()),
                                    bool, cand.size)
                keep = cand[fresh]
                seen.update(keep.tolist())
            tel.pf_deduped += int(pf.size) - int(keep.size)
            pf = keep
            self._schedule_channel(pf, now)
        item = WorkItem(trunk, bits, pf, submit_us=now)
        if self._q is not None:
            self._q.put(item)  # bounded: blocks when the worker lags
        else:
            self._pending.append(item)
            if len(self._pending) > self._max_pending:
                self.drain()  # inline backpressure: caller absorbs the work

    def _schedule_channel(self, pf: np.ndarray, now: float):
        """Model the background fetch: ids already resident at submission
        are cancelled (no traffic); the rest occupy the single channel."""
        if not pf.size:
            return
        with self.lock:  # the thread worker mutates residency under it
            fresh = pf[~self.store.resident_mask(pf)]
        if not fresh.size:
            return
        cost = self.fetch_us_fixed + self.fetch_us_per_row * fresh.size
        start = max(self._channel_free_us, now)
        self._channel_free_us = start + cost
        tel = self.telemetry
        tel.pf_fetch_ms += cost * 1e-3
        tel.pf_channel_scheduled += int(fresh.size)
        done = self._channel_free_us
        tr = get_tracer()
        if tr.enabled:
            # Modeled background-channel occupancy [start, start+cost).
            tr.add_span("pf", "channel", start, cost,
                        track=self.trace_track,
                        args={"rows": int(fresh.size)})
        eta = self._pf_eta
        for k in fresh.tolist():
            # Overwrite: a key can only be rescheduled after its previous
            # issue retired (in-flight dedup), i.e. this is a genuinely
            # new fetch — keeping the old ETA would fake timeliness.  The
            # lost ETA is counted so the timeliness identity still closes
            # (channel_scheduled == timely+late+unused+overwritten+pending).
            if k in eta:
                tel.pf_eta_overwritten += 1
            eta[k] = done

    # ---------------- worker side ----------------

    def drain(self):
        """Apply everything queued.  Inline: synchronously, in submission
        order (the deterministic drain point).  Thread: block until the
        worker has emptied the queue (flush barrier)."""
        if self._q is not None:
            self._q.join()
            if self._worker_exc is not None:
                exc, self._worker_exc = self._worker_exc, None
                raise RuntimeError("prefetch worker failed") from exc
            return
        items, self._pending = self._pending, []
        if items:
            with self.lock:
                self._apply(items)

    def _worker_loop(self):
        while True:
            item = self._q.get()
            stop = item is _STOP
            batch = [] if stop else [item]
            # Opportunistically pull whatever else is queued so adjacent
            # prefetch items coalesce into one populate call.
            while not stop:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                else:
                    batch.append(nxt)
            try:
                if batch and self._worker_exc is None:
                    with self._device_ctx(), self.lock:
                        self._apply(batch)
            except BaseException as exc:  # surfaced at the next barrier
                self._worker_exc = exc
            finally:
                # task_done() for every get() — even on error or shutdown —
                # so drain()/close() barriers on q.join() never hang.
                for _ in range(len(batch) + stop):
                    self._q.task_done()
            if stop:
                return

    def _apply(self, items: List[WorkItem]):
        """Apply work items in order, coalescing consecutive
        prefetch-only items into one batched populate call."""
        tel = self.telemetry
        i = 0
        while i < len(items):
            it = items[i]
            if it.prefetch_only:
                pf = [it.prefetch]
                rows = it.prefetch.size
                j = i + 1
                while (j < len(items) and items[j].prefetch_only
                       and rows + items[j].prefetch.size
                       <= self.coalesce_rows):
                    pf.append(items[j].prefetch)
                    rows += items[j].prefetch.size
                    j += 1
                self._issue(np.concatenate(pf), coalesced=j - i)
                i = j
            else:
                if it.trunk.size:
                    # The store drops rankings for ids evicted before
                    # issue; count them so Fig. 14 attribution can see
                    # how stale the pipelined stream ran.
                    n_evicted = int(np.count_nonzero(
                        ~self.store.resident_mask(it.trunk)))
                    tel.rank_cancelled_evicted += n_evicted
                if it.prefetch.size:  # mixed rank+prefetch item
                    fresh = int(np.count_nonzero(
                        ~self.store.resident_mask(it.prefetch)))
                    tel.pf_cancelled_resident += it.prefetch.size - fresh
                    tel.pf_issued += fresh
                    tel.pf_populate_calls += bool(fresh)
                self.store.apply_model_outputs(it.trunk, it.bits, it.prefetch)
                self._retire(it.prefetch)
                i += 1

    def _issue(self, pf: np.ndarray, coalesced: int):
        """One batched populate: cancel ids that became resident before
        issue, then hand the rest to the store in one call."""
        tel = self.telemetry
        resident = self.store.resident_mask(pf)
        tel.pf_cancelled_resident += int(np.count_nonzero(resident))
        fresh = pf[~resident]
        if fresh.size:
            self.store.apply_model_outputs(_EMPTY, _EMPTY, fresh)
            tel.pf_issued += int(fresh.size)
            tel.pf_populate_calls += 1
        self._retire(pf)

    def _retire(self, pf: np.ndarray):
        # Callers hold self.lock (worker loop / inline drain), pairing
        # with the locked dedup in submit().
        self._inflight.difference_update(np.asarray(pf).tolist())

    # ---------------- demand-side hooks ----------------

    def set_down(self, down: bool):
        """Shard health signal from the failover layer.

        Going down cancels every in-flight work item for the dead shard —
        queued prefetch rows take the distinct ``pf.shard_down`` fate
        (extending the submitted identity) and undemanded channel ETAs
        fold into ``pf.unused`` — so a drain-after-kill is a safe no-op
        instead of a populate call on a dead store.  While down, newly
        submitted items are cancelled the same way at submit time.  Going
        back up re-opens submission; recovery repopulation then arrives
        as ordinary submit traffic.
        """
        down = bool(down)
        if down and not self._down:
            self._cancel_inflight()
        self._down = down

    def _cancel_inflight(self):
        tel = self.telemetry
        if self._q is not None:
            self.drain()  # thread mode: barrier — applied work stands
        else:
            items, self._pending = self._pending, []
            for it in items:
                tel.pf_shard_down += int(it.prefetch.size)
        with self.lock:
            self._inflight.clear()
        tel.pf_unused += len(self._pf_eta)
        self._pf_eta.clear()

    def set_backpressure(self, on: bool):
        """Admission-control signal: while on, newly submitted prefetch
        ids are suppressed (counted in ``pf_suppressed``) instead of
        scheduled — graceful degradation keeps the modeled slow-tier
        channel free for demand traffic under overload."""
        self._backpressure = bool(on)

    def observe_demand(self, uniq_ids: np.ndarray, now_us: float):
        """Classify prefetch timeliness for a demand batch starting at
        ``now_us``: a previously prefetched id whose modeled fetch
        completed by now was timely; one still in flight was late."""
        if not self._pf_eta:
            return
        tel = self.telemetry
        n_timely = n_late = 0
        for k in np.asarray(uniq_ids).ravel().tolist():
            eta = self._pf_eta.pop(k, None)
            if eta is None:
                continue
            if eta <= now_us:
                tel.pf_timely += 1
                n_timely += 1
            else:
                tel.pf_late += 1
                n_late += 1
                tel.pf_late_ms += (eta - now_us) * 1e-3
        if n_timely or n_late:
            tr = get_tracer()
            if tr.enabled:
                tr.add_instant("pf", "demand", ts=now_us,
                               track=self.trace_track,
                               args={"timely": n_timely, "late": n_late})
    def publish(self, reg, prefix: str = "rt"):
        """Publish the engine's telemetry plus its live-state gauges into a
        :class:`repro_torch.obs.MetricsRegistry`.  The gauges close the fate
        identities mid-run: ``pf.queued`` (submitted rows still staged,
        zero after a drain) and ``pf.eta_pending`` (channel fetches not
        yet demanded — becomes ``pf.unused`` at close)."""
        self.telemetry.publish(reg, prefix)
        if self._q is None:
            queued = sum(int(it.prefetch.size) for it in self._pending)
        else:  # thread mode: publish after a drain/close barrier
            queued = 0
        reg.gauge(f"{prefix}.pf.queued").set(queued)
        reg.gauge(f"{prefix}.pf.eta_pending").set(len(self._pf_eta))
        return reg

    # ---------------- lifecycle ----------------

    def close(self):
        """Flush and stop the worker; count never-demanded prefetches."""
        if self._closed:
            return
        try:
            self.drain()
        finally:
            if self._q is not None:
                self._q.put(_STOP)
                self._worker.join(timeout=5.0)
            self.telemetry.pf_unused += len(self._pf_eta)
            self._pf_eta.clear()
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def heuristic_prediction_stream(keys: np.ndarray, prefetcher, chunk: int = 15,
                                max_per_chunk: int = 5,
                                sim_capacity: int = 4096):
    """Run a rule-based :class:`~repro_torch.core.prefetchers.Prefetcher` over a
    trace and package its issues as a :class:`~repro_torch.core.recmg.RecMGOutputs`
    stream (chunk boundaries every ``chunk`` accesses, like the models) so
    the engine can serve heuristic predictions with no training step.

    A small LRU shadow cache (``sim_capacity`` rows, prefetch-inserted)
    supplies the ``hit`` feedback signal — adaptive prefetchers like the
    MAB coordinator need a real reward, not a constant.
    """
    from repro_torch.core.cache_sim import FALRU
    from repro_torch.core.recmg import RecMGOutputs

    keys = np.asarray(keys, np.int64).ravel()
    n = int(keys.max()) + 1 if keys.size else 0
    shadow = FALRU(sim_capacity)
    starts = np.arange(chunk, len(keys), chunk, dtype=np.int64)
    pf = np.empty(len(starts), object)  # ragged: one id array per chunk
    lo = 0
    for ci, s in enumerate(starts.tolist()):
        issued: List[int] = []
        for k in keys[lo:s].tolist():
            preds = prefetcher.on_access(k, shadow.access(k))
            for p in preds:
                if 0 <= p < n:  # clip out-of-table offsets
                    issued.append(p)
                    if not shadow.contains(p):
                        shadow.insert_prefetch(p)
        lo = s
        pf[ci] = np.asarray(issued[-max_per_chunk:], np.int64)
    return RecMGOutputs(starts, None, pf)
