"""Drift detection + online adaptation for tiered serving.

Copied from ``src/repro/runtime/drift.py`` (NumPy and stdlib only): the
port imports nothing of the JAX package, so it keeps its own copy.

The RecMG models are trained offline and frozen; when the access
distribution moves (diurnal hot-set rotation, a flash crowd), their
outputs keep protecting and prefetching *stale* rows and the policy
decays toward (or below) LRU.  This module closes the loop:

* :class:`DriftDetector` — windowed telemetry over the live access
  stream: per-window hit rate against an EWMA baseline, and the Jaccard
  overlap between consecutive windows' hot sets.  Either signal crossing
  its threshold flags drift (hot-set Jaccard catches the *cause*, the
  hit-rate drop catches the *symptom* — a switch inside the buffer's
  capacity can move Jaccard without hurting hit rate yet, and vice
  versa).
* :class:`AdaptiveController` — owns a detector plus a ring of the most
  recent accesses; on a drift trigger it rebuilds the model-output
  *features* from that live window (the incremental refresh: the hot-id
  candidate pool and keep-priorities are re-derived online, exactly the
  inputs the offline models were approximating) and emits Algorithm-1
  items ``(trunk, bits, prefetch_ids)``: protect the currently-hot
  resident rows, prefetch the currently-hot non-resident ones.  Staging
  those through the normal model-output path re-ranks the buffer without
  touching residency invariants.

Wiring: the synchronous ``serve_trace`` loop calls
``controller.on_batch(ids, hits, b)`` after each batch and stages the
returned items; :class:`~repro_torch.runtime.pipeline.PipelinedRuntime` accepts
the same callable as its ``batch_hook`` and submits the items through the
prefetch engine — one controller, both serving paths.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.obs.tracing import get_tracer

_EMPTY = np.empty(0, np.int64)


@dataclass(frozen=True)
class DriftConfig:
    window: int = 4096        # accesses per telemetry window
    hot_k: int = 256          # hot-set size for the Jaccard signal
    jaccard_min: float = 0.35  # drift when overlap falls below this
    hitrate_drop: float = 0.12  # drift when window hit rate falls this far
    #                             below the EWMA baseline (absolute)
    ewma: float = 0.3         # baseline smoothing factor
    warmup_windows: int = 2   # closed windows before triggers may fire
    cooldown_windows: int = 1  # post-trigger windows with triggers held
    refresh_pf: int = 512     # max prefetch rows per adaptation refresh


class DriftDetector:
    """Windowed hit-rate + hot-set-Jaccard drift telemetry.

    Feed every served batch through :meth:`observe`; it returns ``True``
    exactly when an access window closes *and* flags drift.  All state is
    derived from the fed stream, so the detector is deterministic for a
    deterministic serving loop (golden-testable).
    """

    def __init__(self, cfg: Optional[DriftConfig] = None):
        self.cfg = cfg or DriftConfig()
        self._ids: List[np.ndarray] = []
        self._n = 0
        self._hits = 0
        self._prev_hot: Optional[np.ndarray] = None
        self._baseline: Optional[float] = None
        self._cooldown = 0
        # ---- telemetry counters ----
        self.accesses = 0
        self.windows = 0
        self.triggers = 0
        self.jaccard_triggers = 0
        self.hitrate_triggers = 0
        self.last_jaccard = 1.0
        self.min_jaccard = 1.0
        self.last_window_hit_rate = 0.0

    def observe(self, ids: np.ndarray, hits: int) -> bool:
        """Add one served batch (``ids`` accessed, ``hits`` of them served
        from the fast tier); returns True when a window closes with
        drift."""
        ids = np.asarray(ids, np.int64).ravel()
        self._ids.append(ids)
        self._n += ids.size
        self._hits += int(hits)
        self.accesses += ids.size
        if self._n < self.cfg.window:
            return False
        return self._close_window()

    def _hot_set(self, ids: np.ndarray) -> np.ndarray:
        from repro_torch.core.cache_sim import top_ids_by_count

        return np.sort(top_ids_by_count(ids, self.cfg.hot_k))

    def _close_window(self) -> bool:
        cfg = self.cfg
        ids = np.concatenate(self._ids)
        win_hr = self._hits / max(self._n, 1)
        hot = self._hot_set(ids)
        jac = 1.0
        if self._prev_hot is not None:
            inter = np.intersect1d(hot, self._prev_hot,
                                   assume_unique=True).size
            union = hot.size + self._prev_hot.size - inter
            jac = inter / max(union, 1)
        self.windows += 1
        self.last_jaccard = jac
        self.min_jaccard = min(self.min_jaccard, jac)
        self.last_window_hit_rate = win_hr

        fired = False
        armed = (self.windows > cfg.warmup_windows and self._cooldown == 0)
        if armed and self._prev_hot is not None and jac < cfg.jaccard_min:
            self.jaccard_triggers += 1
            fired = True
        if (armed and self._baseline is not None
                and win_hr < self._baseline - cfg.hitrate_drop):
            self.hitrate_triggers += 1
            fired = True
        if fired:
            self.triggers += 1
            tr = get_tracer()
            if tr.enabled:
                tr.add_instant("drift", "trigger", track="drift", args={
                    "window": self.windows, "jaccard": round(jac, 4),
                    "hit_rate": round(win_hr, 4)})
            self._cooldown = cfg.cooldown_windows
            # Adopt the post-drift regime as the new normal so a single
            # switch does not re-trigger every following window.
            self._baseline = win_hr
        else:
            if self._cooldown:
                self._cooldown -= 1
            self._baseline = (win_hr if self._baseline is None else
                              (1 - cfg.ewma) * self._baseline
                              + cfg.ewma * win_hr)
        self._prev_hot = hot
        self._ids, self._n, self._hits = [], 0, 0
        return fired

    def publish(self, reg, prefix: str = "drift"):
        """Publish into a :class:`repro_torch.obs.MetricsRegistry` under the
        ``drift.*`` namespace."""
        for key, val in (("accesses", self.accesses),
                         ("windows", self.windows),
                         ("triggers", self.triggers),
                         ("jaccard_triggers", self.jaccard_triggers),
                         ("hitrate_triggers", self.hitrate_triggers)):
            reg.counter(f"{prefix}.{key}").inc(val)
        reg.gauge(f"{prefix}.last_jaccard").set(self.last_jaccard)
        reg.gauge(f"{prefix}.min_jaccard").set(self.min_jaccard)
        reg.gauge(f"{prefix}.last_window_hit_rate").set(
            self.last_window_hit_rate)
        return reg

    def as_dict(self) -> dict:
        return {
            "accesses": self.accesses,
            "windows": self.windows,
            "triggers": self.triggers,
            "jaccard_triggers": self.jaccard_triggers,
            "hitrate_triggers": self.hitrate_triggers,
            "last_jaccard": round(self.last_jaccard, 4),
            "min_jaccard": round(self.min_jaccard, 4),
            "last_window_hit_rate": round(self.last_window_hit_rate, 4),
            "baseline_hit_rate": (None if self._baseline is None
                                  else round(self._baseline, 4)),
        }


class AdaptiveController:
    """Drift detector + live-window feature refresh for one store.

    ``on_batch(ids, hits, batch_index)`` is the single hook both serving
    paths call per batch; it returns ``(trunk, bits, prefetch_ids)``
    items to stage.  Until drift fires the list is empty — the offline
    model runs untouched.  The first trigger switches the controller into
    **online mode**, where the model's *features* are continuously
    refreshed from the live stream:

    * the hot-id pool (the feature the frozen model derived from its
      training window) is rebuilt from the last ``window`` accesses at
      the trigger and again at every later window close — incremental,
      one ``unique`` per window;
    * every batch, the just-accessed chunk is re-ranked against the live
      pool (keep-bit = pool membership).  Staged *after* the frozen
      model's items, these fresh ranks win, so stale demotions of
      newly-hot rows stop immediately;
    * hot non-resident rows are prefetched at each pool rebuild (bounded
      by ``refresh_pf``) over the background channel.

    A one-shot refresh is not enough: the frozen model keeps demoting the
    new regime's rows on every subsequent chunk, and would undo it within
    a window.
    """

    def __init__(self, store, capacity: int,
                 cfg: Optional[DriftConfig] = None):
        self.cfg = cfg or DriftConfig()
        self.detector = DriftDetector(self.cfg)
        self.store = store
        self.capacity = int(capacity)
        self._recent: List[np.ndarray] = []
        self._recent_n = 0
        self._pool: Optional[np.ndarray] = None  # sorted live hot ids
        self.refreshes = 0
        self.refresh_pf_rows = 0
        self.rerank_rows = 0

    def on_batch(self, ids: np.ndarray, hits: int,
                 batch_index: int = 0) -> List[Tuple]:
        ids = np.asarray(ids, np.int64).ravel()
        self._recent.append(ids)
        self._recent_n += ids.size
        while (len(self._recent) > 1
               and self._recent_n - self._recent[0].size >= self.cfg.window):
            self._recent_n -= self._recent[0].size
            self._recent.pop(0)
        windows_before = self.detector.windows
        fired = self.detector.observe(ids, hits)
        items: List[Tuple] = []
        if fired or (self._pool is not None
                     and self.detector.windows > windows_before):
            items.extend(self._refresh_pool())
        if self._pool is not None:
            items.append(self._rerank_chunk(ids))
        return items

    def recent_ids(self) -> np.ndarray:
        """The controller's live access window (most recent ~``window``
        accesses, oldest first) — the data an online fine-tune trains on
        (:class:`~repro_torch.core.model_runtime.LearnedController`)."""
        if not self._recent:
            return _EMPTY
        return np.concatenate(self._recent)

    def _refresh_pool(self) -> List[Tuple]:
        from repro_torch.core.cache_sim import top_ids_by_count

        tr = get_tracer()
        if tr.enabled:
            t0 = tr.clock.now()
        hot = top_ids_by_count(np.concatenate(self._recent), self.capacity)
        self._pool = np.sort(hot)
        # Truncate the bounded prefetch budget in HEAT order (``hot`` is
        # hottest-first) — spending it on the lowest ids instead would
        # leave the genuinely hottest rows on the on-demand path.
        pf = hot[~self.store.resident_mask(hot)][: self.cfg.refresh_pf]
        self.refreshes += 1
        self.refresh_pf_rows += int(pf.size)
        if tr.enabled:
            tr.add_span("drift", "refresh", t0, tr.clock.now() - t0,
                        track="drift",
                        args={"pool": int(hot.size), "pf_rows": int(pf.size)})
        return [(_EMPTY, _EMPTY, pf)] if pf.size else []

    def _rerank_chunk(self, ids: np.ndarray) -> Tuple:
        """Fresh keep-bits for the just-accessed chunk: membership of the
        live hot pool (the online stand-in for the caching model's
        inference on refreshed features)."""
        from repro_torch.core.cache_sim import isin_sorted

        uniq = np.unique(ids)
        bits = isin_sorted(self._pool, uniq).astype(np.int64)
        self.rerank_rows += uniq.size
        return (uniq, bits, _EMPTY)

    def as_dict(self) -> dict:
        d = self.detector.as_dict()
        d.update(refreshes=self.refreshes,
                 refresh_pf_rows=self.refresh_pf_rows,
                 rerank_rows=self.rerank_rows)
        return d

    def publish(self, reg, prefix: str = "drift"):
        """Detector counters plus the controller's refresh counters."""
        self.detector.publish(reg, prefix)
        for key, val in (("refreshes", self.refreshes),
                         ("refresh_pf_rows", self.refresh_pf_rows),
                         ("rerank_rows", self.rerank_rows)):
            reg.counter(f"{prefix}.{key}").inc(val)
        return reg


# The hook signature both serving paths use.
BatchHook = Callable[[np.ndarray, int, int], List[Tuple]]
