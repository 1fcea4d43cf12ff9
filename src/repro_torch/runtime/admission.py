"""SLO-aware admission control for the pipelined serving runtime.

Copied from ``src/repro/runtime/admission.py`` (NumPy and stdlib only): the
port imports nothing of the JAX package, so it keeps its own copy.

Production DLRM serving (SDM, PAPERS.md) is governed by tail-latency
SLOs, and the defining regime of a millions-of-users service is offered
load **exceeding** capacity.  This module adds the overload vocabulary
the `MicroBatcher` lacks:

* **Priority classes** (:data:`PRIORITY_CLASSES`): every request carries
  a class index — 0 is the most important — and a per-class latency
  budget that turns its arrival time into an absolute deadline.
* **EDF batch scheduling**: :meth:`AdmissionQueue.pop` closes batches in
  earliest-deadline-first order (ties broken by arrival, then request
  id) instead of the batcher's FIFO order, so urgent work jumps the
  queue deterministically.
* **Bounded queue with exact shed accounting**: when the queue is at
  ``queue_bound``, :meth:`AdmissionQueue.offer` sheds **lowest-priority-
  first** — an important arrival displaces the least important queued
  request; an unimportant arrival is turned away at the door.  Every
  shed is counted per class.
* **Graceful degradation**: requests already past their deadline when a
  batch starts service are answered from fast-tier residency only
  (:meth:`~repro_torch.core.tiered.TieredEmbeddingStore.lookup_resident` —
  stale-but-resident rows plus a zero default row, never a wrong-shape
  answer) and counted as *degraded*, keeping the slow tier off their
  critical path.  Queue pressure also raises a **backpressure** signal
  that makes the :class:`~repro_torch.runtime.prefetch_engine.PrefetchEngine`
  skip prefetch issue until the queue drains (hysteresis, so the signal
  does not flap batch to batch).

Everything runs on the deterministic VirtualClock timeline, so every
overload scenario replays byte-for-byte, and the accounting closes
exactly::

    admitted == served + shed + degraded          (per class and total)

— reconciled by :func:`repro_torch.obs.reconcile.check_admission` under the
``adm.*`` metrics namespace.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# Class index 0 is the most important.  The names are labels for metrics
# and CLI mixes; the scheduler only ever sees the index.
PRIORITY_CLASSES: Tuple[str, ...] = ("gold", "silver", "bronze")

# Default per-class latency budgets (modeled us): interactive gold
# traffic, near-line silver, batch-ish bronze.
DEFAULT_CLASS_DEADLINE_US: Tuple[float, ...] = (50_000.0, 200_000.0,
                                                1_000_000.0)


def _finite_nonneg(name: str, v: float, allow_inf: bool = False) -> float:
    v = float(v)
    if math.isnan(v) or v < 0 or (not allow_inf and math.isinf(v)):
        raise ValueError(f"{name} must be a finite non-negative number, "
                         f"got {v!r}")
    return v


@dataclass(frozen=True)
class AdmissionConfig:
    """Overload-behavior knobs for :class:`PipelinedRuntime`."""

    queue_bound: int = 256            # max queued requests before shedding
    class_deadline_us: Tuple[float, ...] = DEFAULT_CLASS_DEADLINE_US
    degrade: bool = True              # serve stale/default past deadline
    # Backpressure hysteresis, as fractions of queue_bound: the prefetch
    # engine stops issuing above ``hi`` occupancy and resumes below ``lo``.
    backpressure_hi: float = 0.75
    backpressure_lo: float = 0.50

    def __post_init__(self):
        if int(self.queue_bound) < 1:
            raise ValueError("queue_bound must be >= 1")
        object.__setattr__(self, "queue_bound", int(self.queue_bound))
        dl = tuple(_finite_nonneg("class_deadline_us", d, allow_inf=True)
                   for d in self.class_deadline_us)
        if not dl:
            raise ValueError("class_deadline_us must name >= 1 class")
        object.__setattr__(self, "class_deadline_us", dl)
        hi = _finite_nonneg("backpressure_hi", self.backpressure_hi)
        lo = _finite_nonneg("backpressure_lo", self.backpressure_lo)
        if not (0.0 <= lo <= hi <= 1.0):
            raise ValueError("need 0 <= backpressure_lo <= backpressure_hi"
                             f" <= 1, got lo={lo} hi={hi}")

    @property
    def n_classes(self) -> int:
        return len(self.class_deadline_us)

    def class_name(self, pri: int) -> str:
        if pri < len(PRIORITY_CLASSES):
            return PRIORITY_CLASSES[pri]
        return f"class{pri}"

    def deadline_for(self, pri: int, arrival_us: float) -> float:
        """Absolute deadline for a class-``pri`` request arriving now."""
        if not 0 <= pri < self.n_classes:
            raise ValueError(f"priority {pri} out of range "
                             f"[0, {self.n_classes})")
        return arrival_us + self.class_deadline_us[pri]


@dataclass
class AdmissionStats:
    """Per-class request-fate counters.  Every offered request lands in
    exactly one of served / shed / degraded, so the identity
    ``admitted == served + shed + degraded`` holds at all times (and per
    class), which :func:`repro_torch.obs.reconcile.check_admission` asserts."""

    n_classes: int = len(PRIORITY_CLASSES)
    admitted: List[int] = field(default_factory=list)   # offered to queue
    served: List[int] = field(default_factory=list)     # full-quality answer
    shed: List[int] = field(default_factory=list)       # turned away
    degraded: List[int] = field(default_factory=list)   # stale/default answer
    degraded_rows_stale: int = 0    # resident rows served without recency
    degraded_rows_default: int = 0  # zero-vector default rows served

    def __post_init__(self):
        for f in ("admitted", "served", "shed", "degraded"):
            if not getattr(self, f):
                setattr(self, f, [0] * self.n_classes)

    # ---- totals ----
    @property
    def total_admitted(self) -> int:
        return sum(self.admitted)

    @property
    def total_served(self) -> int:
        return sum(self.served)

    @property
    def total_shed(self) -> int:
        return sum(self.shed)

    @property
    def total_degraded(self) -> int:
        return sum(self.degraded)

    def check(self):
        """Raise if the fate identity is violated (cheap, exact)."""
        for c in range(self.n_classes):
            got = self.served[c] + self.shed[c] + self.degraded[c]
            if got != self.admitted[c]:
                raise AssertionError(
                    f"class {c}: admitted {self.admitted[c]} != "
                    f"served+shed+degraded {got}")

    def as_dict(self, cfg: Optional[AdmissionConfig] = None) -> Dict:
        name = (cfg.class_name if cfg is not None
                else lambda c: PRIORITY_CLASSES[c]
                if c < len(PRIORITY_CLASSES) else f"class{c}")
        d = {
            "admitted": self.total_admitted,
            "served": self.total_served,
            "shed": self.total_shed,
            "degraded": self.total_degraded,
            "degraded_rows_stale": self.degraded_rows_stale,
            "degraded_rows_default": self.degraded_rows_default,
        }
        for c in range(self.n_classes):
            d[f"{name(c)}_admitted"] = self.admitted[c]
            d[f"{name(c)}_served"] = self.served[c]
            d[f"{name(c)}_shed"] = self.shed[c]
            d[f"{name(c)}_degraded"] = self.degraded[c]
        return d

    def merge(self, other: "AdmissionStats") -> "AdmissionStats":
        if other.n_classes != self.n_classes:
            raise ValueError("class-count mismatch in merge")
        for f in ("admitted", "served", "shed", "degraded"):
            mine, theirs = getattr(self, f), getattr(other, f)
            for c in range(self.n_classes):
                mine[c] += theirs[c]
        self.degraded_rows_stale += other.degraded_rows_stale
        self.degraded_rows_default += other.degraded_rows_default
        return self

    def publish(self, reg, prefix: str = "adm",
                cfg: Optional[AdmissionConfig] = None):
        """Publish into a :class:`repro_torch.obs.MetricsRegistry` under the
        ``adm.*`` namespace: totals plus one ``adm.class.<name>.*``
        sub-namespace per priority class (reconciled by
        :func:`repro_torch.obs.reconcile.check_admission`)."""
        name = (cfg.class_name if cfg is not None
                else lambda c: PRIORITY_CLASSES[c]
                if c < len(PRIORITY_CLASSES) else f"class{c}")
        reg.counter(f"{prefix}.admitted").inc(self.total_admitted)
        reg.counter(f"{prefix}.served").inc(self.total_served)
        reg.counter(f"{prefix}.shed").inc(self.total_shed)
        reg.counter(f"{prefix}.degraded").inc(self.total_degraded)
        reg.counter(f"{prefix}.degraded_rows_stale").inc(
            self.degraded_rows_stale)
        reg.counter(f"{prefix}.degraded_rows_default").inc(
            self.degraded_rows_default)
        for c in range(self.n_classes):
            ns = f"{prefix}.class.{name(c)}"
            reg.counter(f"{ns}.admitted").inc(self.admitted[c])
            reg.counter(f"{ns}.served").inc(self.served[c])
            reg.counter(f"{ns}.shed").inc(self.shed[c])
            reg.counter(f"{ns}.degraded").inc(self.degraded[c])
        return reg


class AdmissionQueue:
    """Bounded admission queue with EDF pop order and lowest-priority-
    first shedding.  Deterministic: every tie is broken by (priority,
    deadline, arrival, rid), so two runs over the same arrival sequence
    shed and schedule identically."""

    def __init__(self, cfg: AdmissionConfig,
                 stats: Optional[AdmissionStats] = None):
        self.cfg = cfg
        self.stats = stats if stats is not None \
            else AdmissionStats(n_classes=cfg.n_classes)
        self._q: List = []   # unordered; pop() sorts by EDF key

    def __len__(self):
        return len(self._q)

    @property
    def occupancy(self) -> float:
        return len(self._q) / self.cfg.queue_bound

    @staticmethod
    def _edf_key(req) -> tuple:
        return (req.deadline_us, req.arrival_us, req.rid)

    @staticmethod
    def _shed_key(req) -> tuple:
        """Largest key = first to shed: least important class, then the
        least urgent (latest deadline), then the youngest arrival."""
        return (req.priority, req.deadline_us, req.arrival_us, req.rid)

    def offer(self, req) -> bool:
        """Admit ``req``; returns False when it (not necessarily another
        request) was shed.  At the bound the *least important* request —
        queued or incoming — is shed, so a gold arrival always finds
        room while bronze is waiting."""
        st = self.stats
        st.admitted[req.priority] += 1
        if len(self._q) < self.cfg.queue_bound:
            self._q.append(req)
            return True
        victim_i = max(range(len(self._q)),
                       key=lambda i: self._shed_key(self._q[i]))
        victim = self._q[victim_i]
        if self._shed_key(victim) > self._shed_key(req):
            self._q[victim_i] = req
            st.shed[victim.priority] += 1
            return True
        st.shed[req.priority] += 1
        return False

    def pop(self, max_batch: int) -> List:
        """Close one batch: up to ``max_batch`` requests in EDF order."""
        if not self._q:
            raise ValueError("pop on empty admission queue")
        self._q.sort(key=self._edf_key)
        take, self._q = self._q[:max_batch], self._q[max_batch:]
        return take

    def drain(self) -> List:
        """Take everything queued (end-of-stream), in EDF order."""
        self._q.sort(key=self._edf_key)
        take, self._q = self._q, []
        return take
