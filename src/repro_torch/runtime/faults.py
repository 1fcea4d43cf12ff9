"""Deterministic fault injection for the sharded serving path.

Copied from ``src/repro/runtime/faults.py`` (NumPy and stdlib only): the
port imports nothing of the JAX package, so it keeps its own copy.

Production DLRM serving spreads terabyte-scale embedding tables over many
workers; at that scale shard loss, slow hosts and fetch-channel hiccups
are routine events, not exceptions.  This module turns them into *seeded,
schedulable* events on the serving run's deterministic timeline so every
chaos experiment is byte-reproducible and golden-pinnable:

* :class:`FaultPlan` — a parsed schedule of fault events (shard kills,
  recoveries, slow-shard latency windows, transient fetch-failure
  windows) plus the retry-policy knobs, built from a compact CLI string
  (``serve --fault-plan "kill:1@mid,recover:1@75%"``);
* :class:`FaultInjector` — executes the plan against a run: per-shard
  health/slow/flaky state machines stepped at batch boundaries, a seeded
  RNG for transient-failure draws, and exact per-shard down-time
  accounting on the virtual clock;
* :class:`FtStats` — the exactly-reconciled ``ft.*`` counter namespace
  (``served == primary + failover_replica + failover_degraded``,
  ``retries == retry_succeeded + retry_exhausted``; checked by
  :func:`repro_torch.obs.reconcile.check_ft`).

Fault model taxonomy (what each event means for the simulated worker):

* ``kill``    — the shard process dies.  Its fast tier survives only as a
  read-only stale snapshot (the facade's last-known-good standby view):
  requests for the dead shard's rows are answered from hot-row replicas
  when the plan replicated them, else through the degraded
  ``lookup_resident`` contract (stale-but-resident row or zero default —
  never a wrong vector, never a hang).
* ``recover`` — a replacement worker comes up *empty*; the rows that were
  resident at kill time stream back in bounded background chunks through
  the shard's prefetch channel as int8 row transfers
  (:mod:`repro.distributed.compression`) while serving continues.
* ``slow``    — the shard's modeled slow-tier fetch time is multiplied by
  ``factor`` inside the window (a congested / thermally-throttled host).
* ``flaky``   — each of the shard's slow-tier fetch attempts fails with
  probability ``factor`` inside the window (seeded draws); failures go
  through the clock-driven retry/backoff wrapper (rebuilt from
  :func:`repro.distributed.fault_tolerance.retry_step`) with a hard
  deadline so admission deadlines still hold — exhausted retries take
  the degraded path.

Event times are **batch indices** by default (exactly reproducible no
matter what the cost model charges); ``mid`` / ``N%`` tokens resolve
against the run's batch horizon, and an absolute virtual-time trigger is
available as ``Nus``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

FAULT_KINDS = ("kill", "recover", "slow", "flaky")


class TransientFetchError(RuntimeError):
    """A retryable slow-tier fetch failure (injected or real)."""


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault transition.

    ``at`` / ``until`` are batch indices once resolved; before resolution
    they may be fractions of the horizon (``frac=True``) or absolute
    virtual microseconds (``unit="us"``).
    """

    kind: str
    shard: int
    at: float
    until: Optional[float] = None     # window end (slow / flaky)
    factor: float = 1.0               # slow multiplier / failure probability
    frac: bool = False                # at/until are horizon fractions
    unit: str = "batch"               # "batch" | "us"

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.shard < 0:
            raise ValueError("shard must be >= 0")
        if self.kind == "slow" and self.factor < 1.0:
            raise ValueError("slow factor must be >= 1")
        if self.kind == "flaky" and not (0.0 <= self.factor <= 1.0):
            raise ValueError("flaky probability must be in [0, 1]")


# ``kind[:shard[xfactor]]@start[..end]`` — e.g. ``kill:1@mid``,
# ``slow:0x4@25%..75%``, ``flaky:2x0.3@10..40``, ``recover:1@80%``.
_EVENT_RE = re.compile(
    r"^(?P<kind>[a-z]+)"
    r"(?::(?P<shard>\d+)(?:x(?P<factor>[0-9.]+))?)?"
    r"@(?P<at>[a-z0-9.%]+?)"
    r"(?:\.\.(?P<until>[a-z0-9.%]+))?$")


def _parse_time(tok: str) -> Tuple[float, bool, str]:
    """Time token -> (value, is_fraction, unit)."""
    if tok == "mid":
        return 0.5, True, "batch"
    if tok == "start":
        return 0.0, True, "batch"
    if tok == "end":
        return 1.0, True, "batch"
    if tok.endswith("%"):
        return float(tok[:-1]) / 100.0, True, "batch"
    if tok.endswith("us"):
        return float(tok[:-2]), False, "us"
    return float(tok), False, "batch"


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, parseable schedule of fault events + retry policy.

    The plan is pure data — byte-reproducible, hashable into goldens.
    ``seed`` drives the injector's transient-failure draws; the retry
    knobs configure the clock-driven wrapper around flaky fetches.
    """

    events: Tuple[FaultEvent, ...] = ()
    seed: int = 0
    # Retry policy for transient (flaky) fetch failures: each failed
    # attempt costs ``retry_timeout_us`` of modeled time, retries back
    # off exponentially from ``retry_backoff_us``, and the whole episode
    # is bounded by ``retry_deadline_us`` so a batch can never hang past
    # an admission deadline.
    max_retries: int = 3
    retry_timeout_us: float = 120.0
    retry_backoff_us: float = 60.0
    retry_deadline_us: float = 4000.0
    # Recovery streaming: rows restored per background chunk (one chunk
    # per serving batch — bounded background work, serving never halts).
    recovery_chunk: int = 256

    @classmethod
    def parse(cls, text: str, seed: int = 0, **kw) -> "FaultPlan":
        """Parse a comma-separated event list, e.g.
        ``"kill:1@mid,recover:1@75%"`` or ``"slow:0x4@25%..75%"``.
        Shard defaults to 0; ``kill@mid`` is the CI chaos smoke."""
        events: List[FaultEvent] = []
        for item in filter(None, (s.strip() for s in text.split(","))):
            m = _EVENT_RE.match(item)
            if not m:
                raise ValueError(f"cannot parse fault event {item!r} "
                                 "(grammar: kind[:shard[xfactor]]"
                                 "@start[..end])")
            at, at_frac, unit = _parse_time(m.group("at"))
            until = until_frac = None
            if m.group("until") is not None:
                until, until_frac, u_unit = _parse_time(m.group("until"))
                if u_unit != unit or until_frac != at_frac:
                    raise ValueError(f"mixed time units in {item!r}")
            events.append(FaultEvent(
                kind=m.group("kind"),
                shard=int(m.group("shard") or 0),
                factor=float(m.group("factor") or
                             (1.0 if m.group("kind") != "flaky" else 0.5)),
                at=at, until=until, frac=at_frac, unit=unit))
        return cls(events=tuple(events), seed=seed, **kw)

    @property
    def needs_horizon(self) -> bool:
        return any(e.frac for e in self.events)

    def describe(self) -> str:
        """Canonical plan string; ``parse(describe())`` gives back the
        same events (the chaos harness pins this field in results)."""
        def fmt(t: float, e: FaultEvent) -> str:
            if e.frac:
                return f"{t * 100:g}%"
            return f"{t:g}{'us' if e.unit == 'us' else ''}"

        parts = []
        for e in self.events:
            head = f"{e.kind}:{e.shard}"
            if e.kind in ("slow", "flaky"):
                head += f"x{e.factor:g}"
            t = fmt(e.at, e)
            if e.until is not None:
                t += f"..{fmt(e.until, e)}"
            parts.append(f"{head}@{t}")
        return ",".join(parts)


@dataclass
class FtStats:
    """The exactly-reconciled ``ft.*`` namespace.

    Identities (:func:`repro_torch.obs.reconcile.check_ft`):

    * ``served == primary + failover_replica + failover_degraded`` —
      every row routed while the fault layer is armed has exactly one
      answer source;
    * ``retries == retry_succeeded + retry_exhausted`` — every retry
      episode ends exactly one way.
    """

    n_shards: int = 1
    served: int = 0                 # rows routed while faults armed
    primary: int = 0                # answered by the row's healthy shard
    failover_replica: int = 0       # dead shard, answered from a replica
    failover_degraded: int = 0      # dead shard / exhausted retries:
    #                                 stale-resident or zero-default row
    degraded_default: int = 0       # the zero-default subset of the above
    retries: int = 0                # retry episodes (>=1 failed attempt)
    retry_succeeded: int = 0        # episode ended in a successful fetch
    retry_exhausted: int = 0        # episode hit max retries / deadline
    retry_overhead_ms: float = 0.0  # modeled timeout+backoff time charged
    kills: int = 0
    recoveries: int = 0
    recovery_rows: int = 0          # rows streamed back post-recovery
    recovery_chunks: int = 0        # bounded background chunks used
    recovery_bytes: int = 0         # int8 payload bytes on the wire
    recovery_bytes_raw: int = 0     # fp32-equivalent bytes (the savings)
    slow_ms: float = 0.0            # extra critical-path ms from slow shards
    staged_dropped: int = 0         # staged model-output rows for a dead shard
    down_us: np.ndarray = field(default=None)  # per-shard down time

    def __post_init__(self):
        if self.down_us is None:
            self.down_us = np.zeros(self.n_shards, np.float64)

    def check(self):
        assert self.served == (self.primary + self.failover_replica
                               + self.failover_degraded), \
            (f"ft: served({self.served}) != primary({self.primary}) + "
             f"replica({self.failover_replica}) + "
             f"degraded({self.failover_degraded})")
        assert self.retries == self.retry_succeeded + self.retry_exhausted
        assert self.degraded_default <= self.failover_degraded

    def as_dict(self) -> dict:
        return {
            "served": self.served, "primary": self.primary,
            "failover_replica": self.failover_replica,
            "failover_degraded": self.failover_degraded,
            "degraded_default": self.degraded_default,
            "retries": self.retries,
            "retry_succeeded": self.retry_succeeded,
            "retry_exhausted": self.retry_exhausted,
            "retry_overhead_ms": round(self.retry_overhead_ms, 3),
            "kills": self.kills, "recoveries": self.recoveries,
            "recovery_rows": self.recovery_rows,
            "recovery_chunks": self.recovery_chunks,
            "recovery_bytes": self.recovery_bytes,
            "recovery_bytes_raw": self.recovery_bytes_raw,
            "slow_ms": round(self.slow_ms, 3),
            "staged_dropped": self.staged_dropped,
            "down_ms": [round(u * 1e-3, 3) for u in self.down_us.tolist()],
        }

    def publish(self, reg, prefix: str = "ft"):
        """Publish into a :class:`repro_torch.obs.MetricsRegistry`; the layout
        :func:`repro_torch.obs.reconcile.check_ft` reconciles."""
        for key, val in (
            ("served", self.served), ("primary", self.primary),
            ("failover_replica", self.failover_replica),
            ("failover_degraded", self.failover_degraded),
            ("degraded_default", self.degraded_default),
            ("retries", self.retries),
            ("retry_succeeded", self.retry_succeeded),
            ("retry_exhausted", self.retry_exhausted),
            ("retry_overhead_ms", self.retry_overhead_ms),
            ("kills", self.kills), ("recoveries", self.recoveries),
            ("recovery_rows", self.recovery_rows),
            ("recovery_chunks", self.recovery_chunks),
            ("recovery_bytes", self.recovery_bytes),
            ("recovery_bytes_raw", self.recovery_bytes_raw),
            ("slow_ms", self.slow_ms),
            ("staged_dropped", self.staged_dropped),
        ):
            reg.counter(f"{prefix}.{key}").inc(val)
        for s in range(self.n_shards):
            reg.gauge(f"{prefix}.shard.{s}.down_ms").set(
                float(self.down_us[s]) * 1e-3)
        return reg


class FaultInjector:
    """Execute a :class:`FaultPlan` against a serving run.

    The owning store polls :meth:`poll` once per batch (before routing);
    due events fire in schedule order and the injector returns them so
    the store can act (kill/recover side effects) and emit span events.
    Per-shard state between polls: ``up`` (health), ``slow`` (latency
    multiplier), ``flaky`` (fetch-failure probability).  All transient
    draws come from one seeded generator in a fixed order, so two runs of
    the same plan over the same trace are byte-identical.
    """

    def __init__(self, plan: FaultPlan, n_shards: int,
                 horizon_batches: Optional[int] = None):
        self.plan = plan
        self.n_shards = int(n_shards)
        if plan.needs_horizon and not horizon_batches:
            raise ValueError("fault plan uses fractional times "
                             "(mid / N%); pass horizon_batches")
        self.horizon = int(horizon_batches or 0)
        # Expand windows into transitions: (batch, seq, event, clear).
        self._timeline: List[Tuple[float, int, FaultEvent, bool]] = []
        seq = 0
        for e in self.events_resolved():
            self._timeline.append((e.at, seq, e, False))
            seq += 1
            if e.until is not None:
                self._timeline.append((e.until, seq, e, True))
                seq += 1
        self._timeline.sort(key=lambda t: (t[0], t[1]))
        self._next = 0
        self.up = np.ones(self.n_shards, bool)
        self.slow = np.ones(self.n_shards, np.float64)
        self.flaky = np.zeros(self.n_shards, np.float64)
        self.down_since_us = np.full(self.n_shards, np.nan)
        self._rng = np.random.default_rng(plan.seed)

    def events_resolved(self) -> List[FaultEvent]:
        """The plan's events with fractional times resolved to batches."""
        out = []
        for e in self.plan.events:
            if e.shard >= self.n_shards:
                raise ValueError(f"fault event targets shard {e.shard}, "
                                 f"store has {self.n_shards}")
            if e.frac:
                at = float(int(e.at * self.horizon))
                until = (float(int(e.until * self.horizon))
                         if e.until is not None else None)
                e = FaultEvent(e.kind, e.shard, at, until, e.factor,
                               frac=False, unit=e.unit)
            out.append(e)
        return out

    @property
    def any_down(self) -> bool:
        return not bool(self.up.all())

    @property
    def armed(self) -> bool:
        """Any fault behavior still pending or active?"""
        return (self._next < len(self._timeline) or self.any_down
                or bool((self.slow != 1.0).any())
                or bool((self.flaky > 0.0).any()))

    def poll(self, batch: int, now_us: float) -> List[Tuple[FaultEvent, bool]]:
        """Fire every transition due at ``batch`` (or by ``now_us`` for
        absolute-virtual-time events); returns ``(event, is_clear)``
        pairs in firing order.  State mutates here; kill/recover side
        effects on the store are the caller's job."""
        fired: List[Tuple[FaultEvent, bool]] = []
        while self._next < len(self._timeline):
            at, _, e, clear = self._timeline[self._next]
            due = (now_us >= at) if e.unit == "us" else (batch >= at)
            if not due:
                break
            self._next += 1
            s = e.shard
            if e.kind == "kill" and not clear:
                if self.up[s]:
                    self.up[s] = False
                    self.down_since_us[s] = now_us
                    fired.append((e, False))
            elif e.kind == "recover" and not clear:
                if not self.up[s]:
                    self.up[s] = True
                    fired.append((e, False))
            elif e.kind == "slow":
                self.slow[s] = 1.0 if clear else e.factor
                fired.append((e, clear))
            elif e.kind == "flaky":
                self.flaky[s] = 0.0 if clear else e.factor
                fired.append((e, clear))
        return fired

    def draw_failure(self, shard: int) -> bool:
        """One seeded transient-failure draw for a fetch attempt."""
        p = self.flaky[shard]
        return bool(p > 0.0 and self._rng.random() < p)

    def down_time_us(self, shard: int, now_us: float) -> float:
        """Open downtime window through ``now`` (0 if never killed, or if
        the window was already closed via :meth:`close_downtime`)."""
        if np.isnan(self.down_since_us[shard]):
            return 0.0
        return float(now_us - self.down_since_us[shard])

    def close_downtime(self, shard: int, now_us: float) -> float:
        """On recovery: return and clear the closed downtime window."""
        dt = self.down_time_us(shard, now_us)
        self.down_since_us[shard] = np.nan
        return dt
