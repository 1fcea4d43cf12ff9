"""Serving-runtime telemetry: prefetch timeliness/accuracy/coverage and
on-demand fetch-stall accounting.

Copied from ``src/repro/runtime/telemetry.py`` (NumPy and stdlib only): the
port imports nothing of the JAX package, so it keeps its own copy.

Extends the store-level Fig. 14 attribution (``_pf_flag`` first-touch
prefetch hits) with the *runtime*-side counters the paper's deployment
story needs: was a prefetch issued early enough to beat the demand access
(**timeliness**), how much slow-tier traffic stayed on the inference
critical path (**stall**), and how much the pipeline hid (**hidden**).

All times are modeled microseconds from the runtime's deterministic
timeline (see :mod:`repro_torch.runtime.clock`), reported in ms.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from repro_torch.obs.metrics import Reservoir

# Per-request latency samples are kept in a bounded deterministic
# reservoir (exact below the cap, Algorithm-R subsample past it) instead
# of an unbounded list — a long-running service must not grow memory with
# request count.  ``len()`` still reports the total observed count and
# iteration yields the retained samples, so existing consumers are
# unchanged; percentiles stay exact for runs under the cap.
LATENCY_RESERVOIR_CAP = 16384


def latency_percentiles(samples_ms, prefix: str = "") -> Dict[str, float]:
    """p50/p95/p99 of a latency sample list, in ms (NaN-safe on empty)."""
    if len(samples_ms) == 0:
        return {f"{prefix}p50_ms": 0.0, f"{prefix}p95_ms": 0.0,
                f"{prefix}p99_ms": 0.0}
    s = np.asarray(samples_ms, np.float64)
    return {
        f"{prefix}p50_ms": float(np.percentile(s, 50)),
        f"{prefix}p95_ms": float(np.percentile(s, 95)),
        f"{prefix}p99_ms": float(np.percentile(s, 99)),
    }


@dataclass
class RuntimeTelemetry:
    """Counters for one pipelined serving run (additive via ``merge``)."""

    batches: int = 0
    requests: int = 0
    # ---- prefetch engine ----
    pf_submitted: int = 0          # rows handed to the engine
    pf_suppressed: int = 0         # dropped at submit: backpressure on
    pf_deduped: int = 0            # dropped: already queued in-flight
    pf_cancelled_resident: int = 0  # dropped at issue: became resident
    pf_shard_down: int = 0         # cancelled: target shard died (failover)
    pf_issued: int = 0             # rows actually populated
    pf_populate_calls: int = 0     # coalesced batched populate calls
    pf_timely: int = 0             # modeled completion <= demand time
    pf_late: int = 0               # demanded while still in flight
    pf_late_ms: float = 0.0        # total modeled lateness
    pf_unused: int = 0             # never demanded before run end
    pf_fetch_ms: float = 0.0       # background-channel traffic (modeled)
    pf_channel_scheduled: int = 0  # rows put on the modeled fetch channel
    pf_eta_overwritten: int = 0    # rescheduled rows whose old ETA was lost
    rank_cancelled_evicted: int = 0  # rankings dropped: evicted pre-issue
    # ---- critical path ----
    demand_fetch_ms: float = 0.0   # total on-demand slow-tier cost
    stall_ms: float = 0.0          # part of it the pipeline could NOT hide
    compute_ms: float = 0.0        # modeled device compute
    # ---- per-request latency (modeled us; bounded reservoir) ----
    latencies_us: Reservoir = field(
        default_factory=lambda: Reservoir(cap=LATENCY_RESERVOIR_CAP))

    def __post_init__(self):
        # Accept a plain list at construction (test/legacy convenience).
        if not isinstance(self.latencies_us, Reservoir):
            self.latencies_us = Reservoir(cap=LATENCY_RESERVOIR_CAP,
                                          items=self.latencies_us)

    # ------------------------------------------------------------------
    @property
    def hidden_ms(self) -> float:
        """On-demand fetch time overlapped with compute (the pipeline win)."""
        return self.demand_fetch_ms - self.stall_ms

    @property
    def stall_reduction(self) -> float:
        """1 - stall/total: fraction of on-demand fetch taken off the
        critical path (the sync runtime is 0 by construction)."""
        return self.hidden_ms / max(self.demand_fetch_ms, 1e-12)

    @property
    def pf_timeliness(self) -> float:
        return self.pf_timely / max(self.pf_timely + self.pf_late, 1)

    def request_percentiles(self) -> Dict[str, float]:
        return latency_percentiles(
            [u * 1e-3 for u in self.latencies_us], prefix="req_")

    def as_dict(self) -> Dict:
        d = {
            "batches": self.batches, "requests": self.requests,
            "pf_submitted": self.pf_submitted,
            "pf_suppressed": self.pf_suppressed,
            "pf_deduped": self.pf_deduped,
            "pf_cancelled_resident": self.pf_cancelled_resident,
            "pf_shard_down": self.pf_shard_down,
            "pf_issued": self.pf_issued,
            "pf_populate_calls": self.pf_populate_calls,
            "pf_timely": self.pf_timely, "pf_late": self.pf_late,
            "pf_timeliness": round(self.pf_timeliness, 4),
            "pf_late_ms": round(self.pf_late_ms, 3),
            "pf_unused": self.pf_unused,
            "pf_fetch_ms": round(self.pf_fetch_ms, 3),
            "pf_channel_scheduled": self.pf_channel_scheduled,
            "pf_eta_overwritten": self.pf_eta_overwritten,
            "rank_cancelled_evicted": self.rank_cancelled_evicted,
            "demand_fetch_ms": round(self.demand_fetch_ms, 3),
            "stall_ms": round(self.stall_ms, 3),
            "hidden_ms": round(self.hidden_ms, 3),
            "stall_reduction": round(self.stall_reduction, 4),
            "compute_ms": round(self.compute_ms, 3),
        }
        d.update({k: round(v, 3)
                  for k, v in self.request_percentiles().items()})
        return d

    def merge(self, other: "RuntimeTelemetry") -> "RuntimeTelemetry":
        for f in ("batches", "requests", "pf_submitted", "pf_suppressed",
                  "pf_deduped",
                  "pf_cancelled_resident", "pf_shard_down",
                  "pf_issued", "pf_populate_calls",
                  "pf_timely", "pf_late", "pf_unused",
                  "pf_channel_scheduled", "pf_eta_overwritten",
                  "rank_cancelled_evicted"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        for f in ("pf_late_ms", "pf_fetch_ms", "demand_fetch_ms",
                  "stall_ms", "compute_ms"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        if isinstance(other.latencies_us, Reservoir):
            self.latencies_us.merge(other.latencies_us)
        else:
            self.latencies_us.extend(other.latencies_us)
        return self

    def publish(self, reg, prefix: str = "rt"):
        """Publish into a :class:`repro_torch.obs.MetricsRegistry` under the
        ``rt.*`` namespace (see docs/architecture.md)."""
        for key, val in (
            ("batches", self.batches), ("requests", self.requests),
            ("pf.submitted", self.pf_submitted),
            ("pf.suppressed", self.pf_suppressed),
            ("pf.deduped", self.pf_deduped),
            ("pf.cancelled_resident", self.pf_cancelled_resident),
            ("pf.shard_down", self.pf_shard_down),
            ("pf.issued", self.pf_issued),
            ("pf.populate_calls", self.pf_populate_calls),
            ("pf.timely", self.pf_timely), ("pf.late", self.pf_late),
            ("pf.late_ms", self.pf_late_ms),
            ("pf.unused", self.pf_unused),
            ("pf.fetch_ms", self.pf_fetch_ms),
            ("pf.channel_scheduled", self.pf_channel_scheduled),
            ("pf.eta_overwritten", self.pf_eta_overwritten),
            ("rank_cancelled_evicted", self.rank_cancelled_evicted),
            ("demand_fetch_ms", self.demand_fetch_ms),
            ("stall_ms", self.stall_ms),
            ("compute_ms", self.compute_ms),
        ):
            reg.counter(f"{prefix}.{key}").inc(val)
        reg.gauge(f"{prefix}.hidden_ms").set(self.hidden_ms)
        reg.gauge(f"{prefix}.stall_reduction").set(self.stall_reduction)
        reg.gauge(f"{prefix}.pf.timeliness").set(self.pf_timeliness)
        reg.histogram(f"{prefix}.req_latency_us",
                      cap=self.latencies_us.cap).merge(self.latencies_us)
        return reg
