"""Typed metrics registry: namespaced Counter / Gauge / Histogram with
lossless snapshot / merge semantics.

Copied from ``src/repro/obs/metrics.py`` (NumPy and stdlib only): the
port imports nothing of the JAX package, so it keeps its own copy.

Every telemetry producer in the serving stack (``TierStats``,
``RuntimeTelemetry``, the sharded facade, the drift detector, the learned
controller) publishes its counters into one :class:`MetricsRegistry`
under a dotted namespace (``store.fast.hits``, ``rt.pf.issued``,
``shard.0.store.lookups``, ``drift.triggers``, ``model.finetunes``), so a
single snapshot carries the whole run's accounting and the
reconciliation checker (:mod:`repro.obs.reconcile`) can assert the
cross-layer identities in one place.

Design constraints:

* **lossless** — counters are exact ints/floats, never rounded; a
  snapshot round-trips through JSON (:meth:`MetricsRegistry.snapshot` /
  :meth:`MetricsRegistry.from_snapshot`) and two snapshots of split runs
  :meth:`merge` into the whole-run snapshot (counters add, gauges take
  the later value, histograms merge their reservoirs);
* **bounded** — histograms never hold more than ``reservoir`` samples
  (deterministic Algorithm-R subsampling past that), so per-request
  latency series cannot grow with run length;
* **cheap** — publishing happens once per run (or per window), not per
  row; the hot path keeps its plain dataclass counters and hands them
  over in one ``publish`` call.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Union

import numpy as np

# Dotted lowercase namespace; digit-only segments are allowed for
# per-shard / per-table indices (``shard.0.imbalance``).
_NAME_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_-]+)*$")

Number = Union[int, float]


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(
            f"bad metric name {name!r}: want dotted lowercase segments "
            "like 'store.fast.hits'")
    return name


class Counter:
    """Monotone additive metric (int or float — time accumulators are
    float counters).  ``inc`` only; use a :class:`Gauge` for values that
    move both ways."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value: Number = 0):
        self.name = name
        self.value = value

    def inc(self, n: Number = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (by {n})")
        self.value += n


class Gauge:
    """Last-written value (ratios, imbalance, loss)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value: Number = 0.0):
        self.name = name
        self.value = value

    def set(self, v: Number) -> None:
        self.value = v


class Reservoir:
    """Bounded uniform sample of a stream (Algorithm R) with exact
    streaming count / sum / min / max.

    Deterministic: the replacement RNG is seeded at construction, so the
    same insertion stream always yields the same sample (golden-testable).
    Below ``cap`` observations the sample is the exact stream, so small
    runs lose nothing.

    List-compatible surface (``append`` / ``extend`` / ``__iter__`` /
    ``__len__`` / ``==``) so it can replace the unbounded
    ``RuntimeTelemetry.latencies_us`` list in place: ``len`` reports the
    *total observed* count (the old list semantics for bounded streams),
    iteration yields the retained sample.
    """

    __slots__ = ("cap", "count", "total", "mn", "mx", "_samples", "_rng")

    def __init__(self, cap: int = 4096, seed: int = 0,
                 items: Optional[Iterable[float]] = None):
        if cap < 1:
            raise ValueError("reservoir cap must be >= 1")
        self.cap = int(cap)
        self.count = 0
        self.total = 0.0
        self.mn = float("inf")
        self.mx = float("-inf")
        self._samples: List[float] = []
        self._rng = np.random.Generator(np.random.PCG64(seed))
        if items is not None:
            self.extend(items)

    # ---------------- stream side ----------------

    def append(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.total += x
        self.mn = min(self.mn, x)
        self.mx = max(self.mx, x)
        if len(self._samples) < self.cap:
            self._samples.append(x)
        else:  # Algorithm R: keep with probability cap/count
            j = int(self._rng.integers(0, self.count))
            if j < self.cap:
                self._samples[j] = x

    def extend(self, xs: Iterable[float]) -> None:
        for x in xs:
            self.append(x)

    def merge(self, other: "Reservoir") -> "Reservoir":
        """Combine two reservoirs; exact while the union fits ``cap``,
        a proportional deterministic subsample past that."""
        mine, theirs = self._samples, list(other.samples())
        if len(mine) + len(theirs) > self.cap:
            total = self.count + other.count
            k_mine = min(len(mine),
                         max(0, round(self.cap * self.count / max(total, 1))))
            k_theirs = self.cap - k_mine
            if k_theirs > len(theirs):  # give the slack back
                k_mine = min(len(mine), self.cap - len(theirs))
                k_theirs = min(len(theirs), self.cap - k_mine)
            mine = list(self._rng.choice(
                mine, size=k_mine, replace=False)) if k_mine < len(mine) \
                else mine
            theirs = list(self._rng.choice(
                theirs, size=k_theirs, replace=False)) \
                if k_theirs < len(theirs) else theirs
        self._samples = [float(x) for x in mine] + [float(x) for x in theirs]
        self.count += other.count
        self.total += other.total
        self.mn = min(self.mn, other.mn)
        self.mx = max(self.mx, other.mx)
        return self

    # ---------------- read side ----------------

    def samples(self) -> List[float]:
        return self._samples

    def percentile(self, q: float) -> float:
        if not self._samples:
            return 0.0
        return float(np.percentile(np.asarray(self._samples, np.float64), q))

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)

    # ---------------- list-compat surface ----------------

    def __len__(self) -> int:
        return self.count

    def __iter__(self):
        return iter(self._samples)

    def __eq__(self, other) -> bool:
        if isinstance(other, Reservoir):
            return self._samples == other._samples \
                and self.count == other.count
        if isinstance(other, (list, tuple)):
            return self._samples == list(other)
        return NotImplemented

    def __repr__(self):
        return (f"Reservoir(count={self.count}, kept={len(self._samples)}, "
                f"cap={self.cap})")


class Histogram(Reservoir):
    """A named :class:`Reservoir` registered in a
    :class:`MetricsRegistry` (streaming quantile sketch)."""

    __slots__ = ("name",)

    def __init__(self, name: str, cap: int = 4096, seed: int = 0):
        super().__init__(cap=cap, seed=seed)
        self.name = name

    def as_dict(self, with_samples: bool = True) -> Dict:
        d = {
            "count": self.count,
            "sum": self.total,
            "min": self.mn if self.count else 0.0,
            "max": self.mx if self.count else 0.0,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "cap": self.cap,
        }
        if with_samples:
            d["samples"] = list(self._samples)
        return d


class MetricsRegistry:
    """Namespaced typed metrics with lossless snapshot / merge.

    ``counter`` / ``gauge`` / ``histogram`` create-or-fetch by name (the
    type must match on re-fetch — one name, one meaning); producers hold
    the returned object and mutate it directly.
    """

    def __init__(self):
        self._metrics: Dict[str, Union[Counter, Gauge, Histogram]] = {}

    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(_check_name(name), **kw)
            self._metrics[name] = m
        elif type(m) is not cls:
            raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                            f"not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, cap: int = 4096) -> Histogram:
        return self._get(name, Histogram, cap=cap)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __len__(self) -> int:
        return len(self._metrics)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def value(self, name: str, default=None):
        m = self._metrics.get(name)
        if m is None:
            return default
        return m.value if isinstance(m, (Counter, Gauge)) else m

    # ---------------- snapshot / merge ----------------

    def snapshot(self, with_samples: bool = True) -> Dict:
        """JSON-serializable full state; ``from_snapshot`` round-trips it
        (histograms only up to their retained samples when the stream
        exceeded ``cap``)."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.as_dict(with_samples)
        return out

    @classmethod
    def from_snapshot(cls, snap: Dict) -> "MetricsRegistry":
        reg = cls()
        for name, v in snap.get("counters", {}).items():
            reg.counter(name).inc(v)
        for name, v in snap.get("gauges", {}).items():
            reg.gauge(name).set(v)
        for name, h in snap.get("histograms", {}).items():
            hist = reg.histogram(name, cap=int(h.get("cap", 4096)))
            samples = h.get("samples", [])
            hist.extend(samples)
            # Restore the exact streaming aggregates even when the
            # snapshot only retained a subsample.
            hist.count = int(h["count"])
            hist.total = float(h["sum"])
            if hist.count:
                hist.mn = float(h["min"])
                hist.mx = float(h["max"])
        return reg

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Additive merge: counters add, gauges take ``other``'s value,
        histograms merge reservoirs.  Merging the registries of two run
        halves yields the whole run's registry (exact for counters,
        within reservoir tolerance for quantiles)."""
        for name in other.names():
            m = other._metrics[name]
            if isinstance(m, Counter):
                self.counter(name).inc(m.value)
            elif isinstance(m, Gauge):
                self.gauge(name).set(m.value)
            else:
                self.histogram(name, cap=m.cap).merge(m)
        return self

    def as_dict(self) -> Dict[str, Number]:
        """Flat name -> value view (histograms expand to ``.count`` /
        ``.p50`` / ``.p95`` / ``.p99`` sub-keys) — the human-readable /
        bench-row form."""
        flat: Dict[str, Number] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, (Counter, Gauge)):
                flat[name] = m.value
            else:
                for k, v in m.as_dict(with_samples=False).items():
                    if k != "cap":
                        flat[f"{name}.{k}"] = v
        return flat


def publish_all(reg: MetricsRegistry, *producers) -> MetricsRegistry:
    """Publish every non-None producer (anything with a
    ``publish(registry)`` method) into ``reg``."""
    for p in producers:
        if p is not None:
            p.publish(reg)
    return reg
