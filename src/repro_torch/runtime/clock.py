"""Injectable clocks for the serving runtime.

Copied from ``src/repro/runtime/clock.py`` (NumPy and stdlib only): the
port imports nothing of the JAX package, so it keeps its own copy.

The pipelined runtime keeps two notions of time:

* **wall time** — what actually elapsed on this machine (benchmarks);
* **modeled time** — a deterministic microsecond timeline built from the
  slow-tier cost model (``fetch_us_fixed + fetch_us_per_row * rows``) and
  per-batch compute, so pipelining results are reproducible byte-for-byte
  on any host and transfer to the real two-tier hardware this container
  lacks.

Every runtime component takes a :class:`Clock`; tests inject a
:class:`VirtualClock` and the whole run replays identically.
"""
from __future__ import annotations

import time


class Clock:
    """Monotonic microsecond clock interface."""

    def now(self) -> float:
        raise NotImplementedError


class VirtualClock(Clock):
    """Deterministic clock: advances only when the runtime says so."""

    def __init__(self, start_us: float = 0.0):
        self._now = float(start_us)

    def now(self) -> float:
        return self._now

    def advance(self, dt_us: float) -> float:
        if dt_us < 0:
            raise ValueError("clock cannot run backwards")
        self._now += dt_us
        return self._now

    def advance_to(self, t_us: float) -> float:
        """Monotone jump: no-op if ``t_us`` is in the past."""
        self._now = max(self._now, float(t_us))
        return self._now


class WallClock(Clock):
    """Real time in microseconds (thread-scheduler benchmarks)."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6
