"""Transient-failure retry, straggler detection and liveness.

Copied from ``src/repro/distributed/fault_tolerance.py`` (stdlib only):
:class:`RetryDeadlineExceeded` and :func:`retry_step` (lines 30-78), which
the sharded store's flaky-shard fetch
(:meth:`repro_torch.core.sharded_serving.ShardedTieredStore.
_fetch_with_retry`) and the training launcher run through, and
:class:`StragglerMonitor` and :class:`Heartbeat` (lines 80-130, 149-168),
which the training launcher (``launch/train.py``) keeps, and
:class:`ElasticMesh` (lines 131-147), which re-factors the (data, model)
mesh of :mod:`repro_torch.distributed.mesh` to the ranks that are live.
"""
from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional, Tuple, Type, Union

from repro_torch.distributed import mesh


class RetryDeadlineExceeded(TimeoutError):
    """The retry episode's wall/virtual-time deadline passed before a
    successful attempt; carries the last underlying error as cause."""


def retry_step(fn: Callable, *args, retries: int = 3, backoff_s: float = 0.5,
               on_retry: Optional[Callable] = None,
               retryable: Union[Type[BaseException],
                                Tuple[Type[BaseException], ...]] = Exception,
               sleep: Optional[Callable[[float], None]] = None,
               now: Optional[Callable[[], float]] = None,
               deadline_s: Optional[float] = None):
    """Run fn(*args); retry *retryable* failures with exponential backoff.

    Serving-path requirements (vs the original train-loop helper):

    * ``retryable`` — only the named exception classes are retried;
      anything else (a logic bug, a KeyboardInterrupt) propagates on the
      first raise instead of being swallowed by a catch-all.  The default
      ``Exception`` keeps the legacy train-loop behavior.
    * ``sleep`` / ``now`` — injectable clock.  On the serving path these
      charge modeled microseconds to the deterministic virtual timeline
      (no bare ``time.sleep`` blocking a request); defaults keep
      wall-clock semantics for the train loop.
    * ``deadline_s`` — a hard bound on the whole episode measured via
      ``now()``: if the next backoff would land past the deadline, raise
      :class:`RetryDeadlineExceeded` immediately so admission deadlines
      still hold (a retry loop must never outlast the request).
    """
    _sleep = sleep if sleep is not None else time.sleep
    _now = now if now is not None else time.monotonic
    start = _now() if deadline_s is not None else 0.0
    attempt = 0
    while True:
        try:
            return fn(*args)
        except retryable as e:
            attempt += 1
            if attempt > retries:
                raise
            pause = backoff_s * (2 ** (attempt - 1))
            if deadline_s is not None and (_now() - start) + pause > deadline_s:
                raise RetryDeadlineExceeded(
                    f"retry deadline {deadline_s}s exceeded after "
                    f"{attempt} attempt(s)") from e
            if on_retry:
                on_retry(attempt, e)
            _sleep(pause)


@dataclass
class StragglerMonitor:
    """EWMA step-time tracker with outlier detection.

    ``clock`` is optional and only used by :meth:`record_since` for
    callers that want the monitor to own timing; ``record`` takes an
    explicit duration and needs no clock at all.
    """

    alpha: float = 0.1
    k_sigma: float = 3.0
    warmup: int = 10
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    slow_steps: List[int] = field(default_factory=list)
    clock: Optional[Callable[[], float]] = None
    _last_t: Optional[float] = None

    def record_since(self, step: int) -> bool:
        """Record the interval since the previous call using the injected
        clock (defaults to ``time.monotonic``). First call only arms."""
        now = (self.clock or time.monotonic)()
        prev, self._last_t = self._last_t, now
        if prev is None:
            return False
        return self.record(step, now - prev)

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        self.n += 1
        if self.n == 1:
            self.mean = dt
            return False
        slow = False
        if self.n > self.warmup:
            sd = math.sqrt(max(self.var, 1e-12))
            if dt > self.mean + self.k_sigma * sd and dt > 1.2 * self.mean:
                slow = True
                self.slow_steps.append(step)
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return slow

    def summary(self):
        return {"mean_s": round(self.mean, 4),
                "std_s": round(math.sqrt(max(self.var, 0.0)), 4),
                "stragglers": len(self.slow_steps)}


def elastic_mesh_shape(n: int, model_parallel: int) -> Tuple[int, int]:
    """``ElasticMesh``'s rule: the largest model axis up to
    ``model_parallel`` that divides ``n``.  It differs from
    ``make_host_mesh``'s ``gcd`` rule: at n = 6 and 4 it gives 3, gcd 2."""
    mp = model_parallel
    while n % mp:
        mp -= 1
    return n // mp, mp


class ElasticMesh:
    """Re-factor (data, model) to the live rank count on restart.

    model_parallel is treated as an upper bound: if ranks were lost and
    the count no longer factors, model parallelism shrinks to the largest
    divisor, so the job resumes at reduced model parallelism rather than
    not at all."""

    def __init__(self, model_parallel: int = 1):
        self.model_parallel = model_parallel

    def make(self) -> mesh.Mesh:
        n = mesh.world_rank()[0]
        return mesh.make_mesh(*elastic_mesh_shape(n, self.model_parallel))


class Heartbeat:
    """Periodic liveness file; ``clock`` is injectable so the cadence can
    run on a virtual timeline in tests (first beat always writes)."""

    def __init__(self, path: str, every_s: float = 30.0,
                 clock: Optional[Callable[[], float]] = None):
        self.path = Path(path)
        self.every_s = every_s
        self.clock = clock or time.time
        self._last: Optional[float] = None

    def beat(self, step: int, **info):
        now = self.clock()
        if self._last is not None and now - self._last < self.every_s:
            return
        self._last = now
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps({"step": step, "time": now, **info}))
        os.replace(tmp, self.path)
