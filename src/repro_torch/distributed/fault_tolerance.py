"""Transient-failure retry for the serving path.

Copied from ``src/repro/distributed/fault_tolerance.py`` (lines 30-78,
stdlib only): :class:`RetryDeadlineExceeded` and :func:`retry_step`, which
the sharded store's flaky-shard fetch runs through
(:meth:`repro_torch.core.sharded_serving.ShardedTieredStore.
_fetch_with_retry`).  The rest of that module belongs to the training
loop and is not ported here: ``StragglerMonitor``, ``ElasticMesh`` and
``Heartbeat`` go with ``launch/train.py`` to ROADMAP A11b, their only
user.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, Type, Union


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
