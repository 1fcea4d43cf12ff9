"""Structured span tracing on the serving stack's deterministic timeline.

Copied from ``src/repro/obs/tracing.py`` (NumPy and stdlib only): the
port imports nothing of the JAX package, so it keeps its own copy.

Spans are recorded against whatever clock the run uses — the modeled
``VirtualClock`` under ``--async-prefetch`` (so traces are byte-identical
across runs) or a wall clock otherwise.  The tracer never imports
``repro.runtime`` (that package imports us); it accepts any object with a
``now()`` returning microseconds.

Span taxonomy (category / name — see docs/architecture.md):

* ``store`` — ``lookup`` (whole batch), ``gather``, ``admit`` per batch;
* ``pf`` — ``channel`` (modeled background-channel occupancy per prefetch
  submit), ``populate``; instants ``timely`` / ``late`` / ``unused``;
* ``rt`` — ``fetch`` / ``compute`` / ``stall`` lanes of the pipelined
  modeled timeline;
* ``drift`` — instant ``trigger``, span ``refresh``;
* ``model`` — span ``finetune``, instant ``swap``;
* ``shard`` — per-shard ``lookup`` on ``shard-<i>`` tracks.

Every event carries the current batch id (set once per batch via
:meth:`SpanTracer.set_batch`) in ``args["batch"]`` so cross-layer events
correlate.  Export is Chrome trace-event JSON (Perfetto-loadable):
complete events (``ph: "X"``), instants (``ph: "i"``), plus ``ph: "M"``
metadata naming each track.  A bounded ring buffer keeps the last N
batches as a flight recorder for post-mortem dumps.

Near-zero cost when disabled: the module-level tracer defaults to a
:class:`NullTracer` whose ``enabled`` is ``False``; hot paths guard with
``if tr.enabled:`` so the off cost is one attribute check per *batch*
(never per row).
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Any, Dict, List, Optional


class _WallUs:
    """Minimal wall clock in microseconds (used when no deterministic
    clock is supplied)."""

    def now(self) -> float:
        return time.perf_counter() * 1e6


class NullTracer:
    """Disabled tracer: every record method is a no-op.  ``enabled`` is
    False so instrumented code can skip even argument construction."""

    enabled = False

    def set_batch(self, batch_id: int) -> None:  # pragma: no cover - trivial
        pass

    def add_span(self, *a, **kw) -> None:  # pragma: no cover - trivial
        pass

    def add_instant(self, *a, **kw) -> None:  # pragma: no cover - trivial
        pass


class SpanTracer:
    """Deterministic span recorder with Chrome-trace export and a
    flight-recorder ring of the last ``ring_batches`` batches.

    Spans are recorded with *explicit* timestamps (callers pass the
    begin timestamp they sampled from the clock, or fully modeled
    ``ts``/``dur`` pairs for virtual-timeline lanes), so recording order
    never perturbs the timeline.
    """

    enabled = True

    def __init__(self, clock: Optional[Any] = None,
                 ring_batches: int = 64) -> None:
        self.clock = clock if clock is not None else _WallUs()
        self.events: List[Dict[str, Any]] = []
        self.ring_batches = max(1, int(ring_batches))
        # The in-progress batch occupies one ring slot, so the deque of
        # *completed* batches keeps one fewer.
        self._ring: deque = deque(maxlen=self.ring_batches - 1)
        self._ring_cur: List[Dict[str, Any]] = []
        self.batch_id: int = -1
        self._tids: Dict[str, int] = {}

    # ---------------- recording ----------------

    def set_batch(self, batch_id: int) -> None:
        """Mark the start of a batch; all subsequent events carry this id
        and the flight-recorder ring rolls to a fresh slot."""
        if self._ring_cur:
            self._ring.append(self._ring_cur)
        self._ring_cur = []
        self.batch_id = int(batch_id)

    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = len(self._tids)
            self._tids[track] = tid
        return tid

    def _push(self, ev: Dict[str, Any]) -> None:
        self.events.append(ev)
        self._ring_cur.append(ev)

    def add_span(self, cat: str, name: str, ts: float, dur: float,
                 track: str = "main",
                 args: Optional[Dict[str, Any]] = None) -> None:
        """Record a complete span [ts, ts+dur) in microseconds on
        ``track``.  ``dur`` is clamped non-negative."""
        a = dict(args) if args else {}
        a.setdefault("batch", self.batch_id)
        self._push({
            "ph": "X", "cat": cat, "name": name,
            "ts": float(ts), "dur": max(0.0, float(dur)),
            "pid": 0, "tid": self._tid(track), "args": a,
        })

    def add_instant(self, cat: str, name: str, ts: Optional[float] = None,
                    track: str = "main",
                    args: Optional[Dict[str, Any]] = None) -> None:
        a = dict(args) if args else {}
        a.setdefault("batch", self.batch_id)
        self._push({
            "ph": "i", "cat": cat, "name": name,
            "ts": float(ts if ts is not None else self.clock.now()),
            "s": "t", "pid": 0, "tid": self._tid(track), "args": a,
        })

    # ---------------- export ----------------

    def _metadata(self) -> List[Dict[str, Any]]:
        md: List[Dict[str, Any]] = [{
            "ph": "M", "name": "process_name", "pid": 0, "tid": 0,
            "args": {"name": "repro-serve"},
        }]
        for track, tid in sorted(self._tids.items(), key=lambda kv: kv[1]):
            md.append({"ph": "M", "name": "thread_name", "pid": 0,
                       "tid": tid, "args": {"name": track}})
        return md

    def chrome_trace(self) -> Dict[str, Any]:
        """Full trace as a Chrome trace-event JSON object
        (``{"traceEvents": [...]}`` — load at https://ui.perfetto.dev)."""
        return {"traceEvents": self._metadata() + self.events,
                "displayTimeUnit": "ms"}

    def flight_record(self) -> Dict[str, Any]:
        """Chrome-trace JSON of only the last ``ring_batches`` batches —
        the post-mortem dump on failure."""
        evs: List[Dict[str, Any]] = []
        for batch_evs in self._ring:
            evs.extend(batch_evs)
        evs.extend(self._ring_cur)
        return {"traceEvents": self._metadata() + evs,
                "displayTimeUnit": "ms"}

    def write(self, path, flight_only: bool = False) -> None:
        obj = self.flight_record() if flight_only else self.chrome_trace()
        with open(path, "w") as f:
            json.dump(obj, f)

    # ---------------- queries (reconciliation helpers) ----------------

    def spans(self, cat: Optional[str] = None,
              name: Optional[str] = None) -> List[Dict[str, Any]]:
        return [e for e in self.events if e["ph"] == "X"
                and (cat is None or e["cat"] == cat)
                and (name is None or e["name"] == name)]

    def instants(self, cat: Optional[str] = None,
                 name: Optional[str] = None) -> List[Dict[str, Any]]:
        return [e for e in self.events if e["ph"] == "i"
                and (cat is None or e["cat"] == cat)
                and (name is None or e["name"] == name)]

    def sum_arg(self, cat: str, name: str, arg: str) -> float:
        """Sum an args field over matching spans — the bridge between the
        trace and the counter snapshot (e.g. sum of ``hit_ids`` over
        ``store.lookup`` spans must equal ``store.fast.hits``)."""
        return sum(e["args"].get(arg, 0) for e in self.spans(cat, name))


# ---------------- module-level tracer ----------------

_NULL = NullTracer()
_tracer: Any = _NULL


def get_tracer() -> Any:
    """The process-wide tracer; a :class:`NullTracer` unless tracing was
    enabled via :func:`install_tracer`."""
    return _tracer


def install_tracer(tracer: Optional[SpanTracer]) -> Any:
    """Install (or, with ``None``, remove) the process-wide tracer.
    Returns the installed object."""
    global _tracer
    _tracer = tracer if tracer is not None else _NULL
    return _tracer


# ---------------- trace validation (CI smoke) ----------------

def validate_chrome_trace(obj: Dict[str, Any]) -> List[str]:
    """Schema + monotonicity check for an exported trace; returns a list
    of problems (empty == valid).

    * top level must be ``{"traceEvents": [...]}``;
    * every event needs ``ph``/``name``/``pid``/``tid``; complete events
      need numeric ``ts`` >= 0 and ``dur`` >= 0;
    * per track, in append order, span *end* timestamps must be
      non-decreasing — true of a well-nested per-batch timeline on a
      monotone (virtual or wall) clock.
    """
    problems: List[str] = []
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    last_end: Dict[int, float] = {}
    for i, e in enumerate(evs):
        ph = e.get("ph")
        if ph not in ("X", "i", "M"):
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        for k in ("name", "pid", "tid"):
            if k not in e:
                problems.append(f"event {i}: missing {k}")
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
            continue
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: bad dur {dur!r}")
                continue
            tid = e.get("tid", 0)
            end = ts + dur
            if end < last_end.get(tid, 0.0) - 1e-6:
                problems.append(
                    f"event {i}: span end {end} regresses on tid {tid} "
                    f"(prev end {last_end[tid]})")
            last_end[tid] = max(last_end.get(tid, 0.0), end)
    return problems
