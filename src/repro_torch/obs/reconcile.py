"""Counter-reconciliation checker: the serving stack's accounting
identities, asserted explicitly.

Copied from ``src/repro/obs/reconcile.py`` (NumPy and stdlib only): the
port imports nothing of the JAX package, so it keeps its own copy.

The serving stack counts every row at several layers — the store counts
tier hits, the prefetch engine counts the fate of every submitted id,
the pipeline splits on-demand fetch time into hidden vs stalled.  Those
counters must *reconcile*: every submitted prefetch id has exactly one
fate, every request either hit or missed the fast tier, no fetch
millisecond is both hidden and stalled.  This module states those
identities once, over a flat metrics mapping (``MetricsRegistry.as_dict``
or a loaded ``--metrics-out`` snapshot), so they run as a CLI
(``scripts/check_accounting.py``), as a test-lane invariant
(``tests/test_observability.py``), and as a debug assert after any run.

Identities (see docs/architecture.md for the derivations):

* **store**:   ``fast.hits + fast.misses == lookups``  (request level),
  ``fast.prefetch_hits <= fast.hits``;
* **prefetch fate**:  ``pf.submitted == pf.suppressed + pf.deduped
  + pf.cancelled_resident + pf.shard_down + pf.issued + pf.queued``
  (queued == still staged at snapshot time; suppressed == dropped under
  backpressure; shard_down == cancelled because the target shard died);
* **prefetch timeliness**:  ``pf.channel_scheduled == pf.timely + pf.late
  + pf.unused + pf.eta_overwritten + pf.eta_pending``  (every id put on
  the modeled channel is eventually demanded timely/late, never demanded,
  rescheduled, or still awaited);
* **pipeline**:  ``stall_ms + hidden_ms == demand_fetch_ms`` with both
  parts non-negative (hidden is defined as the difference, so the
  substantive check is ``0 <= stall <= demand_fetch``);
* **admission**:  ``adm.admitted == adm.served + adm.shed + adm.degraded``
  (every request has exactly one fate), and each ``adm.class.<name>.*``
  sub-namespace both closes the same identity and sums to the totals;
* **sharded**:  aggregate ``store.*`` == sum over ``shard.<i>.store.*``;
* **fault tolerance**:  ``ft.served == ft.primary + ft.failover_replica
  + ft.failover_degraded`` and ``ft.retries == ft.retry_succeeded +
  ft.retry_exhausted``  (every routed row has one answer source, every
  retry episode ends one way — see :func:`check_ft`).

The trace cross-check (:func:`check_trace_vs_metrics`) closes the loop
between the two observability surfaces: per-batch span args summed over
the trace must equal the counter snapshot exactly.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional

_EPS = 1e-6


def _get(flat: Mapping[str, Any], name: str, default: float = 0.0) -> float:
    v = flat.get(name, default)
    return float(v) if v is not None else default


def _has_any(flat: Mapping[str, Any], prefix: str) -> bool:
    return any(k == prefix or k.startswith(prefix + ".") for k in flat)


def check_store(flat: Mapping[str, Any], prefix: str = "store") -> List[str]:
    """Request-level tier accounting for one store namespace."""
    if not _has_any(flat, prefix):
        return []
    p: List[str] = []
    lookups = _get(flat, f"{prefix}.lookups")
    hits = _get(flat, f"{prefix}.fast.hits")
    misses = _get(flat, f"{prefix}.fast.misses")
    pf_hits = _get(flat, f"{prefix}.fast.prefetch_hits")
    if abs(hits + misses - lookups) > _EPS:
        p.append(f"{prefix}: fast.hits({hits:g}) + fast.misses({misses:g}) "
                 f"!= lookups({lookups:g})")
    if pf_hits > hits + _EPS:
        p.append(f"{prefix}: fast.prefetch_hits({pf_hits:g}) > "
                 f"fast.hits({hits:g})")
    for k in ("lookups", "batches", "fast.hits", "fast.misses",
              "fast.prefetch_hits", "fast.on_demand_rows", "fast.evictions"):
        if _get(flat, f"{prefix}.{k}") < -_EPS:
            p.append(f"{prefix}.{k} is negative")
    return p


def check_prefetch(flat: Mapping[str, Any], prefix: str = "rt") -> List[str]:
    """Every submitted prefetch id has exactly one fate; every id put on
    the modeled channel is eventually accounted for."""
    if not _has_any(flat, f"{prefix}.pf"):
        return []
    p: List[str] = []
    sub = _get(flat, f"{prefix}.pf.submitted")
    fate = (_get(flat, f"{prefix}.pf.suppressed")
            + _get(flat, f"{prefix}.pf.deduped")
            + _get(flat, f"{prefix}.pf.cancelled_resident")
            + _get(flat, f"{prefix}.pf.shard_down")
            + _get(flat, f"{prefix}.pf.issued")
            + _get(flat, f"{prefix}.pf.queued"))
    if abs(sub - fate) > _EPS:
        p.append(f"{prefix}: pf.submitted({sub:g}) != suppressed + deduped "
                 f"+ cancelled_resident + shard_down + issued + queued "
                 f"({fate:g})")
    sched = _get(flat, f"{prefix}.pf.channel_scheduled")
    acct = (_get(flat, f"{prefix}.pf.timely")
            + _get(flat, f"{prefix}.pf.late")
            + _get(flat, f"{prefix}.pf.unused")
            + _get(flat, f"{prefix}.pf.eta_overwritten")
            + _get(flat, f"{prefix}.pf.eta_pending"))
    if abs(sched - acct) > _EPS:
        p.append(f"{prefix}: pf.channel_scheduled({sched:g}) != timely + "
                 f"late + unused + eta_overwritten + eta_pending ({acct:g})")
    return p


def check_pipeline(flat: Mapping[str, Any], prefix: str = "rt") -> List[str]:
    """No fetch millisecond is both hidden and stalled."""
    if not _has_any(flat, prefix):
        return []
    p: List[str] = []
    demand = _get(flat, f"{prefix}.demand_fetch_ms")
    stall = _get(flat, f"{prefix}.stall_ms")
    hidden = _get(flat, f"{prefix}.hidden_ms", demand - stall)
    if stall < -_EPS:
        p.append(f"{prefix}: stall_ms({stall:g}) negative")
    if stall > demand + _EPS:
        p.append(f"{prefix}: stall_ms({stall:g}) > "
                 f"demand_fetch_ms({demand:g})")
    if abs(stall + hidden - demand) > max(_EPS, 1e-9 * abs(demand)):
        p.append(f"{prefix}: stall_ms({stall:g}) + hidden_ms({hidden:g}) "
                 f"!= demand_fetch_ms({demand:g})")
    return p


def check_admission(flat: Mapping[str, Any],
                    prefix: str = "adm") -> List[str]:
    """Every admitted request has exactly one fate — served in full,
    shed, or answered degraded — and the per-class sub-namespaces must
    sum to the totals (``adm.class.<name>.* -> adm.*``)."""
    if not _has_any(flat, prefix):
        return []
    p: List[str] = []
    fates = ("admitted", "served", "shed", "degraded")
    adm, srv, shd, deg = (_get(flat, f"{prefix}.{f}") for f in fates)
    if abs(adm - (srv + shd + deg)) > _EPS:
        p.append(f"{prefix}: admitted({adm:g}) != served({srv:g}) + "
                 f"shed({shd:g}) + degraded({deg:g})")
    for f in fates + ("degraded_rows_stale", "degraded_rows_default"):
        if _get(flat, f"{prefix}.{f}") < -_EPS:
            p.append(f"{prefix}.{f} is negative")
    cls_re = re.compile(rf"^{re.escape(prefix)}\.class\.([^.]+)\.")
    classes = sorted({m.group(1) for k in flat if (m := cls_re.match(k))})
    for f in fates:
        total = _get(flat, f"{prefix}.{f}")
        by_class = sum(_get(flat, f"{prefix}.class.{c}.{f}")
                       for c in classes)
        if classes and abs(total - by_class) > _EPS:
            p.append(f"{prefix}: {f}({total:g}) != sum over classes "
                     f"({by_class:g})")
    for c in classes:
        ca = _get(flat, f"{prefix}.class.{c}.admitted")
        cf = sum(_get(flat, f"{prefix}.class.{c}.{f}")
                 for f in ("served", "shed", "degraded"))
        if abs(ca - cf) > _EPS:
            p.append(f"{prefix}.class.{c}: admitted({ca:g}) != "
                     f"served + shed + degraded ({cf:g})")
    return p


def check_ft(flat: Mapping[str, Any], prefix: str = "ft") -> List[str]:
    """Fault-tolerance accounting: every row routed while the fault layer
    is armed has exactly one answer source, and every retry episode ends
    exactly one way.

    * ``ft.served == ft.primary + ft.failover_replica +
      ft.failover_degraded``;
    * ``ft.retries == ft.retry_succeeded + ft.retry_exhausted``;
    * ``ft.degraded_default <= ft.failover_degraded`` (the zero-default
      rows are a subset of the degraded answers);
    * ``ft.recoveries <= ft.kills`` (a shard can only recover after a
      kill) and ``ft.recovery_bytes <= ft.recovery_bytes_raw`` (int8
      transfer never inflates the payload).
    """
    if not _has_any(flat, prefix):
        return []
    p: List[str] = []
    served = _get(flat, f"{prefix}.served")
    src = (_get(flat, f"{prefix}.primary")
           + _get(flat, f"{prefix}.failover_replica")
           + _get(flat, f"{prefix}.failover_degraded"))
    if abs(served - src) > _EPS:
        p.append(f"{prefix}: served({served:g}) != primary + "
                 f"failover_replica + failover_degraded ({src:g})")
    retries = _get(flat, f"{prefix}.retries")
    ended = (_get(flat, f"{prefix}.retry_succeeded")
             + _get(flat, f"{prefix}.retry_exhausted"))
    if abs(retries - ended) > _EPS:
        p.append(f"{prefix}: retries({retries:g}) != retry_succeeded + "
                 f"retry_exhausted ({ended:g})")
    dd = _get(flat, f"{prefix}.degraded_default")
    deg = _get(flat, f"{prefix}.failover_degraded")
    if dd > deg + _EPS:
        p.append(f"{prefix}: degraded_default({dd:g}) > "
                 f"failover_degraded({deg:g})")
    kills = _get(flat, f"{prefix}.kills")
    recov = _get(flat, f"{prefix}.recoveries")
    if recov > kills + _EPS:
        p.append(f"{prefix}: recoveries({recov:g}) > kills({kills:g})")
    rb = _get(flat, f"{prefix}.recovery_bytes")
    rbr = _get(flat, f"{prefix}.recovery_bytes_raw")
    if rb > rbr + _EPS:
        p.append(f"{prefix}: recovery_bytes({rb:g}) > "
                 f"recovery_bytes_raw({rbr:g})")
    for k in ("served", "primary", "failover_replica", "failover_degraded",
              "retries", "retry_succeeded", "retry_exhausted", "kills",
              "recoveries", "recovery_rows", "recovery_chunks",
              "recovery_bytes", "recovery_bytes_raw", "staged_dropped"):
        if _get(flat, f"{prefix}.{k}") < -_EPS:
            p.append(f"{prefix}.{k} is negative")
    return p


_SHARD_RE = re.compile(r"^shard\.(\d+)\.")


def check_sharded(flat: Mapping[str, Any]) -> List[str]:
    """Aggregate counters must equal the sum over per-shard namespaces
    (and each shard namespace must itself reconcile)."""
    shards = sorted({int(m.group(1)) for k in flat
                     if (m := _SHARD_RE.match(k))})
    if not shards:
        return []
    p: List[str] = []
    for c in ("lookups", "fast.hits", "fast.misses", "fast.prefetch_hits",
              "fast.on_demand_rows", "fast.evictions"):
        agg = _get(flat, f"store.{c}")
        total = sum(_get(flat, f"shard.{s}.store.{c}") for s in shards)
        if abs(agg - total) > _EPS:
            p.append(f"sharded: store.{c}({agg:g}) != sum of shards "
                     f"({total:g})")
    for s in shards:
        p += check_store(flat, prefix=f"shard.{s}.store")
        p += check_prefetch(flat, prefix=f"shard.{s}.rt")
    return p


def check_all(flat: Mapping[str, Any]) -> List[str]:
    """All identities over one flat metrics mapping; empty == reconciled."""
    return (check_store(flat) + check_prefetch(flat)
            + check_pipeline(flat) + check_admission(flat)
            + check_sharded(flat) + check_ft(flat))


# ---------------- trace <-> metrics cross-check ----------------

def _span_sums(events, cat: str, name: str, arg: str) -> float:
    return sum(e.get("args", {}).get(arg, 0) for e in events
               if e.get("ph") == "X" and e.get("cat") == cat
               and e.get("name") == name)


def check_trace_vs_metrics(trace: Dict[str, Any],
                           flat: Mapping[str, Any],
                           store_prefix: str = "store") -> List[str]:
    """Spans must reconcile *exactly* with the counter snapshot: per-batch
    ``store.lookup`` span args summed over the trace equal the store
    counters.  ``trace`` is a Chrome trace object (``{"traceEvents":
    [...]}``)."""
    evs = trace.get("traceEvents", [])
    lookup_spans = [e for e in evs if e.get("ph") == "X"
                    and e.get("cat") == "store"
                    and e.get("name") == "lookup"]
    if not lookup_spans or not _has_any(flat, store_prefix):
        return []  # nothing traced on this surface — vacuous
    p: List[str] = []
    pairs = [
        ("ids", f"{store_prefix}.lookups"),
        ("hit_ids", f"{store_prefix}.fast.hits"),
        ("miss_ids", f"{store_prefix}.fast.misses"),
        ("miss_rows", f"{store_prefix}.fast.on_demand_rows"),
    ]
    for arg, metric in pairs:
        got = _span_sums(evs, "store", "lookup", arg)
        want = _get(flat, metric)
        if abs(got - want) > _EPS:
            p.append(f"trace: sum({arg} over store.lookup spans)={got:g} "
                     f"!= {metric}={want:g}")
    # Evictions happen on both the demand path (lookup spans) and the
    # prefetch/populate path (populate spans); together they cover every
    # _evict_slots call.
    got_ev = (_span_sums(evs, "store", "lookup", "evictions")
              + _span_sums(evs, "store", "populate", "evictions"))
    want_ev = _get(flat, f"{store_prefix}.fast.evictions")
    if abs(got_ev - want_ev) > _EPS:
        p.append(f"trace: evictions over lookup+populate spans={got_ev:g} "
                 f"!= {store_prefix}.fast.evictions={want_ev:g}")
    if not _has_any(flat, "shard") and not _has_any(flat, "table"):
        # Sharded / multi-table runs emit one store.lookup span per
        # touched *shard* (resp. *table*) while the facade counts one
        # batch, so the span-count identity only holds for single-store
        # surfaces.
        n = len(lookup_spans)
        batches = _get(flat, f"{store_prefix}.batches")
        if abs(n - batches) > _EPS:
            p.append(f"trace: {n} store.lookup spans != "
                     f"{store_prefix}.batches={batches:g}")
    return p


def reconcile(metrics: Optional[Mapping[str, Any]] = None,
              trace: Optional[Dict[str, Any]] = None,
              strict: bool = True) -> List[str]:
    """Run every applicable identity; with ``strict`` raise
    ``AssertionError`` listing the violations, else return them."""
    problems: List[str] = []
    if metrics is not None:
        flat = dict(metrics)
        if "counters" in flat or "gauges" in flat:  # registry snapshot form
            from repro_torch.obs.metrics import MetricsRegistry
            flat = MetricsRegistry.from_snapshot(metrics).as_dict()
        problems += check_all(flat)
        if trace is not None:
            problems += check_trace_vs_metrics(trace, flat)
    if problems and strict:
        raise AssertionError(
            "accounting identities violated:\n  " + "\n  ".join(problems))
    return problems
