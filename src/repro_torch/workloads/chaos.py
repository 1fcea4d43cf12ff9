"""Chaos serving harness: deterministic shard-fault replay with a
lockstep zero-wrong-answers audit.

Ported from ``src/repro/workloads/chaos.py``, a copy with one change: the
stores live on ``device`` (``"cuda"`` by default; it raises when CUDA is
absent), and the audit compares each batch's rows, assembled on the
device, after one copy to the host (``.cpu().numpy()``).

``replay_chaos`` serves a workload through the sharded store with a
:class:`~repro_torch.runtime.faults.FaultPlan` armed, and — the part a
counter can't prove — runs a **clean shadow store** (same plan, same
trace, no faults) in lockstep, byte-comparing every output row:

* a row is **exact** if it equals the no-fault run's row bit-for-bit
  (healthy shards, hot-row replicas, stale-but-resident degraded rows —
  embedding values never change in this system, so stale == exact);
* a row is a **zero default** if it is all-zero (the degraded contract's
  only other allowed answer);
* anything else is a **wrong answer**, and the failover contract says
  there are exactly zero of them.

Everything is deterministic on the virtual clock: equal specs + plans
give byte-identical outputs, fates and ``ft.*`` counters (asserted in
``tests/test_faults.py``), and the full metrics snapshot reconciles
(``scripts/check_accounting.py``).

``failover_goodput`` is the gated figure of merit: full-quality rows per
modeled second under a mid-run kill, over the same workload with no
faults — the ``failover_goodput_kill_vs_clean`` floor in
``scripts/check_bench_regression.py``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core.sharded_serving import ShardedTieredStore
from repro_torch.device import resolve_device
from repro_torch.obs import MetricsRegistry
from repro_torch.obs.reconcile import reconcile
from repro_torch.workloads.spec import WorkloadSpec, make_spec, make_trace

_EMPTY = np.empty(0, np.int64)

# Deterministic chaos metrics a regression test may pin.
CHAOS_KEYS = ("regime", "fault_plan", "batches", "served", "primary",
              "failover_replica", "failover_degraded", "wrong_rows",
              "goodput_rps")

DEFAULT_FAULT_PLAN = "kill:1@mid,recover:1@75%"


def replay_chaos(spec: Optional[WorkloadSpec] = None, *,
                 fault_plan: Optional[str] = DEFAULT_FAULT_PLAN,
                 seed: int = 0, replicate_hot_frac: float = 0.05,
                 policy: str = "lru", batch: int = 256, shards: int = 4,
                 placement: str = "row", capacity_frac: float = 0.12,
                 capacity: Optional[int] = None, emb_dim: int = 8,
                 profile_frac: float = 0.25, audit: bool = True,
                 check: bool = True, device="cuda") -> Dict:
    """Serve one chaos scenario end to end; returns fates, the audit
    verdict, goodput and the full metrics snapshot.

    ``fault_plan`` is the CLI-grammar schedule (``None`` or ``""`` runs
    the clean arm — the goodput denominator).  ``replicate_hot_frac``
    sizes the hot-row replica set as a fraction of total vectors, from
    frequencies profiled on the first ``profile_frac`` of the trace.
    ``audit`` runs the lockstep no-fault shadow and byte-compares every
    row (skipped automatically on the clean arm).  Both stores live on
    ``device``.
    """
    dev = resolve_device(device)
    if spec is None:
        spec = make_spec("shard_failure", n_accesses=48_000)
    trace = make_trace(spec)
    gid = trace.global_id
    batch = int(batch)
    n_batches = len(gid) // batch
    if n_batches < 4:
        raise ValueError(f"trace of {len(gid)} ids gives only {n_batches} "
                         f"batches of {batch}; chaos needs >= 4")
    cap = int(capacity) if capacity else max(
        shards, int(capacity_frac * trace.unique_count()))
    host = np.random.default_rng(0).normal(
        size=(trace.n_vectors, emb_dim)).astype(np.float32)
    n_prof = max(1, int(len(gid) * profile_frac))
    rep = (max(1, int(replicate_hot_frac * trace.n_vectors))
           if replicate_hot_frac > 0 else 0)

    def build() -> ShardedTieredStore:
        return ShardedTieredStore.build(
            host, trace.rows_per_table, shards, placement, capacity=cap,
            policy=policy, profile_ids=gid[:n_prof], replicate_hot=rep,
            warmup_batch=batch, device=dev)

    store = build()
    faulty = bool(fault_plan)
    if faulty:
        store.arm_faults(fault_plan, horizon_batches=n_batches, seed=seed)
    shadow = build() if (audit and faulty) else None

    wrong = zero_default = exact = 0
    for b in range(n_batches):
        ids = gid[b * batch: (b + 1) * batch]
        out = store.lookup(ids).cpu().numpy()
        # Same one-prefetch-set-per-batch Algorithm-1 staging as the
        # scenario harness — the traffic pf.shard_down acts on.
        store.apply_model_outputs(_EMPTY, _EMPTY, np.unique(ids))
        if shadow is not None:
            ref = shadow.lookup(ids).cpu().numpy()
            shadow.apply_model_outputs(_EMPTY, _EMPTY, np.unique(ids))
            eq = np.all(out == ref, axis=-1)
            z = np.all(out == 0.0, axis=-1)
            wrong += int(np.count_nonzero(~(eq | z)))
            zero_default += int(np.count_nonzero(z & ~eq))
            exact += int(np.count_nonzero(eq))

    total_rows = n_batches * batch
    modeled_s = max(store.clock.now() * 1e-6, 1e-12)
    if shadow is not None:
        quality_rows = exact
    elif faulty:
        quality_rows = total_rows - store.ft_stats.degraded_default
    else:
        quality_rows = total_rows
    res = {
        "regime": spec.regime, "policy": policy, "shards": shards,
        "placement": placement,
        "fault_plan": (store._injector.plan.describe() if faulty else ""),
        "replicated_rows": rep,
        "batches": n_batches,
        "rows": total_rows,
        "modeled_s": round(modeled_s, 6),
        "goodput_rps": round(quality_rows / modeled_s, 3),
        "wrong_rows": wrong,
        "zero_default_rows": zero_default,
        "exact_rows": exact if shadow is not None else total_rows,
        "recovery_pending": sum(len(c) for c in store._recovery.values()),
    }
    if faulty:
        ft = store.ft_stats
        ft.check()
        res.update({k: ft.as_dict()[k]
                    for k in ("served", "primary", "failover_replica",
                              "failover_degraded", "degraded_default",
                              "kills", "recoveries", "recovery_rows",
                              "recovery_chunks", "recovery_bytes",
                              "recovery_bytes_raw", "retries")})
    else:
        res.update({"served": total_rows, "primary": total_rows,
                    "failover_replica": 0, "failover_degraded": 0})

    reg = MetricsRegistry()
    store.publish_metrics(reg)
    if check:
        reconcile(metrics=reg.as_dict(), strict=True)
    res["metrics"] = reg.snapshot()
    return res


def chaos_sweep(plans: Sequence[Optional[str]] = (
        None, DEFAULT_FAULT_PLAN, "kill:1@mid",
        "flaky:2x0.4@25%..75%", "slow:0x4@25%..75%"),
        **kw) -> Dict[str, Dict]:
    """Replay the same scenario under each fault plan (fresh stores per
    point; ``None`` is the clean arm).  Returns ``{plan: result}`` keyed
    by the plan string (``""`` for clean)."""
    return {(p or ""): replay_chaos(fault_plan=p, **kw) for p in plans}


def failover_goodput(sweep: Dict[str, Dict],
                     plan: str = DEFAULT_FAULT_PLAN) -> float:
    """Goodput under the kill plan over clean goodput (1.0 == the kill
    cost nothing; the bench gate floors this ratio)."""
    return (sweep[plan]["goodput_rps"]
            / max(sweep[""]["goodput_rps"], 1e-12))
