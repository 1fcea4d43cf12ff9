"""Workload scenario subsystem: named, seeded, composable access-pattern
regimes behind one ``WorkloadSpec -> trace / iterator-of-batches`` API.

Ported from ``src/repro/workloads/__init__.py``.  ``spec``, ``regimes``
and ``replay`` are copies (NumPy and stdlib only: the port imports nothing
of the JAX package); ``harness``, ``overload`` and ``chaos`` serve on the
port's stores (single, or sharded with faults) on a ``device``.

See :mod:`repro_torch.workloads.spec` for the API,
:mod:`repro_torch.workloads.regimes` for the generator taxonomy,
:mod:`repro_torch.workloads.replay` for the external trace adapter and
:mod:`repro_torch.workloads.harness` for the model-free serving replay.
"""
from repro_torch.workloads import regimes as _regimes  # noqa: F401  (registers)
from repro_torch.workloads import replay as _replay  # noqa: F401  (registers)
from repro_torch.workloads.chaos import (CHAOS_KEYS, DEFAULT_FAULT_PLAN,
                                         chaos_sweep, failover_goodput,
                                         replay_chaos)
from repro_torch.workloads.harness import (GOLDEN_KEYS, build_store,
                                           golden_metrics,
                                           phase_steady_hit_rates,
                                           replay_scenario)
from repro_torch.workloads.overload import (OVERLOAD_KEYS,
                                            degradation_ratio,
                                            overload_sweep, replay_overload)
from repro_torch.workloads.spec import (DRIFT_SCENARIOS,
                                        PAPER_TARGET_SCENARIOS, REGIMES,
                                        SCENARIOS, WorkloadSpec,
                                        iter_batches, make_spec, make_trace,
                                        parse_workload, scenario)

__all__ = [
    "CHAOS_KEYS", "DEFAULT_FAULT_PLAN", "DRIFT_SCENARIOS", "GOLDEN_KEYS",
    "OVERLOAD_KEYS",
    "PAPER_TARGET_SCENARIOS", "REGIMES", "SCENARIOS", "WorkloadSpec",
    "build_store", "chaos_sweep", "degradation_ratio", "failover_goodput",
    "golden_metrics", "iter_batches",
    "make_spec", "make_trace", "overload_sweep", "parse_workload",
    "phase_steady_hit_rates", "replay_chaos", "replay_overload",
    "replay_scenario", "scenario",
]
