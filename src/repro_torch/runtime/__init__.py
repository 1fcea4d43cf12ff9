"""Asynchronous pipelined serving runtime (background prefetch engine,
micro-batching request pipeline, SLO-aware admission control, telemetry).
See docs/architecture.md ("Serving runtime" and "Admission control &
overload behavior") for the determinism contract.

Ported from ``src/repro/runtime``.  ``clock``, ``telemetry``,
``admission``, ``drift`` and ``faults`` are copies (NumPy and stdlib only:
the port imports nothing of the JAX package).  ``prefetch_engine`` runs
its thread scheduler's worker under the store's CUDA device and stream,
and ``pipeline`` assembles a degraded batch on the device.
"""
from repro_torch.runtime.admission import (PRIORITY_CLASSES, AdmissionConfig,
                                           AdmissionQueue, AdmissionStats)
from repro_torch.runtime.clock import Clock, VirtualClock, WallClock
from repro_torch.runtime.drift import (AdaptiveController, DriftConfig,
                                       DriftDetector)
from repro_torch.runtime.faults import (FaultEvent, FaultInjector, FaultPlan,
                                        FtStats, TransientFetchError)
from repro_torch.runtime.pipeline import (MicroBatcher, PipelinedRuntime,
                                          Request, RuntimeConfig)
from repro_torch.runtime.prefetch_engine import (PrefetchEngine,
                                                 heuristic_prediction_stream)
from repro_torch.runtime.telemetry import (RuntimeTelemetry,
                                           latency_percentiles)

__all__ = [
    "PRIORITY_CLASSES", "AdmissionConfig", "AdmissionQueue",
    "AdmissionStats",
    "Clock", "VirtualClock", "WallClock",
    "AdaptiveController", "DriftConfig", "DriftDetector",
    "FaultEvent", "FaultInjector", "FaultPlan", "FtStats",
    "TransientFetchError",
    "MicroBatcher", "PipelinedRuntime", "Request", "RuntimeConfig",
    "PrefetchEngine", "heuristic_prediction_stream",
    "RuntimeTelemetry", "latency_percentiles",
]
