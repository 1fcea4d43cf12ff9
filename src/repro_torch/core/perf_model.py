"""Linear performance model (paper §VII-F, Fig. 18).

DLRM inference time is linear in the buffer hit rate: t = t0 - s * hit_rate
(equivalently t = a + b * misses), validated in the paper with RMSE < 3.75ms
(1.7%).  We fit it from measured (hit_rate, latency) points produced by the
tiered-memory runtime and use it to estimate end-to-end latency for every
caching/prefetching strategy from its simulated hit rate (Fig. 19).

Copied from ``src/repro/core/perf_model.py`` (NumPy only): the port
imports nothing of the JAX package, so it keeps its own copy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass
class LinearPerfModel:
    intercept: float  # latency at hit rate 0
    slope: float  # d latency / d hit_rate (negative)
    rmse: float = 0.0

    def predict(self, hit_rate):
        return self.intercept + self.slope * np.asarray(hit_rate)

    def as_dict(self):
        return {"intercept_ms": self.intercept, "slope_ms_per_hit": self.slope,
                "rmse_ms": self.rmse}


def fit_perf_model(hit_rates: Sequence[float],
                   latencies_ms: Sequence[float]) -> LinearPerfModel:
    x = np.asarray(hit_rates, dtype=np.float64)
    y = np.asarray(latencies_ms, dtype=np.float64)
    A = np.stack([np.ones_like(x), x], axis=1)
    (b0, b1), *_ = np.linalg.lstsq(A, y, rcond=None)
    resid = y - (b0 + b1 * x)
    return LinearPerfModel(float(b0), float(b1),
                           float(np.sqrt((resid ** 2).mean())))
