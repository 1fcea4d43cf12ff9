"""The port's rule-based prefetchers against the JAX package's.

``core/prefetchers.py`` is a NumPy copy, so every prefetcher must issue
the same prefetch sequence, access by access, on one trace (the MAB
coordinator's seeded arm choice included), and the sequence-prediction
metrics must be equal.
"""
import numpy as np
import pytest

from repro.core.prefetchers import PREFETCHERS as JAX_PREFETCHERS
from repro.core.prefetchers import make_prefetcher as jax_make_prefetcher
from repro.core.prefetchers import prediction_metrics as jax_metrics
from repro_torch.core.cache_sim import FALRU
from repro_torch.core.prefetchers import (PREFETCHERS, make_prefetcher,
                                          prediction_metrics)
from repro_torch.core.trace import TraceGenConfig, generate_trace


def _keys():
    """Strides, a repeated sequence, region re-entries and a calibrated
    trace: every prefetcher has something to learn."""
    tr = generate_trace(TraceGenConfig(n_tables=4, rows_per_table=500,
                                       n_accesses=5000, seed=2))
    seq = np.tile(np.array([3, 90, 17, 250, 41, 8]), 100)
    return np.concatenate([np.arange(1500) * 3 % 1000, seq,
                           (np.arange(600) // 8) * 64 + np.arange(600) % 8,
                           tr.global_id]).astype(np.int64)


def test_registry_equals_jax():
    assert sorted(PREFETCHERS) == sorted(JAX_PREFETCHERS)


@pytest.mark.parametrize("name", sorted(JAX_PREFETCHERS))
def test_issue_sequence_equals_jax(name):
    keys = _keys()
    got, want = make_prefetcher(name), jax_make_prefetcher(name)
    shadow = FALRU(256)
    n_issued = 0
    for k in keys.tolist():
        hit = shadow.access(k)
        a, b = got.on_access(k, hit), want.on_access(k, hit)
        assert a == b
        n_issued += len(a)
    if name != "none":
        assert n_issued > 0


@pytest.mark.parametrize("name", sorted(JAX_PREFETCHERS))
def test_prediction_metrics_equal_jax(name):
    keys = _keys()[:4000]
    assert prediction_metrics(keys, make_prefetcher(name)) == \
        jax_metrics(keys, jax_make_prefetcher(name))
