"""DLRM inference-query generator: dense features + multi-hot sparse ids.

Copied from ``src/repro/data/dlrm_data.py`` (NumPy and stdlib only): the
port imports nothing of the JAX package, so it keeps its own copy.

Query batches are derived from a ``repro_torch.core.trace`` access stream so the
serving runtime, the cache simulators and the DLRM model all see the same
distribution; labels for training are a synthetic CTR function of the
features (deterministic, so loss decrease is meaningful).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.core.trace import Trace, TraceGenConfig, generate_trace


@dataclass(frozen=True)
class DLRMDataConfig:
    n_tables: int = 8
    rows_per_table: int = 4096
    multi_hot: int = 4
    dense_features: int = 13
    batch: int = 256
    seed: int = 0


def query_batches(cfg: DLRMDataConfig, trace: Optional[Trace] = None,
                  n_batches: int = 100,
                  workload=None) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {dense (B,F), sparse (B,T,P), label (B,)} batches.

    With a trace, sparse ids replay its access stream (query-aligned);
    ``workload`` (a :class:`~repro_torch.workloads.spec.WorkloadSpec`) derives
    the trace from a named scenario regime at this config's geometry;
    otherwise ids come from the default calibrated generator.
    """
    rng = np.random.default_rng(cfg.seed)
    B, T, P = cfg.batch, cfg.n_tables, cfg.multi_hot
    per_batch = B * T * P

    if trace is None and workload is not None:
        from repro_torch.workloads import make_trace

        trace = make_trace(workload.with_(
            n_tables=T, rows_per_table=cfg.rows_per_table,
            n_accesses=n_batches * per_batch, seed=cfg.seed))
    if trace is None:
        tr_cfg = TraceGenConfig(
            n_tables=T, rows_per_table=cfg.rows_per_table,
            n_accesses=n_batches * per_batch, seed=cfg.seed,
        )
        trace = generate_trace(tr_cfg)

    rows = trace.row_id
    tables = trace.table_id
    pos = 0
    for _ in range(n_batches):
        if pos + per_batch > len(rows):
            pos = 0
        # Reshape the flat stream into (B, T, P) respecting table ids as
        # best effort: use the row stream and assign tables round-robin (the
        # trace's own table marginals are preserved in expectation).
        sl = rows[pos : pos + per_batch]
        sparse = (sl % cfg.rows_per_table).reshape(B, T, P).astype(np.int32)
        pos += per_batch
        dense = rng.normal(size=(B, cfg.dense_features)).astype(np.float32)
        # Synthetic CTR: depends on dense features + id parity (learnable).
        logit = dense[:, 0] - 0.5 * dense[:, 1] + 0.1 * (
            (sparse.sum(axis=(1, 2)) % 7) - 3
        )
        label = (logit + 0.5 * rng.normal(size=B) > 0).astype(np.float32)
        yield {"dense": dense, "sparse": sparse, "label": label}
