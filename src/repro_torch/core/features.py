"""Input featurization + training-window extraction for the RecMG models.

Per the paper (§V-A): the model input is a fixed-length *chunk* of prior
accesses — (row id, table id) pairs — possibly spanning query boundaries (so
cross-query correlations are learnable).  Delta/one-hot labelings don't work
at embedding scale (§I), so features are small learned embeddings of the
table id and hashed row id, plus the normalized global index (the continuous
coordinate the prefetch model regresses in).

Copied from ``src/repro/core/features.py`` (lines 1-117, NumPy only):
the port imports nothing of the JAX package, so it keeps its own copy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.belady import belady_labels
from repro_torch.core.trace import Trace

ROW_BUCKETS = (256, 256)  # two-level hash of the row id


@dataclass
class WindowData:
    """Vectorized training windows."""

    x_table: np.ndarray  # (N, T_in) int32
    x_row1: np.ndarray  # (N, T_in) int32  row % B1
    x_row2: np.ndarray  # (N, T_in) int32  (row // B1) % B2
    x_norm: np.ndarray  # (N, T_in) f32    global id / n_vectors
    x_freq: np.ndarray = None  # (N, T_in) f32  online log-frequency
    x_rec: np.ndarray = None  # (N, T_in) f32   online log-recency
    y_keep: Optional[np.ndarray] = None  # (N, T_in) f32  Belady labels
    y_window: Optional[np.ndarray] = None  # (N, W) f32   future norm ids

    def __len__(self):
        return len(self.x_table)

    def batch(self, idx):
        return WindowData(
            self.x_table[idx], self.x_row1[idx], self.x_row2[idx],
            self.x_norm[idx], self.x_freq[idx], self.x_rec[idx],
            None if self.y_keep is None else self.y_keep[idx],
            None if self.y_window is None else self.y_window[idx],
        )


def access_stats(gid: np.ndarray):
    """Per-access online statistics, causally computable at deployment:
    log2-frequency-so-far and log2-recency (accesses since last use of the
    same vector), both normalized to ~[0, 1]."""
    n = len(gid)
    freq = np.zeros(n, dtype=np.float32)
    rec = np.ones(n, dtype=np.float32)
    counts: dict = {}
    last: dict = {}
    logn = max(np.log2(n + 1), 1.0)
    for i in range(n):
        k = gid[i]
        c = counts.get(k, 0)
        freq[i] = np.log2(c + 1) / logn
        j = last.get(k)
        if j is not None:
            rec[i] = np.log2(i - j + 1) / logn
        counts[k] = c + 1
        last[k] = i
    return freq, rec


def _stack_windows(a: np.ndarray, starts: np.ndarray, length: int):
    return a[starts[:, None] + np.arange(length)[None, :]]


def make_windows(trace: Trace, in_len: int = 15, out_window: int = 15,
                 stride: int = 15, capacity: Optional[int] = None,
                 labels: Optional[np.ndarray] = None,
                 stats=None) -> WindowData:
    """Extract (input chunk, Belady keep labels, future window) triples.

    ``capacity`` (or precomputed ``labels``) enables caching-model labels;
    the future window of normalized ids is the prefetch ground truth W.
    """
    gid = trace.global_id
    n = len(gid)
    norm = gid.astype(np.float64) / max(trace.n_vectors, 1)

    starts = np.arange(in_len, n - out_window - 1, stride, dtype=np.int64)
    starts_in = starts - in_len  # input chunk = [p-in_len, p)

    x_table = _stack_windows(trace.table_id.astype(np.int32), starts_in, in_len)
    row = trace.row_id
    x_row1 = _stack_windows((row % ROW_BUCKETS[0]).astype(np.int32),
                            starts_in, in_len)
    x_row2 = _stack_windows(((row // ROW_BUCKETS[0]) % ROW_BUCKETS[1]).astype(np.int32),
                            starts_in, in_len)
    x_norm = _stack_windows(norm.astype(np.float32), starts_in, in_len)
    freq, rec = stats if stats is not None else access_stats(gid)
    x_freq = _stack_windows(freq, starts_in, in_len)
    x_rec = _stack_windows(rec, starts_in, in_len)

    y_keep = None
    if labels is None and capacity:
        labels, _, _ = belady_labels(gid, capacity)
    if labels is not None:
        y_keep = _stack_windows(labels.astype(np.float32), starts_in, in_len)

    y_window = _stack_windows(norm.astype(np.float32), starts, out_window)
    return WindowData(x_table, x_row1, x_row2, x_norm, x_freq, x_rec,
                      y_keep, y_window)


def split_train_eval(data: WindowData, eval_frac: float = 0.2):
    n = len(data)
    cut = int(n * (1 - eval_frac))
    idx_tr = np.arange(0, cut)
    idx_ev = np.arange(cut, n)
    return data.batch(idx_tr), data.batch(idx_ev)
