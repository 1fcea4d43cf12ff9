"""Embedding-access traces: containers, synthetic generation, locality stats.

Copied from ``src/repro/core/trace.py`` (NumPy and stdlib only): the
port imports nothing of the JAX package, so it keeps its own copy.

The paper evaluates on Meta production traces (dlrm_datasets): 856 sparse
features, 62M unique vectors, >400M accesses, with (a) power-law popularity
(~20% of vectors take ~80% of accesses), (b) a heavy long-reuse-distance tail
(20% of accesses with reuse distance > 2^20), (c) pooling factors from 1 to
hundreds, and (d) cross-query user-behavior correlation that makes accesses
*learnable*.  The generator below reproduces those properties at configurable
scale (offline container -> synthetic, calibrated to the published stats; the
interface accepts real traces unchanged).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Trace:
    """A flat sequence of embedding-vector accesses."""

    table_id: np.ndarray  # (N,) int32
    row_id: np.ndarray  # (N,) int64  (row within table)
    rows_per_table: np.ndarray  # (T,) int64
    query_id: Optional[np.ndarray] = None  # (N,) int32 — inference query

    def __len__(self):
        return len(self.table_id)

    @property
    def n_tables(self) -> int:
        return len(self.rows_per_table)

    @property
    def table_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.rows_per_table)[:-1]])

    @property
    def global_id(self) -> np.ndarray:
        """Unique vector id across all tables."""
        return self.table_offsets[self.table_id] + self.row_id

    @property
    def n_vectors(self) -> int:
        return int(self.rows_per_table.sum())

    def unique_count(self) -> int:
        return len(np.unique(self.global_id))

    def slice(self, start: int, stop: int) -> "Trace":
        q = self.query_id[start:stop] if self.query_id is not None else None
        return Trace(self.table_id[start:stop], self.row_id[start:stop],
                     self.rows_per_table, q)


# ---------------------------------------------------------------------------
# Synthetic generation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TraceGenConfig:
    n_tables: int = 24
    rows_per_table: int = 100_000
    n_accesses: int = 500_000
    seed: int = 0
    # Popularity: per-table zipf over rows; mix of components per access.
    zipf_a: float = 1.05
    table_zipf_a: float = 1.1
    p_popular: float = 0.40  # global power-law draws (high temporal locality)
    p_cluster: float = 0.25  # user-cluster correlated draws (learnable)
    p_markov: float = 0.20  # successor-item correlations (consecutive-access
    #   structure: learnable by sequence models, invisible to spatial/offset
    #   prefetchers because the per-table jumps are large)
    p_stream: float = 0.15  # advancing streams (few reuses / long distance)
    n_clusters: int = 64
    cluster_size: int = 256  # correlated rows per (cluster, table)
    # Queries: pooling factor distribution (1..hundreds, lognormal).
    pool_mu: float = 2.2
    pool_sigma: float = 0.9
    pool_max: int = 300
    drift_every: int = 200_000  # popularity drift period (content drift)


def _zipf_ranks(rng, a: float, n: int, size: int) -> np.ndarray:
    """Zipf-distributed ranks in [0, n) via inverse-CDF on a truncated zipf."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-a)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    u = rng.random(size)
    return np.searchsorted(cdf, u).astype(np.int64)


def generate_trace(cfg: TraceGenConfig) -> Trace:
    rng = np.random.default_rng(cfg.seed)
    T, R, N = cfg.n_tables, cfg.rows_per_table, cfg.n_accesses

    # Per-table popularity permutation (which rows are "hot") + drift.
    n_epochs = max(1, N // cfg.drift_every)
    perm_seed = rng.integers(0, 2**31, size=(n_epochs, T))

    # Cluster profiles: correlated row sets shared by users with the same
    # interests — this is what makes the access stream *learnable*.
    cluster_rows = rng.integers(0, R, size=(cfg.n_clusters, T, cfg.cluster_size))

    # 1) Build per-access query structure.
    pool = np.clip(
        np.round(rng.lognormal(cfg.pool_mu, cfg.pool_sigma, size=N // 4)),
        1, cfg.pool_max,
    ).astype(np.int64)
    table_of_q = _zipf_ranks(rng, cfg.table_zipf_a, T, len(pool)) % T
    csum = np.cumsum(pool)
    n_q = int(np.searchsorted(csum, N))
    pool = pool[: n_q + 1]
    csum = csum[: n_q + 1]
    total = int(csum[-1])

    table_id = np.repeat(table_of_q[: n_q + 1], pool).astype(np.int32)
    query_id = np.repeat(np.arange(n_q + 1, dtype=np.int32), pool)
    epoch = np.minimum(
        np.arange(total, dtype=np.int64) // cfg.drift_every, n_epochs - 1
    )

    # Session-level cluster choice: each query belongs to a user cluster, and
    # consecutive queries are often from the same session.
    q_cluster = _zipf_ranks(rng, 1.2, cfg.n_clusters, n_q + 1) % cfg.n_clusters
    same = rng.random(n_q + 1) < 0.6
    for i in range(1, n_q + 1):  # cheap session smoothing
        if same[i]:
            q_cluster[i] = q_cluster[i - 1]
    cluster_of_access = q_cluster[query_id]

    # 2) Draw rows per access as a mixture of components.
    u = rng.random(total)
    p1 = cfg.p_popular
    p2 = p1 + cfg.p_cluster
    p3 = p2 + cfg.p_markov
    comp = np.where(u < p1, 0, np.where(u < p2, 1, np.where(u < p3, 3, 2)))

    row_id = np.empty(total, dtype=np.int64)

    # Popular: zipf rank -> permuted row (drift rotates the permutation).
    pop_mask = comp == 0
    ranks = _zipf_ranks(rng, cfg.zipf_a, R, int(pop_mask.sum()))
    salt = perm_seed[epoch[pop_mask], table_id[pop_mask].astype(np.int64)]
    # Cheap keyed permutation: (rank * odd + salt) % R.
    row_id[pop_mask] = (ranks * 2654435761 + salt) % R

    # Cluster-correlated: pick from the (cluster, table) profile.
    cl_mask = comp == 1
    idx = rng.integers(0, cfg.cluster_size, size=int(cl_mask.sum()))
    row_id[cl_mask] = cluster_rows[
        cluster_of_access[cl_mask], table_id[cl_mask].astype(np.int64), idx
    ]

    # Streams: slowly advancing fronts per table — long reuse distance / few
    # reuses (the component LRU cannot hold).
    st_mask = comp == 2
    front = (np.arange(total, dtype=np.int64) * 7) % R
    jitter = rng.integers(0, 64, size=int(st_mask.sum()))
    row_id[st_mask] = (front[st_mask] + jitter) % R

    # Markov successors: "users who touched item r next touch succ_t(r)" —
    # the consecutive-access correlation the paper's LSTM exploits.  The
    # per-table jump is large (R/11..R/5), so no spatial/delta prefetcher
    # sees it, but it is a deterministic (hence learnable) function of the
    # previous access.
    jumps = rng.integers(R // 11, R // 5, size=T)
    mk_idx = np.nonzero(comp == 3)[0]
    for i in mk_idx:
        if i == 0:
            row_id[i] = 0
        else:
            row_id[i] = (row_id[i - 1] + jumps[table_id[i]]) % R

    tr = Trace(
        table_id=table_id[:N],
        row_id=row_id[:N],
        rows_per_table=np.full(T, R, dtype=np.int64),
        query_id=query_id[:N],
    )
    return tr


# ---------------------------------------------------------------------------
# Trace serialization: npz (exact dtypes) and csv (interoperable)
# ---------------------------------------------------------------------------


def save_trace(trace: Trace, path) -> None:
    """Write a trace to ``path`` (format by suffix: ``.npz`` or ``.csv``).

    Both formats round-trip byte-identically through :func:`load_trace`
    (same arrays, same dtypes) — the contract the ``replay`` workload
    regime and its property test rely on.  CSV carries one access per
    line (``table_id,row_id[,query_id]``) with the per-table row counts
    in a ``# rows_per_table=`` header comment, so external traces can be
    dropped in from any tool that can write a text file.
    """
    from pathlib import Path

    path = Path(path)
    if path.suffix == ".npz":
        payload = {"table_id": trace.table_id, "row_id": trace.row_id,
                   "rows_per_table": trace.rows_per_table}
        if trace.query_id is not None:
            payload["query_id"] = trace.query_id
        np.savez(path, **payload)
        return
    if path.suffix == ".csv":
        rpt = ",".join(str(int(r)) for r in trace.rows_per_table)
        cols = [trace.table_id, trace.row_id]
        header = "table_id,row_id"
        if trace.query_id is not None:
            cols.append(trace.query_id)
            header += ",query_id"
        body = np.stack([c.astype(np.int64) for c in cols], axis=1)
        with open(path, "w") as f:
            f.write(f"# rows_per_table={rpt}\n{header}\n")
            np.savetxt(f, body, fmt="%d", delimiter=",")
        return
    raise ValueError(f"unsupported trace format {path.suffix!r} "
                     "(use .npz or .csv)")


def load_trace(path) -> Trace:
    """Read a trace written by :func:`save_trace` (or any external file in
    the same layout).  Dtypes are restored exactly: ``table_id`` int32,
    ``row_id`` int64, ``rows_per_table`` int64, ``query_id`` int32."""
    from pathlib import Path

    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            q = z["query_id"] if "query_id" in z.files else None
            return Trace(z["table_id"].astype(np.int32),
                         z["row_id"].astype(np.int64),
                         z["rows_per_table"].astype(np.int64),
                         None if q is None else q.astype(np.int32))
    if path.suffix == ".csv":
        with open(path) as f:
            first = f.readline().strip()
            if not first.startswith("# rows_per_table="):
                raise ValueError(f"{path}: missing rows_per_table header")
            rpt = np.asarray([int(x) for x in
                              first.split("=", 1)[1].split(",")], np.int64)
            header = f.readline().strip().split(",")
            body = np.loadtxt(f, dtype=np.int64, delimiter=",", ndmin=2)
        if body.size == 0:
            body = body.reshape(0, len(header))
        cols = {name: body[:, i] for i, name in enumerate(header)}
        q = cols.get("query_id")
        return Trace(cols["table_id"].astype(np.int32),
                     cols["row_id"].astype(np.int64), rpt,
                     None if q is None else q.astype(np.int32))
    raise ValueError(f"unsupported trace format {path.suffix!r} "
                     "(use .npz or .csv)")


# ---------------------------------------------------------------------------
# Locality statistics (paper §III)
# ---------------------------------------------------------------------------


def reuse_distances(keys: np.ndarray) -> np.ndarray:
    """Exact reuse distance per access (#distinct keys between consecutive
    uses of the same key); -1 for first-ever accesses.

    Fenwick-tree algorithm, O(N log N).
    """
    n = len(keys)
    out = np.full(n, -1, dtype=np.int64)
    tree = np.zeros(n + 2, dtype=np.int64)

    def update(i, v):
        i += 1
        while i <= n + 1:
            tree[i] += v
            i += i & (-i)

    def query(i):  # sum of [0, i]
        i += 1
        s = 0
        while i > 0:
            s += tree[i]
            i -= i & (-i)
        return s

    last = {}
    for i in range(n):
        k = keys[i]
        j = last.get(k)
        if j is not None:
            # #distinct keys accessed in (j, i) = count of "last occurrence"
            # markers in that range.
            out[i] = query(i - 1) - query(j)
            update(j, -1)
        update(i, 1)
        last[k] = i
    return out


def reuse_distance_cdf(keys: np.ndarray, max_pow: int = 24):
    """(bucket_edges, frac_of_accesses_with_rd >= edge) for log2 buckets."""
    rd = reuse_distances(keys)
    seen = rd[rd >= 0]
    edges = [2**p for p in range(0, max_pow + 1)]
    frac = [float((seen >= e).mean()) if len(seen) else 0.0 for e in edges]
    return np.array(edges), np.array(frac)
