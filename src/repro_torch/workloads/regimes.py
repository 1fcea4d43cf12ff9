"""Workload regime generators — one seeded function per access-pattern
family (see the taxonomy table in docs/architecture.md).

Copied from ``src/repro/workloads/regimes.py`` (NumPy and stdlib only): the
port imports nothing of the JAX package, so it keeps its own copy.

Every generator takes ``(spec, rng)`` and returns ``(table_id, row_id)``
arrays of exactly ``spec.n_accesses`` entries with ids inside the spec's
table bounds (fuzzed in ``tests/test_workloads.py``).  All draws come
from the single passed generator in a fixed order, so a spec is a pure
function of its fields — equal specs give byte-identical traces.

Shared conventions:

* **Table choice** is a zipf over tables (hot tables exist in production;
  RecShard's motivating observation), keyed by ``table_zipf_a``.
* **Hot rows are scattered**, not contiguous: zipf *ranks* map to rows
  through a keyed multiplicative permutation (same trick as the
  calibrated generator in :mod:`repro_torch.core.trace`), so no spatial
  prefetcher can exploit adjacency the real workload doesn't have.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.trace import _zipf_ranks
from repro_torch.workloads.spec import WorkloadSpec, register

_MULT = 2654435761  # Knuth multiplicative-hash constant (odd -> bijective)


def _tables(spec: WorkloadSpec, rng, n: int) -> np.ndarray:
    a = float(spec.param("table_zipf_a", 1.1))
    return (_zipf_ranks(rng, a, spec.n_tables, n)
            % spec.n_tables).astype(np.int32)


def _permute(ranks: np.ndarray, salt, n_rows: int) -> np.ndarray:
    """Keyed permutation rank -> row (vectorized, salt may be per-access)."""
    return (ranks * _MULT + salt) % n_rows


@register("stationary", params=("zipf_a",))
def stationary(spec: WorkloadSpec, rng) -> tuple:
    """Stationary per-table zipf at skew ``zipf_a`` — the steady-state
    power-law regime (no drift; the control arm of the drift tests)."""
    n, R = spec.n_accesses, spec.rows_per_table
    table_id = _tables(spec, rng, n)
    ranks = _zipf_ranks(rng, float(spec.param("zipf_a", 1.05)), R, n)
    salt = rng.integers(0, 2**31, size=spec.n_tables)
    row_id = _permute(ranks, salt[table_id], R)
    return table_id, row_id


@register("diurnal", params=("n_phases", "hot_frac", "p_hot"))
def diurnal(spec: WorkloadSpec, rng) -> tuple:
    """Diurnal hot-set rotation: time splits into ``n_phases`` equal
    phases; each phase has its own hot set of ``hot_frac * rows`` rows per
    table, hit with probability ``p_hot`` (zipf-shaped inside the hot
    set), else a uniform cold draw.  Consecutive phases share no hot rows
    by construction — the wholesale working-set switch the drift detector
    must catch."""
    n, R, T = spec.n_accesses, spec.rows_per_table, spec.n_tables
    n_phases = int(spec.param("n_phases", 4))
    hot = max(1, int(float(spec.param("hot_frac", 0.05)) * R))
    p_hot = float(spec.param("p_hot", 0.9))
    table_id = _tables(spec, rng, n)
    phase = np.minimum(np.arange(n) * n_phases // max(n, 1),
                       n_phases - 1)
    # Phase p's hot rows per table: a disjoint slice of a fixed keyed
    # permutation (disjoint while n_phases * hot <= R).
    salt = rng.integers(0, 2**31, size=T)
    ranks = _zipf_ranks(rng, 1.1, hot, n)
    hot_rows = _permute(phase * hot + ranks, salt[table_id], R)
    cold_rows = rng.integers(0, R, size=n)
    is_hot = rng.random(n) < p_hot
    return table_id, np.where(is_hot, hot_rows, cold_rows)


@register("flash_crowd", params=("zipf_a", "onset", "duration", "p_burst",
                                 "burst_frac"))
def flash_crowd(spec: WorkloadSpec, rng) -> tuple:
    """Flash crowd: a stationary zipf baseline, then at ``onset`` (fraction
    of the trace) a burst window of ``duration`` where ``p_burst`` of
    accesses slam a tiny set of previously-cold rows (``burst_frac`` of
    each table) — the viral-item spike.  After the window the baseline
    resumes (the crowd disperses)."""
    n, R = spec.n_accesses, spec.rows_per_table
    table_id = _tables(spec, rng, n)
    base_ranks = _zipf_ranks(rng, float(spec.param("zipf_a", 1.05)), R, n)
    salt = rng.integers(0, 2**31, size=spec.n_tables)
    base_rows = _permute(base_ranks, salt[table_id], R)
    onset = int(float(spec.param("onset", 0.5)) * n)
    end = min(n, onset + int(float(spec.param("duration", 0.3)) * n))
    burst = max(1, int(float(spec.param("burst_frac", 0.03)) * R))
    # Burst rows come from the *far end* of a second permutation: cold
    # under the baseline zipf (which concentrates on low ranks).
    b_ranks = _zipf_ranks(rng, 1.2, burst, n)
    burst_rows = _permute(R - 1 - b_ranks, salt[table_id] ^ 0x5BF03635, R)
    in_window = (np.arange(n) >= onset) & (np.arange(n) < end)
    hit_burst = in_window & (rng.random(n) <
                             float(spec.param("p_burst", 0.85)))
    return table_id, np.where(hit_burst, burst_rows, base_rows)


@register("multi_tenant", params=("n_tenants", "block", "zipf_a"))
def multi_tenant(spec: WorkloadSpec, rng) -> tuple:
    """Multi-tenant interleave: ``n_tenants`` independent zipfs over
    disjoint per-tenant row permutations, scheduled in coarse blocks of
    ``block`` consecutive accesses (a tenant's requests arrive bursty, not
    access-interleaved).  The aggregate distribution is stationary but the
    *short-window* hot set swings tenant to tenant."""
    n, R = spec.n_accesses, spec.rows_per_table
    n_ten = int(spec.param("n_tenants", 4))
    block = max(1, int(spec.param("block", 512)))
    table_id = _tables(spec, rng, n)
    n_blocks = n // block + 2
    tenant_of_block = rng.integers(0, n_ten, size=n_blocks)
    tenant = tenant_of_block[np.arange(n) // block]
    ranks = _zipf_ranks(rng, float(spec.param("zipf_a", 1.2)), R, n)
    salt = rng.integers(0, 2**31, size=(n_ten, spec.n_tables))
    row_id = _permute(ranks, salt[tenant, table_id], R)
    return table_id, row_id


@register("sustained_overload", params=("zipf_a", "load_x", "hot_frac",
                                        "p_hot_end"))
def sustained_overload(spec: WorkloadSpec, rng) -> tuple:
    """Sustained overload traffic: a stationary zipf baseline whose hot
    set *concentrates* as the surge persists — the fraction of accesses
    slamming a tiny hot set (``hot_frac`` of each table) ramps linearly
    from 0 to ``p_hot_end`` over the trace, modeling the skew
    concentration RecShard observes when traffic spikes.  The ``load_x``
    param is not read here: it rides on the spec for the serving harness
    (:mod:`repro_torch.workloads.overload`), which turns it into an offered
    load of ``load_x`` times modeled compute capacity."""
    n, R = spec.n_accesses, spec.rows_per_table
    table_id = _tables(spec, rng, n)
    ranks = _zipf_ranks(rng, float(spec.param("zipf_a", 1.2)), R, n)
    salt = rng.integers(0, 2**31, size=spec.n_tables)
    base_rows = _permute(ranks, salt[table_id], R)
    hot = max(1, int(float(spec.param("hot_frac", 0.02)) * R))
    h_ranks = _zipf_ranks(rng, 1.3, hot, n)
    hot_rows = _permute(h_ranks, salt[table_id] ^ 0x9E3779B9, R)
    p_hot = np.linspace(0.0, float(spec.param("p_hot_end", 0.5)), n)
    is_hot = rng.random(n) < p_hot
    return table_id, np.where(is_hot, hot_rows, base_rows)


@register("shard_failure", params=("zipf_a", "hot_frac", "p_hot"))
def shard_failure(spec: WorkloadSpec, rng) -> tuple:
    """Traffic for the shard-failover chaos runs: a stationary zipf
    baseline with a *steady* concentrated hot set (``hot_frac`` of each
    table, hit with probability ``p_hot``) — the RecShard-CDF shape that
    makes hot-row replication the failover lever: when a shard dies
    mid-run, the replicated top-k keeps most of this traffic exactly
    answerable from survivors.  The fault timeline itself is not in the
    trace; it rides on the serving harness (:mod:`repro.workloads.chaos`)
    as a :class:`~repro_torch.runtime.faults.FaultPlan`."""
    n, R = spec.n_accesses, spec.rows_per_table
    table_id = _tables(spec, rng, n)
    ranks = _zipf_ranks(rng, float(spec.param("zipf_a", 1.1)), R, n)
    salt = rng.integers(0, 2**31, size=spec.n_tables)
    base_rows = _permute(ranks, salt[table_id], R)
    hot = max(1, int(float(spec.param("hot_frac", 0.03)) * R))
    h_ranks = _zipf_ranks(rng, 1.3, hot, n)
    hot_rows = _permute(h_ranks, salt[table_id] ^ 0x7F4A7C15, R)
    is_hot = rng.random(n) < float(spec.param("p_hot", 0.6))
    return table_id, np.where(is_hot, hot_rows, base_rows)


@register("churn", params=("zipf_a", "churn_per_k"))
def churn(spec: WorkloadSpec, rng) -> tuple:
    """Popularity-decay churn: zipf over a *sliding* rank window — the
    rank->row mapping advances by ``churn_per_k`` rows every 1000
    accesses, so items continuously go stale while fresh ones warm up
    (RecShard's observed slow CDF drift, as opposed to the diurnal
    regime's hard switch)."""
    n, R = spec.n_accesses, spec.rows_per_table
    table_id = _tables(spec, rng, n)
    ranks = _zipf_ranks(rng, float(spec.param("zipf_a", 1.1)), R, n)
    front = (np.arange(n, dtype=np.int64)
             * float(spec.param("churn_per_k", 24.0)) / 1000.0)
    salt = rng.integers(0, 2**31, size=spec.n_tables)
    row_id = _permute(ranks + front.astype(np.int64), salt[table_id], R)
    return table_id, row_id
