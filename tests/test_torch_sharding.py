"""The port's shard placement planner against the JAX package's.

``repro_torch.sharding.embedding_shard`` is a NumPy copy of
``repro.sharding.embedding_shard``: on equal inputs every plan (shard map,
local numbering, per-shard ids, budgets, replica set), every route and
every error must be identical.
"""
import numpy as np
import pytest

from repro.sharding import embedding_shard as J
from repro_torch.sharding import embedding_shard as T

ROWS = [100, 50, 200, 70]
N_VEC = sum(ROWS)


def _freq(seed=1):
    return np.random.default_rng(seed).zipf(1.3, size=N_VEC).astype(np.int64)


def _ids(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(1.15, size=n), N_VEC) - 1
    return rng.permutation(N_VEC)[ranks].astype(np.int64)


def _same_plan(got, want):
    assert got.placement == want.placement
    assert got.n_shards == want.n_shards
    for f in ("shard_of", "local_of", "capacities"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert len(got.global_ids) == len(want.global_ids)
    for a, b in zip(got.global_ids, want.global_ids):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if want.replicated_ids is None:
        assert got.replicated_ids is None
    else:
        np.testing.assert_array_equal(got.replicated_ids,
                                      want.replicated_ids)
    np.testing.assert_array_equal(got.shard_rows, want.shard_rows)
    np.testing.assert_array_equal(got.replica_mask(), want.replica_mask())


@pytest.mark.parametrize("placement", J.PLACEMENTS)
@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("replicate_hot", [0, 17])
def test_plans_equal_jax(placement, n_shards, replicate_hot):
    kw = dict(frequencies=_freq(), replicate_hot=replicate_hot)
    got = T.make_plan(ROWS, n_shards, 64, placement, **kw)
    want = J.make_plan(ROWS, n_shards, 64, placement, **kw)
    got.check()
    _same_plan(got, want)
    ids = _ids()
    for a, b in zip(got.route(ids), want.route(ids)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("placement", ["row", "freq"])
def test_weighted_budgets_equal_jax(placement):
    kw = dict(frequencies=_freq(2), fast_weights=[3.0, 1.0, 0.5])
    _same_plan(T.make_plan(ROWS, 3, 60, placement, **kw),
               J.make_plan(ROWS, 3, 60, placement, **kw))


def test_tiny_tables_rebalance_like_jax():
    # Few vectors for the shard count: the hash placement's rebalance loop.
    _same_plan(T.make_plan([3, 4], 5, 5, "hash"),
               J.make_plan([3, 4], 5, 5, "hash"))


@pytest.mark.parametrize("sample_frac", [0.25, 0.5, 1.0])
def test_trace_frequencies_equal_jax(sample_frac):
    ids = _ids(1500, seed=3)
    np.testing.assert_array_equal(
        T.trace_frequencies(ids, N_VEC, sample_frac),
        J.trace_frequencies(ids, N_VEC, sample_frac))


@pytest.mark.parametrize("args,kw,match", [
    ((ROWS, 2, 64, "zigzag"), {}, "unknown placement"),
    ((ROWS, 2, 64, "freq"), {}, "needs per-row frequencies"),
    ((ROWS, 8, 64, "table"), {}, "more shards"),
    ((ROWS, 2, 64, "freq"), dict(frequencies=np.ones(3)), "frequencies cover"),
    (([2], 4, 4, "row"), {}, "cannot span"),
    ((ROWS, 0, 4, "row"), {}, "n_shards must be"),
    ((ROWS, 2, 64, "row"), dict(replicate_hot=4), "replicate_hot needs"),
    ((ROWS, 2, 64, "row"), dict(replicate_hot=4, frequencies=np.ones(3)),
     "frequencies cover"),
])
def test_plan_errors_equal_jax(args, kw, match):
    for mod in (T, J):
        with pytest.raises(ValueError, match=match):
            mod.make_plan(*args, **kw)
