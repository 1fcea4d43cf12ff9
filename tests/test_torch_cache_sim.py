"""The port's cache-policy baselines and linear performance model against
the JAX package's.

``repro_torch.core.cache_sim`` and ``repro_torch.core.perf_model`` are
NumPy copies: on an equal key stream every policy of ``POLICIES`` (and the
Belady replay) gives the same hit mask and ``simulate`` the same
``SimResult``, with and without each of the port's prefetchers (seeded
RNGs and signature tables included); ``fit_perf_model`` agrees within
1e-12.
"""
import numpy as np
import pytest

from repro.core import cache_sim as J
from repro.core import perf_model as JPM
from repro.core import prefetchers as JPF
from repro.core.trace import TraceGenConfig as JaxTraceGenConfig
from repro.core.trace import generate_trace as jax_generate_trace
from repro_torch.core import cache_sim as T
from repro_torch.core import perf_model as TPM
from repro_torch.core import prefetchers as TPF
from repro_torch.core.trace import TraceGenConfig, generate_trace

CAP = 96


def _keys(n=4000):
    kw = dict(n_tables=4, rows_per_table=400, n_accesses=n, seed=3,
              drift_every=10**9)
    keys = generate_trace(TraceGenConfig(**kw)).global_id
    np.testing.assert_array_equal(
        keys, jax_generate_trace(JaxTraceGenConfig(**kw)).global_id)
    return keys


def test_registries_equal_jax():
    assert sorted(T.POLICIES) == sorted(J.POLICIES)
    for name, cls in T.POLICIES.items():
        assert cls.name == J.POLICIES[name].name


@pytest.mark.parametrize("name", sorted(J.POLICIES) + ["belady"])
@pytest.mark.parametrize("cap", [7, CAP])
def test_policy_hit_masks_equal_jax(name, cap):
    keys = _keys()
    got = T.make_cache(name, cap, keys)
    want = J.make_cache(name, cap, keys)
    np.testing.assert_array_equal(got.access_many(keys),
                                  want.access_many(keys))
    assert T.simulate(keys, T.make_cache(name, cap, keys)).as_dict() == \
        J.simulate(keys, J.make_cache(name, cap, keys)).as_dict()


@pytest.mark.parametrize("prefetcher", sorted(JPF.PREFETCHERS))
@pytest.mark.parametrize("name", ["lru_fa", "lru_32w", "drrip", "hawkeye",
                                  "mockingjay"])
def test_simulate_with_prefetcher_equals_jax(name, prefetcher):
    keys = _keys(1500)
    got = T.simulate(keys, T.make_cache(name, CAP),
                     TPF.make_prefetcher(prefetcher))
    want = J.simulate(keys, J.make_cache(name, CAP),
                      JPF.make_prefetcher(prefetcher))
    assert got.as_dict() == want.as_dict()
    assert got.prefetch_useful == want.prefetch_useful


@pytest.mark.parametrize("name", ["brrip", "drrip"])
def test_seeded_policies_depend_on_the_seed_like_jax(name):
    keys = _keys(3000)
    for seed in (0, 5):
        got = T.POLICIES[name](CAP, seed=seed)
        want = J.POLICIES[name](CAP, seed=seed)
        np.testing.assert_array_equal(got.access_many(keys),
                                      want.access_many(keys))


def test_helpers_equal_jax():
    keys = _keys(2000)
    np.testing.assert_array_equal(T.top_ids_by_count(keys, 50),
                                  J.top_ids_by_count(keys, 50))
    pf = np.sort(np.unique(keys[::7]))
    np.testing.assert_array_equal(T.isin_sorted(pf, keys),
                                  J.isin_sorted(pf, keys))
    hits = T.make_cache("lru_fa", CAP).access_many(keys)
    a, b = set(keys[:300:3].tolist()), set(keys[:300:3].tolist())
    assert T.attribute_prefetch_hits(keys, hits, a) == \
        J.attribute_prefetch_hits(keys, hits, b)
    assert a == b


@pytest.mark.parametrize("noise", [0.0, 0.5, 3.0])
def test_fit_perf_model_equals_jax(noise):
    rng = np.random.default_rng(11)
    hr = rng.uniform(0.1, 0.9, 12)
    lat = 200.0 - 120.0 * hr + rng.normal(size=12) * noise
    got, want = TPM.fit_perf_model(hr, lat), JPM.fit_perf_model(hr, lat)
    for k, v in want.as_dict().items():
        assert abs(got.as_dict()[k] - v) <= 1e-12, k
    np.testing.assert_allclose(got.predict(hr), want.predict(hr),
                               rtol=0, atol=1e-12)
    assert isinstance(got, TPM.LinearPerfModel)
