"""The port's DLRM against the JAX package's, on JAX's parameters.

``params_from_jax(init_dlrm(PRNGKey(0), cfg))`` gives both packages the
same weights; the dense and sparse inputs are numpy draws.  Tolerances: at
fp32 (``reduced()``) rtol/atol 1e-5, the sums running in another order; at
bf16 params and compute rtol/atol 2e-2, because the two frameworks round
to bf16 at different points (the port sums the pooled rows in fp32 and
rounds once, XLA sums in bf16).
"""
import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import _dense_forward as jax_dense_forward
from repro.models.dlrm import dlrm_forward as jax_dlrm_forward
from repro.models.dlrm import init_dlrm as jax_init_dlrm
from repro_torch.configs import get_config
from repro_torch.launch.serve import _dense_forward
from repro_torch.models.dlrm import (dlrm_forward, embedding_lookup,
                                     init_dlrm, num_interactions,
                                     params_from_jax)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _cfg(dtype):
    cfg = get_config("dlrm-recmg").reduced()
    return dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)


@lru_cache(maxsize=None)
def _both(dtype):
    """(port cfg, JAX cfg, JAX params, the port's copy of them)."""
    cfg = _cfg(dtype)
    jcfg = dataclasses.replace(jax_get_config("dlrm-recmg").reduced(),
                               param_dtype=dtype, compute_dtype=dtype)
    jp = jax_init_dlrm(jax.random.PRNGKey(0), jcfg)
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return cfg, jcfg, jp, p


def _inputs(cfg, b=6, seed=0):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(b, cfg.dense_features)).astype(np.float32)
    idx = rng.integers(0, cfg.rows_per_table,
                       (b, cfg.n_tables, cfg.multi_hot)).astype(np.int32)
    return dense, idx


def test_configs_match_jax():
    for name in ("dlrm-recmg",):
        want = jax_get_config(name)
        got = get_config(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert dataclasses.asdict(got.reduced()) == \
            dataclasses.asdict(want.reduced())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_keep_bits(dtype):
    _, _, jp, p = _both(dtype)
    assert p["emb"].dtype == {"float32": torch.float32,
                              "bfloat16": torch.bfloat16}[dtype]
    np.testing.assert_array_equal(
        p["emb"].float().numpy(), np.asarray(jp["emb"].astype(jnp.float32)))
    for k in ("bottom", "top"):
        for a, b in zip(p[k]["w"], jp[k]["w"]):
            assert tuple(a.shape) == b.shape  # (in, out), as JAX keeps it
            np.testing.assert_array_equal(
                a.float().numpy(), np.asarray(b.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dlrm_forward_matches_jax(dtype):
    cfg, jcfg, jp, p = _both(dtype)
    dense, idx = _inputs(cfg)
    want = np.asarray(jax_dlrm_forward(jp, jcfg, jnp.asarray(dense),
                                       jnp.asarray(idx)))
    got = dlrm_forward(p, cfg, torch.from_numpy(dense),
                       torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == (dense.shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_forward_matches_jax(dtype):
    cfg, jcfg, jp, p = _both(dtype)
    rng = np.random.default_rng(1)
    dense = rng.normal(size=(5, cfg.dense_features)).astype(np.float32)
    pooled = rng.normal(size=(5, cfg.n_tables, cfg.emb_dim)) \
        .astype(np.float32)
    want = np.asarray(jax_dense_forward(jp, jcfg, jnp.asarray(dense),
                                        jnp.asarray(pooled))
                      .astype(jnp.float32))
    got = _dense_forward(p, cfg, torch.from_numpy(dense),
                         torch.from_numpy(pooled)).float()
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_embedding_lookup_is_one_pooled_gather():
    cfg = _cfg("float32")
    p = init_dlrm(cfg, seed=0, device="cpu")
    _, idx = _inputs(cfg, b=3, seed=2)
    got = embedding_lookup(p["emb"], torch.from_numpy(idx))
    emb = p["emb"].numpy()
    want = np.stack([emb[t][idx[:, t]].sum(axis=1)
                     for t in range(cfg.n_tables)], axis=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_init_dlrm_shapes_and_seed():
    cfg = _cfg("bfloat16")
    a = init_dlrm(cfg, seed=0, device="cpu")
    b = init_dlrm(cfg, seed=0, device="cpu")
    assert a["emb"].shape == (cfg.n_tables, cfg.rows_per_table, cfg.emb_dim)
    assert a["emb"].dtype == torch.bfloat16
    assert a["top"]["w"][0].shape[0] == cfg.emb_dim + num_interactions(cfg)
    assert torch.equal(a["emb"], b["emb"])
    assert not torch.equal(a["emb"], init_dlrm(cfg, seed=1,
                                               device="cpu")["emb"])


def test_embedding_lookup_out_of_range_ids_match_jax():
    """Negative ids count from the end and ids past the table clamp, as
    jnp indexing treats them."""
    from repro.models.dlrm import embedding_lookup as jax_embedding_lookup

    cfg, _, jp, p = _both("float32")
    _, idx = _inputs(cfg, b=2, seed=3)
    idx[0, :, 0] = -1
    idx[1, :, 1] = cfg.rows_per_table + 7
    want = np.asarray(jax_embedding_lookup(jp["emb"], jnp.asarray(idx)))
    got = embedding_lookup(p["emb"], torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
