"""DLRM's gradients at ids out of range against JAX's, on the CPU.

JAX's dense lookup indexes each table with ``jnp`` indexing: a negative
id counts from the end and one past the end is clamped to the last row in
the forward, but the transpose of that clamped gather is a scatter that
drops the id, so the last row takes no gradient from it.  The port's
dense lookup (``embedding_lookup``), and its placed lookup under the dense
flag (``embedding_lookup_placed`` on a one-rank mesh), keep both halves;
the row-sharded flag drops such ids in both directions, as JAX's
``shard_map`` lookup does.  Reduced fp32 dlrm-recmg from JAX's
parameters, ids over [-2, R + 2): the loss and every gradient within
1e-5 of ``jax.grad``'s (of each leaf's largest magnitude, or 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import dlrm as JD
from repro_torch.configs import get_config
from repro_torch.distributed import mesh as M
from repro_torch.models import dlrm as D
from repro_torch.tree import named_leaves

TOL = 1e-5
B = 8


def _case():
    jcfg = jax_get_config("dlrm-recmg").reduced()
    cfg = get_config("dlrm-recmg").reduced()
    tree = JD.init_dlrm(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(7)
    batch = {"dense": rng.normal(size=(B, cfg.dense_features)).astype(
                 np.float32),
             "sparse": rng.integers(-2, cfg.rows_per_table + 2, (
                 B, cfg.n_tables, cfg.multi_hot)).astype(np.int32),
             "label": (rng.random(B) < 0.5).astype(np.float32)}
    return jcfg, cfg, tree, batch


@pytest.mark.parametrize("placed", [False, True])
def test_dense_lookup_drops_the_gradient_of_a_clamped_id(placed):
    jcfg, cfg, tree, batch = _case()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want = jax.value_and_grad(
        lambda p: JD.dlrm_loss(p, jcfg, jb["dense"], jb["sparse"],
                               jb["label"]))(tree)
    params = D.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                               "cpu")
    if placed:
        params = D.place_tables(params, M.Mesh(1, 1, 0))
    names = [n for n, _ in named_leaves(params)]
    ps = [p.requires_grad_(True) for _, p in named_leaves(params)]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = D.dlrm_loss(params, cfg, tb["dense"], tb["sparse"], tb["label"])
    grads = torch.autograd.grad(loss, ps)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=TOL)
    flat = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(want)[0]}
    for n, g in zip(names, grads):
        w = flat[n]
        bound = TOL * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g.numpy() - w).max()) <= bound, n
    # The batch reads past the end of some table: the case in which the
    # gradient's drop and the forward's clamp part ways.
    past = (batch["sparse"] >= cfg.rows_per_table).any(axis=(0, 2))
    assert past.any()
