"""The port's mesh and row-sharded DLRM serving against the JAX package's,
on the CPU.

The multi-rank reference is JAX's ``dlrm_forward(sharded_lookup=True)``
and ``embedding_lookup_rowsharded`` on a (2, 2) mesh of four CPU devices,
run in a subprocess of its own with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (the flag is set
only inside that process).  The port runs as four ``gloo`` processes on
the CPU (``tests/torch_dist_ranks.py``) on a ``file://`` store, each rank
holding its quarter of the batch and half of every table's rows; both
read the same JAX parameters and numpy inputs, and one spawn of each
serves every case.  The single-rank reference is the same JAX code on a
(1, 1) mesh in this process.

Ids are drawn in range and over ``[-2, R + 2)``: the row-sharded lookup
drops an id that no shard owns (JAX's ``where(ok, rows, 0)``), where the
dense lookup wraps or clamps it.  Tolerances: fp32 1e-5, bf16 2e-2 (the
port sums the pooled rows and their all-reduce in fp32 and rounds once,
where JAX sums each shard and its ``psum`` in bf16).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_ranks as ranks
from repro.configs import get_config as jax_get_config
from repro.launch.mesh import make_host_mesh as jax_make_host_mesh
from repro.models.dlrm import dlrm_forward as jax_dlrm_forward
from repro.models.dlrm import \
    embedding_lookup_rowsharded as jax_lookup_rowsharded
from repro.models.dlrm import init_dlrm as jax_init_dlrm
from repro.sharding import partition as jax_partition
from repro_torch.configs.base import RunConfig
from repro_torch.distributed import mesh as M
from repro_torch.distributed.fault_tolerance import (ElasticMesh,
                                                     elastic_mesh_shape)
from repro_torch.kernels import ops, ref
from repro_torch.models import dlrm as D
from repro_torch.models.model_api import build

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B = 8  # global batch: 4 rows a data rank on the (2, 2) mesh

# JAX on a (2, 2) mesh of four CPU devices: the sharded lookup and
# forward on the test's parameters and inputs, and how make_host_mesh and
# ElasticMesh factor four devices.
JAX_4DEV = textwrap.dedent("""
    import dataclasses, sys
    import jax, jax.numpy as jnp, ml_dtypes, numpy as np
    from repro.configs import get_config
    from repro.distributed.fault_tolerance import ElasticMesh
    from repro.launch.mesh import make_host_mesh
    from repro.models.dlrm import dlrm_forward, embedding_lookup_rowsharded
    from repro.sharding import partition as sp

    assert len(jax.devices()) == 4
    data, out = np.load(sys.argv[1]), {}
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    out["device_ids"] = np.array([[d.id for d in row]
                                  for row in mesh.devices])
    for mp in MODEL_PARALLEL:
        out[f"host_mesh/{mp}"] = np.array(list(make_host_mesh(mp)
                                               .shape.values()))
        out[f"elastic_mesh/{mp}"] = np.array(list(ElasticMesh(mp).make()
                                                  .shape.values()))
    for dt in DTYPES:
        cfg = dataclasses.replace(get_config("dlrm-recmg").reduced(),
                                  param_dtype=dt, compute_dtype=dt)

        def arr(key):
            a = data[f"{dt}/{key}"]
            return jnp.asarray(a.view(ml_dtypes.bfloat16)
                               if dt == "bfloat16" else a)

        n = {k: int(data[f"{dt}/n_{k}"]) for k in ("bottom", "top")}
        params = {"emb": arr("emb"),
                  **{k: {"w": [arr(f"{k}/w{i}") for i in range(n[k])],
                         "b": [arr(f"{k}/b{i}") for i in range(n[k])]}
                     for k in ("bottom", "top")}}
        for case in CASES:
            dense = jnp.asarray(data[f"dense/{case}"])
            idx = jnp.asarray(data[f"idx/{case}"])
            with sp.activation_sharding(mesh):
                logits = dlrm_forward(params, cfg, dense, idx,
                                      sharded_lookup=True)
            pooled = embedding_lookup_rowsharded(params["emb"], idx, mesh)
            out[f"{dt}/{case}/logits"] = np.asarray(logits, np.float32)
            out[f"{dt}/{case}/pooled"] = np.asarray(pooled, np.float32)
    np.savez(sys.argv[2], **out)
""").replace("MODEL_PARALLEL", repr(ranks.MODEL_PARALLEL)) \
    .replace("DTYPES", repr(ranks.DTYPES)).replace("CASES", repr(ranks.CASES))


@lru_cache(maxsize=None)
def _jax_params(dtype):
    jcfg = dataclasses.replace(jax_get_config("dlrm-recmg").reduced(),
                               param_dtype=dtype, compute_dtype=dtype)
    return jcfg, jax.tree_util.tree_map(
        np.asarray, jax_init_dlrm(jax.random.PRNGKey(0), jcfg))


def _inputs(case, b=B, seed=0):
    """Dense features and ids of ``b`` queries: ids in ``[0, R)`` or, for
    ``out``, in ``[-2, R + 2)`` (some owned by no shard)."""
    cfg = ranks.cfg_for("float32")
    r = cfg.rows_per_table
    lo, hi = (0, r) if case == "in" else (-2, r + 2)
    rng = np.random.default_rng(seed + (case == "out"))
    dense = rng.normal(size=(b, cfg.dense_features)).astype(np.float32)
    idx = rng.integers(lo, hi, (b, cfg.n_tables, cfg.multi_hot)) \
        .astype(np.int32)
    return dense, idx


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One run of each side on the (2, 2) mesh: ``(JAX's results, every
    rank's results)``.  JAX's subprocess runs while the ranks do."""
    work = tmp_path_factory.mktemp("dist")
    data = {}
    for dtype in ranks.DTYPES:
        _, tree = _jax_params(dtype)
        data[f"{dtype}/emb"] = _bits(tree["emb"])
        for k in ("bottom", "top"):
            data[f"{dtype}/n_{k}"] = np.array(len(tree[k]["w"]))
            for i, (w, b) in enumerate(zip(tree[k]["w"], tree[k]["b"])):
                data[f"{dtype}/{k}/w{i}"] = _bits(w)
                data[f"{dtype}/{k}/b{i}"] = _bits(b)
    for case in ranks.CASES:
        data[f"dense/{case}"], data[f"idx/{case}"] = _inputs(case)
    inputs = work / "inputs.npz"
    np.savez(inputs, **data)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": str(ROOT / "src")}
    jax_out = work / "jax.npz"
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_4DEV, str(inputs), str(jax_out)],
        env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    # A rank that raises fails the spawn, and with it every test here.
    mp.spawn(ranks.rank_main, args=(4, str(work / "store"), str(inputs),
                                    str(work)), nprocs=4, join=True)
    log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log
    return (dict(np.load(jax_out)),
            [dict(np.load(work / f"rank{r}.npz")) for r in range(4)])


# ---------------------------------------------------------------------------
# Four ranks on a (2, 2) mesh against JAX on four devices.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ranks.CASES)
@pytest.mark.parametrize("dtype", ranks.DTYPES)
def test_sharded_forward_matches_jax_on_four_devices(four_ranks, dtype,
                                                     case):
    """``build(run=RunConfig(dlrm_sharded_lookup=True)).prefill`` on each
    rank's quarter of the batch, the logits gathered over ``data``."""
    jx, by_rank = four_ranks
    want = jx[f"{dtype}/{case}/logits"]
    for res in by_rank:  # every rank gathers the whole batch
        got = res[f"{dtype}/{case}/logits"]
        assert got.shape == (B,)
        np.testing.assert_allclose(got, want, rtol=TOL[dtype],
                                   atol=TOL[dtype])


@pytest.mark.parametrize("case", ranks.CASES)
@pytest.mark.parametrize("dtype", ranks.DTYPES)
def test_rowsharded_lookup_matches_jax_on_four_devices(four_ranks, dtype,
                                                       case):
    jx, by_rank = four_ranks
    got = by_rank[0][f"{dtype}/{case}/pooled"]
    want = jx[f"{dtype}/{case}/pooled"]
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    if case == "out":
        # Dropped, not wrapped or clamped: the dense lookup differs here.
        _, tree = _jax_params(dtype)
        dense = D.embedding_lookup(
            D.params_from_jax(tree, "cpu")["emb"],
            torch.from_numpy(_inputs(case)[1])).float().numpy()
        assert np.abs(dense - got).max() > 10 * TOL[dtype]


def test_ranks_sit_where_jax_puts_its_devices(four_ranks):
    """Rank r is at (r // model, r % model), as device r is in JAX's
    ``make_mesh((2, 2))``."""
    jx, by_rank = four_ranks
    for r, res in enumerate(by_rank):
        d, m = res["coords"]
        assert jx["device_ids"][d, m] == r


@pytest.mark.parametrize("mp_", ranks.MODEL_PARALLEL)
def test_mesh_factoring_matches_jax_on_four_devices(four_ranks, mp_):
    jx, by_rank = four_ranks
    for res in by_rank:
        for kind in ("host_mesh", "elastic_mesh"):
            np.testing.assert_array_equal(res[f"{kind}/{mp_}"],
                                          jx[f"{kind}/{mp_}"])


def test_uneven_rows_raise_on_the_ranks(four_ranks):
    _, by_rank = four_ranks
    assert all(bool(res["uneven_raises"]) for res in by_rank)


# ---------------------------------------------------------------------------
# One rank, in this process, against JAX on a (1, 1) mesh.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ranks.CASES)
@pytest.mark.parametrize("dtype", ranks.DTYPES)
def test_single_rank_matches_jax(dtype, case):
    jcfg, tree = _jax_params(dtype)
    cfg = ranks.cfg_for(dtype)
    dense, idx = _inputs(case, b=5)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    with jax_partition.activation_sharding(jmesh):
        want = jax_dlrm_forward(jax.tree_util.tree_map(jnp.asarray, tree),
                                jcfg, jnp.asarray(dense), jnp.asarray(idx),
                                sharded_lookup=True)
    want_pool = jax_lookup_rowsharded(jnp.asarray(tree["emb"]),
                                      jnp.asarray(idx), jmesh)
    params = D.params_from_jax(tree, "cpu")
    mesh = M.make_host_mesh()
    assert (mesh.data, mesh.model, mesh.model_group) == (1, 1, None)
    with M.activation_sharding(mesh):
        got = D.dlrm_forward(params, cfg, torch.from_numpy(dense),
                             torch.from_numpy(idx), sharded_lookup=True)
    pool = D.embedding_lookup_rowsharded(params["emb"], torch.from_numpy(idx),
                                         mesh, rows=cfg.rows_per_table)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(pool.float().numpy(),
                               np.asarray(want_pool, np.float32),
                               rtol=tol, atol=tol)


def test_one_rank_in_range_equals_the_dense_lookup_bit_for_bit():
    """With one model rank and every id in range, the shard window is
    ``gather_pool`` itself: the same sums in the same order."""
    cfg = ranks.cfg_for("float32")
    params = D.init_dlrm(cfg, seed=3, device="cpu")
    dense, idx = (torch.from_numpy(a) for a in _inputs("in", b=6))
    with M.activation_sharding(M.make_host_mesh()):
        got = D.dlrm_forward(params, cfg, dense, idx, sharded_lookup=True)
    assert torch.equal(got, D.dlrm_forward(params, cfg, dense, idx))


# ---------------------------------------------------------------------------
# Refusals.
# ---------------------------------------------------------------------------

def test_sharded_lookup_without_a_mesh_raises():
    cfg = ranks.cfg_for("float32")
    params = D.init_dlrm(cfg, device="cpu")
    dense, idx = (torch.from_numpy(a) for a in _inputs("in", b=2))
    assert M.active_mesh() is None
    with pytest.raises(RuntimeError, match="mesh scope"):
        D.dlrm_forward(params, cfg, dense, idx, sharded_lookup=True)
    bundle = build(cfg, "cpu", RunConfig(dlrm_sharded_lookup=True))
    with pytest.raises(RuntimeError, match="mesh scope"):
        bundle.prefill(params, {"dense": dense, "sparse": idx})


def test_rows_that_do_not_split_over_the_model_axis_raise():
    two = M.Mesh(data=1, model=2, rank=1)
    assert D.shard_rows(256, two) == (128, 256)
    with pytest.raises(ValueError, match="evenly"):
        D.shard_rows(255, two)
    emb = torch.zeros((2, 100, 4))
    with pytest.raises(ValueError, match="owns 64"):
        D.embedding_lookup_rowsharded(emb, torch.zeros((1, 2, 3),
                                                       dtype=torch.int32),
                                      two, rows=128)


def test_training_through_the_sharded_lookup_on_one_rank():
    """On a (1, 1) mesh with ids in range, the sharded loss and its
    gradients are the dense lookup's bit for bit, through ``dlrm_loss``,
    the bundle's loss and ``ops.gather_pool_shard`` under autograd (the
    four-rank training: ``test_torch_distributed_train.py``)."""
    cfg = ranks.cfg_for("float32")
    params = D.init_dlrm(cfg, device="cpu")
    dense, idx = (torch.from_numpy(a) for a in _inputs("in", b=2))
    label = torch.tensor([1.0, 0.0])
    grads = []
    for sharded in (False, True):
        emb = params["emb"].clone().requires_grad_(True)
        with M.activation_sharding(M.make_host_mesh()):
            loss = D.dlrm_loss({**params, "emb": emb}, cfg, dense, idx,
                               label, sharded_lookup=sharded)
            bundle_loss = build(cfg, "cpu", RunConfig(
                dlrm_sharded_lookup=sharded)).loss(
                    {**params, "emb": emb},
                    {"dense": dense, "sparse": idx, "label": label})
        assert torch.equal(loss, bundle_loss)
        grads.append((loss, *torch.autograd.grad(loss, [emb])))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])
    table = params["emb"].reshape(-1, cfg.emb_dim).clone().requires_grad_()
    out = ops.gather_pool_shard(table, torch.zeros((1, 2), dtype=torch.int32))
    assert out.requires_grad


def test_quantized_tables_have_no_sharded_lookup():
    cfg = ranks.cfg_for("float32")
    qparams = D.quantize_tables(D.init_dlrm(cfg, device="cpu"))
    dense, idx = (torch.from_numpy(a) for a in _inputs("in", b=2))
    mesh = M.make_host_mesh()
    with pytest.raises(NotImplementedError, match="JAX has none"):
        D.shard_params(qparams, mesh)
    with M.activation_sharding(mesh):
        with pytest.raises(NotImplementedError, match="JAX has none"):
            D.dlrm_forward(qparams, cfg, dense, idx, sharded_lookup=True)


@pytest.mark.parametrize("kw,err,match", [
    (dict(backend="mpi"), ValueError, "expected one of"),
    (dict(backend="nccl", device="cpu"), ValueError, "CUDA devices"),
    (dict(backend="gloo", rank=None), ValueError, "RANK is not set"),
])
def test_init_distributed_refuses(monkeypatch, tmp_path, kw, err, match):
    monkeypatch.delenv("RANK", raising=False)
    args = {**dict(init_method=f"file://{tmp_path}/store", rank=0,
                   world_size=1, device="cpu"), **kw}
    with pytest.raises(err, match=match):
        M.init_distributed(**args)
    assert not torch.distributed.is_initialized()


def test_init_distributed_defaults_to_the_card(tmp_path):
    """No rank quietly runs on the CPU: without CUDA the default device
    raises before any process group starts."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_distributed("gloo", f"file://{tmp_path}/store", 0, 1)
    assert not torch.distributed.is_initialized()


def test_init_distributed_reads_torchrun_env(monkeypatch, tmp_path):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    try:
        dev = M.init_distributed("gloo", f"file://{tmp_path}/store",
                                 device="cpu")
        assert dev == torch.device("cpu")
        assert torch.distributed.get_world_size() == 1
        mesh = M.make_host_mesh(4)
        assert (mesh.data, mesh.model, mesh.rank) == (1, 1, 0)
        assert mesh.model_group is not None
    finally:
        M.close_distributed()


def test_nccl_refuses_two_ranks_on_one_device():
    assert M.shared_devices(["h/cuda:0", "h/cuda:1"]) == []
    assert M.shared_devices(["h/cuda:0", "h/cuda:0", "g/cuda:0"]) == \
        ["h/cuda:0"]


# ---------------------------------------------------------------------------
# The mesh rules, the scope, the shard's parameters and the window's twin.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_rules_for_every_world_size(n):
    """``gcd`` for ``make_host_mesh``, decrement-until-it-divides for
    ``ElasticMesh``: they differ, e.g. at n = 6 and mp = 4 (2 against 3)."""
    for mp_ in range(1, 9):
        d, m = M.host_mesh_shape(n, mp_)
        assert d * m == n and m == max(k for k in range(1, mp_ + 1)
                                       if n % k == 0 and mp_ % k == 0)
        d, m = elastic_mesh_shape(n, mp_)
        assert d * m == n and m == max(k for k in range(1, mp_ + 1)
                                       if n % k == 0)
    assert M.host_mesh_shape(6, 4) == (3, 2)
    assert elastic_mesh_shape(6, 4) == (2, 3)


def test_one_process_meshes_match_jax():
    """Outside a process group the mesh is this process, (1, 1), as JAX's
    meshes are over this test process's one device."""
    for mp_ in ranks.MODEL_PARALLEL:
        want = tuple(jax_make_host_mesh(mp_).shape.values())
        assert tuple(M.make_host_mesh(mp_).shape.values()) == want
        assert tuple(ElasticMesh(mp_).make().shape.values()) == want
    with pytest.raises(ValueError, match="does not cover"):
        M.make_mesh(2, 1)


def test_activation_sharding_nests_and_restores():
    a, b = M.Mesh(1, 1, 0), M.Mesh(1, 1, 0)
    assert M.active_mesh() is None
    with M.activation_sharding(a):
        with M.activation_sharding(b):
            assert M.active_mesh() is b
        assert M.active_mesh() is a
    assert M.active_mesh() is None


@pytest.mark.parametrize("dtype", ranks.DTYPES)
def test_init_rows_is_the_slice_of_the_whole_draw(dtype):
    cfg = ranks.cfg_for(dtype)
    whole = D.init_dlrm(cfg, seed=5, device="cpu")
    half = D.init_dlrm(cfg, seed=5, device="cpu", rows=(128, 256))
    assert torch.equal(half["emb"].view(torch.int16) if dtype == "bfloat16"
                       else half["emb"], whole["emb"][:, 128:256].view(
                           torch.int16) if dtype == "bfloat16"
                       else whole["emb"][:, 128:256])
    for k in ("bottom", "top"):
        for x, y in zip(half[k]["w"] + half[k]["b"],
                        whole[k]["w"] + whole[k]["b"]):
            assert torch.equal(x, y)
    mesh = M.Mesh(data=1, model=2, rank=1)
    shard = D.shard_params(whole, mesh)["emb"]
    assert shard.is_contiguous() and torch.equal(shard, half["emb"])
    with pytest.raises(ValueError, match="not within"):
        D.init_dlrm(cfg, device="cpu", rows=(0, cfg.rows_per_table + 1))


@pytest.mark.parametrize("dtype", ranks.DTYPES)
def test_params_from_jax_rows_keep_the_bits_of_the_slice(dtype):
    _, tree = _jax_params(dtype)
    whole = D.params_from_jax(tree, "cpu")
    part = D.params_from_jax(tree, "cpu", rows=(64, 192))
    assert torch.equal(part["emb"], whole["emb"][:, 64:192])
    assert part["emb"].is_contiguous()
    for k in ("bottom", "top"):
        for x, y in zip(part[k]["w"], whole[k]["w"]):
            assert torch.equal(x, y)


def test_flat_shard_ids_mark_what_the_shard_does_not_own():
    idx = torch.tensor([[[0, 3, 4, 7], [-1, 8, 5, 2]]], dtype=torch.int32)
    flat = D._flat_shard_ids(idx, 2, 4, 4)  # rows [4, 8) of 8, 2 tables
    assert flat.tolist() == [[-1, -1, 0, 3], [-1, -1, 5, -1]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_twin_matches_a_numpy_loop(dtype):
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.normal(size=(37, 6)).astype(np.float32)) \
        .to(dtype)
    idx = rng.integers(-3, 37, (11, 5)).astype(np.int32)
    idx[0] = -1  # a row of nothing owned pools to zeros
    want = np.zeros((11, 6), np.float32)
    rows = table.float().numpy()
    for b in range(11):
        for p in range(5):
            if idx[b, p] >= 0:
                want[b] += rows[idx[b, p]]
    got = ref.gather_pool_shard_ref(table, torch.from_numpy(idx))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(ops.gather_pool_shard(table, torch.from_numpy(idx)),
                       got)
    inrange = torch.from_numpy(np.abs(idx))
    assert torch.equal(ref.gather_pool_shard_ref(table, inrange),
                       ref.gather_pool_ref(table, inrange))
