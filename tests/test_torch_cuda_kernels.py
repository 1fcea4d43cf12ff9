"""repro_torch's CUDA kernels against their plain PyTorch versions, on the
card.  These tests need an NVIDIA GPU and nvcc and skip without them; the
file imports no JAX, so it runs on a machine that has none:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_kernels.py -q

Tolerances: the row gathers are pure copies, so bit-exact; the pooled
gather sums P rows in fp32 in another order than ``torch.sum``, so fp32
rtol 1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.recmg import frequency_outputs
from repro_torch.core.tiered import TieredEmbeddingStore
from repro_torch.core.trace import TraceGenConfig, generate_trace
from repro_torch.kernels import embedding_gather as eg
from repro_torch.kernels import ref
from repro_torch.models.dlrm import dlrm_forward, init_dlrm

pytestmark = pytest.mark.cuda

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    # fp32 products stay fp32 on the card (no TF32) in every comparison.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _table(n, d, dtype, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)) \
        .to(dtype).to(dev)


@pytest.mark.parametrize("d", [16, 128, 20])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gather_rows_bit_exact(dev, dt, d):
    table = _table(300, d, DTYPES[dt], 0, dev)
    idx = torch.from_numpy(np.random.default_rng(1).integers(
        0, 300, 1000).astype(np.int32)).to(dev)
    n0 = eg.gather_rows.launches
    out = eg.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert eg.gather_rows.launches == n0 + 1
    assert torch.equal(out, ref.gather_rows_ref(table, idx))


@pytest.mark.parametrize("with_ov", [False, True])
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gather_rows_expand_bit_exact(dev, dt, d, with_ov):
    rng = np.random.default_rng(2)
    table = _table(64, d, DTYPES[dt], 3, dev)
    u, m = 50, 700
    slots = torch.from_numpy(rng.permutation(64)[:u].astype(np.int32)).to(dev)
    inv = torch.from_numpy(rng.integers(0, u, m).astype(np.int32)).to(dev)
    ov = hr = None
    if with_ov:
        ov = torch.from_numpy(rng.random(u) < 0.3).to(dev)
        hr = _table(u, d, DTYPES[dt], 4, dev)
    n0 = eg.gather_rows_expand.launches
    out = eg.gather_rows_expand(table, slots, inv, ov, hr)
    torch.cuda.synchronize()
    assert eg.gather_rows_expand.launches == n0 + 1
    assert torch.equal(out, ref.gather_rows_expand_ref(table, slots, inv,
                                                       ov, hr))


@pytest.mark.parametrize("d", [16, 128, 20])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gather_pool_matches_plain(dev, dt, d):
    table = _table(500, d, DTYPES[dt], 5, dev)
    idx = torch.from_numpy(np.random.default_rng(6).integers(
        0, 500, (97, 20)).astype(np.int32)).to(dev)
    n0 = eg.gather_pool.launches
    out = eg.gather_pool(table, idx)
    torch.cuda.synchronize()
    assert eg.gather_pool.launches == n0 + 1
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref.gather_pool_ref(table, idx),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("policy", ["lru", "recmg"])
def test_store_on_card_matches_cpu(dev, policy):
    trace = generate_trace(TraceGenConfig(
        n_tables=4, rows_per_table=500, n_accesses=6000, seed=0,
        drift_every=10**9))
    host = np.random.default_rng(0).normal(
        size=(int(trace.rows_per_table.sum()), 16)).astype(np.float32)
    cap = 150  # small enough that some batches overflow the buffer
    outs = frequency_outputs(trace, cap)
    stores = [TieredEmbeddingStore(host, cap, policy=policy, device=d)
              for d in ("cpu", dev)]
    per_batch = 400
    for b in range(len(trace) // per_batch):
        ids = trace.global_id[b * per_batch: (b + 1) * per_batch]
        rows = [s.lookup(ids) for s in stores]
        assert torch.equal(rows[0], rows[1].cpu())
        trunk = ids[-15:]
        bits = outs.caching_bits[b % len(outs.caching_bits)]
        for s in stores:
            s.stage_model_outputs(trunk, bits, outs.prefetch_ids[b])
            s.flush_staged()
            s.check_invariants()
    keys = ("lookups", "hits", "misses", "prefetch_hits", "on_demand_rows",
            "evictions")
    assert [getattr(stores[0].stats, k) for k in keys] == \
        [getattr(stores[1].stats, k) for k in keys]


def test_dlrm_forward_on_card_matches_cpu(dev):
    cfg = get_config("dlrm-recmg").reduced()
    params = init_dlrm(cfg, seed=0, device="cpu")
    on_card = {"emb": params["emb"].to(dev),
               **{k: {"w": [w.to(dev) for w in params[k]["w"]],
                      "b": [b.to(dev) for b in params[k]["b"]]}
                  for k in ("bottom", "top")}}
    rng = np.random.default_rng(7)
    dense = torch.from_numpy(rng.normal(size=(16, cfg.dense_features))
                             .astype(np.float32))
    idx = torch.from_numpy(rng.integers(
        0, cfg.rows_per_table, (16, cfg.n_tables, cfg.multi_hot))
        .astype(np.int32))
    n0 = eg.gather_pool.launches
    got = dlrm_forward(on_card, cfg, dense.to(dev), idx.to(dev))
    assert eg.gather_pool.launches == n0 + 1
    want = dlrm_forward(params, cfg, dense, idx)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
