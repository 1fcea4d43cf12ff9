"""repro_torch's CUDA kernels against their plain PyTorch versions, on the
card.  These tests need an NVIDIA GPU and nvcc and skip without them; the
file imports no JAX, so it runs on a machine that has none:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_kernels.py -q

Tolerances: the row gathers are pure copies, so bit-exact; the pooled
gather sums P rows in fp32 in another order than ``torch.sum``, so fp32
rtol 1e-5, in its shard window too (which gives the unmasked kernel's
bits when no id is masked).  Quantized tier: codes bit-exact, scales within one ulp (fp32
rtol 2e-7; both sides divide with IEEE division, so 0 is expected); the
dequantizing row gathers bit-exact (one multiply per element); the
dequantizing pooled gather fp32 rtol/atol 1e-6 (each product rounded on its
own and summed in the order p = 0..P-1 on both sides, so 0 is expected).
The pipelined runtime on the card: the thread scheduler's worker gives the
inline engine's counters and stored bytes exactly, and the degraded read
(the store's gather kernel) and the admission path's batches equal the
CPU's bit for bit.  Training: ``flash_attention_bwd`` against the plain
backward within 1e-5 (fp32) and 2e-2 (bf16, the bound bf16 LM parity uses)
of each gradient's largest magnitude, also across the bf16 kernels' tile
edges, with the query heads split over blocks and in a sliding window (a
window of S or more gives the causal bits), and bit-equal over two calls
(no atomics); ``selective_scan_bwd`` against the plain reverse recurrence
within 1e-4 of each gradient's largest magnitude (bf16 dx, dz 1e-2), also
where exp(dt a) flushes to 0, and bit-equal over two calls; the reduced
SSM and hybrid LMs' gradients on the card within 1e-4 of the CPU's; the
forward's output bits do not
change when it also writes the log-sum-exp; ``gather_pool``'s table
gradient on the card within 1e-5 of its largest magnitude of the CPU's
(the card's scatter-adds use atomics, so the order of summation differs;
a bf16 table's gradient within one bf16 ulp, 2^-8).  The MoE and VLM LMs
on the card, in fp32 (a bf16 activation's ulp flips near-tied expert
choices between the devices): one MoE block's routing (top-K sets, keep
masks) equal to the CPU's, its output, aux and gradients within 1e-5 of
their largest magnitude; reduced granite-moe and internvl2 (with a
frontend) prefill and decode within 1e-4; the bf16 MoE's loss and
gradients bit-equal over two calls.  The unmasked attention
(``causal=False``, whisper's encoder) forward and backward against their
plain versions at the tolerances above, bit-equal over two calls; reduced
whisper-large-v3's loss, gradients, prefill and decode on the card within
1e-4 of the CPU's.  The attention at a query offset (a sequence-parallel
rank's queries): the forward against ``kv_stream_attention_ref``, the
backward against ``flash_attention_bwd_ref`` at the offset (fp32 1e-5,
bf16 2e-2 of each gradient's largest magnitude; zeros for keys no query
sees), a split's dq rows stacked and dk/dv summed against the whole
call's (dq bit for bit at whole 64-row tiles), and ``ops.flash_attention``
trained at an offset against the CPU's autograd.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.recmg import frequency_outputs
from repro_torch.core.serving import MultiTableTieredStore
from repro_torch.core.tiered import TieredEmbeddingStore
from repro_torch.core.trace import TraceGenConfig, generate_trace
from repro_torch.kernels import embedding_gather as eg
from repro_torch.kernels import ref
from repro_torch.models.dlrm import dlrm_forward, init_dlrm, quantize_tables

pytestmark = pytest.mark.cuda

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
FORMATS = ("int8", "fp8")


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


@pytest.mark.parametrize("d", [16, 128, 20])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gather_pool_shard_matches_plain(dev, dt, d):
    """The shard window: ids < 0 add nothing; with every id in range it
    gives ``gather_pool``'s bits (the same sums in the same order)."""
    table = _table(500, d, DTYPES[dt], 5, dev)
    rng = np.random.default_rng(8)
    idx = rng.integers(0, 500, (97, 20)).astype(np.int32)
    masked = np.where(rng.random(idx.shape) < 0.5, -1, idx).astype(np.int32)
    masked[0] = -1  # nothing owned: a row of zeros
    idx, masked = (torch.from_numpy(a).to(dev) for a in (idx, masked))
    n0 = eg.gather_pool_shard.launches
    out = eg.gather_pool_shard(table, masked)
    torch.cuda.synchronize()
    assert eg.gather_pool_shard.launches == n0 + 1
    assert out.dtype == torch.float32 and not out[0].any()
    torch.testing.assert_close(out, ref.gather_pool_shard_ref(table, masked),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(eg.gather_pool_shard(table, idx),
                       eg.gather_pool(table, idx))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gather_pool_shard_backward_on_card_matches_plain(dev, dt):
    """The shard window under autograd on the card: its forward launches
    the kernel, its backward (a scatter-add that skips ids < 0) matches
    the same backward on the CPU twin's tensors, within one bf16 ulp of
    the largest magnitude (atomics); with every id in range it is
    ``gather_pool``'s backward within one ulp."""
    from repro_torch.kernels import ops

    table = _table(500, 128, DTYPES[dt], 5, dev)
    rng = np.random.default_rng(8)
    idx = rng.integers(0, 500, (97, 20)).astype(np.int32)
    masked = np.where(rng.random(idx.shape) < 0.5, -1, idx).astype(np.int32)
    masked[0] = -1
    dout = torch.from_numpy(rng.normal(size=(97, 128)).astype(np.float32))
    tol = 2.0 ** -7 if dt == "bf16" else 1e-5

    def grad(fn, t, ids, d):
        t = t.clone().requires_grad_(True)
        return torch.autograd.grad(fn(t, torch.from_numpy(ids).to(t.device)),
                                   [t], d.to(t.device))[0]

    n0 = eg.gather_pool_shard.launches
    card = grad(ops.gather_pool_shard, table, masked, dout)
    torch.cuda.synchronize()
    assert eg.gather_pool_shard.launches == n0 + 1
    plain = grad(ops.gather_pool_shard, table.cpu(), masked, dout)
    bound = tol * float(plain.float().abs().max())
    assert float((card.cpu().float() - plain.float()).abs().max()) <= bound
    full = grad(ops.gather_pool, table, idx, dout)
    window = grad(ops.gather_pool_shard, table, idx, dout)
    bound = tol * float(full.float().abs().max())
    assert float((full.float() - window.float()).abs().max()) <= bound


def test_one_rank_sharded_forward_on_card_is_the_dense_forward(dev):
    """A (1, 1) mesh of this process: the sharded forward on the card has
    the unsharded forward's bits when every id is in range."""
    from repro_torch.distributed import mesh as M

    cfg = get_config("dlrm-recmg").reduced()
    params = init_dlrm(cfg, seed=0, device=dev)
    rng = np.random.default_rng(9)
    dense = torch.from_numpy(rng.normal(size=(16, cfg.dense_features))
                             .astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(
        0, cfg.rows_per_table, (16, cfg.n_tables, cfg.multi_hot))
        .astype(np.int32)).to(dev)
    n0 = eg.gather_pool_shard.launches
    with M.activation_sharding(M.make_host_mesh()):
        got = dlrm_forward(params, cfg, dense, idx, sharded_lookup=True)
    assert eg.gather_pool_shard.launches == n0 + 1
    assert torch.equal(got, dlrm_forward(params, cfg, dense, idx))


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


# ---------------------------------------------------------------------------
# Quantized fast tier.
# ---------------------------------------------------------------------------

def _rows(m, d, seed, spread=1e3):
    """Rows of magnitudes within ``spread`` of 1 either way, with a zero
    row, a row of half-integers whose int8 scale is exactly 1, and a row
    whose absmax element lands on qmax."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, d))
         * rng.uniform(1 / spread, spread, size=(m, 1))).astype(np.float32)
    x[0] = 0.0
    x[1] = (np.arange(d) % 16 - 8 + 0.5).astype(np.float32)
    x[1, 0] = 127.0
    x[2, d // 2] = -np.abs(x[2]).max() * 3
    return torch.from_numpy(x)


def _quantized(n, d, row_format, seed, dev):
    q, s = ref.quantize_rows_ref(_rows(n, d, seed, spread=2.0), row_format)
    return q.to(dev), s.to(dev)


# (M, D, variant).  D = 16, 20 and 128 keep one 4-element piece of a row a
# lane, 256 and 512 two and four, 1024 takes the generic two-pass branch and
# 18 (not a multiple of 4) one element a piece.  M = 1001 is not a multiple
# of the rows a warp takes at once; M = 3 and 37 fill less than one block.
# "bad_slot" gives two rows slots out of range, which the kernel drops;
# "view" passes rows 4 bytes off a 16-byte boundary (one element a piece).
QUANT_CASES = [(500, 16, ""), (500, 128, ""), (500, 20, ""), (500, 256, ""),
               (500, 512, ""), (500, 1024, ""), (1001, 128, ""),
               (3, 128, ""), (37, 16, ""), (70, 18, ""),
               (500, 128, "bad_slot"), (500, 16, "bad_slot"),
               (500, 128, "view"), (100, 512, "view")]


@pytest.mark.parametrize("m,d,variant", QUANT_CASES)
@pytest.mark.parametrize("row_format", FORMATS)
def test_quantize_scatter_matches_plain(dev, row_format, m, d, variant):
    cap = m + 200
    rows = _rows(max(m, 3), d, 11)[:m].to(dev)
    if variant == "view":
        flat = torch.zeros(m * d + 1, device=dev)
        flat[1:] = rows.reshape(-1)
        rows = flat[1:].view(m, d)
        assert rows.data_ptr() % 16 == 4
    slots = torch.from_numpy(np.random.default_rng(12).permutation(cap)[:m]
                             .astype(np.int32)).to(dev)
    if variant == "bad_slot":
        slots[0], slots[m // 2] = -3, cap + 5
    qdt = ref.ROW_FORMATS[row_format][0]
    bufs = [torch.zeros((cap, d), dtype=qdt, device=dev) for _ in range(2)]
    scales = [torch.full((cap,), -1.0, device=dev) for _ in range(2)]
    n0 = eg.quantize_scatter.launches
    eg.quantize_scatter(bufs[0], scales[0], slots, rows, row_format)
    keep = (slots >= 0) & (slots < cap)
    ref.quantize_scatter_ref(bufs[1], scales[1], slots[keep], rows[keep],
                             row_format)
    torch.cuda.synchronize()
    assert eg.quantize_scatter.launches == n0 + 1
    assert torch.equal(bufs[0].view(torch.uint8), bufs[1].view(torch.uint8))
    torch.testing.assert_close(scales[0], scales[1], rtol=2e-7, atol=0)


@pytest.mark.parametrize("d", [16, 128, 20])
@pytest.mark.parametrize("row_format", FORMATS)
def test_gather_rows_dequant_bit_exact(dev, row_format, d):
    q, s = _quantized(300, d, row_format, 13, dev)
    idx = torch.from_numpy(np.random.default_rng(14).integers(
        0, 300, 1000).astype(np.int32)).to(dev)
    n0 = eg.gather_rows_dequant.launches
    out = eg.gather_rows_dequant(q, s, idx)
    torch.cuda.synchronize()
    assert eg.gather_rows_dequant.launches == n0 + 1
    assert torch.equal(out, ref.gather_rows_dequant_ref(q, s, idx))


@pytest.mark.parametrize("with_ov", [False, True])
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("row_format", FORMATS)
def test_gather_rows_dequant_expand_bit_exact(dev, row_format, d, with_ov):
    rng = np.random.default_rng(15)
    q, s = _quantized(64, d, row_format, 16, dev)
    u, m = 50, 700
    slots = torch.from_numpy(rng.permutation(64)[:u].astype(np.int32)).to(dev)
    inv = torch.from_numpy(rng.integers(0, u, m).astype(np.int32)).to(dev)
    ov = hr = None
    if with_ov:
        ov = torch.from_numpy(rng.random(u) < 0.3).to(dev)
        hr = _table(u, d, torch.float32, 17, dev)
    n0 = eg.gather_rows_dequant_expand.launches
    out = eg.gather_rows_dequant_expand(q, s, slots, inv, ov, hr)
    torch.cuda.synchronize()
    assert eg.gather_rows_dequant_expand.launches == n0 + 1
    assert torch.equal(out, ref.gather_rows_dequant_expand_ref(
        q, s, slots, inv, ov, hr))


@pytest.mark.parametrize("d", [16, 128, 20])
@pytest.mark.parametrize("row_format", FORMATS)
def test_gather_pool_dequant_matches_plain(dev, row_format, d):
    q, s = _quantized(500, d, row_format, 18, dev)
    idx = torch.from_numpy(np.random.default_rng(19).integers(
        0, 500, (97, 20)).astype(np.int32)).to(dev)
    n0 = eg.gather_pool_dequant.launches
    out = eg.gather_pool_dequant(q, s, idx)
    torch.cuda.synchronize()
    assert eg.gather_pool_dequant.launches == n0 + 1
    torch.testing.assert_close(out, ref.gather_pool_dequant_ref(q, s, idx),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("multi_table", [False, True])
@pytest.mark.parametrize("row_format", FORMATS)
@pytest.mark.parametrize("policy", ["lru", "recmg"])
def test_quantized_store_on_card_matches_cpu(dev, policy, row_format,
                                             multi_table):
    """The quantized store (alone, or behind the per-table facade) on the
    card and on the CPU: equal counters, codes and rows, including
    batches that overflow the buffer."""
    trace = generate_trace(TraceGenConfig(
        n_tables=4, rows_per_table=500, n_accesses=6000, seed=0,
        drift_every=10**9))
    host = np.random.default_rng(0).normal(
        size=(int(trace.rows_per_table.sum()), 16)).astype(np.float32)
    cap = 150
    outs = frequency_outputs(trace, cap)
    kw = dict(policy=policy, quantize=True, row_format=row_format,
              warmup_batch=400)
    if multi_table:
        stores = [MultiTableTieredStore.from_global_table(
            host, trace.rows_per_table, capacity=cap, device=d, **kw)
            for d in ("cpu", dev)]
    else:
        stores = [TieredEmbeddingStore(host, cap, device=d, **kw)
                  for d in ("cpu", dev)]
    launches = (eg.quantize_scatter.launches,
                eg.gather_rows_dequant_expand.launches)
    per_batch = 400
    for b in range(len(trace) // per_batch):
        ids = trace.global_id[b * per_batch: (b + 1) * per_batch]
        rows = [st.lookup(ids) for st in stores]
        assert torch.equal(rows[0], rows[1].cpu())
        bits = outs.caching_bits[b % len(outs.caching_bits)]
        for st in stores:
            st.stage_model_outputs(ids[-15:], bits, outs.prefetch_ids[b])
            st.flush_staged()
    keys = ("lookups", "hits", "misses", "prefetch_hits", "on_demand_rows",
            "evictions")
    assert [getattr(stores[0].stats, k) for k in keys] == \
        [getattr(stores[1].stats, k) for k in keys]
    subs = [st.stores if multi_table else [st] for st in stores]
    for a, c in zip(*subs):
        assert torch.equal(a.buffer.view(torch.uint8),
                           c.buffer.view(torch.uint8).cpu())
        assert torch.equal(a.scales, c.scales.cpu())
    assert eg.quantize_scatter.launches > launches[0]
    assert eg.gather_rows_dequant_expand.launches > launches[1]


@pytest.mark.parametrize("row_format", FORMATS)
def test_quantized_forward_on_card_matches_cpu(dev, row_format):
    cfg = get_config("dlrm-recmg").reduced()
    params = quantize_tables(init_dlrm(cfg, seed=0, device="cpu"),
                             row_format)
    on_card = quantize_tables(init_dlrm(cfg, seed=0, device="cpu"),
                              row_format)
    on_card = {"emb": on_card["emb"].to(dev),
               "emb_scales": on_card["emb_scales"].to(dev),
               **{k: {"w": [w.to(dev) for w in params[k]["w"]],
                      "b": [b.to(dev) for b in params[k]["b"]]}
                  for k in ("bottom", "top")}}
    rng = np.random.default_rng(20)
    dense = torch.from_numpy(rng.normal(size=(16, cfg.dense_features))
                             .astype(np.float32))
    idx = torch.from_numpy(rng.integers(
        0, cfg.rows_per_table, (16, cfg.n_tables, cfg.multi_hot))
        .astype(np.int32))
    n0 = eg.gather_pool_dequant.launches
    got = dlrm_forward(on_card, cfg, dense.to(dev), idx.to(dev))
    assert eg.gather_pool_dequant.launches == n0 + 1
    want = dlrm_forward(params, cfg, dense, idx)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    # quantize_tables on the card gives the CPU's codes.
    card_q = quantize_tables({"emb": init_dlrm(cfg, seed=0, device="cpu")
                              ["emb"].to(dev)}, row_format)
    assert torch.equal(card_q["emb"].view(torch.uint8).cpu(),
                       params["emb"].view(torch.uint8))


# ---------------------------------------------------------------------------
# Learned models: lstm_cell and chamfer.  lstm_cell: fp32 abs 1e-5 on h',
# c' and the gates (the product sums K terms in another order than the
# matmul); chamfer: the distances, argmins and means are computed in the
# same order with one rounding per operation on both sides, so the loss
# is held within rtol 1e-5 (0 expected) and the argmins exactly.  Gradients
# through the autograd Functions against autograd through the plain
# versions: rtol 1e-4, atol 1e-6.
# ---------------------------------------------------------------------------

def _lstm_inputs(b, in_dim, hid, seed, dev):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32)).to(dev)

    k = in_dim + hid
    return (t(b, in_dim), t(b, hid), t(b, hid), t(k, 4 * hid,
                                                   scale=k ** -0.5),
            t(4 * hid, scale=0.5))


# The learned path's K = in + H in {57, 67, 80, 88, 120} at H in {32, 40},
# at the inference (4096) and training (256) batches, then odd sizes: row
# tiles and unit slices with ragged ends, K not a multiple of 4, a W slice
# too large for shared memory (K = 3000), H not a multiple of 4 (W read
# through the cache), and the largest K the kernel takes with rows that are
# not 16-byte aligned (1,815) and with rows that are (3,632).
LSTM_CASES = [(b, k - hid, hid) for b in (4096, 256)
              for k in (57, 67, 80, 88, 120) for hid in (32, 40)] + [
    (1, 27, 40), (7, 40, 40), (300, 25, 40), (64, 40, 32), (33, 48, 40),
    (5, 8, 16), (100, 200, 100), (70, 2900, 100), (1000, 3, 1),
    (70, 1715, 100), (70, 3532, 100)]


@pytest.mark.parametrize("b,in_dim,hid", LSTM_CASES)
def test_lstm_cell_matches_plain(dev, b, in_dim, hid):
    from repro_torch.kernels import lstm_cell as lc

    x, h, c, w, bias = _lstm_inputs(b, in_dim, hid, b + in_dim, dev)
    n0 = lc.lstm_cell.launches
    got = lc.lstm_cell(x, h, c, w, bias)
    torch.cuda.synchronize()
    assert lc.lstm_cell.launches == n0 + 1
    want = ref.lstm_cell_ref(x, h, c, w, bias)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)
    h2, c2, gates = lc.lstm_cell(x, h, c, w, bias, save_gates=False)
    assert gates is None
    torch.testing.assert_close(h2, got[0], rtol=0, atol=0)


@pytest.mark.parametrize("in_dim,hid", [(1715, 101), (3536, 100)])
def test_lstm_cell_rejects_k_beyond_its_shared_memory(dev, in_dim, hid):
    """One K past each limit: 16 rows of K = 1,816 with their flat copies
    (H not a multiple of 4), and of K = 3,636 alone, exceed 227 KB."""
    from repro_torch.kernels import lstm_cell as lc

    n0 = lc.lstm_cell.launches
    with pytest.raises(RuntimeError, match="lstm_cell launch failed"):
        lc.lstm_cell(*_lstm_inputs(70, in_dim, hid, 5, dev))
    assert lc.lstm_cell.launches == n0


@pytest.mark.parametrize("in_dim", [80, 27])
def test_lstm_cell_takes_views_off_16_byte_boundaries(dev, in_dim):
    """x, h and w that start 4 bytes into their allocations."""
    from repro_torch.kernels import lstm_cell as lc

    x, h, c, w, bias = _lstm_inputs(300, in_dim, 40, 9, dev)
    views = []
    for t in (x, h, w):
        buf = torch.empty(t.numel() + 1, device=dev)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        assert v.data_ptr() % 16 == 4
        views.append(v)
    got = lc.lstm_cell(views[0], views[1], c, views[2], bias)
    for g, r in zip(got, ref.lstm_cell_ref(x, h, c, w, bias)):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)


def _chamfer_inputs(b, n_p, n_w, n_f, dev):
    """Normal po and w with exact ties: w[0, 1] = w[0, 0] (adjacent), and
    where the shape has room, in the first and the last row, w 3 and 11 both
    equal to po 2 (a forward tie at distance 0) and po 1 and 4 both equal to
    w 7 (a backward tie): the lowest index must win on both sides."""
    rng = np.random.default_rng(b)
    po = torch.from_numpy(rng.normal(size=(b, n_p, n_f))
                          .astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(size=(b, n_w, n_f))
                         .astype(np.float32)).to(dev)
    w[0, 1] = w[0, 0]
    if n_p > 4 and n_w > 11:
        for r in (0, b - 1):
            w[r, 3] = w[r, 11] = po[r, 2]
            po[r, 1] = po[r, 4] = w[r, 7]
    return po, w


# B = 77, 513 and 1001 are not multiples of the rows a block holds; (64, 8,
# 16, 25) and (513, 3, 40, 7) have more pairs than a warp, and W = 40 more
# than 32 points a lane group.
@pytest.mark.parametrize("b,n_p,n_w,n_f", [
    (256, 5, 15, 25), (1, 5, 15, 25), (77, 5, 5, 25), (513, 3, 40, 7),
    (1001, 5, 15, 25), (64, 8, 16, 25),
])
def test_chamfer_matches_plain(dev, b, n_p, n_w, n_f):
    from repro_torch.kernels import chamfer_kernel as ck

    po, w = _chamfer_inputs(b, n_p, n_w, n_f, dev)
    n0 = ck.chamfer.launches
    loss, af, ab = ck.chamfer(po, w, 0.7)
    torch.cuda.synchronize()
    assert ck.chamfer.launches == n0 + 1
    rl, raf, rab = ref.chamfer_ref(po, w, 0.7)
    torch.testing.assert_close(loss, rl, rtol=1e-5, atol=0)
    assert torch.equal(af, raf) and torch.equal(ab, rab)
    if n_p > 4 and n_w > 11:
        assert af[0, 2] == 3 and ab[0, 7] == 1


@pytest.mark.parametrize("n_f,fits", [(612, True), (613, False)])
def test_chamfer_rejects_rows_beyond_its_shared_memory(dev, n_f, fits):
    from repro_torch.kernels import chamfer_kernel as ck

    # A row takes pad4(5 F + 3) + pad4(15 F + 3) + pad4(2 * 5 + 15) floats
    # (pad4 rounds up to a multiple of 4), at most 12,288 (48 KB): F = 612
    # takes 12,276, F = 613 takes 12,296.
    po, w = _chamfer_inputs(4, 5, 15, n_f, dev)
    if not fits:
        with pytest.raises(RuntimeError, match="chamfer launch failed"):
            ck.chamfer(po, w, 0.7)
        return
    loss, af, ab = ck.chamfer(po, w, 0.7)
    rl, raf, rab = ref.chamfer_ref(po, w, 0.7)
    torch.testing.assert_close(loss, rl, rtol=1e-5, atol=0)
    assert torch.equal(af, raf) and torch.equal(ab, rab)


@pytest.mark.parametrize("n_f", [25, 8])
def test_chamfer_takes_views_off_16_byte_boundaries(dev, n_f):
    """po and w 4 bytes off a 16-byte boundary: the wrapper copies them."""
    from repro_torch.kernels import chamfer_kernel as ck

    po, w = _chamfer_inputs(300, 5, 15, n_f, dev)
    views = []
    for t in (po, w):
        flat = torch.zeros(t.numel() + 1, device=dev)
        flat[1:] = t.reshape(-1)
        views.append(flat[1:].view(t.shape))
        assert views[-1].data_ptr() % 16 == 4
    loss, af, ab = ck.chamfer(*views, 0.7)
    rl, raf, rab = ref.chamfer_ref(po, w, 0.7)
    torch.testing.assert_close(loss, rl, rtol=1e-5, atol=0)
    assert torch.equal(af, raf) and torch.equal(ab, rab)


def test_lstm_cell_and_chamfer_grads_match_plain(dev):
    from repro_torch.kernels import ops

    ins = [t.requires_grad_() for t in _lstm_inputs(64, 27, 40, 3, dev)]
    h2, c2 = ops.lstm_cell(*ins)
    (h2.square().sum() + (c2 * 0.5).sum()).backward()
    got = [t.grad.clone() for t in ins]
    ref_ins = [t.detach().clone().requires_grad_() for t in ins]
    rh, rc, _ = ref.lstm_cell_ref(*ref_ins)
    (rh.square().sum() + (rc * 0.5).sum()).backward()
    for g, r in zip(got, ref_ins):
        torch.testing.assert_close(g, r.grad, rtol=1e-4, atol=1e-6)

    rng = np.random.default_rng(4)
    po = torch.from_numpy(rng.normal(size=(256, 5, 25)).astype(np.float32)
                          ).to(dev).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(256, 15, 25)).astype(np.float32)
                         ).to(dev)
    ops.chamfer(po, w, 0.7).mean().backward()
    po_ref = po.detach().clone().requires_grad_()
    ref.chamfer_ref(po_ref, w, 0.7)[0].mean().backward()
    torch.testing.assert_close(po.grad, po_ref.grad, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# Dense-LM serving: flash_attention and the vocab-row read.
# Tolerances: fp32 rtol/atol 1e-5 (fp32 sums in another order than the
# plain version's products); bf16 1e-2 (the output rounds to bf16, whose
# ulp is 2^-8 of the value, after sums in another order).
# ---------------------------------------------------------------------------

FLASH_SHAPES = [(2, 100, 4, 2, 16), (1, 1, 2, 1, 16), (2, 1000, 9, 3, 64),
                (1, 300, 16, 2, 128), (3, 77, 8, 8, 32), (2, 64, 6, 3, 64),
                (2, 300, 16, 8, 64), (1, 300, 48, 8, 128)]
# The bf16 tensor-core kernel's tile edges: 128-query blocks of 16-row
# warps, 64-key tiles; S below, at and one past a key tile, ragged, one
# and two whole query blocks' multiples; G = H / K in {1, 3, 8}.
FLASH_BF16_EDGES = [(1, s, 2 * g, 2, hd) for hd in (16, 32, 64, 128)
                    for s in (1, 17, 64, 65, 1000, 2048) for g in (1, 3, 8)]


@pytest.mark.parametrize("dt,b,s,h,n_kv,hd", [
    (dt, *shape) for dt in sorted(DTYPES) for shape in FLASH_SHAPES] + [
    ("bf16", *shape) for shape in FLASH_BF16_EDGES])
def test_flash_attention_matches_plain(dev, dt, b, s, h, n_kv, hd):
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(s + hd)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, n, hd)).astype(
        np.float32)).to(DTYPES[dt]).to(dev) for n in (h, n_kv, n_kv))
    n0 = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = 1e-5 if dt == "fp32" else 1e-2
    torch.testing.assert_close(got.float(),
                               ref.causal_attention_ref(q, k, v).float(),
                               rtol=tol, atol=tol)


def test_flash_attention_takes_views_off_16_byte_boundaries(dev):
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 130, n, 64)).astype(
        np.float32)).to(torch.bfloat16).to(dev) for n in (6, 2, 2))
    views = []
    for t in (q, k, v):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 2
        views.append(view)
    torch.testing.assert_close(fa.flash_attention(*views).float(),
                               ref.causal_attention_ref(q, k, v).float(),
                               rtol=1e-2, atol=1e-2)


def test_flash_attention_refuses_what_it_cannot_serve(dev):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    q = torch.zeros((1, 8, 4, 16), device=dev, requires_grad=True)
    kv = torch.zeros((1, 8, 2, 16), device=dev)
    # Under autograd the op trains (its backward is flash_attention_bwd).
    assert ops.flash_attention(q, kv, kv).grad_fn is not None
    with torch.inference_mode():
        assert ops.flash_attention(q, kv, kv).shape == q.shape
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(torch.zeros((1, 8, 4, 24), device=dev),
                           torch.zeros((1, 8, 2, 24), device=dev),
                           torch.zeros((1, 8, 2, 24), device=dev))
    with pytest.raises(ValueError, match="H % K"):
        fa.flash_attention(torch.zeros((1, 8, 4, 16), device=dev),
                           torch.zeros((1, 8, 3, 16), device=dev),
                           torch.zeros((1, 8, 3, 16), device=dev))


# flash_attention_bwd: the training cut's heads, qwen2.5-3b's, a ragged S,
# head dims 16 and 32, granite-moe's heads (16/8, hd 64) and internvl2's
# (48/8, hd 128: G = 6) (B, S, H, K, hd).
FLASH_BWD_SHAPES = [(2, 256, 9, 3, 64), (1, 200, 16, 2, 128),
                    (2, 1000, 9, 3, 64), (2, 130, 4, 2, 16),
                    (1, 65, 6, 3, 32), (3, 17, 2, 1, 16),
                    (2, 256, 16, 8, 64), (1, 200, 48, 8, 128)]


def _attn_inputs(dev, dt, b, s, h, n_kv, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, s, n, hd)).astype(
        np.float32)).to(DTYPES[dt]).to(dev) for n in (h, n_kv, n_kv, h)]


# The bf16 kernels' tile edges: warps of 16 rows, 64-key blocks, query or
# key steps of 64 (32 at hd 128); S under one warp's rows, 16 n +- 1 and
# across a step, at G = H / K of 1 and 8 (B, S, H, K, hd).
FLASH_BWD_BF16_EDGES = [(1, s, 2 * g, 2, hd) for hd in (64, 128)
                        for s in (5, 15, 17, 31, 33, 63, 65, 129)
                        for g in (1, 8)]


def _assert_bwd_close(dt, got, want, floor=0.0):
    """Each gradient within the tolerance of max(its largest magnitude,
    ``floor``)."""
    tol = 1e-5 if dt == "fp32" else 2e-2
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        err = float((g.float() - w.float()).abs().max())
        scale = max(float(w.float().abs().max()), floor)
        assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


@pytest.mark.parametrize("dt,shape", [
    (dt, shape) for dt in sorted(DTYPES) for shape in FLASH_BWD_SHAPES] + [
    ("bf16", shape) for shape in FLASH_BWD_BF16_EDGES])
def test_flash_attention_bwd_matches_plain(dev, dt, shape):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do = _attn_inputs(dev, dt, *shape, seed=sum(shape))
    o, lse = fa.flash_attention(q, k, v, with_lse=True)
    n0 = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == n0 + 1
    _assert_bwd_close(dt, got, ref.flash_attention_bwd_ref(q, k, v, o, do,
                                                           lse))


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [(1, 200, 16, 2, 128), (2, 130, 8, 1, 64)])
def test_flash_attention_bwd_splits_match_plain(dev, shape, splits):
    """bf16 dK/dV with the G query heads split over blocks (fp32 partials
    summed by a second pass) at every divisor of G = 8."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do = _attn_inputs(dev, "bf16", *shape, seed=5)
    o, lse = fa.flash_attention(q, k, v, with_lse=True)
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, splits=splits)
    torch.cuda.synchronize()
    _assert_bwd_close("bf16", got, ref.flash_attention_bwd_ref(q, k, v, o,
                                                               do, lse))


# The training cut's heads (9/3, hd 64) and qwen2.5-3b's (16/2, hd 128,
# where the default splits the G heads over blocks).
@pytest.mark.parametrize("shape", [(2, 1000, 9, 3, 64), (1, 1024, 16, 2, 128)])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_attention_bwd_gives_the_same_bits_every_call(dev, dt, shape):
    """No atomics: two calls on the same inputs give bit-equal dq, dk and
    dv (a resumed training run repeats the uninterrupted run's losses)."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do = _attn_inputs(dev, dt, *shape, seed=13)
    o, lse = fa.flash_attention(q, k, v, with_lse=True)
    first = fa.flash_attention_bwd(q, k, v, o, do, lse)
    second = fa.flash_attention_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_flash_attention_bwd_takes_views_off_16_byte_boundaries(dev):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do = _attn_inputs(dev, "bf16", 2, 130, 6, 2, 64, seed=3)
    o, lse = fa.flash_attention(q, k, v, with_lse=True)
    views = []
    for t in (q, k, v, o, do):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 2
        views.append(view)
    got = fa.flash_attention_bwd(*views, lse)
    torch.cuda.synchronize()
    _assert_bwd_close("bf16", got, ref.flash_attention_bwd_ref(q, k, v, o,
                                                               do, lse))


def test_flash_attention_bwd_refuses_splits_it_cannot_take(dev):
    from repro_torch.kernels import flash_attention as fa

    for dt, splits in (("bf16", 3), ("bf16", 0), ("fp32", 2)):
        q, k, v, do = _attn_inputs(dev, dt, 1, 32, 4, 1, 16, seed=1)
        o, lse = fa.flash_attention(q, k, v, with_lse=True)
        with pytest.raises(ValueError, match="splits"):
            fa.flash_attention_bwd(q, k, v, o, do, lse, splits=splits)


@pytest.mark.parametrize("shape", [(2, 300, 9, 3, 64), (1, 129, 16, 2, 128),
                                   (2, 1000, 4, 2, 16)])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_attention_lse_keeps_the_output_bits(dev, dt, shape):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, _ = _attn_inputs(dev, dt, *shape, seed=7)
    served = fa.flash_attention(q, k, v)
    o, lse = fa.flash_attention(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o, served)
    _, want = ref.causal_attention_lse_ref(q, k, v)
    assert lse.shape == want.shape == (shape[0], shape[2], shape[1])
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


def test_attention_trains_through_the_kernels(dev):
    """``ops.flash_attention`` under autograd: forward and backward are the
    kernels, and the gradients match autograd through the plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    q, k, v, do = _attn_inputs(dev, "fp32", 2, 100, 4, 2, 32, seed=11)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    n_fwd, n_bwd = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    got = torch.autograd.grad(ops.flash_attention(*ins), ins, do)
    assert fa.flash_attention.launches == n_fwd + 1
    assert fa.flash_attention_bwd.launches == n_bwd + 1
    ref_ins = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.causal_attention_ref(*ref_ins), ref_ins,
                               do)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gather_pool_table_gradient_on_card_matches_cpu(dev, dt):
    from repro_torch.kernels import ops

    table = _table(500, 128, DTYPES[dt], 12, dev)
    rng = np.random.default_rng(13)
    idx = torch.from_numpy(rng.integers(0, 500, (256, 20)).astype(np.int32))
    dout = torch.from_numpy(rng.normal(size=(256, 128)).astype(np.float32))
    grads = {}
    for d in ("cpu", dev):
        t = table.detach().to(d).requires_grad_()
        n0 = eg.gather_pool.launches
        ops.gather_pool(t, idx.to(d)).backward(dout.to(d))
        assert eg.gather_pool.launches == n0 + (d != "cpu")
        assert t.grad is not None and t.grad.dtype == table.dtype
        grads[str(d)] = t.grad.float().cpu()
    want = grads["cpu"]
    err = float((grads[str(dev)] - want).abs().max())
    # bf16: the two fp32 sums, rounded once to bf16, may land one bf16 ulp
    # (2^-8 of a magnitude) apart.
    tol = 1e-5 if dt == "fp32" else 2.0 ** -8
    assert err <= tol * float(want.abs().max())


def test_gather_rows_expand_at_the_vocab_width(dev):
    """smollm-135m's vocab rows: D=576 fp32, 8 ids of a decode step."""
    table = _table(4915, 576, torch.float32, 5, dev)
    slots = torch.tensor([7, 4900, 0, 12], dtype=torch.int32, device=dev)
    inv = torch.tensor([0, 1, 1, 2, 3, 0, 3, 2], dtype=torch.int32,
                       device=dev)
    out = eg.gather_rows_expand(table, slots, inv)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.gather_rows_expand_ref(table, slots, inv))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_lm_prefill_and_decode_on_card_match_cpu(dev, dtype, tol):
    """A reduced dense LM from the same parameters on both devices: the card
    runs flash_attention in every prefill layer."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.transformer import (decode_step, init_lm,
                                                prefill)

    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              param_dtype=dtype, compute_dtype=dtype)
    cpu = init_lm(cfg, seed=0, device="cpu")
    card = init_lm(cfg, seed=0, device="cpu").to(dev)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 70)))
    n0 = fa.flash_attention.launches
    out = {}
    for name, model, d in (("cpu", cpu, "cpu"), ("card", card, dev)):
        logits, cache = prefill(model, cfg, tokens.to(d), 80)
        steps = [logits]
        for i in range(3):
            logits, cache = decode_step(model, cfg, tokens[:, i:i + 1].to(d),
                                        cache)
            steps.append(logits)
        out[name] = torch.stack(steps).cpu()
    assert fa.flash_attention.launches == n0 + cfg.n_layers
    torch.testing.assert_close(out["card"], out["cpu"], rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# The MoE and VLM LMs on the card (fp32: bf16 router inputs differ by an
# ulp between the devices and flip near-tied selections).
# ---------------------------------------------------------------------------

def _moe_cfg(cf):
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(name="t", family="moe", n_layers=1, d_model=64,
                       d_ff=64, vocab=64, n_experts=8, top_k=2, moe_d_ff=64,
                       capacity_factor=cf, param_dtype="float32",
                       compute_dtype="float32")


@pytest.mark.parametrize("dense_route", [False, True])
@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_moe_block_on_card_matches_cpu(dev, cf, dense_route):
    """One MoE block from the same parameters on both devices: routing
    (top-K sets and keep masks) equal, outputs, aux and the gradients of
    the input and every parameter within 1e-5 of their largest
    magnitude."""
    from repro_torch.models import layers as L

    cfg = _moe_cfg(cf)
    g = torch.Generator().manual_seed(0)
    params = L.init_moe(g, cfg, torch.float32, torch.device("cpu"))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 96, 64)).astype(np.float32))
    dy = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, 96, 64)).astype(np.float32))
    out = {}
    for d in ("cpu", dev):
        p = {k: v.to(d).requires_grad_() for k, v in params.items()}
        xd = x.to(d).requires_grad_()
        y, aux = L.moe_block(p, cfg, xd, dense_route=dense_route)
        xf = x.to(d).reshape(-1, 64)
        _, _, top_e = L._route(p, cfg, xf)
        c = max(1, int(np.ceil(cf * xf.shape[0] * 2 / 8)))
        _, keep = L._capacity_slots(top_e.reshape(-1), 8, c)
        names = ["x"] + list(p)
        grads = torch.autograd.grad((y * dy.to(d)).sum() + aux,
                                    [xd] + list(p.values()),
                                    allow_unused=True)
        out[str(d)] = {"y": y.detach().cpu(), "aux": aux.detach().cpu(),
                       "top_e": top_e.cpu(), "keep": keep.cpu(),
                       **{f"d{n}": (torch.zeros(1) if gr is None
                                    else gr.cpu())
                          for n, gr in zip(names, grads)}}
    cpu, card = out["cpu"], out[str(dev)]
    assert torch.equal(cpu["top_e"], card["top_e"])
    assert torch.equal(cpu["keep"], card["keep"])
    if cf == 0.5:
        assert not cpu["keep"].all()
    for k, want in cpu.items():
        if k in ("top_e", "keep"):
            continue
        err = float((card[k] - want).abs().max())
        assert err <= 1e-5 * max(1.0, float(want.abs().max())), k


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "internvl2-26b"])
def test_moe_and_vlm_prefill_and_decode_on_card_match_cpu(dev, arch):
    """The reduced fp32 MoE (cf 1.25, so tokens drop) and VLM (with a
    frontend) from the same parameters on both devices: prefill and three
    decode steps within 1e-4, flash_attention in every prefill layer."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model_api import build

    cfg = get_config(arch).reduced()
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=1.25)
    rng = np.random.default_rng(8)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 70))}
    if cfg.frontend:
        batch["frontend"] = rng.normal(size=(
            2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    model = build(cfg, device="cpu").init(seed=0)
    n0 = fa.flash_attention.launches
    out = {}
    for d in ("cpu", dev):
        bundle = build(cfg, device=d)
        m = model if d == "cpu" else copy.deepcopy(model).to(d)
        logits, cache = bundle.prefill(m, batch, cache_len=80)
        steps = [logits]
        for i in range(3):
            logits, cache = bundle.decode(m, batch["tokens"][:, i:i + 1],
                                          cache)
            steps.append(logits)
        out["cpu" if d == "cpu" else "card"] = torch.stack(steps).cpu()
    assert fa.flash_attention.launches == n0 + cfg.n_layers
    torch.testing.assert_close(out["card"], out["cpu"], rtol=1e-4,
                               atol=1e-4)


def test_moe_training_step_on_card_gives_the_same_bits_twice(dev):
    """The reduced bf16 MoE's loss and gradients (capacity dispatch, drop
    slot and all, remat full) are bit-equal over two calls, so a resumed
    run repeats the uninterrupted run's losses."""
    import dataclasses

    from repro_torch.configs import RunConfig
    from repro_torch.models.model_api import build

    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                              capacity_factor=1.25, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    bundle = build(cfg, device=dev, run=RunConfig(remat="full"))
    model = bundle.init(seed=0).requires_grad_(True)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (4, 128))
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    runs = []
    for _ in range(2):
        loss = bundle.loss(model, batch)
        runs.append([loss.detach()] + list(torch.autograd.grad(
            loss, list(model.parameters()))))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The pipelined runtime on the card: the thread scheduler's worker and the
# degraded read.
# ---------------------------------------------------------------------------

def _runtime_trace():
    return generate_trace(TraceGenConfig(
        n_tables=4, rows_per_table=500, n_accesses=6000, seed=0,
        drift_every=10**9))


def _store_pair(dev, multi_table, row_format, trace, cap=150, **kw):
    host = np.random.default_rng(0).normal(
        size=(int(trace.rows_per_table.sum()), 16)).astype(np.float32)
    if row_format is not None:
        kw.update(quantize=True, row_format=row_format)
    if multi_table:
        return [MultiTableTieredStore.from_global_table(
            host, trace.rows_per_table, capacity=cap, device=d, **kw)
            for d in ("cpu", dev)]
    return [TieredEmbeddingStore(host, cap, device=d, **kw)
            for d in ("cpu", dev)]


@pytest.mark.parametrize("row_format", [None, "int8"])
def test_thread_scheduler_on_card_equals_inline(dev, row_format):
    """The thread worker applies the prefetches on the card (under the
    store's device and the lookups' stream): with a drain barrier after
    each batch's submits, its counters and stored rows equal the inline
    engine's, and on the quantized store the worker itself launched
    ``quantize_scatter``."""
    from repro_torch.runtime import PrefetchEngine

    trace = _runtime_trace()
    outs = frequency_outputs(trace, 150)
    empty = np.empty(0, np.int64)
    stores = {}
    for sched in ("inline", "thread"):
        store = _store_pair(dev, False, row_format, trace,
                            policy="recmg")[1]
        eng = PrefetchEngine(store, scheduler=sched, max_queue=8)
        n0 = eg.quantize_scatter.launches
        eng.submit(empty, empty, np.arange(40, 90))  # prefetch only
        eng.drain()
        worker_launches = eg.quantize_scatter.launches - n0
        for b in range(len(trace) // 400):
            ids = trace.global_id[b * 400: (b + 1) * 400]
            with eng.lock:
                store.lookup(ids)
            eng.submit(ids[-15:], outs.caching_bits[b], outs.prefetch_ids[b])
            eng.drain()
        eng.close()
        store.check_invariants()
        if row_format is not None:
            assert worker_launches > 0
        stores[sched] = store
    a, c = stores["inline"], stores["thread"]
    assert a.stats.as_dict() | {k: 0 for k in ("fetch_s", "gather_s",
                                               "model_s")} == \
        c.stats.as_dict() | {k: 0 for k in ("fetch_s", "gather_s",
                                            "model_s")}
    assert torch.equal(a.buffer.view(torch.uint8), c.buffer.view(torch.uint8))
    if row_format is not None:
        assert torch.equal(a.scales, c.scales)


@pytest.mark.parametrize("multi_table", [False, True])
@pytest.mark.parametrize("row_format", [None] + list(FORMATS))
def test_degraded_read_on_card_matches_cpu(dev, row_format, multi_table):
    """``lookup_resident_device`` on the card reads with the store's own
    gather kernel (one launch a store touched) and returns the CPU's rows
    bit for bit: resident rows are copies (times one scale), misses zero."""
    trace = _runtime_trace()
    stores = _store_pair(dev, multi_table, row_format, trace)
    for b in range(6):
        ids = trace.global_id[b * 400: (b + 1) * 400]
        for st in stores:
            st.lookup(ids)
    probe = trace.global_id[2000:2600]
    kernel = (eg.gather_rows_dequant_expand if row_format is not None
              else eg.gather_rows_expand)
    n0 = kernel.launches
    rows, n_def = zip(*(st.lookup_resident_device(probe) for st in stores))
    torch.cuda.synchronize()
    touched = (len(np.unique(np.searchsorted(
        stores[1].offsets, probe, side="right") - 1)) if multi_table else 1)
    assert kernel.launches == n0 + touched
    assert rows[1].device.type == "cuda" and n_def[0] == n_def[1] > 0
    assert torch.equal(rows[0], rows[1].cpu())


@pytest.mark.parametrize("row_format", [None, "int8"])
def test_overload_runtime_on_card_matches_cpu(dev, row_format):
    """The admission path on the card: the same fates and the same batches,
    degraded rows included, as on the CPU."""
    from repro_torch.runtime import (AdmissionConfig, PipelinedRuntime,
                                     RuntimeConfig)

    trace = _runtime_trace()
    rng = np.random.default_rng(0)
    gid = trace.global_id
    stream = [(gid[i * 20: (i + 1) * 20], int(p))
              for i, p in enumerate(rng.integers(0, 3, size=200))]
    out = {}
    for st in _store_pair(dev, False, row_format, trace,
                          fetch_us_fixed=200.0):
        rt = PipelinedRuntime(st, RuntimeConfig(
            max_batch=4, interarrival_us=10.0, compute_us=400.0,
            admission=AdmissionConfig(
                queue_bound=8, class_deadline_us=(50.0, 200.0, 800.0))))
        embs = []
        rt.run(iter(stream), lambda b, emb: (embs.append(emb.cpu()) or 0.0,
                                             []))
        out[st.device.type] = (rt.results(), embs)
    assert out["cpu"][0] == out["cuda"][0]
    assert out["cuda"][0]["admission"]["degraded_rows_stale"] > 0
    for a, c in zip(out["cpu"][1], out["cuda"][1]):
        assert torch.equal(a, c)


@pytest.mark.parametrize("placement", ["row", "freq"])
@pytest.mark.parametrize("row_format", [None, "int8"])
def test_sharded_store_on_card_matches_cpu(dev, row_format, placement):
    """The sharded store on the card, 4 shards with hot-row replicas and a
    kill then a recovery of shard 1: every batch (assembled on the card by
    one ``index_copy_``) equals the CPU's bit for bit, and so do the
    counters, the shard telemetry and the ``ft.*`` fates; the card's
    shards launched their gather kernel."""
    from repro_torch.core.sharded_serving import ShardedTieredStore

    trace = _runtime_trace()
    gid = trace.global_id
    host = np.random.default_rng(0).normal(
        size=(int(trace.rows_per_table.sum()), 16)).astype(np.float32)
    q = dict(quantize=True, row_format=row_format) if row_format else {}
    kernel = (eg.gather_rows_dequant_expand if row_format is not None
              else eg.gather_rows_expand)
    runs = {}
    for d in ("cpu", dev):
        st = ShardedTieredStore.build(
            host, trace.rows_per_table, 4, placement, capacity=300,
            policy="recmg", profile_ids=gid[:2000], replicate_hot=64,
            device=d, **q)
        st.arm_faults("kill:1@3,recover:1@7", horizon_batches=12)
        n0 = kernel.launches
        rows = []
        for b in range(12):
            ids = gid[b * 400: (b + 1) * 400]
            rows.append(st.lookup(ids).cpu())
            st.apply_model_outputs(ids[:15], np.ones(15, np.int64),
                                   np.unique(gid[(b + 1) * 400:
                                                 (b + 1) * 400 + 20]))
        runs[torch.device(d).type] = (rows, st.stats.as_dict(),
                                      st.shard_telemetry(),
                                      kernel.launches - n0)
    cpu, card = runs["cpu"], runs["cuda"]
    for a, c in zip(cpu[0], card[0]):
        assert torch.equal(a, c)
    for wall in ("fetch_s", "gather_s", "model_s"):
        cpu[1].pop(wall), card[1].pop(wall)
    assert cpu[1] == card[1]
    assert cpu[2] == card[2] and card[2]["ft"]["kills"] == 1
    assert card[3] > 0


def test_chaos_on_card_has_zero_wrong_rows_and_cpu_fates(dev):
    """``replay_chaos`` under the kill-and-recover plan on the card: the
    clean-shadow audit counts 0 wrong rows, and the fates equal the CPU
    run's."""
    from repro_torch.workloads import CHAOS_KEYS, make_spec, replay_chaos

    spec = make_spec("shard_failure", n_accesses=10_240, n_tables=4,
                     rows_per_table=256)
    got = {d: replay_chaos(spec, batch=128, shards=4, device=d)
           for d in ("cpu", "cuda")}
    assert got["cuda"]["wrong_rows"] == 0
    keys = CHAOS_KEYS + ("kills", "recoveries", "recovery_rows",
                         "degraded_default")
    assert {k: got["cuda"][k] for k in keys} == \
        {k: got["cpu"][k] for k in keys}


# ---------------------------------------------------------------------------
# The SSM and hybrid LMs: selective_scan and the windowed flash_attention.
# selective_scan runs the plain version's recurrence in the same order in
# fp32 (fused multiply-adds and expf's last ulp aside): fp32 y and h_last
# within 1e-5 of their largest magnitudes; bf16 y within 1e-2 of its largest
# magnitude (one bf16 rounding of nearly the same fp32 value: 2^-8), its
# h_last (fp32) within 1e-5.  The windowed attention as the causal one
# above: fp32 rtol/atol 1e-5, bf16 1e-2.
# ---------------------------------------------------------------------------

# (B, S, Di, N): ragged S and Di, S = 1, one step past a 64-step tile and
# two tiles and one step, both compiled state sizes, and hymba's channels;
# then the kernel's geometry (16-step tiles; blocks of 32 channels at
# N = 16, 64 at N = 8, 4 and 2 lanes a channel): a Di that fills no whole
# block (80; 100, whose bf16 rows are off 16-byte boundaries), S one step
# past a tile and past two tiles, N = 8 over its 2 lanes, and hymba-1.5b's
# Di at B = 8.
SCAN_SHAPES = [(2, 100, 256, 16), (1, 1, 128, 16), (3, 77, 200, 8),
               (2, 129, 64, 8), (1, 65, 300, 16), (2, 64, 3200, 16),
               (2, 17, 80, 16), (1, 33, 100, 16), (2, 17, 96, 8),
               (8, 40, 3200, 16)]


def _scan_inputs(dev, dt_name, b, s, di, n, seed, with_h0=False):
    """The block's inputs at the model's scales: dt = softplus(. - 2),
    a = -(1 .. N) jittered, bm/cm/x/z standard normal."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    xc, z = (f(b, s, di).to(DTYPES[dt_name]).to(dev) for _ in range(2))
    dt = torch.nn.functional.softplus(f(b, s, di) - 2.0).to(dev)
    a = (-torch.arange(1, n + 1, dtype=torch.float32).repeat(di, 1)
         * torch.exp(0.1 * f(di, n))).to(dev)
    bm, cm = f(b, s, n).to(dev), f(b, s, n).to(dev)
    d_skip = f(di).to(dev)
    h0 = f(b, di, n).to(dev) if with_h0 else None
    return xc, z, dt, a, bm, cm, d_skip, h0


def _assert_scan_close(dt_name, got, want):
    (y, h), (wy, wh) = got, want
    assert y.dtype == wy.dtype and y.shape == wy.shape
    assert h.dtype == wh.dtype == torch.float32 and h.shape == wh.shape
    tol = 1e-5 if dt_name == "fp32" else 1e-2
    for name, g, w, t in (("y", y, wy, tol), ("h_last", h, wh, 1e-5)):
        err = float((g.float() - w.float()).abs().max())
        scale = max(1.0, float(w.float().abs().max()))
        assert err <= t * scale, f"{name}: {err} > {t} * {scale}"


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape", SCAN_SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_selective_scan_matches_plain(dev, dt, shape, with_h0):
    from repro_torch.kernels import selective_scan as ss

    ins = _scan_inputs(dev, dt, *shape, seed=sum(shape), with_h0=with_h0)
    n0 = ss.selective_scan.launches
    got = ss.selective_scan(*ins)
    torch.cuda.synchronize()
    assert ss.selective_scan.launches == n0 + 1
    _assert_scan_close(dt, got, ref.selective_scan_ref(*ins))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_selective_scan_dt_zero_is_an_exact_identity(dev, dt):
    """dt = 0 everywhere: every step keeps the state, bit for bit, and y is
    (h0 . C_t + D x_t) silu(z_t)."""
    from repro_torch.kernels import selective_scan as ss

    xc, z, dt_, a, bm, cm, d_skip, h0 = _scan_inputs(
        dev, dt, 2, 70, 130, 16, seed=5, with_h0=True)
    y, h = ss.selective_scan(xc, z, torch.zeros_like(dt_), a, bm, cm,
                             d_skip, h0)
    torch.cuda.synchronize()
    assert torch.equal(h, h0)
    wy, wh = ref.selective_scan_ref(xc, z, torch.zeros_like(dt_), a, bm, cm,
                                    d_skip, h0)
    assert torch.equal(wh, h0)
    _assert_scan_close(dt, (y, h), (wy, wh))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_selective_scan_decays_to_the_new_input(dev, dt):
    """dt up to 20 from a large h0: exp(dt a) reaches 2^-126 and below,
    where the SFU's 2^x flushes to 0, so a state keeps only its new input;
    the kernel still agrees with the plain version."""
    from repro_torch.kernels import selective_scan as ss

    xc, z, _, a, bm, cm, d_skip, h0 = _scan_inputs(dev, dt, 2, 40, 96, 16,
                                                   seed=13, with_h0=True)
    rng = np.random.default_rng(14)
    big = torch.from_numpy(rng.uniform(0.0, 20.0, (2, 40, 96)).astype(
        np.float32)).to(dev)
    assert float((big[..., None] * a).min()) < -126.0 / 1.4426950408889634
    ins = (xc, z, big, a, bm, cm, d_skip, 1e3 * h0)
    got = ss.selective_scan(*ins)
    torch.cuda.synchronize()
    _assert_scan_close(dt, got, ref.selective_scan_ref(*ins))


def test_selective_scan_takes_views_off_16_byte_boundaries(dev):
    from repro_torch.kernels import selective_scan as ss

    xc, z, dt, a, bm, cm, d_skip, _ = _scan_inputs(dev, "fp32", 2, 50, 96,
                                                   8, seed=9)
    views = []
    for t in (bm, cm):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 4
        views.append(view)
    _assert_scan_close("fp32", ss.selective_scan(xc, z, dt, a, *views,
                                                 d_skip),
                       ref.selective_scan_ref(xc, z, dt, a, bm, cm, d_skip))


def test_selective_scan_trains_and_refuses_what_it_cannot_take(dev):
    """Under autograd the op launches the forward (saving states) and, in
    the backward, selective_scan_bwd; serving launches the forward alone;
    state sizes and shapes the kernels do not take raise."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_scan as ss

    ins = _scan_inputs(dev, "fp32", 1, 8, 32, 16, seed=2, with_h0=True)
    grad_ins = [t.clone().requires_grad_() for t in ins]
    n_f, n_b = ss.selective_scan.launches, ss.selective_scan_bwd.launches
    y, h = ops.selective_scan(*grad_ins)
    grads = torch.autograd.grad(y.sum() + h.sum(), grad_ins)
    torch.cuda.synchronize()
    assert (ss.selective_scan.launches, ss.selective_scan_bwd.launches) == (
        n_f + 1, n_b + 1)
    assert all(torch.isfinite(g).all() for g in grads)
    with torch.inference_mode():
        assert ops.selective_scan(*grad_ins)[0].shape == ins[0].shape
    assert ss.selective_scan_bwd.launches == n_b + 1
    with pytest.raises(ValueError, match="state size"):
        bad = _scan_inputs(dev, "fp32", 1, 8, 32, 12, seed=2)
        ss.selective_scan(*bad)
    with pytest.raises(ValueError, match="shapes"):
        ss.selective_scan(ins[0], ins[1][:, :4], *ins[2:])
    _, _, states = ss.selective_scan(*ins, save_states=True)
    dy = torch.ones_like(ins[0])
    with pytest.raises(ValueError, match="shapes"):
        ss.selective_scan_bwd(*ins[:7], states[:, :, :16], dy)
    with pytest.raises(ValueError, match="state size"):
        bad = _scan_inputs(dev, "fp32", 1, 8, 32, 12, seed=2)
        ss.selective_scan_bwd(*bad[:7], states, dy)


# The scan's backward: its plain version's names, and the shapes of
# SCAN_SHAPES plus S = 16 (one whole tile of saved states), S = 15 and 33
# (a ragged last tile) and one Di past a 64-channel block.
SCAN_GRADS = ("dx", "dz", "ddt", "da", "dbm", "dcm", "dd", "dh0")
SCAN_BWD_SHAPES = SCAN_SHAPES + [(2, 16, 64, 16), (1, 15, 130, 8),
                                 (3, 33, 65, 16)]


def _scan_bwd_case(dev, dt_name, b, s, di, n, seed, with_h0, with_dh):
    """The scan's inputs (dt = 0 every fifth step), the forward's saved
    states, dy and dh_last."""
    from repro_torch.kernels import selective_scan as ss

    ins = list(_scan_inputs(dev, dt_name, b, s, di, n, seed,
                            with_h0=with_h0))
    ins[2][:, ::5] = 0.0
    rng = np.random.default_rng(seed + 1)
    dy = torch.from_numpy(rng.normal(size=(b, s, di)).astype(
        np.float32)).to(DTYPES[dt_name]).to(dev)
    dh = (torch.from_numpy(rng.normal(size=(b, di, n)).astype(
        np.float32)).to(dev) if with_dh else None)
    y, h, states = ss.selective_scan(*ins, save_states=True)
    wy, wh = ss.selective_scan(*ins)
    assert torch.equal(y, wy) and torch.equal(h, wh)
    assert states.shape == (b, -(-s // 16), di, n)
    return ins, states, dy, dh


def _assert_scan_grads_close(dt_name, got, want):
    """Each gradient within 1e-4 of its largest magnitude (exps by
    ex2.approx through the reverse recurrence and sums over channels, rows
    and steps in another order); dx and dz at bf16 within 1e-2 (one bf16
    rounding)."""
    for name, g, w in zip(SCAN_GRADS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        tol = 1e-2 if dt_name == "bf16" and name in ("dx", "dz") else 1e-4
        err = float((g.float() - w.float()).abs().max())
        scale = max(float(w.float().abs().max()), 1e-30)
        assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


@pytest.mark.parametrize("with_h0,with_dh", [(False, False), (True, True)])
@pytest.mark.parametrize("shape", SCAN_BWD_SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_selective_scan_bwd_matches_plain(dev, dt, shape, with_h0, with_dh):
    from repro_torch.kernels import selective_scan as ss

    ins, states, dy, dh = _scan_bwd_case(dev, dt, *shape, seed=sum(shape),
                                         with_h0=with_h0, with_dh=with_dh)
    h0 = ins[7]
    n0 = ss.selective_scan_bwd.launches
    got = ss.selective_scan_bwd(*ins[:7], states, dy, dh)
    torch.cuda.synchronize()
    assert ss.selective_scan_bwd.launches == n0 + 1
    _assert_scan_grads_close(dt, got, ref.selective_scan_bwd_ref(
        *ins[:7], h0, dy, dh))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_selective_scan_bwd_gives_the_same_bits_every_call(dev, dt):
    """No atomics: two calls give bit-equal gradients (a resumed training
    run repeats the uninterrupted run's losses)."""
    from repro_torch.kernels import selective_scan as ss

    ins, states, dy, dh = _scan_bwd_case(dev, dt, 2, 300, 3200, 16, seed=3,
                                         with_h0=True, with_dh=True)
    first = ss.selective_scan_bwd(*ins[:7], states, dy, dh)
    second = ss.selective_scan_bwd(*ins[:7], states, dy, dh)
    torch.cuda.synchronize()
    for name, a, b in zip(SCAN_GRADS, first, second):
        assert torch.equal(a, b), name


def test_selective_scan_libraries_agree_on_the_saved_state_layout(dev):
    """The forward's chunk between saved states is the backward's, both
    read from the compiled libraries; the states a forward saves are the
    shape the backward takes."""
    from repro_torch.kernels import selective_scan as ss

    ss._bwd_lib()
    assert ss._BWD_LAYOUT["chunk"] == ss.state_chunk()
    assert ss._BWD_LAYOUT["channels"] >= 1
    ins = _scan_inputs(dev, "fp32", 1, 37, 64, 8, seed=4, with_h0=False)
    _, _, states = ss.selective_scan(*ins[:7], save_states=True)
    assert states.shape == (1, ss.n_chunks(37), 64, 8)
    assert ss.n_chunks(37) == -(-37 // ss.state_chunk())


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_selective_scan_bwd_where_the_state_decays_away(dev, dt):
    """dt up to 20 from a large h0: exp(dt a) flushes to 0 on the SFU; the
    backward, which never inverts the recurrence, still agrees."""
    from repro_torch.kernels import selective_scan as ss

    xc, z, _, a, bm, cm, d_skip, h0 = _scan_inputs(dev, dt, 2, 40, 96, 16,
                                                   seed=13, with_h0=True)
    rng = np.random.default_rng(15)
    big = torch.from_numpy(rng.uniform(0.0, 20.0, (2, 40, 96)).astype(
        np.float32)).to(dev)
    ins = (xc, z, big, a, bm, cm, d_skip)
    _, _, states = ss.selective_scan(*ins, 1e3 * h0, save_states=True)
    dy = torch.ones_like(xc)
    got = ss.selective_scan_bwd(*ins, states, dy)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g).all() for g in got)
    _assert_scan_grads_close(dt, got, ref.selective_scan_bwd_ref(
        *ins, 1e3 * h0, dy))


# The backward's lane layout: a channel's N states over N / 4 lanes, 64
# channels a block.  Di not a multiple of the block's channels with B > 1
# (200, bf16 rows on 16-byte boundaries; 72 at N = 8), N = 8 over its 2
# lanes, and a last tile of exactly one step (S = 17, 4,097), whose 15
# zero-staged steps the reverse walk meets first.
SCAN_BWD_LAYOUT_SHAPES = [(3, 40, 200, 16), (2, 33, 72, 8), (1, 17, 64, 16),
                          (2, 17, 64, 8), (2, 4097, 64, 16)]


@pytest.mark.parametrize("shape", SCAN_BWD_LAYOUT_SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_selective_scan_bwd_lane_layout_edges(dev, dt, shape):
    from repro_torch.kernels import selective_scan as ss

    ins, states, dy, dh = _scan_bwd_case(dev, dt, *shape, seed=sum(shape),
                                         with_h0=True, with_dh=True)
    got = ss.selective_scan_bwd(*ins[:7], states, dy, dh)
    again = ss.selective_scan_bwd(*ins[:7], states, dy, dh)
    torch.cuda.synchronize()
    for name, u, w in zip(SCAN_GRADS, got, again):
        assert torch.equal(u, w), name
    _assert_scan_grads_close(dt, got, ref.selective_scan_bwd_ref(
        *ins[:7], ins[7], dy, dh))


def test_selective_scan_bwd_takes_views_off_16_byte_boundaries(dev):
    """Bm, Cm and the saved states are staged 16 bytes at a time: the
    wrapper copies a view that is off a 16-byte boundary first."""
    from repro_torch.kernels import selective_scan as ss

    ins, states, dy, dh = _scan_bwd_case(dev, "fp32", 2, 50, 96, 8, seed=9,
                                         with_h0=False, with_dh=True)
    views = []
    for t in (ins[4], ins[5], states):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 4
        views.append(view)
    got = ss.selective_scan_bwd(*ins[:4], views[0], views[1], ins[6],
                                views[2], dy, dh)
    want = ss.selective_scan_bwd(*ins[:7], states, dy, dh)
    torch.cuda.synchronize()
    for name, u, w in zip(SCAN_GRADS, got, want):
        assert torch.equal(u, w), name


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_selective_scan_bwd_geometry_matches_its_layout(dev, dt, n):
    """The geometry query's channels a block are the layout's (the leading
    extent of the dB, dC partials); N / 4 lanes a channel; at N = 16 an SM
    holds at least 16 of its warps.  The constants the meta device sizes
    the saved states, the partials and the attention's splits by
    (``kernels/work.py``) are the libraries' and the card's."""
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels import work as W

    geo = ss.bwd_geometry(n, DTYPES[dt])
    assert geo["channels"] == ss._BWD_LAYOUT["channels"] == 64
    assert geo["channels"] == W.SCAN_BWD_CHANNELS
    assert ss.state_chunk() == W.SCAN_STATE_CHUNK
    assert torch.cuda.get_device_properties(0).multi_processor_count \
        == W.H100_SMS
    assert geo["threads"] == geo["channels"] * n // 4
    assert geo["blocks_per_sm"] >= 1
    if n == 16:
        assert geo["blocks_per_sm"] * geo["threads"] // 32 >= 16


# (B, S, H, K, hd, window): windows below one KV tile, at and one past it,
# across query blocks, and hymba's heads (25/5, hd 64) with its window at
# S = 2 windows; at S = 1000 with W = 100 a block's late rows meet KV tiles
# that are wholly masked for them before their first visible key.
FLASH_WINDOW_SHAPES = [(2, 300, 4, 2, 16, 1), (2, 300, 9, 3, 64, 17),
                       (1, 1000, 8, 2, 64, 100), (2, 257, 16, 8, 64, 64),
                       (1, 300, 16, 2, 128, 65), (2, 200, 6, 3, 32, 130),
                       (1, 2048, 25, 5, 64, 1024)]


@pytest.mark.parametrize("shape", FLASH_WINDOW_SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_attention_window_matches_plain(dev, dt, shape):
    from repro_torch.kernels import flash_attention as fa

    *dims, window = shape
    q, k, v, _ = _attn_inputs(dev, dt, *dims, seed=sum(shape))
    n0 = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, window=window)
    o, lse = fa.flash_attention(q, k, v, with_lse=True, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 2
    assert torch.equal(o, got)
    want, want_lse = ref.causal_attention_lse_ref(q, k, v, window)
    tol = 1e-5 if dt == "fp32" else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    # The window bites: the result is not the causal one.
    assert not torch.allclose(got.float(), ref.causal_attention_ref(
        q, k, v).float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [(8, 2048, 9, 3, 64), (2, 1000, 9, 3, 64),
                                   (1, 300, 25, 5, 64)])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_attention_window_at_or_above_s_gives_the_causal_bits(
        dev, dt, shape):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, _ = _attn_inputs(dev, dt, *shape, seed=3)
    s = shape[1]
    causal = fa.flash_attention(q, k, v)
    causal_o, causal_lse = fa.flash_attention(q, k, v, with_lse=True)
    for window in (s, s + 5, 10 ** 12):
        assert torch.equal(fa.flash_attention(q, k, v, window=window),
                           causal)
        o, lse = fa.flash_attention(q, k, v, with_lse=True, window=window)
        assert torch.equal(o, causal_o) and torch.equal(lse, causal_lse)


def test_windowed_flash_attention_trains(dev):
    """Under autograd the windowed op launches the forward with its
    log-sum-exp and, in the backward, flash_attention_bwd with the window:
    the gradients equal the kernel's called directly; a negative window
    raises in both."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    q, k, v, do = _attn_inputs(dev, "bf16", 1, 40, 4, 2, 16, seed=8)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n_f, n_b = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    o = ops.flash_attention(*leaves, window=4)
    got = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) \
        == (n_f + 1, n_b + 1)
    o2, lse = fa.flash_attention(q, k, v, with_lse=True, window=4)
    assert torch.equal(o.detach(), o2)
    for a, b in zip(got, fa.flash_attention_bwd(q, k, v, o2, do, lse,
                                                window=4)):
        assert torch.equal(a, b)
    with torch.inference_mode():
        assert ops.flash_attention(*leaves, window=4).shape == q.shape
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_bwd(q, k, v, o2, do, lse, window=-1)


@pytest.mark.parametrize("shape", FLASH_WINDOW_SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_attention_bwd_window_matches_plain(dev, dt, shape):
    """Within the tolerance of max(1, the gradient's largest magnitude), as
    the CPU tests hold the backward to JAX's: at window 1 a query sees only
    its own key, p = 1, and dq and dk are 0 up to rounding."""
    from repro_torch.kernels import flash_attention as fa

    *dims, window = shape
    q, k, v, do = _attn_inputs(dev, dt, *dims, seed=sum(shape) + 1)
    o, lse = fa.flash_attention(q, k, v, with_lse=True, window=window)
    n0 = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == n0 + 1
    _assert_bwd_close(dt, got, ref.flash_attention_bwd_ref(
        q, k, v, o, do, lse, window), floor=1.0)
    if dt == "bf16":
        # Both dK/dV grids: the query heads split over blocks.
        group = dims[2] // dims[3]
        got = fa.flash_attention_bwd(q, k, v, o, do, lse, splits=group,
                                     window=window)
        _assert_bwd_close(dt, got, ref.flash_attention_bwd_ref(
            q, k, v, o, do, lse, window), floor=1.0)


@pytest.mark.parametrize("shape", [(2, 1000, 9, 3, 64), (1, 300, 25, 5, 64),
                                   (1, 200, 16, 2, 128)])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_attention_bwd_window_at_or_above_s_gives_the_causal_bits(
        dev, dt, shape):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do = _attn_inputs(dev, dt, *shape, seed=4)
    s = shape[1]
    o, lse = fa.flash_attention(q, k, v, with_lse=True)
    causal = fa.flash_attention_bwd(q, k, v, o, do, lse)
    for window in (s, s + 5, 10 ** 12):
        for a, b in zip(fa.flash_attention_bwd(q, k, v, o, do, lse,
                                               window=window), causal):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_attention_bwd_window_gives_the_same_bits_every_call(dev, dt):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do = _attn_inputs(dev, dt, 2, 1000, 25, 5, 64, seed=6)
    o, lse = fa.flash_attention(q, k, v, with_lse=True, window=100)
    first = fa.flash_attention_bwd(q, k, v, o, do, lse, window=100)
    second = fa.flash_attention_bwd(q, k, v, o, do, lse, window=100)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_ssm_and_hybrid_prefill_and_decode_on_card_match_cpu(dev, arch,
                                                            dtype, tol):
    """The reduced SSM and hybrid LMs (hymba's window cut to 8, so a
    24-token prompt is windowed and a 16-slot cache ring holds 8) from the
    same parameters on both devices: prefill and eight decode steps; the
    card runs selective_scan in every prefill layer and, for hymba, the
    windowed flash_attention."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.models.model_api import build

    cfg = dataclasses.replace(get_config(arch).reduced(), param_dtype=dtype,
                              compute_dtype=dtype, window=8)
    tokens = np.random.default_rng(12).integers(0, cfg.vocab, (2, 32))
    model = build(cfg, device="cpu").init(seed=0)
    n_fa, n_ss = fa.flash_attention.launches, ss.selective_scan.launches
    out = {}
    for d in ("cpu", dev):
        bundle = build(cfg, device=d)
        m = model if d == "cpu" else copy.deepcopy(model).to(d)
        logits, cache = bundle.prefill(m, {"tokens": tokens[:, :24]},
                                       cache_len=16)
        steps = [logits]
        for i in range(8):
            logits, cache = bundle.decode(m, tokens[:, 24 + i:25 + i], cache)
            steps.append(logits)
        out["cpu" if d == "cpu" else "card"] = torch.stack(steps).cpu()
    assert ss.selective_scan.launches == n_ss + cfg.n_layers
    assert fa.flash_attention.launches == n_fa + (
        cfg.n_layers if cfg.family == "hybrid" else 0)
    assert torch.isfinite(out["card"]).all()
    torch.testing.assert_close(out["card"], out["cpu"], rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_ssm_and_hybrid_grads_on_card_match_cpu(dev, arch):
    """The reduced SSM and hybrid LMs in fp32 (hymba's window cut to 8, S =
    24) from the same parameters on both devices: the loss within rtol
    1e-5 and every gradient within 1e-4 of its largest magnitude; the card
    runs selective_scan_bwd (and the windowed flash_attention_bwd) once a
    layer."""
    import dataclasses

    from repro_torch.configs import RunConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.models.transformer import init_lm, lm_loss

    cfg = dataclasses.replace(get_config(arch).reduced(), window=8)
    rng = np.random.default_rng(21)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)))
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)],
                       dim=1)
    cpu = init_lm(cfg, seed=0, device="cpu").requires_grad_(True)
    card = copy.deepcopy(cpu).to(dev)
    n_ss, n_fa = ss.selective_scan_bwd.launches, \
        fa.flash_attention_bwd.launches
    res = {}
    for name, model in (("cpu", cpu), ("card", card)):
        d = next(model.parameters()).device
        loss = lm_loss(model, cfg, RunConfig(remat="full"), tokens.to(d),
                       labels.to(d))
        res[name] = (loss.item(), [g.cpu() for g in torch.autograd.grad(
            loss, list(model.parameters()))])
    assert ss.selective_scan_bwd.launches == n_ss + cfg.n_layers
    assert fa.flash_attention_bwd.launches == n_fa + (
        cfg.n_layers if cfg.family == "hybrid" else 0)
    np.testing.assert_allclose(res["card"][0], res["cpu"][0], rtol=1e-5)
    for (name, _), g, w in zip(cpu.named_parameters(), res["card"][1],
                               res["cpu"][1]):
        err = float((g - w).abs().max())
        assert err <= 1e-4 * max(float(w.abs().max()), 1e-30), name


# The unmasked (causal=False) attention, whisper's encoder's: (B, S, H, K,
# hd) at whisper's heads (20/20, hd 64) with S = 1, 17 and 1,500 (a
# 30-second window), a GQA layout, hd 16, 32 and 128, S ragged against the
# bf16 kernels' 64-key tiles and 128-query blocks.
FLASH_FULL_SHAPES = [(2, 1, 20, 20, 64), (2, 17, 20, 20, 64),
                     (1, 1500, 20, 20, 64), (2, 300, 9, 3, 64),
                     (2, 100, 4, 2, 16), (1, 65, 6, 3, 32),
                     (1, 129, 16, 2, 128), (2, 200, 48, 8, 128)]


@pytest.mark.parametrize("shape", FLASH_FULL_SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_attention_unmasked_matches_plain(dev, dt, shape):
    """The forward, served and with its log-sum-exp (the same output
    bits), against ``causal_attention_ref(causal=False)``; not the causal
    result (S > 1)."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, _ = _attn_inputs(dev, dt, *shape, seed=sum(shape) + 2)
    n0 = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=False)
    o, lse = fa.flash_attention(q, k, v, with_lse=True, causal=False)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 2
    assert torch.equal(o, got)
    want, want_lse = ref.causal_attention_lse_ref(q, k, v, causal=False)
    tol = 1e-5 if dt == "fp32" else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    if shape[1] > 1:
        assert not torch.allclose(got.float(), ref.causal_attention_ref(
            q, k, v).float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", FLASH_FULL_SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_attention_bwd_unmasked_matches_plain(dev, dt, shape):
    """Each gradient within 1e-5 (fp32) or 2e-2 (bf16) of max(1, its
    largest magnitude) of ``flash_attention_bwd_ref(causal=False)``, as the
    windowed backward is held: at S = 1 a query sees only its own key, p =
    1, and dq and dk are 0 up to rounding.  bf16 also with the G query
    heads split over blocks."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do = _attn_inputs(dev, dt, *shape, seed=sum(shape) + 3)
    o, lse = fa.flash_attention(q, k, v, with_lse=True, causal=False)
    n0 = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, causal=False)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == n0 + 1
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=False)
    _assert_bwd_close(dt, got, want, floor=1.0)
    group = shape[2] // shape[3]
    if dt == "bf16" and group > 1:
        _assert_bwd_close(dt, fa.flash_attention_bwd(
            q, k, v, o, do, lse, splits=group, causal=False), want,
            floor=1.0)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_attention_bwd_unmasked_gives_the_same_bits_every_call(dev,
                                                                     dt):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do = _attn_inputs(dev, dt, 2, 1000, 20, 20, 64, seed=9)
    o, lse = fa.flash_attention(q, k, v, with_lse=True, causal=False)
    first = fa.flash_attention_bwd(q, k, v, o, do, lse, causal=False)
    second = fa.flash_attention_bwd(q, k, v, o, do, lse, causal=False)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_unmasked_flash_attention_trains_and_refuses_a_window(dev):
    """Under autograd ``ops.flash_attention(causal=False)`` launches the
    unmasked forward and backward: the gradients equal the kernels' called
    directly; a window with causal=False raises in both wrappers."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    q, k, v, do = _attn_inputs(dev, "bf16", 1, 40, 4, 2, 16, seed=8)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n_f, n_b = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    o = ops.flash_attention(*leaves, causal=False)
    got = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) \
        == (n_f + 1, n_b + 1)
    o2, lse = fa.flash_attention(q, k, v, with_lse=True, causal=False)
    assert torch.equal(o.detach(), o2)
    for a, b in zip(got, fa.flash_attention_bwd(q, k, v, o2, do, lse,
                                                causal=False)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, v, window=4, causal=False)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_bwd(q, k, v, o2, do, lse, window=4, causal=False)


def test_whisper_on_card_matches_cpu(dev):
    """Reduced whisper-large-v3 in fp32 from the same parameters on both
    devices: the loss within rtol 1e-5 and every gradient within 1e-4 of
    its largest magnitude under ``remat="full"``, then prefill and three
    decode steps within 1e-4; the card runs the unmasked flash_attention
    and its backward in every encoder layer and the causal ones in every
    decoder layer."""
    from repro_torch.configs import RunConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model_api import build

    cfg = get_config("whisper-large-v3").reduced()
    rng = np.random.default_rng(22)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 12)),
             "frontend": rng.normal(size=(2, cfg.enc_len, cfg.d_model))
             .astype(np.float32)}
    batch["labels"] = np.roll(batch["tokens"], -1, axis=1)
    cpu = build(cfg, device="cpu").init(seed=0).requires_grad_(True)
    card = copy.deepcopy(cpu).to(dev)
    n_f, n_b = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    res = {}
    for name, model, d in (("cpu", cpu, "cpu"), ("card", card, dev)):
        bundle = build(cfg, device=d, run=RunConfig(remat="full"))
        loss = bundle.loss(model, batch)
        grads = [g.cpu() for g in torch.autograd.grad(
            loss, list(model.parameters()))]
        logits, cache = bundle.prefill(model, batch, cache_len=16)
        steps = [logits]
        for i in range(3):
            logits, cache = bundle.decode(model, batch["tokens"][:, i:i + 1],
                                          cache)
            steps.append(logits)
        res[name] = (loss.item(), grads, torch.stack(steps).cpu())
    layers = cfg.n_enc_layers + cfg.n_layers
    # Loss (twice a layer under remat) and prefill (once).
    assert fa.flash_attention.launches == n_f + 3 * layers
    assert fa.flash_attention_bwd.launches == n_b + layers
    np.testing.assert_allclose(res["card"][0], res["cpu"][0], rtol=1e-5)
    for (name, _), g, w in zip(cpu.named_parameters(), res["card"][1],
                               res["cpu"][1]):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), \
            name
    torch.testing.assert_close(res["card"][2], res["cpu"][2], rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# The forward at a query offset (a sequence-parallel rank's queries against
# every key): against ``ref.kv_stream_attention_ref`` at fp32 1e-5 and bf16
# 1e-2; the rows of a split equal the same rows of the whole attention bit
# for bit; offset 0 with Sq = Sk is the old call.
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, K, hd, offset, window, causal)
OFFSET_SHAPES = [(2, 512, 2048, 16, 2, 128, off, 0, True)
                 for off in (0, 512, 1024, 1536)] + [
    (2, 512, 2048, 16, 2, 128, 1536, 700, True),
    (2, 512, 2048, 16, 2, 128, 0, 0, False),
    (2, 300, 1000, 9, 3, 64, 100, 0, True),
    (1, 37, 120, 4, 2, 16, 60, 25, True),
    (1, 17, 65, 6, 3, 32, 48, 0, True),
    (1, 130, 70, 8, 8, 64, 0, 0, False)]


@pytest.mark.parametrize("shape", OFFSET_SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_attention_offset_matches_plain(dev, dt, shape):
    from repro_torch.kernels import flash_attention as fa

    b, sq, sk, h, n_kv, hd, off, w, causal = shape
    rng = np.random.default_rng(sk + off)
    qf, k, v = (torch.from_numpy(rng.normal(size=(b, s, n, hd)).astype(
        np.float32)).to(DTYPES[dt]).to(dev)
        for s, n in ((max(sk, off + sq), h), (sk, n_kv), (sk, n_kv)))
    q = qf[:, off:off + sq].contiguous()
    n0 = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, window=w, causal=causal, q_offset=off)
    o, lse = fa.flash_attention(q, k, v, with_lse=True, window=w,
                                causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 2
    assert got.shape == q.shape and lse.shape == (b, h, sq)
    assert torch.equal(o, got)
    want = ref.kv_stream_attention_ref(q, k, v, w, 512, off, causal)
    tol = 1e-5 if dt == "fp32" else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)
    if causal and sq + off <= sk:
        whole = fa.flash_attention(qf[:, :sk].contiguous(), k, v, window=w)
        assert torch.equal(got, whole[:, off:off + sq])


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_attention_offset_zero_is_the_old_call(dev, dt):
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 1000, n, 64)).astype(
        np.float32)).to(DTYPES[dt]).to(dev) for n in (9, 3, 3))
    for w, causal in ((0, True), (300, True), (0, False)):
        assert torch.equal(
            fa.flash_attention(q, k, v, window=w, causal=causal),
            fa.flash_attention(q, k, v, window=w, causal=causal,
                               q_offset=0))


def test_flash_attention_offset_refuses_queries_past_the_keys(dev):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    q = torch.zeros((1, 64, 4, 16), device=dev)
    kv = torch.zeros((1, 100, 2, 16), device=dev)
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention(q, kv, kv, q_offset=37)
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention(q, kv, kv, q_offset=-1)
    # Unmasked, any Sk serves every row.
    assert fa.flash_attention(q, kv, kv, causal=False,
                              q_offset=37).shape == q.shape
    # Under autograd too: the backward takes the offset, within the keys.
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q.requires_grad_(True), kv, kv, q_offset=37)
    assert ops.flash_attention(q, kv, kv, q_offset=36).requires_grad


# ---------------------------------------------------------------------------
# The backward at a query offset (a sequence-parallel rank's queries under
# a gradient): against ``ref.flash_attention_bwd_ref`` at the offset within
# 1e-5 (fp32) and 2e-2 (bf16) of each gradient's largest magnitude, with
# offsets that are and are not whole query tiles, causal, windowed and
# unmasked; the keys no query of the call sees get zeros; a split's dq
# rows stacked and its dk/dv summed equal the whole call's (dq's rows bit
# for bit where the offsets are whole 64-row tiles: each dq block walks the
# keys the whole call's walks).
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, K, hd, offset, window, causal)
OFFSET_BWD_SHAPES = [
    (2, 512, 1024, 16, 2, 128, 512, 0, True),
    (1, 300, 1000, 9, 3, 64, 100, 0, True),
    (2, 17, 65, 6, 3, 32, 48, 0, True),
    (1, 37, 120, 4, 2, 16, 60, 25, True),
    (1, 200, 600, 8, 2, 64, 333, 150, True),
    (1, 256, 1024, 8, 1, 64, 768, 100, True),
    (1, 130, 70, 8, 8, 64, 0, 0, False),
    (1, 100, 257, 6, 3, 32, 17, 0, False)]


@pytest.mark.parametrize("shape", OFFSET_BWD_SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_attention_bwd_offset_matches_plain(dev, dt, shape):
    from repro_torch.kernels import flash_attention as fa

    b, sq, sk, h, n_kv, hd, off, w, causal = shape
    rng = np.random.default_rng(sq + sk + off)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, s, n, hd)).astype(
        np.float32)).to(DTYPES[dt]).to(dev)
        for s, n in ((sq, h), (sk, n_kv), (sk, n_kv), (sq, h)))
    o, lse = fa.flash_attention(q, k, v, with_lse=True, window=w,
                                causal=causal, q_offset=off)
    n0 = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, window=w,
                                 causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == n0 + 1
    _assert_bwd_close(dt, got, ref.flash_attention_bwd_ref(
        q, k, v, o, do, lse, w, causal, off))
    if causal:  # keys past the last query, or below the first's window
        lo = max(0, off - w + 1) if w else 0
        for g in got[1:]:
            assert not g[:, off + sq:].any() and not g[:, :lo].any()


# (B, S, H, K, hd, parts, window, causal)
SPLIT_BWD_CASES = [(1, 1024, 16, 2, 128, 4, 0, True),
                   (1, 1024, 16, 2, 128, 4, 300, True),
                   (1, 1024, 16, 2, 128, 4, 0, False),
                   (2, 300, 9, 3, 64, 3, 0, True),
                   (2, 300, 9, 3, 64, 3, 70, True)]


@pytest.mark.parametrize("case", SPLIT_BWD_CASES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_attention_bwd_split_sums_to_the_whole(dev, dt, case):
    from repro_torch.kernels import flash_attention as fa

    b, s, h, n_kv, hd, parts, w, causal = case
    q, k, v, do = _attn_inputs(dev, dt, b, s, h, n_kv, hd, seed=s + w)
    o, lse = fa.flash_attention(q, k, v, with_lse=True, window=w,
                                causal=causal)
    whole = fa.flash_attention_bwd(q, k, v, o, do, lse, window=w,
                                   causal=causal)
    n = s // parts
    dqs, dk, dv = [], torch.zeros_like(k, dtype=torch.float32), \
        torch.zeros_like(v, dtype=torch.float32)
    for i in range(parts):
        sl = slice(i * n, (i + 1) * n)
        gq, gk, gv = fa.flash_attention_bwd(
            q[:, sl].contiguous(), k, v, o[:, sl].contiguous(),
            do[:, sl].contiguous(), lse[:, :, sl].contiguous(), window=w,
            causal=causal, q_offset=i * n)
        dqs.append(gq)
        dk += gk.float()
        dv += gv.float()
    got = (torch.cat(dqs, dim=1), dk.to(k.dtype), dv.to(v.dtype))
    _assert_bwd_close(dt, got, whole)
    if n % 64 == 0:
        assert torch.equal(got[0], whole[0])


def test_offset_attention_trains_through_the_kernels(dev):
    """ops.flash_attention at an offset under autograd: the kernels on the
    card (one forward, one backward) against the plain versions' autograd
    on the CPU, fp32."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    rng = np.random.default_rng(11)
    base = [torch.from_numpy(rng.normal(size=(2, s, n, 32)).astype(
        np.float32)) for s, n in ((96, 8), (256, 2), (256, 2), (96, 8))]
    res = {}
    for where in ("cpu", "card"):
        q, k, v, dout = (t.to(dev if where == "card" else "cpu")
                         for t in base)
        q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
        n0 = fa.flash_attention_bwd.launches
        o = ops.flash_attention(q, k, v, window=120, q_offset=130)
        o.backward(dout)
        if where == "card":
            torch.cuda.synchronize()
            assert fa.flash_attention_bwd.launches == n0 + 1
        res[where] = [t.detach().cpu() for t in (o, q.grad, k.grad,
                                                 v.grad)]
    for g, w in zip(res["card"], res["cpu"]):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
