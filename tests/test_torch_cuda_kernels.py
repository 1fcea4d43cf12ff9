"""repro_torch's CUDA kernels against their plain PyTorch versions, on the
card.  These tests need an NVIDIA GPU and nvcc and skip without them; the
file imports no JAX, so it runs on a machine that has none:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_kernels.py -q

Tolerances: the row gathers are pure copies, so bit-exact; the pooled
gather sums P rows in fp32 in another order than ``torch.sum``, so fp32
rtol 1e-5.  Quantized tier: codes bit-exact, scales within one ulp (fp32
rtol 2e-7; both sides divide with IEEE division, so 0 is expected); the
dequantizing row gathers bit-exact (one multiply per element); the
dequantizing pooled gather fp32 rtol/atol 1e-6 (each product rounded on its
own and summed in the order p = 0..P-1 on both sides, so 0 is expected).
The pipelined runtime on the card: the thread scheduler's worker gives the
inline engine's counters and stored bytes exactly, and the degraded read
(the store's gather kernel) and the admission path's batches equal the
CPU's bit for bit.
"""
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
                (1, 300, 16, 2, 128), (3, 77, 8, 8, 32), (2, 64, 6, 3, 64)]
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
    with pytest.raises(NotImplementedError, match="A11b"):
        ops.flash_attention(q, kv, kv)
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
