"""The port's quantized fast-tier kernels (plain versions) against the JAX
package's.

The same numpy-seeded inputs go through the JAX references and Pallas
kernels (interpret mode, as the JAX package's own tests run them on the
CPU) and through the port's plain PyTorch versions.  Tolerances:

* codes are compared bit for bit through uint8 views;
* scales within fp32 rtol 2e-7 (one ulp), as ``tests/test_quantization.py``
  allows between the JAX paths (the Pallas kernel's scale differs from the
  jnp reference's by one ulp; the port's equals the jnp reference's);
* the dequantizing row gathers do one multiply per element: bit-exact;
* the dequantizing pooled gather sums P products in fp32: rtol 1e-6 (XLA
  may fuse a product and its sum into one rounding in interpret mode).

The CUDA kernels are held against these plain versions on the card in
``tests/test_torch_cuda_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tiered import _JIT_GATHER_Q, _JIT_GATHER_Q_OV
from repro.kernels.embedding_gather import (gather_pool_dequant,
                                            gather_rows_dequant,
                                            quantize_rows,
                                            quantize_rows_ref)
from repro_torch.kernels import embedding_gather as eg
from repro_torch.kernels import ops, ref

FORMATS = ("int8", "fp8")


def _rows(m, d, seed, spread=1e3):
    """Rows of magnitudes within ``spread`` of 1 either way, plus the edge
    cases: a zero row, a row of exact half-integers whose absmax is 127
    (the int8 scale is then exactly 1, so round-half-even decides every
    element), and a row whose absmax element lands on qmax after the
    division."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, d))
         * rng.uniform(1 / spread, spread, size=(m, 1))).astype(np.float32)
    x[0] = 0.0
    x[1] = (np.arange(d) % 16 - 8 + 0.5).astype(np.float32)
    x[1, 0] = 127.0
    x[2, d // 2] = -np.abs(x[2]).max() * 3
    return x


def _bits(q):
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy()
    return np.asarray(q).view(np.uint8)


def _quantized(n, d, row_format, seed, spread=1e3):
    """The same (n, d) quantized table in both frameworks."""
    q, s = ref.quantize_rows_ref(torch.from_numpy(_rows(n, d, seed, spread)),
                                 row_format)
    jdt = jnp.int8 if row_format == "int8" else jnp.float8_e4m3fn
    jq = jnp.asarray(_bits(q).view(np.int8)).view(jdt)
    return (jq, jnp.asarray(s.numpy())), (q, s)


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("row_format", FORMATS)
def test_quantize_rows_ref_matches_jax(row_format, d):
    x = _rows(300, d, 0)
    got_q, got_s = ref.quantize_rows_ref(torch.from_numpy(x), row_format)
    assert got_q.dtype == ref.ROW_FORMATS[row_format][0]
    want_q, want_s = quantize_rows_ref(jnp.asarray(x), row_format)
    np.testing.assert_array_equal(_bits(got_q), _bits(want_q))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=2e-7)
    # The Pallas kernel, interpret mode, on the first rows (edge rows too).
    kq, ks = quantize_rows(jnp.asarray(x[:24]), row_format=row_format,
                           interpret=True)
    np.testing.assert_array_equal(_bits(got_q)[:24], _bits(kq))
    np.testing.assert_allclose(got_s.numpy()[:24], np.asarray(ks),
                               rtol=2e-7)


def test_quantize_edge_rows():
    x = _rows(4, 16, 1)
    q, s = ref.quantize_rows_ref(torch.from_numpy(x), "int8")
    assert s[0].item() == np.float32(1e-12) and not q[0].any()
    assert s[1].item() == 1.0
    # Half-integers round to even: -7.5 -> -8, 0.5 -> 0, 1.5 -> 2, 2.5 -> 2.
    np.testing.assert_array_equal(q[1].numpy().astype(np.float32),
                                  np.round(x[1]))
    assert q[2].abs().max().item() == 127
    q8, _ = ref.quantize_rows_ref(torch.from_numpy(x), "fp8")
    assert q8[2].float().abs().max().item() == 448.0


@pytest.mark.parametrize("row_format,bound", [("int8", 1 / 127),
                                              ("fp8", 1 / 16)])
def test_roundtrip_error_bound_per_row(row_format, bound):
    """The bounds of ``tests/test_quantization.py``: int8 within
    max|row|/127 per row, fp8 within max|row|/16."""
    x = np.random.default_rng(7).normal(size=(300, 8)).astype(np.float32)
    q, s = ref.quantize_rows_ref(torch.from_numpy(x), row_format)
    back = ref.dequantize_rows_ref(q, s).numpy()
    amax = np.abs(x).max(axis=1)
    assert (np.abs(back - x).max(axis=1) <= amax * bound + 1e-6).all()


@pytest.mark.parametrize("row_format", FORMATS)
def test_quantize_scatter_ref_writes_only_its_slots(row_format):
    x = _rows(40, 16, 2)
    buf = torch.zeros((64, 16), dtype=ref.ROW_FORMATS[row_format][0])
    scales = torch.full((64,), -1.0)
    slots = torch.from_numpy(
        np.random.default_rng(3).permutation(64)[:40].astype(np.int32))
    ops.quantize_scatter(buf, scales, slots, torch.from_numpy(x), row_format)
    q, s = ref.quantize_rows_ref(torch.from_numpy(x), row_format)
    np.testing.assert_array_equal(_bits(buf)[slots.long()], _bits(q))
    assert torch.equal(scales[slots.long()], s)
    rest = np.setdiff1d(np.arange(64), slots.numpy())
    assert not _bits(buf)[rest].any() and (scales[rest] == -1).all()


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("row_format", FORMATS)
def test_gather_rows_dequant_ref_matches_pallas(row_format, d):
    (jq, js), (q, s) = _quantized(200, d, row_format, 4)
    idx = np.random.default_rng(5).integers(0, 200, 48).astype(np.int32)
    idx[0] = idx[-1]  # a duplicate
    want = gather_rows_dequant(jq, js, jnp.asarray(idx), interpret=True)
    got = ref.gather_rows_dequant_ref(q, s, torch.from_numpy(idx))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_ov", [False, True])
@pytest.mark.parametrize("row_format", FORMATS)
def test_gather_rows_dequant_expand_ref_matches_jit_gather(row_format,
                                                           with_ov):
    """The quantized store's fused read: JAX packs (slots, inv) into one
    padded (2, M) operand and pads ov / host rows to M; the port takes
    them unpadded.  Overflow rows are fp32 host rows."""
    rng = np.random.default_rng(6)
    (jq, js), (q, s) = _quantized(64, 16, row_format, 7)
    u, m = 40, 150
    slots = rng.permutation(64)[:u].astype(np.int32)
    inv = rng.integers(0, u, m).astype(np.int32)
    iv = np.zeros((2, m), np.int32)
    iv[0, :u], iv[1] = slots, inv
    args = (torch.from_numpy(slots), torch.from_numpy(inv))
    if with_ov:
        ov = rng.random(u) < 0.3
        hr = rng.normal(size=(u, 16)).astype(np.float32)
        ov_p, hr_p = np.zeros(m, bool), np.zeros((m, 16), np.float32)
        ov_p[:u], hr_p[:u] = ov, hr
        want = _JIT_GATHER_Q_OV(jq, js, jnp.asarray(iv), jnp.asarray(ov_p),
                                jnp.asarray(hr_p))
        args += (torch.from_numpy(ov), torch.from_numpy(hr))
    else:
        want = _JIT_GATHER_Q(jq, js, jnp.asarray(iv))
    got = ops.gather_rows_dequant_expand(q, s, *args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("row_format", FORMATS)
def test_gather_pool_dequant_ref_matches_pallas(row_format, d):
    """Rows of one magnitude (as the serve's tables): with rows six orders
    apart the sums cancel and an rtol says nothing."""
    (jq, js), (q, s) = _quantized(300, d, row_format, 8, spread=2.0)
    idx = np.random.default_rng(9).integers(0, 300, (24, 5)).astype(np.int32)
    want = np.asarray(gather_pool_dequant(jq, js, jnp.asarray(idx),
                                          interpret=True))
    got = ops.gather_pool_dequant(q, s, torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == (24, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # The plain version sums rounded products in the order p = 0..P-1.
    rows = ref.gather_rows_dequant_ref(q, s, torch.from_numpy(idx.ravel()))
    acc = torch.zeros((24, d))
    for p in range(5):
        acc = acc + rows.reshape(24, 5, d)[:, p]
    assert torch.equal(got, acc)


def test_quantized_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers take CUDA tensors only; ``ops`` sends CPU tensors
    to the plain versions, so nothing here reaches a kernel."""
    q, s = ref.quantize_rows_ref(torch.ones((4, 8)), "int8")
    idx = torch.zeros(3, dtype=torch.int32)
    for call in (lambda: eg.gather_rows_dequant(q, s, idx),
                 lambda: eg.gather_rows_dequant_expand(q, s, idx, idx),
                 lambda: eg.gather_pool_dequant(q, s, idx[None]),
                 lambda: eg.quantize_scatter(q, s, idx, torch.ones((3, 8)),
                                             "int8")):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert all(fn.launches == 0 for fn in eg.KERNELS)


def test_embedding_lookup_dequant_matches_pallas_pool():
    """The quantized-table forward's lookup: one pooled dequantizing gather
    over the flattened tables, against the Pallas kernel on the same codes
    and flattened ids."""
    from repro_torch.configs import get_config
    from repro_torch.models.dlrm import (dlrm_forward,
                                         embedding_lookup_dequant, init_dlrm,
                                         quantize_tables)

    cfg = get_config("dlrm-recmg").reduced()
    params = init_dlrm(cfg, seed=0, device="cpu")
    qp = quantize_tables(params, "int8")
    t, r, d = params["emb"].shape
    rng = np.random.default_rng(10)
    idx = rng.integers(0, r, (6, t, cfg.multi_hot)).astype(np.int32)
    got = embedding_lookup_dequant(qp["emb"], qp["emb_scales"],
                                   torch.from_numpy(idx))
    flat = (idx + (np.arange(t, dtype=np.int32) * r)[None, :, None]
            ).reshape(6 * t, -1)
    jq = jnp.asarray(_bits(qp["emb"]).view(np.int8).reshape(t * r, d))
    want = gather_pool_dequant(jq, jnp.asarray(qp["emb_scales"].numpy()
                                               .reshape(-1)),
                               jnp.asarray(flat), interpret=True)
    np.testing.assert_allclose(got.numpy().reshape(6 * t, d),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
    # The int8 tables stay within the format's error of the fp32 forward.
    dense = torch.from_numpy(rng.normal(size=(6, cfg.dense_features))
                             .astype(np.float32))
    lq = dlrm_forward(qp, cfg, dense, torch.from_numpy(idx))
    lf = dlrm_forward(params, cfg, dense, torch.from_numpy(idx))
    assert lq.shape == (6,) and torch.isfinite(lq).all()
    torch.testing.assert_close(lq, lf, rtol=0.05, atol=0.05)
