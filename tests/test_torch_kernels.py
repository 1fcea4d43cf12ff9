"""repro_torch's plain kernel versions against the JAX package's kernels.

The same numpy-seeded inputs go through the Pallas kernels (interpret mode,
as the JAX package's own tests run them on the CPU) or the JAX store's
jitted gathers, and through the port's plain PyTorch versions.  Tolerances:
the row gathers are copies, so bit-exact; the pooled gather sums in fp32 in
another order, so fp32 rtol 1e-6.  The CUDA kernels themselves are held
against these plain versions on the card in ``test_torch_cuda_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tiered import _JIT_GATHER, _JIT_GATHER_OV
from repro.kernels.embedding_gather import gather_pool, gather_rows
from repro_torch.kernels import embedding_gather as eg
from repro_torch.kernels import ops, ref

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _table(n, d, dt, seed):
    """The same (n, d) table in both frameworks: fp32 numpy draws, rounded
    to bf16 the same way (nearest-even) by both."""
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    """A JAX or torch array as fp32 numpy (exact for fp32 and bf16)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gather_rows_ref_matches_pallas(dt, d):
    jt, tt = _table(200, d, dt, 0)
    idx = np.random.default_rng(1).integers(0, 200, 48).astype(np.int32)
    idx[0] = idx[-1]  # a duplicate
    want = gather_rows(jt, jnp.asarray(idx), interpret=True)
    got = ref.gather_rows_ref(tt, torch.from_numpy(idx))
    assert got.dtype == tt.dtype
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("with_ov", [False, True])
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gather_rows_expand_ref_matches_jit_gather(dt, d, with_ov):
    """The store's fused read: JAX packs (slots, inv) into one padded
    (2, M) operand and pads ov / host rows to M; the port takes them
    unpadded."""
    rng = np.random.default_rng(2)
    jt, tt = _table(64, d, dt, 3)
    u, m = 40, 150
    slots = rng.permutation(64)[:u].astype(np.int32)
    inv = rng.integers(0, u, m).astype(np.int32)
    iv = np.zeros((2, m), np.int32)
    iv[0, :u] = slots
    iv[1] = inv
    if with_ov:
        ov = rng.random(u) < 0.3
        hj, ht = _table(u, d, dt, 4)
        ov_pad = np.zeros(m, bool)
        ov_pad[:u] = ov
        hr_pad = jnp.zeros((m, d), jt.dtype).at[:u].set(hj)
        want = _JIT_GATHER_OV(jt, jnp.asarray(iv), jnp.asarray(ov_pad),
                              hr_pad)
        got = ref.gather_rows_expand_ref(tt, torch.from_numpy(slots),
                                         torch.from_numpy(inv),
                                         torch.from_numpy(ov), ht)
    else:
        want = _JIT_GATHER(jt, jnp.asarray(iv))
        got = ref.gather_rows_expand_ref(tt, torch.from_numpy(slots),
                                         torch.from_numpy(inv))
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gather_pool_ref_matches_pallas(dt, d):
    jt, tt = _table(300, d, dt, 5)
    idx = np.random.default_rng(6).integers(0, 300, (12, 7)).astype(np.int32)
    want = gather_pool(jt, jnp.asarray(idx), interpret=True)
    got = ref.gather_pool_ref(tt, torch.from_numpy(idx))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_ops_take_the_plain_path_for_cpu_tensors():
    _, tt = _table(50, 16, "fp32", 7)
    idx = torch.from_numpy(np.random.default_rng(8).integers(
        0, 50, (6, 3)).astype(np.int32))
    before = [fn.launches for fn in eg.KERNELS]
    torch.testing.assert_close(ops.gather_pool(tt, idx),
                               ref.gather_pool_ref(tt, idx))
    flat = idx.reshape(-1)
    inv = torch.tensor([0, 3, 3, 1], dtype=torch.int32)
    assert torch.equal(ops.gather_rows_expand(tt, flat, inv),
                       tt[flat[inv.long()].long()])
    assert [fn.launches for fn in eg.KERNELS] == before


@pytest.mark.parametrize("fn,args", [
    (eg.gather_rows, lambda t, i: (t, i[:, 0].contiguous())),
    (eg.gather_rows_expand, lambda t, i: (t, i[:, 0].contiguous(),
                                          i[:, 1].contiguous())),
    (eg.gather_pool, lambda t, i: (t, i)),
])
def test_kernel_wrappers_refuse_cpu_tensors(fn, args):
    """A kernel wrapper never runs the plain version: a CPU tensor is an
    error there, not a fallback."""
    t = torch.zeros((4, 16))
    i = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(*args(t, i))


def test_refs_clamp_out_of_range_ids_like_xla():
    _, tt = _table(10, 16, "fp32", 9)
    idx = torch.tensor([-3, 0, 9, 25], dtype=torch.int32)
    assert torch.equal(ref.gather_rows_ref(tt, idx), tt[[0, 0, 9, 9]])
    pooled = ref.gather_pool_ref(tt, idx.reshape(2, 2))
    torch.testing.assert_close(pooled, torch.stack([tt[0] + tt[0],
                                                    tt[9] + tt[9]]))
