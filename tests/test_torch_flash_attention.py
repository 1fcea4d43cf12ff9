"""The port's attention plain versions against the JAX package's.

``flash_attention_ref`` (the Pallas kernel's (BH, S, hd) contract) is held
against the Pallas ``flash_attention`` run in interpret mode, at the shapes
of ``tests/test_kernels.py``, fp32 within 2e-4 and bf16 within 3e-2 (the
tolerances there: the kernel sums blocks in another order, and rounds its
bf16 output).  ``causal_attention_ref`` (the model's GQA layout, the plain
version of the CUDA kernel) is held against the JAX model's
``blocked_causal_attention`` with H=4 and K in {2, 4}, at S=12 (its plain
branch) and at S=2,100 with bq=bk=512 (its padded blocked branch, a ragged
tail), fp32 within 1e-5.  The inputs are numpy draws handed to both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models.layers import blocked_causal_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _draw(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("bh,s,hd,bq,bk", [
    (2, 128, 64, 64, 64),
    (4, 256, 64, 64, 128),
    (1, 512, 128, 128, 128),
    (3, 256, 32, 256, 64),
])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_attention_ref_matches_pallas(dt, bh, s, hd, bq, bk):
    jdt, tdt = DTYPES[dt]
    q, k, v = _draw([(bh, s, hd)] * 3, seed=bh * s + hd)
    want = pallas_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)), bq=bq,
                        bk=bk, interpret=True)
    got = ref.flash_attention_ref(*(torch.from_numpy(a).to(tdt)
                                    for a in (q, k, v)))
    assert got.dtype == tdt and got.shape == (bh, s, hd)
    tol = 2e-4 if dt == "fp32" else 3e-2
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("s", [12, 2100])
@pytest.mark.parametrize("n_kv", [2, 4])
def test_causal_attention_ref_matches_jax_blocked(n_kv, s):
    b, h, hd = 2 if s < 100 else 1, 4, 16
    q, k, v = _draw([(b, s, h, hd), (b, s, n_kv, hd), (b, s, n_kv, hd)],
                    seed=s + n_kv)
    want = blocked_causal_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), bq=512, bk=512)
    got = ref.causal_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_query_head_h_reads_kv_head_h_div_g():
    """H=4 over K=2: heads 0, 1 read KV head 0 and heads 2, 3 KV head 1
    (``h // G``), not ``h % K``."""
    b, s, h, n_kv, hd = 1, 9, 4, 2, 16
    q, k, v = (torch.from_numpy(a) for a in _draw(
        [(b, s, h, hd), (b, s, n_kv, hd), (b, s, n_kv, hd)], seed=3))
    out = ref.causal_attention_ref(q, k, v)
    for head in range(h):
        kv = head // (h // n_kv)
        alone = ref.flash_attention_ref(q[:, :, head], k[:, :, kv],
                                        v[:, :, kv])
        torch.testing.assert_close(out[:, :, head], alone, rtol=0, atol=0)
        if kv != head % n_kv:
            assert not torch.allclose(out[:, :, head], ref.flash_attention_ref(
                q[:, :, head], k[:, :, head % n_kv], v[:, :, head % n_kv]))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_ops_flash_attention_is_the_plain_version_on_the_cpu(dt):
    tdt = DTYPES[dt][1]
    q, k, v = (torch.from_numpy(a).to(tdt) for a in _draw(
        [(2, 33, 6, 32), (2, 33, 3, 32), (2, 33, 3, 32)], seed=4))
    before = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v)
    assert got.dtype == tdt
    assert torch.equal(got, ref.causal_attention_ref(q, k, v))
    assert fa.flash_attention.launches == before


def test_ops_flash_attention_keeps_gradients_on_the_cpu():
    """On the CPU the plain forward and backward run under autograd (on the
    card, the kernel and ``flash_attention_bwd``)."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _draw(
        [(1, 5, 2, 16), (1, 5, 1, 16), (1, 5, 1, 16)], seed=5))
    ops.flash_attention(q, k, v).sum().backward()
    assert all(t.grad is not None for t in (q, k, v))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper never runs the plain version: a CPU tensor is an error,
    not a fallback."""
    q = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention(q, q[:, :, :1].contiguous(),
                           q[:, :, :1].contiguous())


@pytest.mark.parametrize("b,s,n_kv,group,sms,want", [
    (4, 4096, 3, 3, 132, 1),   # the LM training cut: 768 key-tile blocks
    (1, 4096, 2, 8, 132, 4),   # qwen2.5-3b's heads: 128 blocks -> 512
    (1, 200, 2, 8, 132, 8),    # 8 blocks: every head a block of its own
    (1, 4096, 2, 1, 132, 1),   # one head a KV head: nothing to split
    (2, 1000, 3, 3, 132, 3),   # 96 blocks -> 288
])
def test_bwd_splits_fill_two_blocks_an_sm(b, s, n_kv, group, sms, want):
    """The bf16 backward splits a KV head's query heads over blocks only
    until its dK/dV grid gives each SM two blocks."""
    assert fa.bwd_splits(b, s, n_kv, group, sms) == want


def test_bwd_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 4, 2, 16))
    kv = q[:, :, :1].contiguous()
    lse = torch.zeros((1, 2, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_bwd(q, kv, kv, q, q, lse)
