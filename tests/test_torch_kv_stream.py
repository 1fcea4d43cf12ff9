"""The sequence-parallel attention's plain versions against the JAX
package's, on the CPU.

``layers.kv_stream_attention`` (the CPU path: ``ref.kv_stream_attention_
ref``, JAX's online softmax over ``bk``-key blocks) at every query offset
of a four-way split, fp32, GQA (4 query heads on 2 KV heads), causal and
in windows of 50, ``bk`` 64 with S = 200 not a multiple of it: each
rank's rows equal the same rows of JAX's whole ``kv_stream_attention``
within 1e-5 (both sum in the same order), and of JAX's ``plain_attention``
within 3e-4 (JAX's own bar between the two,
``tests/test_perf_variants.py:14-24``).  ``ops.flash_attention`` at a
query offset (the kernel's CPU twin) equals JAX's
``plain_attention(q_offset=)`` within 1e-5, causal, windowed and unmasked
with Sq != Sk; Sq = Sk at offset 0 is the old call's bits; under autograd
an offset is refused (its backward is ROADMAP A11c-6e).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L

B, S, H, K, HD, BK = 2, 200, 4, 2, 16, 64
SPLIT = 4


def _qkv(seed, s_q=S, s_k=S):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, s_q, H, HD)).astype(np.float32),
            rng.normal(size=(B, s_k, K, HD)).astype(np.float32),
            rng.normal(size=(B, s_k, K, HD)).astype(np.float32))


@pytest.mark.parametrize("window", [0, 50])
@pytest.mark.parametrize("part", range(SPLIT))
def test_kv_stream_rows_match_jax(part, window):
    q, k, v = _qkv(window + 1)
    whole = np.asarray(JL.kv_stream_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        bk=BK))
    plain = np.asarray(JL.plain_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window))
    n = S // SPLIT
    lo = part * n
    got = L.kv_stream_attention(torch.from_numpy(q[:, lo:lo + n]),
                                torch.from_numpy(k), torch.from_numpy(v),
                                window, BK, q_offset=lo).numpy()
    assert np.abs(got - whole[:, lo:lo + n]).max() <= 1e-5
    assert np.abs(got - plain[:, lo:lo + n]).max() <= 3e-4


@pytest.mark.parametrize("case", ["causal", "window", "unmasked"])
def test_offset_attention_matches_jax_plain(case):
    s_q, s_k, off = 37, 120, 60
    window = 25 if case == "window" else 0
    causal = case != "unmasked"
    q, k, v = _qkv(7, s_q, s_k)
    want = np.asarray(JL.plain_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_offset=off if causal else 0))
    args = [torch.from_numpy(t) for t in (q, k, v)]
    got = ops.flash_attention(*args, window, causal,
                              off if causal else 0).numpy()
    assert np.abs(got - want).max() <= 1e-5
    stream = ref.kv_stream_attention_ref(*args, window, BK,
                                         off if causal else 0,
                                         causal).numpy()
    assert np.abs(stream - want).max() <= 1e-5


def test_offset_zero_is_the_old_call():
    q, k, v = (torch.from_numpy(t) for t in _qkv(3))
    assert torch.equal(ops.flash_attention(q, k, v, 0, True, 0),
                       ref.causal_attention_ref(q, k, v))
    assert torch.equal(ops.flash_attention(q, k, v, 9),
                       ref.causal_attention_ref(q, k, v, 9))


def test_offset_under_autograd_is_refused():
    q, k, v = (torch.from_numpy(t) for t in _qkv(4))
    q = q[:, :50].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="A11c-6e"):
        ops.flash_attention(q, k, v, q_offset=100)
