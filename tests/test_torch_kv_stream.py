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
an offset trains: a split's dq rows and summed dk/dv equal ``jax.grad`` of
JAX's whole attention within 1e-5, causal, windowed and unmasked.
"""
import jax
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


GRAD_CASES = [(True, 0), (True, 50), (False, 0)]


@pytest.mark.parametrize("impl", ["kv_stream", "flash_attention"])
@pytest.mark.parametrize("causal,window", GRAD_CASES)
def test_offset_under_autograd_is_refused(causal, window, impl):
    """The offset under autograd is no longer refused: over the four
    shards of a split, each shard's dq rows and the shards' summed dk/dv
    (each shard's queries at their offset against every key) equal
    ``jax.grad`` of JAX's whole attention (``kv_stream_attention``;
    unmasked, ``plain_attention(causal=False)``) within 1e-5 of each
    gradient's largest magnitude, fp32; through ``layers.
    kv_stream_attention`` (its CPU path, autograd through JAX's online
    softmax) and ``ops.flash_attention`` (the kernel's plain twins:
    ``causal_attention_lse_ref`` and ``flash_attention_bwd_ref`` at the
    offset)."""
    q, k, v = _qkv(window + 11)
    dout = np.random.default_rng(window + 12).normal(
        size=q.shape).astype(np.float32)
    if causal:
        fn = lambda q_, k_, v_: JL.kv_stream_attention(  # noqa: E731
            q_, k_, v_, window=window, bk=BK)
    else:
        fn = lambda q_, k_, v_: JL.plain_attention(  # noqa: E731
            q_, k_, v_, causal=False)
    _, vjp = jax.vjp(fn, *(jnp.asarray(t) for t in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    kt, vt = (torch.from_numpy(t).requires_grad_(True) for t in (k, v))
    n = S // SPLIT
    dqs = []
    for part in range(SPLIT):
        lo = part * n
        qs = torch.from_numpy(q[:, lo:lo + n].copy()).requires_grad_(True)
        if impl == "kv_stream":
            out = L.kv_stream_attention(qs, kt, vt, window, BK, q_offset=lo,
                                        causal=causal)
        else:
            out = ops.flash_attention(qs, kt, vt, window, causal, lo)
        out.backward(torch.from_numpy(dout[:, lo:lo + n].copy()))
        dqs.append(qs.grad.numpy())
    got = [np.concatenate(dqs, axis=1), kt.grad.numpy(), vt.grad.numpy()]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        err = float(np.abs(g - w).max())
        assert err <= 1e-5 * max(1.0, float(np.abs(w).max())), (name, err)
