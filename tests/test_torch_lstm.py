"""The port's LSTM cell against the JAX package's, on the CPU.

The same NumPy inputs go through the port's plain version
(``kernels/ref.py::lstm_cell_ref``), its autograd entry point
(``kernels/ops.py::lstm_cell``, which takes the plain version for CPU
tensors), the Pallas kernel in interpret mode and
``repro.core.lstm.lstm_step``.  K = in + H covers the models' layers (65:
Voyager's encoder, 67: the caching and prefetch encoders, 80: enc2, 88:
dec2, 120: the decoders).  Tolerances: fp32 abs/rel 1e-5 (the product
sums K terms in another order in each framework); the backward against
``jax.grad`` within 1e-5, and ``gradcheck`` in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import lstm as TLS
from repro_torch.kernels import ops, ref

K_DIMS = (65, 67, 80, 88, 120)


def _inputs(b, in_dim, hid, seed):
    rng = np.random.default_rng(seed)
    k = in_dim + hid
    return (rng.normal(size=(b, in_dim)).astype(np.float32),
            rng.normal(size=(b, hid)).astype(np.float32),
            rng.normal(size=(b, hid)).astype(np.float32),
            (rng.normal(size=(k, 4 * hid)) / np.sqrt(k)).astype(np.float32),
            (rng.normal(size=(4 * hid,)) * 0.5).astype(np.float32))


@pytest.mark.parametrize("hid", [16, 40])
@pytest.mark.parametrize("k", K_DIMS)
@pytest.mark.parametrize("b", [1, 7, 64])
def test_lstm_cell_matches_pallas_and_lstm_step(b, k, hid):
    from repro.core import lstm as JLS
    from repro.kernels.lstm_cell import lstm_cell as pallas_lstm_cell

    arrs = _inputs(b, k - hid, hid, 100 * b + k + hid)
    x, h, c, w, bias = (torch.from_numpy(a) for a in arrs)
    h2, c2, gates = ref.lstm_cell_ref(x, h, c, w, bias)
    assert h2.dtype == c2.dtype == gates.dtype == torch.float32
    oh, oc = ops.lstm_cell(x, h, c, w, bias)
    assert torch.equal(oh, h2) and torch.equal(oc, c2)
    jx, jh, jc, jw, jb = (jnp.asarray(a) for a in arrs)
    ph, pc = pallas_lstm_cell(jx, jh, jc, jw, jb, block=4, interpret=True)
    (sh, sc), _ = JLS.lstm_step({"w": jw, "b": jb}, (jh, jc), jx)
    for want_h, want_c in ((ph, pc), (sh, sc)):
        np.testing.assert_allclose(h2.numpy(), np.asarray(want_h),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(c2.numpy(), np.asarray(want_c),
                                   rtol=1e-5, atol=1e-5)
    # The saved gates are the activated i, f, g, o of z = [x, h] w + b.
    z = np.concatenate([arrs[0], arrs[1]], 1).astype(np.float64) @ arrs[3] \
        + arrs[4]
    sig = 1 / (1 + np.exp(-z))
    want_g = np.concatenate([sig[:, :hid], sig[:, hid:2 * hid],
                             np.tanh(z[:, 2 * hid:3 * hid]),
                             sig[:, 3 * hid:]], 1)
    np.testing.assert_allclose(gates.numpy(), want_g, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,in_dim,hid", [(1, 5, 3), (6, 27, 8),
                                          (4, 40, 16)])
def test_lstm_cell_backward_gradcheck(b, in_dim, hid):
    arrs = _inputs(b, in_dim, hid, b + in_dim)
    ins = tuple(torch.from_numpy(a).double().requires_grad_() for a in arrs)
    assert torch.autograd.gradcheck(ops.lstm_cell, ins)


@pytest.mark.parametrize("k", [67, 120])
def test_lstm_cell_grads_match_jax(k):
    from repro.core import lstm as JLS

    hid = 40
    arrs = _inputs(16, k - hid, hid, k)
    ins = [torch.from_numpy(a).requires_grad_() for a in arrs]
    h2, c2 = ops.lstm_cell(*ins)
    (h2.sum() + 0.5 * c2.sum()).backward()

    def f(x, h, c, w, b):
        (h2, c2), _ = JLS.lstm_step({"w": w, "b": b}, (h, c), x)
        return h2.sum() + 0.5 * c2.sum()

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a)
                                                  for a in arrs))
    for t, g in zip(ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-5)


def test_lstm_seq_and_attend_match_jax_per_window():
    """The batch-first ``lstm_seq`` / ``attend`` against the JAX package's
    per-window functions under ``vmap``."""
    from repro.core import lstm as JLS

    rng = np.random.default_rng(0)
    b, t, in_dim, hid = 5, 15, 27, 16
    xs = rng.normal(size=(b, t, in_dim)).astype(np.float32)
    layer = TLS.LSTMLayer(in_dim, hid)
    att = TLS.Attention(hid)
    with torch.no_grad():
        layer.w.copy_(torch.from_numpy(_inputs(1, in_dim, hid, 1)[3]))
        layer.b.copy_(torch.from_numpy(_inputs(1, in_dim, hid, 1)[4]))
        att.wa.copy_(torch.from_numpy(
            rng.normal(size=(hid, hid)).astype(np.float32)))
        hs, (hT, cT) = TLS.lstm_seq(layer, torch.from_numpy(xs))
        ctx = TLS.attend(att, hT, hs)
    jp = {"w": jnp.asarray(layer.w.detach().numpy()),
          "b": jnp.asarray(layer.b.detach().numpy())}
    jhs, (jhT, jcT) = jax.vmap(lambda x: JLS.lstm_seq(jp, x))(jnp.asarray(xs))
    jctx = jax.vmap(lambda h, e: JLS.attend(
        {"wa": jnp.asarray(att.wa.detach().numpy())}, h, e))(jhT, jhs)
    for got, want in ((hs, jhs), (hT, jhT), (cT, jcT), (ctx, jctx)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
