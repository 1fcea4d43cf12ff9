"""The port's bidirectional Chamfer against the JAX package's, on the CPU.

The same NumPy inputs go through the port's plain version
(``kernels/ref.py::chamfer_ref``), its autograd entry point
(``kernels/ops.py::chamfer``, the plain version for CPU tensors), the
Pallas kernel in interpret mode (ragged batches included) and
``repro.core.chamfer.chamfer_bidirectional_vec``.  Tolerances: the loss
within fp32 rtol 1e-5 (the sums run in another order in each framework);
the argmins equal NumPy's float64 argmins (the inputs have no near-ties);
the gradient with respect to ``po`` against ``jax.grad`` within 1e-5, and
``gradcheck`` in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.chamfer import chamfer_bidirectional_vec
from repro_torch.kernels import ops, ref


def _inputs(b, n_p, n_w, n_f, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n_p, n_f)).astype(np.float32),
            rng.normal(size=(b, n_w, n_f)).astype(np.float32))


@pytest.mark.parametrize("b,n_p,n_w,n_f,block", [
    (256, 5, 15, 25, 64),
    (100, 5, 15, 25, 64),   # ragged batch vs block
    (7, 5, 15, 25, 4),      # ragged batch vs block
    (16, 3, 9, 8, 16),
    (1, 5, 15, 25, 512),
])
def test_chamfer_matches_pallas_and_core(b, n_p, n_w, n_f, block):
    from repro.core.chamfer import chamfer_bidirectional_vec as jax_vec
    from repro.kernels.chamfer_kernel import chamfer as pallas_chamfer

    po, w = _inputs(b, n_p, n_w, n_f, b + n_f)
    loss, af, ab = ref.chamfer_ref(torch.from_numpy(po), torch.from_numpy(w))
    assert loss.dtype == torch.float32 and loss.shape == (b,)
    assert af.dtype == ab.dtype == torch.int32
    got = ops.chamfer(torch.from_numpy(po), torch.from_numpy(w))
    assert torch.equal(got, loss)
    assert torch.equal(chamfer_bidirectional_vec(torch.from_numpy(po),
                                                 torch.from_numpy(w)), loss)
    for want in (pallas_chamfer(jnp.asarray(po), jnp.asarray(w), 0.7,
                                block=block, interpret=True),
                 jax_vec(jnp.asarray(po), jnp.asarray(w), 0.7)):
        np.testing.assert_allclose(loss.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=0)
    d2 = ((po[:, :, None, :].astype(np.float64)
           - w[:, None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(af.numpy(), d2.argmin(2))
    np.testing.assert_array_equal(ab.numpy(), d2.argmin(1))


def test_chamfer_ties_go_to_the_lowest_index():
    po, w = _inputs(2, 3, 4, 5, 0)
    w[:, 2] = w[:, 1]      # two equal targets
    po[:, 2] = po[:, 0]    # two equal predictions
    _, af, ab = ref.chamfer_ref(torch.from_numpy(po), torch.from_numpy(w))
    assert not (af.numpy() == 2).any()
    assert not (ab.numpy() == 2).any()


@pytest.mark.parametrize("b,n_p,n_w,n_f", [(32, 5, 15, 25), (9, 3, 7, 4)])
def test_chamfer_grad_matches_jax(b, n_p, n_w, n_f):
    from repro.core.chamfer import chamfer_bidirectional_vec as jax_vec

    po, w = _inputs(b, n_p, n_w, n_f, 7 * b)
    scale = np.linspace(0.5, 1.5, b).astype(np.float32)
    tpo = torch.from_numpy(po).requires_grad_()
    (ops.chamfer(tpo, torch.from_numpy(w)) * torch.from_numpy(scale)).sum() \
        .backward()
    want = jax.grad(lambda p: (jax_vec(p, jnp.asarray(w), 0.7)
                               * jnp.asarray(scale)).sum())(jnp.asarray(po))
    np.testing.assert_allclose(tpo.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_chamfer_w_gets_no_gradient():
    po, w = _inputs(4, 5, 15, 25, 3)
    tpo = torch.from_numpy(po).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    ops.chamfer(tpo, tw).sum().backward()
    assert tpo.grad is not None and tw.grad is None


@pytest.mark.parametrize("b,n_p,n_w,n_f", [(3, 5, 15, 6), (2, 2, 3, 4)])
def test_chamfer_backward_gradcheck(b, n_p, n_w, n_f):
    po, w = _inputs(b, n_p, n_w, n_f, b)
    tpo = torch.from_numpy(po).double().requires_grad_()
    tw = torch.from_numpy(w).double()
    assert torch.autograd.gradcheck(lambda p: ops.chamfer(p, tw, 0.7),
                                    (tpo,))


@pytest.mark.parametrize("name,vec", [
    ("pairwise_abs", False), ("chamfer_forward", False),
    ("chamfer_bidirectional", False), ("l2_truncated", False),
    ("pairwise_sqdist", True), ("l2_truncated_vec", True)])
def test_plain_chamfer_helpers_match_jax(name, vec):
    """The module's functions outside any kernel, on scalar (B, P) / (B, W)
    or vector (B, P, F) / (B, W, F) sets, within fp32 rtol 1e-6."""
    from repro.core import chamfer as jch
    from repro_torch.core import chamfer as tch

    po, w = _inputs(6, 5, 15, 4, 11)
    if not vec:
        po, w = po[..., 0], w[..., 0]
    got = getattr(tch, name)(torch.from_numpy(po), torch.from_numpy(w))
    want = getattr(jch, name)(jnp.asarray(po), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
