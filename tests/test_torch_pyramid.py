"""The pyramid's resize with its fixed-order backward
(``swnerf_torch/ops/pyramid.py::_Resize``) against ``F.interpolate`` and
against the JAX package's ``jax.image.resize(..., "linear")``.

The forward is ``F.interpolate``'s, bit for bit. The backward applies the
adjoint of the same separable map as two matrix products (no atomics, so on
a card two launches give the same bits): within atol 1e-6 of that adjoint in
float64 (measured max |d| 4.4e-7), within atol and rtol 1e-6 of
``F.interpolate``'s own autograd beyond the distance that autograd lies from
the float64 adjoint itself (at 12 -> 25 it lies 3.5e-6 away, and the two
fp32 results 2.2e-6 apart), and within atol 1e-5 / rtol 1e-6 of ``jax.vjp``
of the JAX package's resize (the bar
``tests/test_torch_multires.py`` holds the reconstruction's VJP to). The
sizes are MultiRes phase 2's at 200x200 (``configs/multires/lego.txt``,
half_res): the Gaussian pyramid's halvings, the reconstruction's doublings,
and the odd 25 -> 12 and 12 -> 25.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swnerf_torch.ops import pyramid as tp
from swnerf_tpu.ops import pyramid as jp

SIZES = [(200, 100), (100, 50), (50, 25), (25, 12), (12, 25), (25, 50), (50, 100), (100, 200)]
IDS = [f"{a}to{b}" for a, b in SIZES]


def _case(n_in, n_out, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (2, n_in, n_in, 3)).astype(np.float32)
    g = rng.standard_normal((2, n_out, n_out, 3)).astype(np.float32)
    return x, g


@pytest.mark.parametrize("n_in,n_out", SIZES, ids=IDS)
def test_resize_forward_is_interpolate_bit_for_bit(n_in, n_out):
    x, _ = _case(n_in, n_out, 0)
    xt = torch.from_numpy(x)
    assert torch.equal(tp._resize(xt, n_out, n_out), tp._interpolate(xt, n_out, n_out))


@pytest.mark.parametrize("n_in,n_out", SIZES, ids=IDS)
def test_resize_backward_matches_interpolate_autograd(n_in, n_out):
    x, g = _case(n_in, n_out, 1)
    got, ref = (torch.from_numpy(x).requires_grad_(True) for _ in range(2))
    (tp._resize(got, n_out, n_out) * torch.from_numpy(g)).sum().backward()
    (tp._interpolate(ref, n_out, n_out) * torch.from_numpy(g)).sum().backward()
    exact = tp.resize_backward(torch.from_numpy(g).double(), n_in, n_in).numpy()
    np.testing.assert_allclose(got.grad.numpy(), exact, atol=1e-6, rtol=0)
    slack = np.abs(ref.grad.numpy() - exact).max()
    np.testing.assert_allclose(got.grad.numpy(), ref.grad.numpy(), atol=1e-6 + slack, rtol=1e-6)
    again = torch.from_numpy(x).requires_grad_(True)
    (tp._resize(again, n_out, n_out) * torch.from_numpy(g)).sum().backward()
    assert torch.equal(again.grad, got.grad)  # fixed order: the same bits


@pytest.mark.parametrize("n_in,n_out", SIZES, ids=IDS)
def test_resize_backward_matches_jax_vjp(n_in, n_out):
    x, g = _case(n_in, n_out, 2)
    _, vjp = jax.vjp(lambda a: jp._resize(a, n_out, n_out), jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tp._resize(xt, n_out, n_out) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-6)


def test_axis_matrix_rows_are_the_interpolation_weights():
    """Each row of the axis matrix sums to 1 (the triangle kernel is
    renormalised at the edges), the matrix is cached per size pair and type,
    and it resizes a 1-D signal as F.interpolate does."""
    a = tp.axis_matrix(25, 12)
    assert a.shape == (12, 25)
    np.testing.assert_allclose(a.sum(1).numpy(), np.ones(12), atol=1e-6)
    assert tp.axis_matrix(25, 12) is a
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (1, 25, 25, 1)).astype(np.float32))
    rows = tp._interpolate(x, 12, 25)[0, :, :, 0]
    np.testing.assert_allclose((a @ x[0, :, :, 0]).numpy(), rows.numpy(), atol=1e-6)
