"""The port's affine warp against the JAX package, on the CPU.

``affine_warp`` on a CPU tensor runs ``affine_warp_plain`` (the gather
sampler at the kernel's sample positions).  It is held against JAX
``grid_sample(affine_grid(theta))`` and against the Pallas kernel in
interpret mode with a window wide enough to lose no taps.  Tolerance
1e-4 (rtol and atol), as ``tests/test_pallas_warp.py``: the two sides
round the sample positions in different orders.  The gradient is held
against ``jax.grad``; the gradient of a gradient against the JAX gather
form only, because Pallas interpret mode cannot nest kernel traces.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gantrack_tpu.ops.grid_sample import affine_grid as j_affine_grid
from gantrack_tpu.ops.grid_sample import grid_sample as j_grid_sample
from gantrack_tpu.ops.pallas.warp import affine_warp as j_affine_warp
from gantrack_tpu.ops.pallas.warp import window_bounds_for
from gantrack_tpu_torch import ops
from gantrack_tpu_torch.ops import warp as wp
from gantrack_tpu_torch.ops.grid_sample import warp_coefficients

TOL = dict(rtol=1e-4, atol=1e-4)


def _theta(n, rng, mag=0.05, flip=False):
    theta = np.tile(np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32), (n, 1, 1))
    theta += rng.standard_normal((n, 2, 3)).astype(np.float32) * mag
    if flip:
        theta[::2, :, 0] *= -1  # x-flip every other sample: a = -1
    return theta


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("c,flip,sizes", [
    (1, False, (64, 72, 48, 56)),
    (2, False, (64, 72, 48, 56)),
    (3, True, (40, 36, 40, 36)),
    (1, True, (24, 40, 52, 30)),   # output larger than the input on one axis
])
def test_forward_matches_jax_gather_and_pallas(c, flip, sizes):
    h, w, out_h, out_w = sizes
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, h, w, c)).astype(np.float32)
    theta = _theta(2, rng, flip=flip)
    want = np.asarray(j_grid_sample(jnp.asarray(img), j_affine_grid(jnp.asarray(theta),
                                                                    out_h, out_w)))
    pallas = np.asarray(j_affine_warp(jnp.asarray(img), jnp.asarray(theta), out_h, out_w,
                                      window=window_bounds_for(2.5, 0.3), interpret=True))
    got = _nhwc(ops.affine_warp(_nchw(img), torch.from_numpy(theta), out_h, out_w))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


def test_plain_equals_the_port_grid_sample_chain():
    """``affine_warp`` = the port's ``grid_sample(affine_grid)``, and the
    coefficient algebra is the JAX wrapper's."""
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.standard_normal((3, 2, 20, 28)).astype(np.float32))
    theta = torch.from_numpy(_theta(3, rng, mag=0.3))
    got = ops.affine_warp(img, theta, 17, 31)
    want = ops.grid_sample(img, ops.affine_grid(theta, 17, 31))
    torch.testing.assert_close(got, want, **TOL)
    coeffs = warp_coefficients(theta, 20, 28, 17, 31)
    torch.testing.assert_close(wp.affine_warp_plain(img, coeffs, 17, 31), got, rtol=0, atol=0)


def test_gradient_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 48, 64, 1)).astype(np.float32)
    theta = _theta(2, rng)
    win = window_bounds_for(1.8, 0.2)
    jt = jnp.asarray(theta)
    g_ref = jax.grad(lambda x: jnp.sum(jnp.sin(j_grid_sample(x, j_affine_grid(jt, 40, 48)))))(
        jnp.asarray(img))
    g_pal = jax.grad(lambda x: jnp.sum(jnp.sin(
        j_affine_warp(x, jt, 40, 48, window=win, interpret=True))))(jnp.asarray(img))
    x = _nchw(img).requires_grad_(True)
    (g,) = torch.autograd.grad(torch.sin(ops.affine_warp(x, torch.from_numpy(theta), 40, 48)).sum(),
                               x)
    np.testing.assert_allclose(_nhwc(g), np.asarray(g_ref), **TOL)
    np.testing.assert_allclose(_nhwc(g), np.asarray(g_pal), **TOL)


def test_gradient_of_gradient_matches_jax_gather_form():
    """An R1-like penalty through the warp: the gradient of the squared
    input gradient."""
    rng = np.random.default_rng(4)
    img = rng.standard_normal((1, 32, 40, 1)).astype(np.float32)
    theta = _theta(1, rng)
    wgt = rng.standard_normal((1, 28, 36, 1)).astype(np.float32)
    jt, jw = jnp.asarray(theta), jnp.asarray(wgt)

    def j_r1(x):
        gx = jax.grad(lambda xi: jnp.sum(jax.nn.softplus(
            j_grid_sample(xi, j_affine_grid(jt, 28, 36))) * jw))(x)
        return jnp.sum(jnp.square(gx))

    want = np.asarray(jax.grad(j_r1)(jnp.asarray(img)))
    x = _nchw(img).requires_grad_(True)
    out = ops.affine_warp(x, torch.from_numpy(theta), 28, 36)
    (gx,) = torch.autograd.grad((torch.nn.functional.softplus(out) * _nchw(wgt)).sum(), x,
                                create_graph=True)
    (ggx,) = torch.autograd.grad(gx.square().sum(), x)
    np.testing.assert_allclose(_nhwc(ggx), want, **TOL)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernels have no CPU mode: a CPU tensor reaches them only by
    mistake, and that raises instead of computing something else."""
    x = torch.zeros((1, 4, 4))
    coeffs = torch.zeros((1, 6))
    with pytest.raises(ValueError, match="CUDA tensor"):
        wp.warp_planes(x, coeffs, 4, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        wp.splat_planes(x, coeffs, 4, 4)
    assert wp.LAUNCHES == {"warp": 0, "splat": 0}
