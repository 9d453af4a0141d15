"""The port's fused upsample+warp (``gantrack_tpu_torch.ops.upwarp``).

On the CPU ``up_affine_warp`` runs its plain version (upsample2d + the
gather sampler).  It is held against the JAX Pallas pair in interpret
mode (forward, gradient) and against the JAX gather composition
``grid_sample(upsample2d(...))`` (forward, gradient, gradient of
gradient: the Pallas pair's own grad-of-grad cannot run on the CPU).
Tolerance 2e-4, as ``test_upwarp.py``: the 12-tap FIR and the bilinear
weights are summed in another order, and the kernel form computes the
sample positions from pixel-space coefficients rather than the
normalised grid.

The CUDA kernels themselves are held against the plain version in
``test_torch_upwarp_cuda.py``, on a machine with a card.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from gantrack_tpu.ops.grid_sample import affine_grid as j_affine_grid
from gantrack_tpu.ops.grid_sample import grid_sample as j_grid_sample
from gantrack_tpu.ops.pallas.upwarp import up_affine_warp as j_up_affine_warp
from gantrack_tpu.ops.upfirdn2d import setup_filter as j_setup_filter
from gantrack_tpu.ops.upfirdn2d import upsample2d as j_upsample2d
from gantrack_tpu_torch.ops import upwarp as uw
from gantrack_tpu_torch.ops.upfirdn2d import setup_filter
from gantrack_tpu_torch.training.augment import WAVELETS

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
WINDOW = (40, 384)
FIR = np.asarray(j_setup_filter(WAVELETS["sym6"]), np.float32)


def _thetas(n, seed=3):
    rng = np.random.default_rng(seed)
    ms = []
    for _ in range(n):
        a = rng.uniform(-0.12, 0.12)
        s = rng.uniform(0.9, 1.1)
        tx, ty = rng.uniform(-0.05, 0.05, 2)
        ms.append([[np.cos(a) / s, -np.sin(a), tx], [np.sin(a), np.cos(a) / s, ty]])
    return np.asarray(ms, np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _jax_composition(x, theta, out_h, out_w):
    up = j_upsample2d(x, jnp.asarray(FIR), up=2)
    return j_grid_sample(up, j_affine_grid(theta, out_h, out_w))


def _port(x, theta, out_h, out_w):
    return uw.up_affine_warp(x, theta, FIR, out_h, out_w)


def _case(seed=0, n=2, h1=20, w1=22):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h1, w1, 1)).astype(np.float32)
    out_h, out_w = 2 * h1 + 4, 2 * w1 - 2
    ct = rng.standard_normal((n, out_h, out_w, 1)).astype(np.float32)
    return x, _thetas(n, seed + 3), out_h, out_w, ct


def test_plain_matches_jax_pallas_interpret():
    x, theta, out_h, out_w, ct = _case(0)
    want = j_up_affine_warp(jnp.asarray(x), jnp.asarray(theta), FIR, out_h, out_w, WINDOW,
                            interpret=True)
    g_want = jax.grad(lambda im: jnp.sum(j_up_affine_warp(
        im, jnp.asarray(theta), FIR, out_h, out_w, WINDOW, interpret=True) * ct))(jnp.asarray(x))
    xt = _nchw(x).requires_grad_(True)
    got = _port(xt, torch.from_numpy(theta), out_h, out_w)
    (g_got,) = torch.autograd.grad(got, xt, _nchw(ct))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_nhwc(g_got), np.asarray(g_want), **TOL)


def test_plain_matches_jax_gather_composition_to_second_order():
    x, theta, out_h, out_w, ct = _case(1)
    th = jnp.asarray(theta)

    def f_j(im):
        return jnp.sum(jax.nn.softplus(_jax_composition(im, th, out_h, out_w)) * ct)

    want = _jax_composition(jnp.asarray(x), th, out_h, out_w)
    g_want = jax.grad(f_j)(jnp.asarray(x))
    gg_want = jax.grad(lambda im: jnp.sum(jnp.square(jax.grad(f_j)(im))))(jnp.asarray(x))

    xt = _nchw(x).requires_grad_(True)
    got = _port(xt, torch.from_numpy(theta), out_h, out_w)
    (g_got,) = torch.autograd.grad((F.softplus(got) * _nchw(ct)).sum(), xt, create_graph=True)
    (gg_got,) = torch.autograd.grad(g_got.square().sum(), xt)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_nhwc(g_got), np.asarray(g_want), **TOL)
    np.testing.assert_allclose(_nhwc(gg_got), np.asarray(gg_want), **TOL)


def test_plain_pair_is_adjoint():
    x, theta, out_h, out_w, ct = _case(2)
    xt = _nchw(x).double().requires_grad_(True)
    coeffs = uw.warp_coefficients(torch.from_numpy(theta), 2 * x.shape[1], 2 * x.shape[2],
                                  out_h, out_w)
    fir = setup_filter(WAVELETS["sym6"]).double()
    y = uw.up_affine_warp_plain(xt, coeffs, fir, out_h, out_w)
    g = _nchw(ct).double()
    (splat,) = torch.autograd.grad(y, xt, g)
    lhs = float((y.detach() * g).sum())
    rhs = float((xt.detach() * splat).sum())
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


def test_positions_match_kernel_rounding():
    """The plain version samples at (a*ox + b*oy) + c, rounded per
    operation: the positions the kernel computes with __fmul_rn/__fadd_rn."""
    theta = torch.from_numpy(_thetas(2))
    c = uw.warp_coefficients(theta, 40, 44, 7, 9)
    fx, fy = uw.sample_positions(c, 7, 9)
    a, b, cc = (c[:, i].numpy().astype(np.float32) for i in range(3))
    ox = np.arange(9, dtype=np.float32)[None, None, :]
    oy = np.arange(7, dtype=np.float32)[None, :, None]
    ref = (a[:, None, None] * ox + b[:, None, None] * oy) + cc[:, None, None]
    np.testing.assert_array_equal(fx.numpy(), ref)
    assert fy.shape == fx.shape


def test_cuda_tensor_without_kernel_never_falls_back():
    """A non-CPU tensor goes to the kernel wrapper, which validates it;
    the plain version is reached only from a CPU tensor."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        uw.upwarp_planes(torch.zeros(1, 4, 4), torch.zeros(1, 6), tuple(FIR.tolist()), 8, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        uw.upsplat_planes(torch.zeros(1, 8, 8), torch.zeros(1, 6), tuple(FIR.tolist()), 4, 4)
