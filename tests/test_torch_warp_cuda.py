"""The affine warp CUDA kernels (K3, K4) against their plain PyTorch version.

Needs an NVIDIA card and ``nvcc``; skips without a card.  Imports no JAX,
so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_warp_cuda.py

Tolerance 1e-5 of the largest reference value in float32: kernel and
plain version sample at bitwise-equal positions and sum the same four
terms in another order.  K4 must be bitwise deterministic.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gantrack_tpu_torch.ops import warp as wp
from gantrack_tpu_torch.ops.grid_sample import warp_coefficients

H, W, OUT_H, OUT_W = 40, 44, 36, 50


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the warp kernels have no CPU mode")
    return torch.device("cuda")


def _thetas(rng, n):
    a, s = rng.uniform(-0.6, 0.6, n), rng.uniform(0.7, 1.3, n)
    t = rng.uniform(-0.2, 0.2, (n, 2))
    flip = np.where(np.arange(n) % 2 == 1, -1.0, 1.0)  # every other plane x-flipped
    return np.stack([np.stack([flip * np.cos(a) / s, -np.sin(a), t[:, 0]], 1),
                     np.stack([flip * np.sin(a), np.cos(a) / s, t[:, 1]], 1)], 1).astype(np.float32)


def _case(dev, n=4, seed=4, theta=None):
    rng = np.random.default_rng(seed)
    theta = _thetas(rng, n) if theta is None else theta
    x = torch.from_numpy(rng.standard_normal((n, H, W)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((n, OUT_H, OUT_W)).astype(np.float32)).to(dev)
    coeffs = warp_coefficients(torch.from_numpy(theta).to(dev), H, W, OUT_H, OUT_W)
    return x, g, coeffs


def _plain(x, coeffs):
    return wp.affine_warp_plain(x[:, None], coeffs, OUT_H, OUT_W)[:, 0]


def _plain_adjoint(g, coeffs):
    x = torch.zeros((g.shape[0], H, W), device=g.device, requires_grad=True)
    return torch.autograd.grad(_plain(x, coeffs), x, g)[0]


def _close(got, ref, rel=1e-5):
    assert float((got - ref).abs().max()) <= rel * float(ref.abs().max())


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device):
    x, g, coeffs = _case(cuda_device)
    got = wp.warp_planes(x, coeffs, OUT_H, OUT_W)
    adj = wp.splat_planes(g, coeffs, H, W)
    torch.cuda.synchronize()
    _close(got, _plain(x, coeffs))
    _close(adj, _plain_adjoint(g, coeffs))
    assert torch.equal(adj, wp.splat_planes(g, coeffs, H, W))
    # bf16 planes, f32 sums: the rounding of the output dominates.
    gotb = wp.warp_planes(x.bfloat16(), coeffs, OUT_H, OUT_W)
    _close(gotb.float(), _plain(x.bfloat16().float(), coeffs), rel=1e-2)
    adjb = wp.splat_planes(g.bfloat16(), coeffs, H, W)
    _close(adjb.float(), _plain_adjoint(g.bfloat16().float(), coeffs), rel=1e-2)


@pytest.mark.cuda
def test_singular_and_degenerate_transforms_on_card(cuda_device):
    """det = 0 (all outputs sample one row), a zero matrix (one point), a
    far-away translation (nothing sampled) and NaN coefficients (zeros):
    K4 stays the exact adjoint of K3."""
    theta = np.array([
        [[1.0, 0.0, 0.0], [0.0, 0.0, 0.1]],
        [[0.0, 0.0, 0.3], [0.0, 0.0, -0.2]],
        [[1.0, 0.0, 50.0], [0.0, 1.0, 0.0]],
        [[np.nan, 0.0, 0.0], [0.0, 1.0, 0.0]],
    ], dtype=np.float32)
    x, g, coeffs = _case(cuda_device, theta=theta)
    got = wp.warp_planes(x, coeffs, OUT_H, OUT_W)
    adj = wp.splat_planes(g, coeffs, H, W)
    torch.cuda.synchronize()
    ok = slice(0, 3)  # the plain version propagates NaN; the kernels give zeros
    ref = _plain(x[ok], coeffs[ok])
    assert float((got[ok] - ref).abs().max()) <= 1e-5 * float(x.abs().max())
    ref_adj = _plain_adjoint(g[ok], coeffs[ok])
    assert float((adj[ok] - ref_adj).abs().max()) <= 1e-4 * float(ref_adj.abs().max())
    assert not got[2].any() and not adj[2].any()
    assert not got[3].any() and not adj[3].any()


@pytest.mark.cuda
def test_many_planes_on_card(cuda_device):
    """More planes than grid.z holds (65535): the kernels walk them."""
    n = 70000
    rng = np.random.default_rng(6)
    theta = torch.from_numpy(_thetas(rng, n)).to(cuda_device)
    x = torch.randn((n, 8, 9), device=cuda_device)
    coeffs = warp_coefficients(theta, 8, 9, 7, 10)
    got = wp.warp_planes(x, coeffs, 7, 10)
    ref = wp.affine_warp_plain(x[:, None], coeffs, 7, 10)[:, 0]
    _close(got, ref)
    g = torch.randn((n, 7, 10), device=cuda_device)
    lhs = (got.double() * g.double()).sum()
    rhs = (x.double() * wp.splat_planes(g, coeffs, 8, 9).double()).sum()
    assert abs(float(lhs - rhs)) <= 1e-5 * abs(float(lhs))


@pytest.mark.cuda
def test_warp_autograd_to_second_order_on_card(cuda_device):
    """Gradient and gradient of gradient through ``Warp`` (K4 then K3
    again) equal autograd of the plain version; ``affine_warp`` on NCHW
    equals the plain version too."""
    x, g, coeffs = _case(cuda_device, seed=5)

    def r1_like(warp):
        xs = x.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad((F.softplus(warp(xs)) * g).sum(), xs, create_graph=True)
        (ggx,) = torch.autograd.grad(gx.square().sum(), xs)
        return gx.detach(), ggx

    gk, ggk = r1_like(lambda t: wp.Warp.apply(t, coeffs, OUT_H, OUT_W))
    gp, ggp = r1_like(lambda t: _plain(t, coeffs))
    _close(gk, gp)
    _close(ggk, ggp)

    rng = np.random.default_rng(7)
    theta = torch.from_numpy(_thetas(rng, 2)).to(cuda_device)
    img = torch.from_numpy(rng.standard_normal((2, 3, H, W)).astype(np.float32)).to(cuda_device)
    ref = wp.affine_warp_plain(img, warp_coefficients(theta, H, W, OUT_H, OUT_W), OUT_H, OUT_W)
    _close(wp.affine_warp(img, theta, OUT_H, OUT_W), ref)
