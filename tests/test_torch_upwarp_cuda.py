"""The upwarp CUDA kernels (K1, K2) against their plain PyTorch version.

Needs an NVIDIA card and ``nvcc``; skips without a card.  Imports no JAX,
so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_upwarp_cuda.py

Tolerance 1e-5 of the largest reference value in float32: kernel and
plain version sample at bitwise-equal positions and sum the same terms
in another order.  K2 must be bitwise deterministic.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gantrack_tpu_torch.ops import upwarp as uw
from gantrack_tpu_torch.ops.upfirdn2d import setup_filter
from gantrack_tpu_torch.training.augment import WAVELETS

H1, W1, OUT_H, OUT_W = 40, 44, 84, 86


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the upwarp kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, n=3, seed=4):
    rng = np.random.default_rng(seed)
    a, s = rng.uniform(-0.12, 0.12, n), rng.uniform(0.9, 1.1, n)
    t = rng.uniform(-0.05, 0.05, (n, 2))
    theta = np.stack([np.stack([np.cos(a) / s, -np.sin(a), t[:, 0]], 1),
                      np.stack([np.sin(a), np.cos(a) / s, t[:, 1]], 1)], 1).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((n, H1, W1)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((n, OUT_H, OUT_W)).astype(np.float32)).to(dev)
    coeffs = uw.warp_coefficients(torch.from_numpy(theta).to(dev), 2 * H1, 2 * W1, OUT_H, OUT_W)
    return x, g, coeffs


def _plain(x, coeffs, fir):
    return uw.up_affine_warp_plain(x[:, None], coeffs, fir, OUT_H, OUT_W)[:, 0]


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device):
    x, g, coeffs = _case(cuda_device)
    fir = setup_filter(WAVELETS["sym6"], device=cuda_device)
    taps = tuple(float(v) for v in fir.cpu())
    x_req = x.clone().requires_grad_(True)
    ref = _plain(x_req, coeffs, fir)
    (ref_adj,) = torch.autograd.grad(ref, x_req, g)
    ref = ref.detach()
    got = uw.upwarp_planes(x, coeffs, taps, OUT_H, OUT_W)
    adj = uw.upsplat_planes(g, coeffs, taps, H1, W1)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert float((adj - ref_adj).abs().max()) <= 1e-5 * float(ref_adj.abs().max())
    assert torch.equal(adj, uw.upsplat_planes(g, coeffs, taps, H1, W1))


@pytest.mark.cuda
def test_upwarp_autograd_to_second_order_on_card(cuda_device):
    """Gradient and gradient of gradient through ``UpWarp`` (K2 then K1
    again) equal autograd of the plain version."""
    x, g, coeffs = _case(cuda_device, seed=5)
    fir = setup_filter(WAVELETS["sym6"], device=cuda_device)
    taps = tuple(float(v) for v in fir.cpu())

    def r1_like(warp):
        xs = x.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad((F.softplus(warp(xs)) * g).sum(), xs, create_graph=True)
        (ggx,) = torch.autograd.grad(gx.square().sum(), xs)
        return gx.detach(), ggx

    gk, ggk = r1_like(lambda t: uw.UpWarp.apply(t, coeffs, taps, OUT_H, OUT_W))
    gp, ggp = r1_like(lambda t: _plain(t, coeffs, fir))
    assert float((gk - gp).abs().max()) <= 1e-5 * float(gp.abs().max())
    assert float((ggk - ggp).abs().max()) <= 1e-5 * float(ggp.abs().max())
