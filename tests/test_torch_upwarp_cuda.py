"""The upwarp CUDA kernels (K1, K2) against their plain PyTorch version.

Needs an NVIDIA card and ``nvcc``; skips without a card.  Imports no JAX,
so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_upwarp_cuda.py

Tolerance 1e-5 of the largest reference value in float32: kernel and
plain version sample at bitwise-equal positions and sum the same terms
in another order; 1e-2 in bf16, where the output's rounding dominates.
K2 must be bitwise deterministic.  Blocks whose box exceeds the shared
buffer (K1's direct gather, K2's cotangents read from device memory) are
counted, so the cases show that both branches of each kernel ran.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gantrack_tpu_torch.ops import upwarp as uw
from gantrack_tpu_torch.ops.upfirdn2d import setup_filter
from gantrack_tpu_torch.training.augment import WAVELETS, AugmentPipe, medical_augment_config

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


def _plain(x, coeffs, fir, out_h=OUT_H, out_w=OUT_W):
    return uw.up_affine_warp_plain(x[:, None], coeffs, fir, out_h, out_w)[:, 0]


def _plain_adjoint(g, coeffs, fir, h1, w1):
    x = torch.zeros((g.shape[0], h1, w1), device=g.device, requires_grad=True)
    return torch.autograd.grad(_plain(x, coeffs, fir, *g.shape[1:]), x, g)[0]


def _fir(dev):
    fir = setup_filter(WAVELETS["sym6"], device=dev)
    return fir, tuple(float(v) for v in fir.cpu())


def _close(got, ref, rel=1e-5):
    assert float((got.float() - ref).abs().max()) <= rel * float(ref.abs().max())


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device):
    x, g, coeffs = _case(cuda_device)
    fir, taps = _fir(cuda_device)
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


def _rot_scale(n, angle_deg, scale, rng):
    """n transforms: a rotation by ``angle_deg`` (every other one negated)
    at ``scale`` canvas pixels an output pixel, with small shifts."""
    a = np.deg2rad(angle_deg) * np.where(np.arange(n) % 2 == 1, -1.0, 1.0)
    t = rng.uniform(-0.05, 0.05, (n, 2))
    return np.stack([np.stack([scale * np.cos(a), -scale * np.sin(a), t[:, 0]], 1),
                     np.stack([scale * np.sin(a), scale * np.cos(a), t[:, 1]], 1)], 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,planes,shape", [
    ("augment draws", 64, (406, 403, 524, 524)),     # the augment's call, odd width
    ("augment draws", 32, (406, 403, 524, 524)),
    ("odd widths, cut tiles", 1, (41, 43, 70, 86)),
    ("rotate 45, scale 0.5", 32, (60, 61, 100, 110)),
    ("rotate 45, scale 2", 32, (60, 61, 100, 110)),
    ("zoom out 8", 2, (90, 91, 120, 130)),           # K1's boxes overflow: the direct gather
])
def test_kernels_match_plain_across_transforms_on_card(cuda_device, kind, planes, shape):
    """K1 and K2 against the plain version (f32 at 1e-5, bf16 at 1e-2),
    adjoint to each other (<K1 x, g> = <x, K2 g> in float64 at 1e-5) and K2
    bitwise deterministic; the blocks that read from device memory counted
    where the boxes overflow: K1's at the zoom out, K2's at scale 0.5 (its
    cotangent box is then larger than 16 KB in bf16 as well)."""
    h1, w1, oh, ow = shape
    rng = np.random.default_rng(10)
    if kind == "augment draws":
        pipe = AugmentPipe(medical_augment_config(), 256, 256, 1)
        gen = torch.Generator(device=cuda_device).manual_seed(planes)
        theta = pipe.warp_geometry(pipe.sample_geometric(planes, 1.0, cuda_device, gen))[0]
    else:
        angle, scale = {"odd widths, cut tiles": (7, 1.0), "rotate 45, scale 0.5": (45, 0.5),
                        "rotate 45, scale 2": (45, 2.0), "zoom out 8": (10, 8.0)}[kind]
        # Scaled by ow / w2: ``scale`` canvas pixels an output pixel.
        theta = torch.from_numpy(_rot_scale(planes, angle, scale * ow / (2 * w1), rng))
    coeffs = uw.warp_coefficients(theta.float().to(cuda_device), 2 * h1, 2 * w1, oh, ow)
    fir, taps = _fir(cuda_device)
    x = torch.from_numpy(rng.standard_normal((planes, h1, w1)).astype(np.float32)).to(cuda_device)
    g = torch.from_numpy(rng.standard_normal((planes, oh, ow)).astype(np.float32)).to(cuda_device)

    direct, unstaged, unstaged_b = (torch.zeros(1, dtype=torch.int32, device=cuda_device)
                                    for _ in range(3))
    got = uw.upwarp_planes(x, coeffs, taps, oh, ow, direct_blocks=direct)
    adj = uw.upsplat_planes(g, coeffs, taps, h1, w1, global_blocks=unstaged)
    torch.cuda.synchronize()
    _close(got, _plain(x, coeffs, fir, oh, ow))
    _close(adj, _plain_adjoint(g, coeffs, fir, h1, w1))
    assert (int(direct) > 0) == (kind == "zoom out 8"), int(direct)
    assert torch.equal(adj, uw.upsplat_planes(g, coeffs, taps, h1, w1))
    xb, gb = x.bfloat16(), g.bfloat16()
    _close(uw.upwarp_planes(xb, coeffs, taps, oh, ow), _plain(xb.float(), coeffs, fir, oh, ow),
           rel=1e-2)
    adjb = uw.upsplat_planes(gb, coeffs, taps, h1, w1, global_blocks=unstaged_b)
    _close(adjb, _plain_adjoint(gb.float(), coeffs, fir, h1, w1), rel=1e-2)
    assert torch.equal(adjb, uw.upsplat_planes(gb, coeffs, taps, h1, w1))
    # A float32 box holds half the samples of a bf16 one: at scale 0.5 both
    # overflow; in bf16 nothing else does.
    assert (int(unstaged_b) > 0) == (kind == "rotate 45, scale 0.5"), int(unstaged_b)
    assert int(unstaged) >= int(unstaged_b), (int(unstaged), int(unstaged_b))
    lhs = float((got.double() * g.double()).sum())
    rhs = float((x.double() * adj.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


@pytest.mark.cuda
def test_degenerate_coefficients_on_card(cuda_device):
    """det == 0 (every block of K2 scans the plane from device memory), NaN
    and infinite coefficients (both kernels write zeros): K1 and K2 stay
    each other's adjoint and match the plain version where it is finite."""
    h1, w1, oh, ow = 30, 33, 50, 46
    c = np.array([
        [2.0, 1.0, 3.0, 4.0, 2.0, -1.0],       # det = 0: every output on one line
        [0.5, 0.25, 10.0, 1.0, 0.5, 5.0],      # det = 0 again, another line
        [1.0, 0.0, np.nan, 0.0, 1.0, 0.0],
        [np.inf, 0.0, 0.0, 0.0, 1.0, 0.0],
    ], dtype=np.float32)
    coeffs = torch.from_numpy(c).to(cuda_device)
    fir, taps = _fir(cuda_device)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((4, h1, w1)).astype(np.float32)).to(cuda_device)
    g = torch.from_numpy(rng.standard_normal((4, oh, ow)).astype(np.float32)).to(cuda_device)
    unstaged = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    got = uw.upwarp_planes(x, coeffs, taps, oh, ow)
    adj = uw.upsplat_planes(g, coeffs, taps, h1, w1, global_blocks=unstaged)
    torch.cuda.synchronize()
    assert int(unstaged) == uw.upsplat_blocks(2, h1, w1)  # the two singular planes' blocks
    ok = slice(0, 2)  # the plain version propagates NaN; the kernels give zeros
    _close(got[ok], _plain(x[ok], coeffs[ok], fir, oh, ow))
    _close(adj[ok], _plain_adjoint(g[ok], coeffs[ok], fir, h1, w1))
    assert not got[2:].any() and not adj[2:].any()
    assert torch.equal(adj, uw.upsplat_planes(g, coeffs, taps, h1, w1))
    lhs = float((got[ok].double() * g[ok].double()).sum())
    rhs = float((x[ok].double() * adj[ok].double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


@pytest.mark.cuda
def test_upwarp_autograd_to_second_order_on_card(cuda_device):
    """Gradient and gradient of gradient through ``UpWarp`` (K2 then K1
    again) equal autograd of the plain version."""
    x, g, coeffs = _case(cuda_device, seed=5)
    fir, taps = _fir(cuda_device)

    def r1_like(warp):
        xs = x.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad((F.softplus(warp(xs)) * g).sum(), xs, create_graph=True)
        (ggx,) = torch.autograd.grad(gx.square().sum(), xs)
        return gx.detach(), ggx

    gk, ggk = r1_like(lambda t: uw.UpWarp.apply(t, coeffs, taps, OUT_H, OUT_W))
    gp, ggp = r1_like(lambda t: _plain(t, coeffs, fir))
    assert float((gk - gp).abs().max()) <= 1e-5 * float(gp.abs().max())
    assert float((ggk - ggp).abs().max()) <= 1e-5 * float(ggp.abs().max())
