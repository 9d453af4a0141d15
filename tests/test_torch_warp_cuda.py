"""The affine warp CUDA kernels (K3, K4) against their plain PyTorch version.

Needs an NVIDIA card and ``nvcc``; skips without a card.  Imports no JAX,
so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_warp_cuda.py

Tolerance 1e-5 of the largest reference value in float32 (1e-2 in bf16,
where the output's rounding dominates): kernel and plain version sample
at bitwise-equal positions and sum the same four terms in another order.
K3 and K4 must be bitwise deterministic.  K3 (a block a 32 × 32 output
tile in several planes, a thread two columns of two rows) is held to the
plain version at tile edges, odd widths and 1-pixel outputs, on a zoom
out and a shrink, on a view that starts at an odd element, with inf and
NaN inputs under zero weights and with non-finite coefficients.
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


def _family(kind, n=3, seed=8):
    """Transforms that shape K4's row and strip intervals: the unfused
    augment's shrink (0.55-0.75 with a rotation), a rotation, a shear, and
    a zoom whose preimage spans many output rows."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = rng.uniform(-np.pi, np.pi)
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        m = {"shrink": rot @ np.diag(rng.uniform(0.55, 0.75, 2)), "rotate": rot,
             "shear": rot @ np.array([[1.0, rng.uniform(-2, 2)], [0.0, 1.0]]),
             "zoom": rot @ np.diag(rng.uniform(0.04, 0.08, 2))}[kind]
        out.append(np.concatenate([m, rng.uniform(-0.1, 0.1, (2, 1))], 1))
    return np.asarray(out, np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", [
    ("shrink", (97, 83, 62, 57)),     # an input tile's box: a few hundred outputs
    ("rotate", (64, 70, 64, 70)),
    ("shear", (40, 90, 52, 75)),
    ("zoom", (20, 40, 400, 420)),    # a pixel's preimage spans many output rows
])
def test_splat_transforms_match_plain_on_card(cuda_device, kind, shape):
    """K4's gather against the plain adjoint (f32 at 1e-5, bf16 at
    1e-2), adjoint to K3 (<K3 x, g> = <x, K4 g> in float64 at 1e-5), and
    bitwise deterministic over two calls."""
    h, w, oh, ow = shape
    theta = torch.from_numpy(_family(kind)).to(cuda_device)
    n = theta.shape[0]
    coeffs = warp_coefficients(theta, h, w, oh, ow)
    rng = np.random.default_rng(9)
    g = torch.from_numpy(rng.standard_normal((n, oh, ow)).astype(np.float32)).to(cuda_device)
    x = torch.from_numpy(rng.standard_normal((n, h, w)).astype(np.float32)).to(cuda_device)

    def plain_adjoint(gg):
        xs = torch.zeros((n, 1, h, w), device=cuda_device, requires_grad=True)
        return torch.autograd.grad(wp.affine_warp_plain(xs, coeffs, oh, ow)[:, 0], xs, gg)[0][:, 0]

    adj = wp.splat_planes(g, coeffs, h, w)
    torch.cuda.synchronize()
    _close(adj, plain_adjoint(g))
    assert torch.equal(adj, wp.splat_planes(g, coeffs, h, w))
    adjb = wp.splat_planes(g.bfloat16(), coeffs, h, w)
    _close(adjb.float(), plain_adjoint(g.bfloat16().float()), rel=1e-2)
    assert torch.equal(adjb, wp.splat_planes(g.bfloat16(), coeffs, h, w))
    lhs = float((wp.warp_planes(x, coeffs, oh, ow).double() * g.double()).sum())
    rhs = float((x.double() * adj.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def _k3_checks(x, coeffs, oh, ow, rel=1e-5):
    """K3 against the plain version in f32 (1e-5) and bf16 (1e-2), bitwise
    the same over two calls."""
    for planes, tol in ((x, rel), (x.bfloat16(), 1e-2)):
        got = wp.warp_planes(planes, coeffs, oh, ow)
        torch.cuda.synchronize()
        ref = wp.affine_warp_plain(planes.float()[:, None], coeffs, oh, ow)[:, 0]
        _close(got.float(), ref, rel=tol)
        assert torch.equal(got, wp.warp_planes(planes, coeffs, oh, ow))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (40, 44, 33, 31),     # partial tiles on both axes
    (37, 53, 65, 97),     # odd widths, an output larger than the input
    (48, 48, 32, 32),     # whole tiles
    (9, 7, 1, 1),         # one output pixel
    (1, 1, 1, 1),         # one input pixel
    (50, 57, 1, 40),      # one output row
])
def test_k3_tiles_at_edges_on_card(cuda_device, shape):
    """K3 at tile edges, odd widths (a thread's second column off the
    plane, pairs stored at odd offsets) and 1-pixel outputs."""
    h, w, oh, ow = shape
    rng = np.random.default_rng(11)
    theta = torch.from_numpy(_thetas(rng, 4)).to(cuda_device)
    x = torch.from_numpy(rng.standard_normal((4, h, w)).astype(np.float32)).to(cuda_device)
    _k3_checks(x, warp_coefficients(theta, h, w, oh, ow), oh, ow)


@pytest.mark.cuda
def test_k3_zoom_out_and_shrink_on_card(cuda_device):
    """A zoom out by 8 (a tile's taps spread over 256 input columns) and a
    shrink by 2.2 agree with the plain version."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((1, 300, 280)).astype(np.float32)).to(cuda_device)
    a = np.deg2rad(10)
    zoom = torch.tensor([[[8 * np.cos(a), 8 * np.sin(a), 0.0], [-8 * np.sin(a), 8 * np.cos(a), 0.0]]],
                        dtype=torch.float32, device=cuda_device)
    _k3_checks(x, warp_coefficients(zoom, 300, 280, 70, 75), 70, 75)
    shrink = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]], device=cuda_device)
    x = torch.from_numpy(rng.standard_normal((1, 264, 264)).astype(np.float32)).to(cuda_device)
    _k3_checks(x, warp_coefficients(shrink, 264, 264, 120, 120), 120, 120)


@pytest.mark.cuda
def test_k3_on_a_view_at_an_odd_offset_on_card(cuda_device):
    """Planes that start at an odd element of their storage (a contiguous
    view of a larger buffer, even widths) warp as their copy does."""
    rng = np.random.default_rng(16)
    theta = torch.from_numpy(_thetas(rng, 3)).to(cuda_device)
    coeffs = warp_coefficients(theta, 40, 44, 36, 38)
    flat = torch.from_numpy(rng.standard_normal(1 + 3 * 40 * 44).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        buf = flat.to(cuda_device, dtype)
        view = buf[1:].view(3, 40, 44)
        assert view.is_contiguous() and view.storage_offset() == 1
        got = wp.warp_planes(view, coeffs, 36, 38)
        torch.cuda.synchronize()
        assert torch.equal(got, wp.warp_planes(view.clone(), coeffs, 36, 38))


@pytest.mark.cuda
def test_k3_skips_inf_and_nan_under_zero_weights_on_card(cuda_device):
    """Integer source positions give zero weights to the second tap of
    each axis; an inf or NaN there stays out of the sum, in the staged
    at a shift and at a zoom out by 8: K3 gives the pixels it reads, where
    the plain version's 0 * NaN is NaN."""
    rng = np.random.default_rng(13)
    for shift, scale, (h, w), (oh, ow) in ((3, 1, (40, 44), (36, 40)), (0, 8, (300, 300), (37, 37))):
        x = torch.from_numpy(rng.standard_normal((2, h, w)).astype(np.float32)).to(cuda_device)
        read = torch.zeros((h, w), dtype=torch.bool, device=cuda_device)
        read[shift:shift + scale * oh:scale, shift:shift + scale * ow:scale] = True
        bad = x.clone()
        bad[0][~read] = float("inf")
        bad[1][~read] = float("nan")
        coeffs = torch.tensor([[scale, 0.0, shift, 0.0, scale, shift]] * 2, device=cuda_device)
        want = x[:, shift:shift + scale * oh:scale, shift:shift + scale * ow:scale]
        for planes in (bad, bad.bfloat16()):
            got = wp.warp_planes(planes, coeffs, oh, ow)
            torch.cuda.synchronize()
            assert torch.equal(got.float(), want.to(planes.dtype).float())


@pytest.mark.cuda
def test_k3_non_finite_coefficients_give_zeros_on_card(cuda_device):
    """NaN or inf coefficients: K3 writes zeros, and the other planes of
    the call are unaffected."""
    rng = np.random.default_rng(14)
    theta = torch.from_numpy(_thetas(rng, 4)).to(cuda_device)
    x = torch.from_numpy(rng.standard_normal((4, H, W)).astype(np.float32)).to(cuda_device)
    coeffs = warp_coefficients(theta, H, W, OUT_H, OUT_W)
    coeffs[1, 2] = float("inf")
    coeffs[2, 4] = float("nan")
    coeffs[3, 0] = -float("inf")
    got = wp.warp_planes(x, coeffs, OUT_H, OUT_W)
    torch.cuda.synchronize()
    assert not got[1:].any()
    _close(got[:1], _plain(x[:1], coeffs[:1]))


@pytest.mark.cuda
def test_k3_digest_stable_over_two_calls_on_card(cuda_device):
    """K3's bits at a rotation and shrink of the unfused augment's kind, in
    bf16 and f32, are the same over two calls."""
    rng = np.random.default_rng(15)
    theta = torch.from_numpy(_family("shrink", n=4)).to(cuda_device)
    coeffs = warp_coefficients(theta, 203, 201, 131, 129)
    x = torch.from_numpy(rng.standard_normal((4, 203, 201)).astype(np.float32)).to(cuda_device)
    for planes in (x, x.bfloat16()):
        first = wp.warp_planes(planes, coeffs, 131, 129)
        assert torch.equal(first, wp.warp_planes(planes, coeffs, 131, 129))
