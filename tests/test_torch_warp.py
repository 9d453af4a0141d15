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

import importlib.util
import os

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
from gantrack_tpu_torch.training.augment import AugmentPipe, medical_augment_config
from gantrack_tpu_torch.utils import profiling

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
    with profiling.recording() as rec:
        with pytest.raises(ValueError, match="CUDA tensor"):
            wp.warp_planes(x, coeffs, 4, 4)
        with pytest.raises(ValueError, match="CUDA tensor"):
            wp.splat_planes(x, coeffs, 4, 4)
    assert rec.under("warp.launch") == {}


def _splat_bounds(coef, fv, n_in, oh, ow):
    """float32 model of the bounds ``splat_kernel`` (``csrc/warp.cu``)
    visits for input pixel ``fv = (vx, vy)``: the rows and columns of the
    parallelogram's extent through the inverse map, and, per row, the
    interval of ox that the two strips give.  Returns ``(c0, c1, r0, r1)``
    unclamped and ``row(oy) -> (lo, hi) or None``."""
    f32, slack = np.float32, np.float32(1e-5)
    h, w = n_in
    ax, bx, cx, ay, by, cy = (f32(c) for c in coef)
    vx, vy = f32(fv[0]), f32(fv[1])
    det = ax * by - bx * ay
    ia, ib, ic, id_ = by / det, -bx / det, -ay / det, ax / det
    mag = slack * (f32(w + h) + abs(cx) + abs(cy) + (abs(ax) + abs(ay)) * f32(ow)
                   + (abs(bx) + abs(by)) * f32(oh) + f32(2))
    ex, ey = (abs(ia) + abs(ib)) * mag, (abs(ic) + abs(id_)) * mag
    qx = [ia * (vx + f32(sx) - cx) + ib * (vy + f32(sy) - cy) for sx in (-1, 1) for sy in (-1, 1)]
    qy = [ic * (vx + f32(sx) - cx) + id_ * (vy + f32(sy) - cy) for sx in (-1, 1) for sy in (-1, 1)]
    box = (int(np.ceil(min(qx) - ex)), int(np.floor(max(qx) + ex)),
           int(np.ceil(min(qy) - ey)), int(np.floor(max(qy) + ey)))
    strips = []
    for a, b, c, v, n in ((ax, bx, cx, vx, w), (ay, by, cy, vy, h)):
        if not abs(a) >= f32(1 / 64):
            continue
        r = f32(1) / a
        k1 = -b * r
        pos = abs(a) * f32(ow) + abs(b) * f32(oh) + abs(c) + f32(n) + f32(2)
        centre = (f32(n) + abs(c)) * abs(r) + abs(k1) * f32(oh) + f32(1)
        strips.append((k1, (v - c) * r, (f32(1) + slack * pos) * abs(r) + slack * centre))

    def row(oy):
        if not strips:
            return None
        lo, hi = -np.inf, np.inf
        for k1, k0, hw in strips:
            m = f32(np.float64(k1) * oy + np.float64(k0))  # fmaf
            lo, hi = max(lo, m - hw), min(hi, m + hw)
        return lo, hi

    return box, row


def _thetas_family(kind, rng, n=3):
    out = []
    for _ in range(n):
        a = rng.uniform(-np.pi, np.pi)
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        m = {"shrink": rot @ np.diag(rng.uniform(0.55, 0.75, 2)),
             "rotate": rot,
             "shear": rot @ np.array([[1.0, rng.uniform(-2, 2)], [0.0, 1.0]]),
             "zoom": rot @ np.diag(rng.uniform(0.05, 0.2, 2)),
             "near-singular": np.array([[1.0, 2.0], [0.5, 1.0 + rng.uniform(-1e-4, 1e-4)]]) * 0.5,
             }[kind]
        out.append(np.concatenate([m, rng.uniform(-0.2, 0.2, (2, 1))], 1))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("kind", ["shrink", "rotate", "shear", "zoom", "near-singular"])
def test_splat_bounds_hold_every_hit(kind):
    """No output pixel whose float32 source position lies within one pixel
    of an input pixel falls outside the rows, columns and per-row interval
    that K4 visits for that pixel."""
    h, w, oh, ow = 37, 41, 45, 39
    rng = np.random.default_rng(["shrink", "rotate", "shear", "zoom", "near-singular"].index(kind))
    theta = torch.from_numpy(_thetas_family(kind, rng))
    coeffs = warp_coefficients(theta, h, w, oh, ow).numpy()
    oxs, oys = np.meshgrid(np.arange(ow, dtype=np.float32), np.arange(oh, dtype=np.float32))
    hits = in_strips = 0
    for coef in coeffs:
        ax, bx, cx, ay, by, cy = (np.float32(c) for c in coef)
        fx = (ax * oxs + bx * oys) + cx  # src_pos, one rounding an operation
        fy = (ay * oxs + by * oys) + cy
        for vy in range(0, h, 3):
            for vx in range(0, w, 2):
                hit = (np.abs(fx - np.float32(vx)) < 1) & (np.abs(fy - np.float32(vy)) < 1)
                if not hit.any():
                    continue
                (c0, c1, r0, r1), row = _splat_bounds(coef, (vx, vy), (h, w), oh, ow)
                rows, cols = np.nonzero(hit)
                hits += len(rows)
                assert r0 <= rows.min() and rows.max() <= r1, (coef, vx, vy, rows, r0, r1)
                assert c0 <= cols.min() and cols.max() <= c1, (coef, vx, vy, cols, c0, c1)
                for oy in np.unique(rows):
                    iv = row(oy)
                    if iv is None:
                        continue
                    in_row = cols[rows == oy]
                    in_strips += len(in_row)
                    assert np.ceil(iv[0]) <= in_row.min() and in_row.max() <= np.floor(iv[1]), (
                        coef, vx, vy, oy, in_row, iv)
    assert hits > 0 and in_strips > 0


# ---------------------------------------------------------------------------
# K3's maps: the unfused augment's draws at p = 1, the eq metrics'
# rotations, and the kinds the card tests hold K3 to.  The port's
# ``affine_warp`` on them against JAX's gather form; and the count of input
# samples K3 reads there (``chip_smoke._warp_reads``, which its byte bound
# is made of) against the support of the plain version's gradient.

_ROOT = os.path.join(os.path.dirname(__file__), os.pardir)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rot(angle_deg, scale=1.0, shift=(0.0, 0.0)):
    a = np.deg2rad(angle_deg)
    return [[scale * np.cos(a), scale * np.sin(a), shift[0]],
            [-scale * np.sin(a), scale * np.cos(a), shift[1]]]


_K3_THETAS = {
    "rotate 45, scale 0.5": (_rot(45, 0.5, (0.03, -0.02)), (70, 66, 75, 81)),
    "rotate 45, scale 2": (_rot(45, 2.0), (70, 66, 40, 44)),
    "x-flip, rotate 30": ([[-np.cos(0.5), -np.sin(0.5), 0.0], [-np.sin(0.5), np.cos(0.5), 0.1]],
                          (45, 53, 67, 33)),
    "shrink 2.2": (_rot(0, 1.0), (264, 264, 120, 120)),
    "zoom out 8": (_rot(10, 8.0), (300, 280, 70, 75)),
    "near-singular shear": ([[0.5, 1.0, 0.1], [0.25, 0.5 + 3e-5, -0.1]], (60, 64, 50, 70)),
    "integer positions": ([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], (64, 64, 64, 64)),
}
_K3_KINDS = ["augment p=1", "eq rotation", *_K3_THETAS]


def _k3_case(kind):
    """theta [N, 2, 3] float32 and (h, w, oh, ow) of a K3 call."""
    if kind == "augment p=1":
        pipe = AugmentPipe(medical_augment_config(), 32, 32, 1, impl="unfused")
        gen = torch.Generator().manual_seed(7)
        theta, oh, ow = pipe.warp_geometry(pipe.sample_geometric(3, 1.0, "cpu", gen))
        mx0, mx1, my0, my1 = pipe.margin
        return theta.float(), (2 * (32 + my0 + my1), 2 * (32 + mx0 + mx1), oh, ow)
    if kind == "eq rotation":
        angle = np.random.default_rng(5).uniform(0, 360, 3)
        return torch.tensor([_rot(a) for a in angle], dtype=torch.float32), (96, 96, 96, 96)
    theta, shape = _K3_THETAS[kind]
    return torch.tensor([theta], dtype=torch.float32), shape


# JAX's gather form takes its positions from a normalised grid, in
# another order of operations; at the zoom out by 8 they reach 600 pixels,
# where the two roundings part by more than TOL, so that map is held to
# the plain version on the card only.
@pytest.mark.parametrize("kind", [k for k in _K3_KINDS if k != "zoom out 8"])
def test_forward_matches_jax_gather_at_k3_maps(kind):
    theta, (h, w, oh, ow) = _k3_case(kind)
    rng = np.random.default_rng(_K3_KINDS.index(kind))
    img = rng.standard_normal((theta.shape[0], h, w, 1)).astype(np.float32)
    want = np.asarray(j_grid_sample(jnp.asarray(img), j_affine_grid(jnp.asarray(theta.numpy()),
                                                                    oh, ow)))
    got = _nhwc(ops.affine_warp(_nchw(img), theta, oh, ow))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kind", _K3_KINDS)
def test_k3_reads_are_the_plain_gradient_support(kind):
    """The input samples K3 reads (a tap with a nonzero weight on the
    plane) are those where the plain version's gradient against a random
    cotangent is nonzero, and the outputs that read any are those where
    the warp of ones is positive (the weights are nonnegative)."""
    theta, (h, w, oh, ow) = _k3_case(kind)
    n = theta.shape[0]
    coeffs = warp_coefficients(theta, h, w, oh, ow)
    read, hit = _chip_smoke()._warp_reads(coeffs, h, w, oh, ow)
    x = torch.zeros((n, 1, h, w), requires_grad=True)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((n, 1, oh, ow)).astype(np.float32))
    (grad,) = torch.autograd.grad(wp.affine_warp_plain(x, coeffs, oh, ow), x, g)
    ones = wp.affine_warp_plain(torch.ones((n, 1, h, w)), coeffs, oh, ow)
    assert read == int((grad != 0).sum()) and hit == int((ones > 0).sum())
    assert 0 < read and 0 < hit
