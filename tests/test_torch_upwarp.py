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

import os
import re

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
from gantrack_tpu_torch.ops.upfirdn2d import Filter, setup_filter
from gantrack_tpu_torch.training.augment import WAVELETS, AugmentPipe, medical_augment_config

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
    return uw.up_affine_warp(x, theta, Filter(FIR), out_h, out_w)


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


# ---------------------------------------------------------------------------
# float32 models of the bounds the kernels of csrc/upwarp.cu rely on.  K1
# stages, a block, the box of the 1x plane its output tile can weigh and
# reads every output's 7 x 7 window from it; K2 visits, for a run of
# K2_RUN canvas pixels of a column, only the rows of their preimage and
# each row's strip interval (K4's bounds, csrc/affine.cuh), and reads them
# from the preimage box of the block's whole canvas, staged in shared
# memory where it fits.  The tile sizes are read from the source.

_CU = open(os.path.join(os.path.dirname(uw.__file__), os.pardir, "csrc", "upwarp.cu")).read()


def _cu_const(name):
    return int(re.search(rf"\b{name} = (\d+)", _CU).group(1))


K1_TILE = (_cu_const("kUpTX"), _cu_const("kUpTY"))
K1_BOX_CAP = _cu_const("kBoxCap")
K2_BOX_BYTES = _cu_const("kGBoxBytes")
K2_TILE = (_cu_const("kSplatTW"), _cu_const("kSplatTH"))
K2_RUN = _cu_const("kColumnPix")
K2_HALO = 5  # canvas pixels 2m - 5 .. 2m + 6 feed 1x output m
K2_CANVAS = (2 * K2_TILE[0] + 10, 2 * K2_TILE[1] + 10)
f32 = np.float32


def _src_pos(a, b, c, ox, oy):
    """The kernels' source position, one rounding an operation."""
    return (f32(a) * ox + f32(b) * oy) + f32(c)


def _half(f, n2):
    """``floor`` of f clamped to the canvas [-1, n2 - 1], halved (floor)."""
    return int(np.floor(min(max(f, f32(-1)), f32(n2 - 1)))) >> 1


def _k1_box(coef, ox0, oy0, oh, ow, h2, w2):
    """K1's staged box (bx0, bx1, by0, by1) for the tile at (ox0, oy0), or
    None where a corner's position is not finite (the direct gather)."""
    xs = (f32(ox0), f32(min(ox0 + K1_TILE[0], ow) - 1))
    ys = (f32(oy0), f32(min(oy0 + K1_TILE[1], oh) - 1))
    fx = [_src_pos(*coef[:3], x, y) for x in xs for y in ys]
    fy = [_src_pos(*coef[3:], x, y) for x in xs for y in ys]
    if not np.all(np.isfinite(fx + fy)):
        return None
    return (_half(min(fx), w2) - 3, _half(max(fx), w2) + 3,
            _half(min(fy), h2) - 3, _half(max(fy), h2) + 3)


def _windows(f, n2):
    """Per output: whether the axis is on the canvas and its window's first
    1x sample m0 (``axis_weights``)."""
    fl = np.floor(f)
    on = (fl >= -1) & (fl <= n2 - 1)
    m0 = np.where(on, np.nan_to_num(fl), 0).astype(np.int64) >> 1
    return on, m0 - 3


def _preimage_bounds(coef, xs, ys, n_in, oh, ow):
    """float32 model of ``preimage_box`` and ``strip_clip`` for the input
    pixels x0..x1, y0..y1: ``(c0, c1, r0, r1)`` unclamped and ``row(oy) ->
    (lo, hi) or None``; None for a singular map."""
    slack = f32(1e-5)
    h, w = n_in
    ax, bx, cx, ay, by, cy = (f32(c) for c in coef)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        det = ax * by - bx * ay
        ia, ib, ic, id_ = by / det, -bx / det, -ay / det, ax / det
    if not (det != 0 and np.all(np.isfinite([ia, ib, ic, id_]))):
        return None
    mag = slack * (f32(w + h) + abs(cx) + abs(cy) + (abs(ax) + abs(ay)) * f32(ow)
                   + (abs(bx) + abs(by)) * f32(oh) + f32(2))
    ex, ey = (abs(ia) + abs(ib)) * mag, (abs(ic) + abs(id_)) * mag
    pxs = (f32(xs[0]) + f32(-1) - cx, f32(xs[1]) + f32(1) - cx)
    pys = (f32(ys[0]) + f32(-1) - cy, f32(ys[1]) + f32(1) - cy)
    qx = [ia * px + ib * py for px in pxs for py in pys]
    qy = [ic * px + id_ * py for px in pxs for py in pys]
    box = (int(np.ceil(min(qx) - ex)), int(np.floor(max(qx) + ex)),
           int(np.ceil(min(qy) - ey)), int(np.floor(max(qy) + ey)))
    strips = []
    for a, b, c, (v0, v1), n in ((ax, bx, cx, xs, w), (ay, by, cy, ys, h)):
        if not abs(a) >= f32(1 / 64):
            continue
        r = f32(1) / a
        k1 = -b * r
        pos = abs(a) * f32(ow) + abs(b) * f32(oh) + abs(c) + f32(n) + f32(2)
        centre = (f32(n) + abs(c)) * abs(r) + abs(k1) * f32(oh) + f32(1)
        strips.append((k1, (f32(v0) - c) * r, (f32(v1) - c) * r,
                       (f32(1) + slack * pos) * abs(r) + slack * centre))

    def row(oy):
        if not strips:
            return None
        lo, hi = -np.inf, np.inf
        for k1, k0a, k0b, hw in strips:
            ma = f32(np.float64(k1) * oy + np.float64(k0a))  # fmaf
            mb = f32(np.float64(k1) * oy + np.float64(k0b))
            lo, hi = max(lo, min(ma, mb) - hw), min(hi, max(ma, mb) + hw)
        return lo, hi

    return box, row


def _rot_scale(angle_deg, scale, shift=(0.03, -0.02)):
    a = np.deg2rad(angle_deg)
    return [[scale * np.cos(a), -scale * np.sin(a), shift[0]],
            [scale * np.sin(a), scale * np.cos(a), shift[1]]]


_EDGE_THETAS = {
    "rotate 45, scale 0.5": _rot_scale(45, 0.5),
    "rotate 45, scale 2": _rot_scale(45, 2.0),
    "rotate -30, x-flip": [[-np.cos(0.5), -np.sin(0.5), 0.0], [-np.sin(0.5), np.cos(0.5), 0.1]],
    "zoom out 8": _rot_scale(10, 8.0),
    "near-singular shear": [[0.5, 1.0, 0.1], [0.25, 0.5 + 3e-5, -0.1]],
}


def _case_coeffs(kind, size=16, n=3):
    """float32 coefficients and (h2, w2, oh, ow) of ``kind``: the augment
    pipe's draws at p = 1 on ``size``² images, or one of the edge thetas on
    the pipe's shapes."""
    pipe = AugmentPipe(medical_augment_config(), size, size, 1)
    gen = torch.Generator().manual_seed(7)
    theta, oh, ow = pipe.warp_geometry(pipe.sample_geometric(n, 1.0, "cpu", gen))
    if kind != "augment p=1":
        theta = torch.tensor([_EDGE_THETAS[kind]], dtype=torch.float32)
    mx0, mx1, my0, my1 = pipe.margin
    h2, w2 = 2 * (size + my0 + my1), 2 * (size + mx0 + mx1)
    return uw.warp_coefficients(theta, h2, w2, oh, ow).numpy(), (h2, w2, oh, ow)


_KINDS = ["augment p=1", *_EDGE_THETAS]


@pytest.mark.parametrize("kind", _KINDS)
def test_upwarp_box_holds_every_window(kind):
    """Every output of a K1 tile whose axes are on the canvas reads its
    7 x 7 window inside the box the tile stages."""
    coeffs, (h2, w2, oh, ow) = _case_coeffs(kind)
    oxs, oys = np.meshgrid(np.arange(ow, dtype=f32), np.arange(oh, dtype=f32))
    checked = 0
    for coef in coeffs:
        on_x, mx = _windows(_src_pos(*coef[:3], oxs, oys), w2)
        on_y, my = _windows(_src_pos(*coef[3:], oxs, oys), h2)
        on = on_x & on_y
        for oy0 in range(0, oh, K1_TILE[1]):
            for ox0 in range(0, ow, K1_TILE[0]):
                box = _k1_box(coef, ox0, oy0, oh, ow, h2, w2)
                tile = (slice(oy0, oy0 + K1_TILE[1]), slice(ox0, ox0 + K1_TILE[0]))
                t_on, t_mx, t_my = on[tile], mx[tile][on[tile]], my[tile][on[tile]]
                if not t_on.any():
                    continue
                assert box is not None, (kind, ox0, oy0)
                bx0, bx1, by0, by1 = box
                assert bx0 <= t_mx.min() and t_mx.max() + 6 <= bx1, (kind, coef, ox0, oy0, box)
                assert by0 <= t_my.min() and t_my.max() + 6 <= by1, (kind, coef, ox0, oy0, box)
                checked += int(t_on.sum())
    assert checked > 0


def _k2_blocks(h2, w2):
    """K2's blocks: the origin (vx0, vy0) of each block's canvas region of
    K2_CANVAS pixels, and its runs (cy, n): n pixels of a column from row
    cy of the region, the last run cut at the region's end."""
    cw, ch = K2_CANVAS
    runs = [(cy, min(K2_RUN, ch - cy)) for cy in range(0, ch, K2_RUN)]
    for by in range(-(-(h2 // 2) // K2_TILE[1])):
        for bx in range(-(-(w2 // 2) // K2_TILE[0])):
            yield (2 * K2_TILE[0] * bx - K2_HALO, 2 * K2_TILE[1] * by - K2_HALO), runs


@pytest.mark.parametrize("kind", _KINDS)
def test_upsplat_run_bounds_hold_every_hit(kind):
    """For every run of canvas pixels K2 takes, no output pixel whose
    float32 source position lies within one pixel of a pixel of the run
    falls outside the rows, columns and per-row interval K2 visits for the
    run, nor outside the preimage box of the block's canvas that it
    stages."""
    coeffs, (h2, w2, oh, ow) = _case_coeffs(kind)
    oxs, oys = np.meshgrid(np.arange(ow, dtype=f32), np.arange(oh, dtype=f32))
    cw, ch = K2_CANVAS
    hits = in_strips = 0
    for coef in coeffs:
        fx, fy = _src_pos(*coef[:3], oxs, oys), _src_pos(*coef[3:], oxs, oys)
        for (vx0, vy0), runs in _k2_blocks(h2, w2):
            block = _preimage_bounds(coef, (vx0, vx0 + cw - 1), (vy0, vy0 + ch - 1), (h2, w2),
                                     oh, ow)[0]
            for cy, n in runs:
                vy, last = vy0 + cy, vy0 + cy + n - 1
                if last < 0 or vy >= h2:  # no pixel of the run on the canvas: not visited
                    continue
                near_y = (np.abs(fy[None] - np.arange(vy, last + 1, dtype=f32)[:, None, None])
                          < 1).any(0)
                for vx in range(max(vx0, 0), min(vx0 + cw, w2)):
                    hit = near_y & (np.abs(fx - f32(vx)) < 1)
                    if not hit.any():
                        continue
                    (c0, c1, r0, r1), row = _preimage_bounds(coef, (vx, vx), (vy, last),
                                                             (h2, w2), oh, ow)
                    rows, cols = np.nonzero(hit)
                    hits += len(rows)
                    assert r0 <= rows.min() and rows.max() <= r1, (kind, coef, vx, vy, r0, r1)
                    assert c0 <= cols.min() and cols.max() <= c1, (kind, coef, vx, vy, c0, c1)
                    for oy in np.unique(rows):
                        iv = row(oy)
                        if iv is None:
                            continue
                        in_row = cols[rows == oy]
                        in_strips += len(in_row)
                        assert np.ceil(iv[0]) <= in_row.min() and in_row.max() <= np.floor(
                            iv[1]), (kind, coef, vx, vy, oy, in_row, iv)
                    b0, b1, s0, s1 = block
                    assert b0 <= cols.min() and cols.max() <= b1 and s0 <= rows.min() and \
                        rows.max() <= s1, (kind, coef, vx, vy, block)
    assert hits > 0 and in_strips > 0


@pytest.mark.parametrize("kind", ["augment p=1", "rotate 45, scale 0.5", "rotate 45, scale 2",
                                  "near-singular shear"])
def test_upsplat_block_boxes_hold_every_hit(kind):
    """On a canvas of several K2 blocks a side, every output pixel lies in
    the staged box of each block whose canvas region holds a canvas pixel
    within one pixel of its float32 source position: the hits a block
    visits are all in the box it copies."""
    coeffs, (h2, w2, oh, ow) = _case_coeffs(kind, size=96, n=2)
    cw, ch = K2_CANVAS
    step_x, step_y = 2 * K2_TILE[0], 2 * K2_TILE[1]
    oxs, oys = np.meshgrid(np.arange(ow), np.arange(oh))
    checked = 0
    for coef in coeffs:
        fx = _src_pos(*coef[:3], oxs.astype(f32), oys.astype(f32))
        fy = _src_pos(*coef[3:], oxs.astype(f32), oys.astype(f32))
        boxes = {origin: _preimage_bounds(coef, (origin[0], origin[0] + cw - 1),
                                          (origin[1], origin[1] + ch - 1), (h2, w2), oh, ow)[0]
                 for origin, _ in _k2_blocks(h2, w2)}
        for dx in (0, 1):
            vx = np.floor(fx).astype(np.int64) + dx
            for dy in (0, 1):
                vy = np.floor(fy).astype(np.int64) + dy
                hit = (np.abs(fx - vx) < 1) & (np.abs(fy - vy) < 1) & (vx >= 0) & (vx < w2)
                for (vx0, vy0), (b0, b1, s0, s1) in boxes.items():
                    held = hit & (vx >= vx0) & (vx < vx0 + cw) & (vy >= vy0) & (vy < vy0 + ch)
                    if not held.any():
                        continue
                    checked += int(held.sum())
                    assert (b0 <= oxs[held]).all() and (oxs[held] <= b1).all(), (kind, vx0, vy0)
                    assert (s0 <= oys[held]).all() and (oys[held] <= s1).all(), (kind, vx0, vy0)
    assert checked > 0


def _augment_call():
    """The augment's K1/K2 call: 64 planes of 406 × 403 ↔ 524², draws at
    p = 1; theta and (h2, w2, oh, ow)."""
    pipe = AugmentPipe(medical_augment_config(), 256, 256, 1)
    gen = torch.Generator().manual_seed(0)
    theta, oh, ow = pipe.warp_geometry(pipe.sample_geometric(64, 1.0, "cpu", gen))
    mx0, mx1, my0, my1 = pipe.margin
    h2, w2 = 2 * (256 + my0 + my1), 2 * (256 + mx0 + mx1)
    assert (h2 // 2, w2 // 2, oh, ow) == (406, 403, 524, 524)
    return theta, (h2, w2, oh, ow)


def test_upwarp_boxes_fit_the_buffer_at_the_augment_draws():
    """At the augment's shapes every K1 tile stages its box: no block takes
    the direct gather.  A 45° rotation at 2 canvas pixels an output pixel
    also fits (about 52² samples at a 32 × 32 tile); a zoom out by 8 does
    not, and its tiles take the direct gather."""
    theta, (h2, w2, oh, ow) = _augment_call()
    x0 = np.arange(0, ow, K1_TILE[0], dtype=f32)
    y0 = np.arange(0, oh, K1_TILE[1], dtype=f32)[:, None]
    corners = [(x, y) for x in (x0, np.minimum(x0 + K1_TILE[0], ow) - 1)
               for y in (y0, np.minimum(y0 + K1_TILE[1], oh) - 1)]

    def half(f, n2):  # ``_half`` over every tile at once
        return np.floor(np.clip(f, f32(-1), f32(n2 - 1))).astype(np.int64) >> 1

    def largest_box(th):
        """The largest of ``_k1_box``'s boxes, in samples, over all tiles."""
        largest = 0
        for coef in uw.warp_coefficients(th, h2, w2, oh, ow).numpy():
            fx = np.stack([_src_pos(*coef[:3], x, y) for x, y in corners])
            fy = np.stack([_src_pos(*coef[3:], x, y) for x, y in corners])
            assert np.isfinite(fx).all() and np.isfinite(fy).all()
            bw = half(fx.max(0), w2) - half(fx.min(0), w2) + 7
            bh = half(fy.max(0), h2) - half(fy.min(0), h2) + 7
            largest = max(largest, int((bw * bh).max()))
        return largest

    assert largest_box(theta) <= K1_BOX_CAP
    # theta scaled by ow / w2 gives 2 canvas pixels an output pixel.
    assert largest_box(torch.tensor([_rot_scale(45, 2.0 * ow / w2)])) <= K1_BOX_CAP
    assert largest_box(torch.tensor([_rot_scale(10, 8.0)])) > K1_BOX_CAP


def test_degenerate_maps_take_the_exact_paths():
    """det == 0 leaves K2 no bounded preimage (it scans the plane) while
    K1's box stays finite; non-finite coefficients leave K1 no box (the
    direct gather, which writes zeros)."""
    singular = np.asarray([2.0, 1.0, 3.0, 4.0, 2.0, -1.0], np.float32)  # det = 0
    assert _preimage_bounds(singular, (5, 5), (6, 7), (40, 44), 36, 38) is None
    assert _k1_box(singular, 0, 0, 36, 38, 40, 44) is not None
    for bad in (np.nan, np.inf):
        coef = np.asarray([1.0, 0.0, bad, 0.0, 1.0, 0.0], np.float32)
        assert _k1_box(coef, 0, 0, 36, 38, 40, 44) is None


def test_upsplat_boxes_fit_the_buffer_at_the_augment_draws():
    """At the augment's shapes in bf16 (the training dtype) every K2 block
    stages its cotangent box, the preimage box of its canvas clamped to the
    output (``preimage_box``); a float32 box holds half the samples, and
    some blocks then read from device memory."""
    theta, (h2, w2, oh, ow) = _augment_call()
    cw, ch = K2_CANVAS
    sizes = []
    for coef in uw.warp_coefficients(theta, h2, w2, oh, ow).numpy():
        for (vx0, vy0), _ in _k2_blocks(h2, w2):
            (c0, c1, r0, r1), _ = _preimage_bounds(coef, (vx0, vx0 + cw - 1),
                                                   (vy0, vy0 + ch - 1), (h2, w2), oh, ow)
            sizes.append(max(min(c1, ow - 1) - max(c0, 0) + 1, 0)
                         * max(min(r1, oh - 1) - max(r0, 0) + 1, 0))
    assert max(sizes) * 2 <= K2_BOX_BYTES
    assert max(sizes) * 4 > K2_BOX_BYTES
