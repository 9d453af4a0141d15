"""The port's resample FIR (``ops/fir.py`` behind ``upfirdn2d``) against
JAX, on the CPU.

* The seven geometries of ``tests/test_pallas_fir.py``: JAX ``fir2d``
  (the Pallas kernels K5–K7, run in interpret mode) against the port's
  plain ``upfirdn2d_plain`` and against its :class:`Fir` Function path,
  float32, tolerance 1e-5 (the same terms, summed in another order).
* The augment pipe's 12-tap crop-downsample (negative padding, which
  ``fir2d`` cannot take) against JAX ``upfirdn2d(impl="conv")``.
* Gradient and gradient of gradient through :class:`Fir` (each backward
  is the adjoint Function) against autograd of the plain version, 1e-5;
  adjointness ``<K x, g> = <x, Kᵀ g>`` of every form in float64.
* StyleGAN3's ×4 forms (up4 and its ↓4 adjoint, which the JAX FIR
  kernels never covered): their polyphase split, a 24-tap up4 against JAX
  ``upfirdn2d(impl="conv")``, and float64 models of the tiles of the
  kernels K5–K7 and of the ↓4 kernel.
"""

import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from gantrack_tpu import ops as jops
from gantrack_tpu.ops.attic import fir as jfir
from gantrack_tpu_torch.ops import fir
from gantrack_tpu_torch.training.augment import WAVELETS

ufd = importlib.import_module("gantrack_tpu_torch.ops.upfirdn2d")

torch.set_num_threads(1)

F4 = [1.0, 3.0, 3.0, 1.0]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def _interpret():
    jfir.INTERPRET = True
    yield
    jfir.INTERPRET = False


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


# (NHWC shape, up, down, fir2d padding (py0, py1, px0, px1), gain, flip):
# the geometries of tests/test_pallas_fir.py.
GEOMETRIES = [
    ((2, 19, 19, 16), 1, 1, (0, 0, 0, 0), 4.0, False),   # G conv0 post-FIR
    ((2, 16, 16, 16), 1, 1, (2, 2, 2, 2), 1.0, False),   # D conv1 pre-FIR
    ((1, 12, 14, 8), 1, 1, (3, 1, 1, 3), 1.0, True),     # flip + asymmetric pad
    ((2, 16, 16, 16), 1, 2, (1, 1, 1, 1), 1.0, False),   # D skip FIR
    ((1, 20, 24, 8), 1, 2, (2, 1, 1, 2), 1.0, False),
    ((2, 9, 9, 16), 2, 1, (2, 1, 2, 1), 4.0, False),     # up2 (upsample2d form)
    ((1, 8, 12, 8), 2, 1, (1, 2, 2, 1), 1.0, True),
]


@pytest.mark.parametrize("shape,up,down,padding,gain,flip", GEOMETRIES)
def test_fir_matches_jax_fir2d(_interpret, shape, up, down, padding, gain, flip):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jfir.fir2d(jnp.asarray(x), F4, F4, up=up, down=down, padding=padding,
                                 gain=gain, flip=flip))
    py0, py1, px0, px1 = padding
    f = torch.from_numpy(np.outer(F4, F4).astype(np.float32))
    kw = dict(up=up, down=down, padding=[px0, px1, py0, py1], flip_filter=flip, gain=gain)
    plain = ufd.upfirdn2d_plain(_nchw(x), f, **kw)
    via_fn = ufd.upfirdn2d(_nchw(x), ufd.Filter(f), **kw)
    np.testing.assert_allclose(_nhwc(plain), want, **TOL)
    np.testing.assert_allclose(_nhwc(via_fn), want, **TOL)


def test_augment_crop_downsample_matches_jax_conv():
    """The 12-tap sym6 down2 with the crop (padding -1 after the helper)
    of ``AugmentPipe.apply_geometric``."""
    x = np.random.default_rng(1).standard_normal((2, 40, 38, 1)).astype(np.float32)
    fj = jops.setup_filter(WAVELETS["sym6"])
    want = np.asarray(jops.upfirdn2d(jnp.asarray(x), fj, down=2, padding=-1, flip_filter=True,
                                     impl="conv"))
    ft = ufd.Filter(ufd.setup_filter(WAVELETS["sym6"]))
    got = ufd.downsample2d(_nchw(x), ft, down=2, padding=-6, flip_filter=True)
    assert got.shape == (2, 1, 14, 13)
    np.testing.assert_allclose(_nhwc(got), want, **TOL)


SPECS = [
    fir.FirSpec("same", (0.1, 0.4, 0.3, 0.2), (0.25, 0.5, 0.25, 0.125), (0, 0, 0, 0)),
    fir.FirSpec("same", (0.125, 0.375, 0.375, 0.125), (0.125, 0.375, 0.375, 0.125), (2, 1, -1, 3)),
    fir.FirSpec("down2", (0.125, 0.375, 0.375, 0.125), (0.2, 0.3, 0.5), (1, 1, 2, 0)),
    fir.FirSpec("down2", tuple(WAVELETS["sym6"]), tuple(WAVELETS["sym6"]), (-1, -1, -1, -1)),
    fir.FirSpec("up2", (0.25, 0.75, 0.75, 0.25), (0.25, 0.75, 0.75, 0.25), (2, 1, 2, 1)),
    fir.FirSpec("up2", (0.3, 0.6, 0.2, 0.1), (0.5, 1.0, 0.5), (-1, 2, 1, 0)),
    # StyleGAN3-T's ×4 up-filter (24 taps summing to 4 an axis, as its
    # gain of 16 makes them; its layers' cropping pads), its ↓4 adjoint's
    # pads, and short and odd tap counts.
    fir.FirSpec("up4", tuple(np.linspace(0.2, 1.0, 24) / 3.0),
                tuple(np.linspace(1.0, 0.1, 24) / 3.3), (-6, -9, -6, -9)),
    fir.FirSpec("down4", tuple(np.linspace(0.2, 1.0, 24) / 12),
                tuple(np.linspace(1.0, 0.1, 24) / 13.2), (29, 29, 29, 30)),
    fir.FirSpec("up4", (0.1, 0.3, 0.5, 0.2, 0.4, 0.3, 0.1), (0.25, 0.5, 0.25), (3, 2, 1, -2)),
    fir.FirSpec("down4", (0.1, 0.3, 0.5, 0.2, 0.4), (0.2, 0.5, 0.3, 0.6, 0.1, 0.2, 0.4, 0.3),
                (1, 2, -1, 3)),
]


def _spec_2d(form, ky, kx, pads, seed=8):
    """A 2-D spec with random correlation taps (a radial filter's kind:
    no separable factors)."""
    rows = np.random.default_rng(seed).standard_normal((ky, kx)) / (ky * kx) ** 0.5
    return fir.FirSpec(form, (0.0,) * ky, (0.0,) * kx, pads, tuple(map(tuple, rows.tolist())))


# StyleGAN3-R's radial down-filter (12 x 12, ↓2, pads 0) and its ×2
# adjoint's pads, other pads, and odd and unequal sizes.
SPECS_2D = [
    _spec_2d("down2", 12, 12, (0, 0, 0, 0)),
    _spec_2d("up2", 12, 12, (11, 10, 11, 10)),
    _spec_2d("down2", 5, 7, (2, -1, 3, 1)),
    _spec_2d("up2", 7, 4, (-2, 3, 4, 0)),
]
SPECS += SPECS_2D


@pytest.mark.parametrize("spec", SPECS, ids=[f"{s.form}-{i}" for i, s in enumerate(SPECS)])
def test_fir_function_to_second_order_matches_plain_autograd(spec):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 27, 25)).astype(np.float32))
    oh, ow = spec.out_size(27, 25)
    w = torch.from_numpy(rng.standard_normal((3, oh, ow)).astype(np.float32))

    def r1_like(fn):
        xs = x.clone().requires_grad_(True)
        y = fn(xs)
        assert y.shape == (3, oh, ow)
        (gx,) = torch.autograd.grad((F.softplus(y) * w).sum(), xs, create_graph=True)
        (ggx,) = torch.autograd.grad(gx.square().sum(), xs)
        return y.detach(), gx.detach(), ggx

    got = r1_like(lambda t: fir.Fir.apply(t, spec))
    want = r1_like(lambda t: fir.fir_plain(t, spec))  # autograd of the plain conv chain
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, **TOL)


@pytest.mark.parametrize("spec", SPECS, ids=[f"{s.form}-{i}" for i, s in enumerate(SPECS)])
@pytest.mark.parametrize("hw", [(27, 25), (16, 17)])
def test_fir_adjoint_spec_is_the_transpose(spec, hw):
    h, w = hw
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, h, w)))
    oh, ow = spec.out_size(h, w)
    g = torch.from_numpy(rng.standard_normal((2, oh, ow)))
    adj = spec.adjoint(h, w)
    kx = fir.fir_plain(x, spec)
    ktg = fir.fir_plain(g, adj)
    assert ktg.shape == x.shape
    lhs, rhs = float((kx * g).sum()), float((x * ktg).sum())
    assert abs(lhs - rhs) <= 1e-10 * max(abs(lhs), 1.0)
    # The adjoint's adjoint computes the same map (a down2 high pad may
    # differ by one where the floor division drops it).
    torch.testing.assert_close(fir.fir_plain(x, adj.adjoint(oh, ow)), kx, rtol=0, atol=0)


def test_filter_taps_factor_separable_filters():
    taps = ufd.filter_taps(ufd.setup_filter([1, 3, 3, 1]))
    assert taps == ((0.125, 0.375, 0.375, 0.125),) * 2
    sym6 = ufd.setup_filter(WAVELETS["sym6"])  # 1-D: its own factor on both axes
    assert ufd.filter_taps(sym6) == (tuple(sym6.tolist()),) * 2
    ty, tx = ufd.filter_taps(np.outer([1.0, -2.0, 0.5], [3.0, 1.0]))
    np.testing.assert_allclose(np.outer(ty, tx), np.outer([1.0, -2.0, 0.5], [3.0, 1.0]))
    assert ufd.filter_taps(np.asarray([[1.0, 2.0], [3.0, 4.0]])) is None
    with pytest.raises(ValueError, match="host filter"):
        ufd.filter_taps(torch.ones(4, device="meta"))


@pytest.mark.parametrize("kwargs", [dict(up=3, padding=2), dict(up=(2, 1), down=(1, 2)),
                                    dict(up=2, down=2, padding=1)])
def test_upfirdn2d_outside_the_contract_takes_plain_on_cpu(kwargs):
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 2, 9, 8)).astype(np.float32))
    f = ufd.setup_filter([1, 3, 3, 1])
    spec, why = fir.fir_spec(f, None, kwargs.get("up", 1), kwargs.get("down", 1),
                             kwargs.get("padding", 0), False, 1)
    assert spec is None and why
    got = ufd.upfirdn2d(x, f, **kwargs)
    torch.testing.assert_close(got, ufd.upfirdn2d_plain(x, f, **kwargs), rtol=0, atol=0)


# 12- and 4-tap up2 specs for the static polyphase split of the ↑2 kernel:
# even and odd low pads, the cropping pads of StyleGAN3's layers, and
# mixed tap counts.
_T12 = tuple(float(t) for t in np.random.default_rng(5).standard_normal(12))
_T4 = (0.125, 0.375, 0.375, 0.125)
UP2_SPLITS = [
    (_T12, _T12, (9, 8, 9, 8)),          # StyleGAN3 ×2 layers, even p0
    (_T12, _T12, (-11, -12, -11, -12)),  # the same with cropping pads, odd p0
    (_T12, _T12[::-1], (10, 9, 3, 2)),   # odd / even p0 on the two axes
    (_T12, _T4, (-2, 5, 1, 2)),          # negative even pad, mixed tap counts
    (_T4, _T4, (2, 1, 2, 1)),            # upsample2d of the claro image skip
    (_T4, _T4[::-1], (1, 2, -1, 0)),
    (_T4, (0.2, 0.5, 0.3), (0, 0, 3, 1)),  # odd tap count: phases of 1 and 2 taps
]


def _check_split(ty, tx, pads, up):
    """``up_phases`` (what the ↑``up`` kernel is given per axis and output
    residue) rebuilds ``fir_plain``'s output from same-form sums over the
    input, float64 at 1e-6."""
    spec = fir.FirSpec(f"up{up}", ty, tx, pads)
    h, w = 29, 31
    x = np.random.default_rng(6).standard_normal((2, h, w))
    oh, ow = spec.out_size(h, w)

    def axis(a, taps, p0, n_out, ax):
        """out[up·b + r] = sum_t taps_r[t] * a[b + d_r + t] along ``ax``."""
        phases = fir.up_phases(taps, p0, up)
        d = [d_r for _, d_r in phases]
        # d_r is d_0 up to p0 mod up and d_0 + 1 above it.
        assert d == [d[0] + (r > p0 % up) for r in range(up)]
        assert sorted(len(t) for t, _ in phases) == sorted(
            len(taps[j::up]) for j in range(up))
        a = np.moveaxis(a, ax, -1)
        out = np.zeros(a.shape[:-1] + (n_out,))
        for u in range(n_out):
            t_r, d_r = phases[u % up]
            for t, c in enumerate(t_r):
                m = u // up + d_r + t
                if 0 <= m < a.shape[-1]:
                    out[..., u] += c * a[..., m]
        return np.moveaxis(out, -1, ax)

    got = axis(axis(x, ty, pads[0], oh, 1), tx, pads[2], ow, 2)
    want = fir.fir_plain(torch.from_numpy(x), spec).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("ty,tx,pads", UP2_SPLITS,
                         ids=[f"{len(s[0])}x{len(s[1])}-{s[2]}" for s in UP2_SPLITS])
def test_up2_polyphase_split_rebuilds_plain(ty, tx, pads):
    _check_split(ty, tx, pads, 2)


# 24-tap up4 specs (StyleGAN3's ×4 up-filters) at every residue of p0 mod 4,
# StyleGAN3-T's cropping pads among them, and short and odd tap counts
# (residues of 2 and 1 taps).
_T24 = tuple(float(t) for t in np.random.default_rng(10).standard_normal(24))
UP4_SPLITS = [
    (_T24, _T24, (-6, -9, -6, -9)),      # StyleGAN3-T's ×4 layers: p0 ≡ 2
    (_T24, _T24[::-1], (-5, -8, 3, 2)),   # p0 ≡ 3 / 3
    (_T24, _T24, (4, 3, -7, 0)),          # p0 ≡ 0 / 1
    (_T24, _T12, (9, 10, 13, 1)),         # p0 ≡ 1 / 1, mixed tap counts
    (_T4, _T4, (2, 1, 3, 3)),
    ((0.2, 0.5, 0.3, 0.1, 0.6, 0.4, 0.2), (0.5, 0.5), (0, 1, -2, 5)),
]


@pytest.mark.parametrize("ty,tx,pads", UP4_SPLITS,
                         ids=[f"{len(s[0])}x{len(s[1])}-{s[2]}" for s in UP4_SPLITS])
def test_up4_polyphase_split_rebuilds_plain(ty, tx, pads):
    _check_split(ty, tx, pads, 4)


def test_up2_split_is_up_phases_at_factor_2():
    """The ×2 kernel's split is unchanged: residue r's taps are those j ≡
    p0 + r (mod 2), as before the split took a factor."""
    for taps, p0 in ((_T12, 9), (_T12, -12), (_T4, 2), ((0.2, 0.5, 0.3), 3)):
        want = tuple((tuple(taps[(p0 + r) % 2::2]), (r + (p0 + r) % 2 - p0) // 2) for r in (0, 1))
        assert fir.up_phases(taps, p0, 2) == want


@pytest.mark.parametrize("up,down,n", [(4, 1, 24), (1, 4, 24), (4, 1, 32), (1, 4, 5)])
def test_fir_spec_admits_x4_with_separable_taps(up, down, n):
    """Factor 4 on both axes, up or down, with separable taps of at most
    32 an axis, is inside the kernels' contract; 33 taps, a factor 4
    with a 2-D filter, or up and down together are not."""
    f = torch.from_numpy(np.linspace(0.5, 1.5, n).astype(np.float32))
    spec, why = fir.fir_spec(f, None, up, down, [1, 2, 3, 4], False, 16.0)
    assert why == "" and spec.form == ("up4" if up == 4 else "down4")
    assert spec.pads == (3, 4, 1, 2) and len(spec.taps_y) == len(spec.taps_x) == n
    np.testing.assert_allclose(spec.taps_x, 4.0 * f.numpy()[::-1], rtol=1e-6)
    f33 = torch.ones(33)
    assert fir.fir_spec(f33, None, up, down, 0, False, 1) == (
        None, "33 x 33 taps (at most 32 per axis)")
    assert fir.fir_spec(torch.ones(4, 4) + torch.eye(4), None, up, down, 0, False, 1)[1] == (
        "2-D filter, not separable")
    assert fir.fir_spec(f, None, 4, 2, 0, False, 1) == (None, "up=4, down=2")


@pytest.mark.parametrize("padding", [(9, 8, 9, 8), (10, 9, 3, 2)])
def test_12_tap_up2_matches_jax_fir2d(_interpret, padding):
    """A StyleGAN3 ×2 geometry: JAX ``fir2d`` (K7's Pallas kernel, run in
    interpret mode) against the port's plain version and its Fir path,
    float32 at 1e-5."""
    from gantrack_tpu_torch.models.stylegan3 import design_lowpass_filter

    taps = design_lowpass_filter(12, 32.0, 16.0, 128.0).tolist()
    x = np.random.default_rng(7).standard_normal((1, 11, 14, 4)).astype(np.float32)
    want = np.asarray(jfir.fir2d(jnp.asarray(x), taps, taps, up=2, padding=padding, gain=4.0))
    py0, py1, px0, px1 = padding
    f = torch.tensor(taps, dtype=torch.float32)
    kw = dict(up=2, padding=[px0, px1, py0, py1], gain=4.0)
    plain = ufd.upfirdn2d_plain(_nchw(x), f, **kw)
    via_fn = ufd.upfirdn2d(_nchw(x), ufd.Filter(f), **kw)
    np.testing.assert_allclose(_nhwc(plain), want, **TOL)
    np.testing.assert_allclose(_nhwc(via_fn), want, **TOL)


@pytest.mark.parametrize("shape", [(2, 3, 46, 46), (1, 2, 45, 51)])
def test_12_tap_down2_matches_jax_fir2d(_interpret, shape):
    """A StyleGAN3 ↓2 down-filter geometry (12 taps, pads 0, gain 1) on
    an even and an odd canvas: JAX ``fir2d`` (K6's Pallas kernel, run in
    interpret mode) against the port's plain version and its Fir path,
    float32 at 1e-5."""
    from gantrack_tpu_torch.models.stylegan3 import design_lowpass_filter

    taps = design_lowpass_filter(12, 16.0, 13.0, 64.0).tolist()
    n, c, h, w = shape
    x = np.random.default_rng(8).standard_normal((n, h, w, c)).astype(np.float32)
    want = np.asarray(jfir.fir2d(jnp.asarray(x), taps, taps, down=2))
    assert want.shape == (n, (h - 12) // 2 + 1, (w - 12) // 2 + 1, c)
    f = torch.tensor(taps, dtype=torch.float32)
    plain = ufd.upfirdn2d_plain(_nchw(x), f, down=2)
    via_fn = ufd.upfirdn2d(_nchw(x), ufd.Filter(f), down=2)
    np.testing.assert_allclose(_nhwc(plain), want, **TOL)
    np.testing.assert_allclose(_nhwc(via_fn), want, **TOL)


# The tile geometry of ``fir_kernel`` (K5, K6) in csrc/fir.cu: kCols window
# columns (one a thread) and kRows output rows a tile, which each thread
# walks down its column.
K_COLS, K_ROWS = 128, 16


def _tile_w(s, k):
    """``tile_w``: the widest even tile whose window, s·(TW − 1) + k
    columns, fits ``K_COLS``."""
    return ((K_COLS - k) // s + 1) & ~1


def _fir_kernel_model(x, spec):
    """``fir_kernel``'s data flow in float64: per tile, the vertical sums
    of each window column from a register window of ky + s·(kRows − 1)
    samples (zeros outside the image) into a buffer whose unwritten
    entries are NaN, then each lane's output pair (u, u + 1) from the
    buffer columns 2s·q … 2s·q + s + kx − 1 (u's taps from the first,
    u + 1's from s on).  A read of an unwritten sum shows as a NaN in the
    output."""
    s = 2 if spec.form == "down2" else 1
    planes, h, w = x.shape
    oh, ow = spec.out_size(h, w)
    # The taps as the kernel and ``fir_plain`` hold them: float32.
    ty, tx = (np.float32(t).astype(np.float64) for t in (spec.taps_y, spec.taps_x))
    ky, kx = len(ty), len(tx)
    py0, _, px0, _ = spec.pads
    tw = _tile_w(s, kx)
    assert tw >= 2 and tw % 2 == 0
    if kx == ky and kx in (4, 12):  # the lane's 2s-float words stay inside the row
        assert s * (tw - 2) + -(-(s + kx) // (2 * s)) * 2 * s <= K_COLS
    padded = np.zeros((planes, h + 2 * 128, w + 2 * 128))
    padded[:, 128:128 + h, 128:128 + w] = x
    out = np.full((planes, oh, ow), np.nan)
    for u0 in range(0, ow, tw):
        n_out = min(tw, (ow - u0 + 1) & ~1)
        nc = s * (n_out - 1) + kx
        assert nc <= K_COLS
        cols = s * u0 - px0 + np.arange(nc) + 128
        for v0 in range(0, oh, K_ROWS):
            vert = np.full((planes, K_ROWS, K_COLS), np.nan)
            iy0 = s * v0 - py0 + 128
            win = padded[:, iy0:iy0 + ky + s * (K_ROWS - 1)][:, :, cols]
            for a in range(K_ROWS):
                vert[:, a, :nc] = np.einsum("i,pic->pc", ty, win[:, s * a:s * a + ky])
            rows = min(K_ROWS, oh - v0)
            for q in range(n_out // 2):
                u = u0 + 2 * q
                h0 = vert[:, :rows, 2 * s * q:2 * s * q + s + kx]
                out[:, v0:v0 + rows, u] = h0[..., :kx] @ tx
                if u + 1 < ow:
                    out[:, v0:v0 + rows, u + 1] = h0[..., s:s + kx] @ tx
    return out


_T5 = (0.1, 0.2, 0.4, 0.2, 0.1)
KERNEL_TILINGS = [
    # StyleGAN3's ↓2 down-filters (12 taps, pads 0): several tiles each way,
    # an odd canvas, and a canvas smaller than one tile.
    (fir.FirSpec("down2", _T12, _T12, (0, 0, 0, 0)), (2, 150, 260)),
    (fir.FirSpec("down2", _T12, _T12, (0, 0, 0, 0)), (1, 83, 131)),
    (fir.FirSpec("down2", _T12, _T12[::-1], (0, 0, 0, 0)), (2, 30, 27)),
    # The claro shapes: the G post-filter (3 column tiles, the last ragged),
    # the D pre-filter and skip, the augment's cropping 12-tap ↓2.
    (fir.FirSpec("same", _T4, _T4, (0, 0, 0, 0)), (2, 67, 259)),
    (fir.FirSpec("same", _T4, _T4[::-1], (2, 2, 2, 2)), (1, 40, 256)),
    (fir.FirSpec("down2", _T4, _T4, (1, 1, 1, 1)), (2, 70, 130)),
    (fir.FirSpec("down2", tuple(WAVELETS["sym6"]), tuple(WAVELETS["sym6"]), (-1, -1, -1, -1)),
     (1, 100, 141)),
    # Other pads and the generic tap loop (5 taps; 1 tap: a pad or crop).
    (fir.FirSpec("same", _T12, _T12, (3, -2, -1, 4)), (1, 45, 150)),
    (fir.FirSpec("same", _T5, _T4, (2, 2, 1, 3)), (2, 50, 101)),
    (fir.FirSpec("down2", _T5, _T5, (2, 2, 1, 3)), (1, 77, 203)),
    (fir.FirSpec("same", (1.0,), (1.0,), (-3, 2, 4, -1)), (1, 35, 140)),
    (fir.FirSpec("down2", _T12 + _T12 + _T12[:8], _T12 + _T12 + _T12[:8], (5, 4, 3, 2)),
     (1, 60, 140)),
]


@pytest.mark.parametrize("spec,shape", KERNEL_TILINGS,
                         ids=[f"{s.form}-{len(s.taps_x)}-{i}" for i, (s, _) in
                              enumerate(KERNEL_TILINGS)])
def test_fir_kernel_tiling_model_rebuilds_plain(spec, shape):
    """The tiles, register windows and output pairs of ``fir_kernel``
    (the model above) cover every output exactly from written sums, and
    rebuild ``fir_plain`` in float64 at 1e-6 (``fir_plain`` rounds the
    outer product of two different tap lists to float32)."""
    x = np.random.default_rng(9).standard_normal(shape)
    got = _fir_kernel_model(x, spec)
    want = fir.fir_plain(torch.from_numpy(x), spec).numpy()
    assert got.shape == want.shape and not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_24_tap_up4_matches_jax_upfirdn2d():
    """A StyleGAN3-T ×4 geometry (24 taps, gain 16, the cropping pads of
    its layers): JAX ``upfirdn2d(impl="conv")`` against the port's plain
    version and its Fir path, float32 at 1e-5."""
    from gantrack_tpu_torch.models.stylegan3 import design_lowpass_filter

    taps = design_lowpass_filter(24, 8.0, 11.3, 64.0).tolist()
    x = np.random.default_rng(11).standard_normal((2, 13, 15, 3)).astype(np.float32)
    kw = dict(up=4, padding=[-6, -9, -6, -9], gain=16.0)
    want = np.asarray(jops.upfirdn2d(jnp.asarray(x), jnp.asarray(taps, dtype=jnp.float32),
                                     impl="conv", **kw))
    assert want.shape == (2, 4 * 13 - 38, 4 * 15 - 38, 3)
    f = torch.tensor(taps, dtype=torch.float32)
    plain = ufd.upfirdn2d_plain(_nchw(x), f, **kw)
    via_fn = ufd.upfirdn2d(_nchw(x), ufd.Filter(f), **kw)
    np.testing.assert_allclose(_nhwc(plain), want, **TOL)
    np.testing.assert_allclose(_nhwc(via_fn), want, **TOL)


def _up4_axis(taps, p0):
    """``read_up4_axis`` of csrc/fir.cu: the slot order of ``up_phases``'
    split, the four outputs 4a + e + i reading X[a + D + t]."""
    phases = fir.up_phases(taps, p0, 4)
    d = [d_r for _, d_r in phases]
    e = sum(d_r == d[0] for d_r in d) % 4
    slots = [np.float32(phases[(e + i) % 4][0]).astype(np.float64) for i in range(4)]
    return slots, e, d[e]


def _up4_kernel_model(x, spec, chunk):
    """``fir_up_kernel<T, 4, K>``'s data flow in float64, ``chunk`` outputs
    a lane (8 at bf16, 4 at f32; 16 lanes a row): per tile of 64 rows x
    16·chunk columns, the input box (zeros outside the image), the
    vertical slots into a buffer whose unwritten entries are NaN, each
    lane's word of outputs from the buffer at slot (phi + k) mod 4 and
    group (phi + k) / 4, then the tile's rows that lie in the output.  An
    output written twice or read from an unwritten sum fails."""
    planes, h, w = x.shape
    oh, ow = spec.out_size(h, w)
    (sy, ey, dy), (sx, ex, dx) = (_up4_axis(spec.taps_y, spec.pads[0]),
                                  _up4_axis(spec.taps_x, spec.pads[2]))
    cols = 16 * chunk
    box_cols = cols // 4 + 8
    box_rows = 16 + max(len(t) for t in sy) - 1
    assert box_rows <= 23
    out = np.full((planes, oh, ow), np.nan)
    for by in range(-(-(oh + (4 - ey) % 4) // 64)):
        oy0 = 64 * by - (4 - ey) % 4
        assert (oy0 - ey) % 4 == 0
        a0 = (oy0 - ey) // 4
        for bx in range(-(-ow // cols)):
            ub, n = cols * bx, min(cols, ow - cols * bx)
            phi = (ub - ex) % 4
            gx0 = (ub - ex - phi) // 4
            iy, ix = a0 + dy + np.arange(box_rows), gx0 + dx + np.arange(box_cols)
            box = np.zeros((planes, box_rows, box_cols))
            ok_y, ok_x = (iy >= 0) & (iy < h), (ix >= 0) & (ix < w)
            box[:, np.ix_(ok_y, ok_x)[0], np.ix_(ok_y, ok_x)[1]] = x[:, iy[ok_y]][:, :, ix[ok_x]]
            vert = np.full((planes, 64, box_cols), np.nan)
            for g in range(16):
                for i in range(4):
                    vert[:, 4 * g + i] = np.einsum("t,ptc->pc", sy[i], box[:, g:g + len(sy[i])])
            for r in range(64):
                if not 0 <= oy0 + r < oh:
                    continue
                for q in range(16):
                    if chunk * q >= n:
                        continue
                    for k in range(chunk):
                        u = ub + chunk * q + k
                        slot, go = (phi + k) % 4, (phi + k) // 4
                        c0 = (chunk // 4) * q + go
                        assert c0 + len(sx[slot]) <= box_cols
                        if chunk * q + k < n:
                            assert np.isnan(out[:, oy0 + r, u]).all()
                            out[:, oy0 + r, u] = vert[:, r, c0:c0 + len(sx[slot])] @ sx[slot]
    return out


UP4_TILINGS = [
    # StyleGAN3-T's ×4 layers at reduced size (two row and column tiles,
    # ragged), an odd residue on both axes, the generic tap loop (7 and 5
    # taps), and an output narrower than one tile.
    (fir.FirSpec("up4", _T24, _T24, (-6, -9, -6, -9)), (2, 23, 40)),
    (fir.FirSpec("up4", _T24, _T24[::-1], (-5, -8, 3, 2)), (1, 30, 21)),
    (fir.FirSpec("up4", (0.2, 0.5, 0.3, 0.1, 0.6, 0.4, 0.2), (0.1, 0.2, 0.4, 0.2, 0.1),
                 (2, 1, -1, 4)), (1, 20, 34)),
    (fir.FirSpec("up4", _T24, _T24, (4, 3, 9, 2)), (2, 9, 7)),
]


@pytest.mark.parametrize("chunk", [8, 4])
@pytest.mark.parametrize("spec,shape", UP4_TILINGS,
                         ids=[f"{len(s.taps_y)}x{len(s.taps_x)}-{s.pads}" for s, _ in UP4_TILINGS])
def test_up4_kernel_tiling_model_rebuilds_plain(spec, shape, chunk):
    """The tiles, box, slots and lane words of the ×4 kernel (the model
    above, at both element sizes) cover every output once from written
    sums, and rebuild ``fir_plain`` in float64 at 1e-6."""
    x = np.random.default_rng(12).standard_normal(shape)
    got = _up4_kernel_model(x, spec, chunk)
    want = fir.fir_plain(torch.from_numpy(x), spec).numpy()
    assert got.shape == want.shape and not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def _down4_kernel_model(x, spec):
    """``fir_down4_kernel``'s data flow in float64: per tile of 16 rows x
    TW columns (TW the widest even count whose window of 4·(TW − 1) + kx
    columns fits 256), each window column's vertical sums from the input
    rows 4v + i − py0 (zeros outside the image) into a buffer whose
    unwritten entries are NaN, then each lane's output pair (u, u + 1)
    from the buffer columns 8q … 8q + 4 + kx − 1."""
    planes, h, w = x.shape
    oh, ow = spec.out_size(h, w)
    ty, tx = (np.float32(t).astype(np.float64) for t in (spec.taps_y, spec.taps_x))
    ky, kx = len(ty), len(tx)
    py0, _, px0, _ = spec.pads
    tw = ((256 - kx) // 4 + 1) & ~1
    padded = np.zeros((planes, h + 2 * 300, w + 2 * 300))
    padded[:, 300:300 + h, 300:300 + w] = x
    out = np.full((planes, oh, ow), np.nan)
    for u0 in range(0, ow, tw):
        n_out = min(tw, (ow - u0 + 1) & ~1)
        nc = 4 * (n_out - 1) + kx
        assert nc <= 256
        cols = 4 * u0 - px0 + np.arange(nc) + 300
        for v0 in range(0, oh, 16):
            vert = np.full((planes, 16, 256), np.nan)
            for a in range(16):
                rows = 4 * (v0 + a) - py0 + np.arange(ky) + 300
                vert[:, a, :nc] = np.einsum("i,pic->pc", ty, padded[:, rows][:, :, cols])
            for r in range(min(16, oh - v0)):
                for q in range(n_out // 2):
                    u = u0 + 2 * q
                    out[:, v0 + r, u] = vert[:, r, 8 * q:8 * q + kx] @ tx
                    if u + 1 < ow:
                        out[:, v0 + r, u + 1] = vert[:, r, 8 * q + 4:8 * q + 4 + kx] @ tx
    return out


DOWN4_TILINGS = [
    # The ↓4 adjoints of StyleGAN3-T's ×4 layers at reduced size (pads 29;
    # several row and column tiles, ragged), the generic tap loop, and a
    # cropping pad.
    (fir.FirSpec("down4", _T24, _T24, (29, 29, 29, 30)), (2, 80, 270)),
    (fir.FirSpec("down4", _T24, _T24[::-1], (29, 29, 29, 29)), (1, 70, 35)),
    (fir.FirSpec("down4", (0.1, 0.3, 0.5, 0.2, 0.4), _T12, (2, 1, 5, 3)), (1, 71, 300)),
    (fir.FirSpec("down4", _T24 + _T4 + _T4, _T24 + _T4 + _T4, (-2, 3, 30, -1)), (1, 90, 150)),
]


@pytest.mark.parametrize("spec,shape", DOWN4_TILINGS,
                         ids=[f"{len(s.taps_y)}x{len(s.taps_x)}-{s.pads}"
                              for s, _ in DOWN4_TILINGS])
def test_down4_kernel_tiling_model_rebuilds_plain(spec, shape):
    """The tiles, vertical sums and output pairs of the ↓4 kernel (the
    model above) cover every output exactly from written sums, and
    rebuild ``fir_plain`` in float64 at 1e-6."""
    x = np.random.default_rng(13).standard_normal(shape)
    got = _down4_kernel_model(x, spec)
    want = fir.fir_plain(torch.from_numpy(x), spec).numpy()
    assert got.shape == want.shape and not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


# ---- 2-D filters at factor 2 (StyleGAN3-R's radial down-filters and
# their ×2 adjoints): the static spec, and float64 models of the two
# kernels' tiles, windows and the host's polyphase split.


def _radial():
    from gantrack_tpu_torch.models.stylegan3 import design_lowpass_filter

    # A radial 12-tap jinc of StyleGAN3-R's layers (numtaps, cutoff, width, rate).
    return torch.from_numpy(design_lowpass_filter(12, 22.6, 17.25, 128.0, radial=True))


@pytest.mark.parametrize("up,down", [(1, 2), (2, 1)])
def test_fir_spec_admits_2d_taps_at_factor_2(up, down):
    """A 2-D filter of at most 12 x 12 taps at ↓2 or ×2 is inside the
    kernels' contract: correlation taps flipped on both axes (unless
    ``flip_filter``), the gain folded in, the sizes on ``taps_y``,
    ``taps_x``; from ``Taps2D`` (a filter on any device) or from a host
    filter given without taps, the same spec."""
    f = _radial()
    taps = ufd.Filter(f).taps
    assert isinstance(taps, ufd.Taps2D) and ufd.filter_taps(f) is None
    spec, why = fir.fir_spec(torch.empty(12, 12, device="meta"), taps, up, down, [1, 2, 3, 4],
                             False, 4.0)
    assert why == "" and spec.form == ("down2" if down == 2 else "up2")
    assert spec.kernel == spec.form + "_2d" and spec.pads == (3, 4, 1, 2)
    assert spec.taps_y == spec.taps_x == (0.0,) * 12
    np.testing.assert_array_equal(np.asarray(spec.taps_2d), 4.0 * f.double().numpy()[::-1, ::-1])
    assert fir.fir_spec(f, None, up, down, [1, 2, 3, 4], False, 4.0) == (spec, "")
    flipped, _ = fir.fir_spec(f, taps, up, down, 0, True, 1.0)
    np.testing.assert_array_equal(np.asarray(flipped.taps_2d), f.double().numpy())
    with pytest.raises(ValueError, match="host taps"):  # no rows: would read the device
        fir.fir_spec(torch.empty(12, 12, device="meta"), None, up, down, 0, False, 1)


@pytest.mark.parametrize("name", ["f4", "sym6", "radial"])
def test_filter_holds_its_taps_once_and_one_copy_per_device(name, monkeypatch):
    """A ``Filter`` computes its host taps once (``filter_taps``'s factors,
    or a 2-D filter's rows), makes one copy per device and gives the spec
    its host tensor gives; a bare device tensor raises where the kernels
    would need its taps, and a copied module shares the ``Filter``."""
    import copy

    host = {"f4": ufd.setup_filter([1, 3, 3, 1]), "sym6": ufd.setup_filter(WAVELETS["sym6"]),
            "radial": _radial()}[name]
    f = ufd.Filter(host)
    factors = ufd.filter_taps(host)
    assert f.taps == (factors if factors is not None
                      else ufd.Taps2D(tuple(map(tuple, host.double().tolist()))))
    calls = []
    monkeypatch.setattr(ufd, "filter_taps", lambda *a: calls.append(a))
    x = torch.randn((1, 2, 30, 30), generator=torch.Generator().manual_seed(3))
    got = [ufd.upfirdn2d(x, f, down=2) for _ in range(2)]
    assert not calls and torch.equal(got[0], got[1])
    monkeypatch.undo()
    assert f.on("cpu") is f.host and f.on("meta") is f.on("meta")
    assert f.on("meta").device.type == "meta" and copy.deepcopy(f) is f
    for kw in (dict(down=2), dict(up=2, padding=[6, 5, 6, 5], gain=4.0), dict(padding=3)):
        args = (kw.get("up", 1), kw.get("down", 1), kw.get("padding", 0), False,
                kw.get("gain", 1))
        assert fir.fir_spec(f, f.taps, *args) == fir.fir_spec(host, None, *args)
        torch.testing.assert_close(ufd.upfirdn2d(x, f, **kw), ufd.upfirdn2d(x, host, **kw),
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="host taps"):
        ufd.upfirdn2d(x, host.to("meta"), down=2)


@pytest.mark.parametrize("up,down,size", [(1, 1, 12), (4, 1, 12), (1, 4, 12), (1, 2, 13),
                                          (2, 1, (12, 13))])
def test_fir_spec_keeps_other_2d_calls_on_the_plain_route(up, down, size):
    """A 2-D filter at factor 1 or 4, or larger than 12 x 12 either way,
    stays outside the contract under its reason; the plain version runs."""
    ky, kx = (size, size) if isinstance(size, int) else size
    f = torch.from_numpy(np.random.default_rng(1).standard_normal((ky, kx)).astype(np.float32))
    taps = ufd.Filter(f).taps
    assert fir.fir_spec(f, taps, up, down, 0, False, 1) == (None, "2-D filter, not separable")
    assert fir.fir_spec(f.to("meta"), taps, up, down, 0, False, 1) == (
        None, "2-D filter, not separable")
    x = torch.randn((1, 2, 30, 30), generator=torch.Generator().manual_seed(2))
    kw = dict(up=up, down=down, padding=[6, 6, 6, 6])
    torch.testing.assert_close(ufd.upfirdn2d(x, ufd.Filter(f), **kw),
                               ufd.upfirdn2d_plain(x, f, **kw), rtol=0, atol=0)


@pytest.mark.parametrize("spec", SPECS_2D, ids=[f"{s.kernel}-{len(s.taps_y)}x{len(s.taps_x)}"
                                                for s in SPECS_2D])
def test_2d_adjoint_is_the_transpose_and_keeps_the_input_size(spec):
    """<A x, y> = <x, Aᵀ y> through ``fir_plain`` in float64, for odd and
    even input sizes, with Aᵀ the other 2-D form (taps reversed on both
    axes) and its output the input's size."""
    for h, w in ((27, 25), (30, 41), (562, 20)):
        rng = np.random.default_rng(h)
        x = torch.from_numpy(rng.standard_normal((2, h, w)))
        oh, ow = spec.out_size(h, w)
        y = torch.from_numpy(rng.standard_normal((2, oh, ow)))
        adj = spec.adjoint(h, w)
        assert adj.kernel == ("up2_2d" if spec.form == "down2" else "down2_2d")
        assert adj.taps_2d == tuple(row[::-1] for row in spec.taps_2d[::-1])
        aty = fir.fir_plain(y, adj)
        assert aty.shape == x.shape
        lhs, rhs = float((fir.fir_plain(x, spec) * y).sum()), float((x * aty).sum())
        assert abs(lhs - rhs) <= 1e-10 * max(abs(lhs), 1.0)


def _staged(x, iy0, ix0, nr, nc):
    """The window the 2-D kernels stage, in float64: samples outside the
    image zero (``zero_window``), those inside from the image
    (``Window::of``'s ranges)."""
    planes, h, w = x.shape
    win = np.zeros((planes, nr, nc))
    r_lo, c_lo = min(max(-iy0, 0), nr), min(max(-ix0, 0), nc)
    r_hi, c_hi = max(min(h - iy0, nr), r_lo), max(min(w - ix0, nc), c_lo)
    win[:, r_lo:r_hi, c_lo:c_hi] = x[:, iy0 + r_lo:iy0 + r_hi, ix0 + c_lo:ix0 + c_hi]
    return win


def _down2_2d_model(x, spec):
    """``fir_kernel<T, kDown2, KY, KX>`` in float64: 32 x 32 output tiles;
    per tile the staged window (74 x 74 at 12 taps) split into its even
    and odd columns; 8 x 8 threads of 4 x 4 outputs, each output the sum
    over its window rows of the taps times the even and odd runs at the
    thread's offsets.  Unwritten outputs stay NaN."""
    planes, h, w = x.shape
    oh, ow = spec.out_size(h, w)
    t = np.float32(spec.taps_2d).astype(np.float64)  # the kernel's taps: float32
    ky, kx = t.shape
    nr, nc = 2 * 31 + 12, 2 * 31 + 12  # the window at the compiled 12 x 12
    half = ((nc + 1) // 2 + 3) & ~3
    ne, no = 4 + 6 - 1, 4 + 6 - 1
    py0, _, px0, _ = spec.pads
    out = np.full((planes, oh, ow), np.nan)
    for v0 in range(0, oh, 32):
        for u0 in range(0, ow, 32):
            win = _staged(x, 2 * v0 - py0, 2 * u0 - px0, nr, nc)
            even, odd = win[:, :, 0::2], win[:, :, 1::2]
            for ty in range(8):
                for tx in range(8):
                    v, u = v0 + 4 * ty, u0 + 4 * tx
                    if v >= oh or u >= ow:
                        continue
                    assert 4 * tx + ne <= half and 4 * tx + no <= half
                    for a in range(4):
                        for c in range(4):
                            if v + a >= oh or u + c >= ow:
                                continue
                            acc = 0.0
                            for i in range(ky):
                                rr = 8 * ty + 2 * a + i
                                for j in range(kx):
                                    run = odd if j % 2 else even
                                    acc += t[i, j] * run[:, rr, 4 * tx + c + j // 2]
                            assert np.isnan(out[:, v + a, u + c]).all()  # written once
                            out[:, v + a, u + c] = acc
    return out


def _up2_2d_model(x, spec):
    """``fir_up_kernel<T, 2, KY, KX>`` in float64, from the host's arrays
    (``_c_2d``): 8 x 64 output-pair tiles from pair (by·8 − ey, bx·64 −
    ex); the staged window (13 x 69 at 6 slot taps) from input sample (a0
    + dy, b0 + dx); 16 x 4 threads of 2 x 4 pairs, each of their 2 x 2
    phases the sum of its slot taps times the window at the thread's
    offsets.  Unwritten outputs stay NaN."""
    planes, h, w = x.shape
    oh, ow = spec.out_size(h, w)
    taps, geom = fir._c_2d(spec)
    ph = np.float32(list(taps)).astype(np.float64).reshape(2, 2, 6, 6)
    ny0, ny1, nx0, nx1, ey, dy, ex, dx = list(geom)
    ny, nx = (ny0, ny1), (nx0, nx1)
    out = np.full((planes, oh, ow), np.nan)
    for by in range((oh + ey + 15) // 16):
        for bx in range((ow + ex + 127) // 128):
            a0, b0 = by * 8 - ey, bx * 64 - ex
            win = _staged(x, a0 + dy, b0 + dx, 8 + 5, 64 + 5)
            for ty in range(4):
                for tx in range(16):
                    at, bt = 2 * ty, 4 * tx
                    for a in range(2):
                        for sy in range(2):
                            oy = 2 * (a0 + at + a) + ey + sy
                            if not 0 <= oy < oh:
                                continue
                            for c in range(4):
                                for sx in range(2):
                                    ox = 2 * (b0 + bt + c) + ex + sx
                                    if not 0 <= ox < ow:
                                        continue
                                    acc = 0.0
                                    for tt in range(ny[sy]):
                                        for ss in range(nx[sx]):
                                            acc += (ph[sy, sx, tt, ss]
                                                    * win[:, at + a + tt, bt + c + ss])
                                    assert np.isnan(out[:, oy, ox]).all()  # written once
                                    out[:, oy, ox] = acc
    return out


# StyleGAN3-R's geometries (↓2 pads 0 and the ×2 adjoint's pads 11, 10 at a
# 74² canvas), several tiles each way with ragged edges, odd pads (e = 1:
# the first tile starts a pair early), smaller filters (the generic
# path), and a canvas smaller than one tile.
TILINGS_2D = [
    (_spec_2d("down2", 12, 12, (0, 0, 0, 0)), (1, 74, 74)),
    (_spec_2d("down2", 12, 12, (0, 0, 0, 0)), (2, 83, 137)),
    (_spec_2d("down2", 12, 12, (3, -2, -1, 4)), (1, 70, 91)),
    (_spec_2d("down2", 5, 7, (2, 1, 3, 3)), (1, 40, 75)),
    (_spec_2d("down2", 12, 12, (0, 0, 0, 0)), (1, 14, 13)),
    (_spec_2d("up2", 12, 12, (11, 10, 11, 10)), (1, 32, 32)),
    (_spec_2d("up2", 12, 12, (11, 10, 11, 10)), (2, 37, 45)),
    (_spec_2d("up2", 12, 12, (10, 9, -2, 3)), (1, 21, 70)),
    (_spec_2d("up2", 7, 4, (-2, 3, 4, 0)), (1, 19, 38)),
    (_spec_2d("up2", 12, 12, (5, 6, 6, 5)), (1, 4, 5)),
]


@pytest.mark.parametrize("spec,shape", TILINGS_2D,
                         ids=[f"{s.kernel}-{len(s.taps_y)}x{len(s.taps_x)}-{s.pads}-{sh[1]}x{sh[2]}"
                              for s, sh in TILINGS_2D])
def test_2d_kernel_tiling_models_rebuild_plain(spec, shape):
    """The tiles, staged windows, thread offsets and, at ×2, the host's
    polyphase split of the two 2-D kernels (the models above) write every
    output once from staged samples and rebuild ``fir_plain`` in float64
    at 1e-6 (``fir_plain`` rounds the taps to float32)."""
    x = np.random.default_rng(17).standard_normal(shape)
    want = fir.fir_plain(torch.from_numpy(x), spec).numpy()
    model = _down2_2d_model if spec.form == "down2" else _up2_2d_model
    got = model(x, spec)
    assert got.shape == want.shape and not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
