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
    via_fn = ufd.upfirdn2d(_nchw(x), f, taps=(tuple(F4), tuple(F4)), **kw)
    np.testing.assert_allclose(_nhwc(plain), want, **TOL)
    np.testing.assert_allclose(_nhwc(via_fn), want, **TOL)


def test_augment_crop_downsample_matches_jax_conv():
    """The 12-tap sym6 down2 with the crop (padding -1 after the helper)
    of ``AugmentPipe.apply_geometric``."""
    x = np.random.default_rng(1).standard_normal((2, 40, 38, 1)).astype(np.float32)
    fj = jops.setup_filter(WAVELETS["sym6"])
    want = np.asarray(jops.upfirdn2d(jnp.asarray(x), fj, down=2, padding=-1, flip_filter=True,
                                     impl="conv"))
    ft = ufd.setup_filter(WAVELETS["sym6"])
    got = ufd.downsample2d(_nchw(x), ft, down=2, padding=-6, flip_filter=True,
                           taps=ufd.filter_taps(ft))
    assert got.shape == (2, 1, 14, 13)
    np.testing.assert_allclose(_nhwc(got), want, **TOL)


SPECS = [
    fir.FirSpec("same", (0.1, 0.4, 0.3, 0.2), (0.25, 0.5, 0.25, 0.125), (0, 0, 0, 0)),
    fir.FirSpec("same", (0.125, 0.375, 0.375, 0.125), (0.125, 0.375, 0.375, 0.125), (2, 1, -1, 3)),
    fir.FirSpec("down2", (0.125, 0.375, 0.375, 0.125), (0.2, 0.3, 0.5), (1, 1, 2, 0)),
    fir.FirSpec("down2", tuple(WAVELETS["sym6"]), tuple(WAVELETS["sym6"]), (-1, -1, -1, -1)),
    fir.FirSpec("up2", (0.25, 0.75, 0.75, 0.25), (0.25, 0.75, 0.75, 0.25), (2, 1, 2, 1)),
    fir.FirSpec("up2", (0.3, 0.6, 0.2, 0.1), (0.5, 1.0, 0.5), (-1, 2, 1, 0)),
]


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


@pytest.mark.parametrize("kwargs", [dict(up=4, padding=2), dict(up=(2, 1), down=(1, 2)),
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


@pytest.mark.parametrize("ty,tx,pads", UP2_SPLITS,
                         ids=[f"{len(s[0])}x{len(s[1])}-{s[2]}" for s in UP2_SPLITS])
def test_up2_polyphase_split_rebuilds_plain(ty, tx, pads):
    """``up2_phases`` (what the ↑2 kernel is given per axis and output
    parity) rebuilds ``fir_plain``'s up2 output from same-form sums over
    the input, float64 at 1e-6."""
    spec = fir.FirSpec("up2", ty, tx, pads)
    h, w = 29, 31
    x = np.random.default_rng(6).standard_normal((2, h, w))
    oh, ow = spec.out_size(h, w)

    def axis(a, taps, p0, n_out, ax):
        """out[2b + r] = sum_t taps_r[t] * a[b + d_r + t] along ``ax``."""
        phases = fir.up2_phases(taps, p0)
        assert phases[1][1] - phases[0][1] in (0, 1)
        assert sorted(len(t) for t, _ in phases) == sorted(
            [len(taps) // 2, (len(taps) + 1) // 2])
        a = np.moveaxis(a, ax, -1)
        out = np.zeros(a.shape[:-1] + (n_out,))
        for u in range(n_out):
            t_r, d_r = phases[u % 2]
            for t, c in enumerate(t_r):
                m = u // 2 + d_r + t
                if 0 <= m < a.shape[-1]:
                    out[..., u] += c * a[..., m]
        return np.moveaxis(out, -1, ax)

    got = axis(axis(x, ty, pads[0], oh, 1), tx, pads[2], ow, 2)
    want = fir.fir_plain(torch.from_numpy(x), spec).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


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
    via_fn = ufd.upfirdn2d(_nchw(x), f, taps=(tuple(taps), tuple(taps)), **kw)
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
    via_fn = ufd.upfirdn2d(_nchw(x), f, taps=(tuple(taps), tuple(taps)), down=2)
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
