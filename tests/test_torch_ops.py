"""The port's ops (``gantrack_tpu_torch.ops``) against their JAX
counterparts: forward and first-order gradients on the same numpy
inputs, over the parameterisations of ``test_ops_upfirdn2d.py`` and
``test_ops_core.py``.

Tolerance rtol = atol = 1e-5: both sides run the same algorithm in
float32 on the CPU; only the summation order of the convolutions differs.
``conv2d_gradfix`` is held against PyTorch's own conv autograd to the
second order in float64 (1e-10: the same sums, another grouping).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from gantrack_tpu import ops as jops
from gantrack_tpu_torch import ops as tops
from gantrack_tpu_torch.ops import conv2d_gradfix

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))


def _hwio(t):
    return np.transpose(t.detach().numpy(), (2, 3, 1, 0))


def _jax_vjp(fn, args, cot):
    """Output and cotangent-weighted gradients of ``fn`` w.r.t. ``args``."""
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _torch_vjp(fn, args, cot):
    ts = [a.clone().requires_grad_(True) for a in args]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, cot)
    return out.detach(), grads


# ---------------------------------------------------------------- bias_act

@pytest.mark.parametrize("act", ["linear", "relu", "lrelu", "tanh", "sigmoid", "elu",
                                 "selu", "softplus", "swish"])
@pytest.mark.parametrize("gain,clamp", [(None, None), (0.7, 0.5)])
def test_bias_act_matches_jax(act, gain, clamp):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    want, (gx, gb) = _jax_vjp(
        lambda x, b: jops.bias_act(x, b, act=act, gain=gain, clamp=clamp), (x, b), cot)
    got, (tx, tb) = _torch_vjp(
        lambda x, b: tops.bias_act(x, b, dim=1, act=act, gain=gain, clamp=clamp),
        (_nchw(x), torch.from_numpy(b)), _nchw(cot))
    np.testing.assert_allclose(_nhwc(got), want, **TOL)
    np.testing.assert_allclose(_nhwc(tx), gx, **TOL)
    np.testing.assert_allclose(tb.numpy(), gb, **TOL)


# --------------------------------------------------------------- upfirdn2d

UPFIRDN_CASES = [
    # (up, down, padding, filter_taps, flip, gain) — as test_ops_upfirdn2d.py
    (1, 1, 0, [1, 3, 3, 1], False, 1),
    (2, 1, [1, 1], [1, 3, 3, 1], False, 4),
    (1, 2, [2, 1, 1, 2], [1, 3, 3, 1], False, 1),
    (2, 2, 2, [1, 2, 1], True, 1),
    (1, 1, [-1, 2, 0, -1], [1, 3, 3, 1], False, 2),
    ((2, 1), (1, 2), [3, 1, 0, 2], [1, 3, 3, 1], False, 1),
    (1, 1, 1, None, False, 1),
    (4, 2, 3, [1, 4, 6, 4, 1], False, 1),
]


@pytest.mark.parametrize("up,down,padding,taps,flip,gain", UPFIRDN_CASES)
def test_upfirdn2d_matches_jax(up, down, padding, taps, flip, gain):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 9, 3)).astype(np.float32)
    fj = jops.setup_filter(taps)
    ft = tops.setup_filter(taps)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    out = jops.upfirdn2d(jnp.asarray(x), fj, up=up, down=down, padding=padding,
                         flip_filter=flip, gain=gain)
    cot = rng.standard_normal(out.shape).astype(np.float32)
    want, (gx,) = _jax_vjp(lambda x: jops.upfirdn2d(x, fj, up=up, down=down, padding=padding,
                                                    flip_filter=flip, gain=gain), (x,), cot)
    got, (tx,) = _torch_vjp(lambda x: tops.upfirdn2d(x, ft, up=up, down=down, padding=padding,
                                                     flip_filter=flip, gain=gain),
                            (_nchw(x),), _nchw(cot))
    np.testing.assert_allclose(_nhwc(got), want, **TOL)
    np.testing.assert_allclose(_nhwc(tx), gx, **TOL)


SYM6 = [0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
        -0.048311742585633, 0.4910559419267466, 0.787641141030194,
        0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
        0.04472490177066578, 0.0017677118642428036, -0.007800708325034148]


@pytest.mark.parametrize("helper,taps,kwargs", [
    ("filter2d", [1, 3, 3, 1], {}),
    ("upsample2d", [1, 3, 3, 1], {}),
    ("downsample2d", [1, 3, 3, 1], {}),
    ("upsample2d", SYM6, {}),                                     # augment: separable 12-tap
    ("downsample2d", SYM6, dict(padding=-6, flip_filter=True)),   # augment crop-down
])
def test_resample_helpers_match_jax(helper, taps, kwargs):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 20, 18, 1)).astype(np.float32)
    fj, ft = jops.setup_filter(taps), tops.setup_filter(taps)
    fn_j = getattr(jops, helper)
    fn_t = getattr(tops, helper)
    out = fn_j(jnp.asarray(x), fj, **kwargs)
    cot = rng.standard_normal(out.shape).astype(np.float32)
    want, (gx,) = _jax_vjp(lambda x: fn_j(x, fj, **kwargs), (x,), cot)
    got, (tx,) = _torch_vjp(lambda x: fn_t(x, ft, **kwargs), (_nchw(x),), _nchw(cot))
    np.testing.assert_allclose(_nhwc(got), want, **TOL)
    np.testing.assert_allclose(_nhwc(tx), gx, **TOL)


def test_setup_filter_rules_match_jax():
    for f, kw in [([1, 3, 3, 1], {}), ([1, 2, 1], dict(flip_filter=True, gain=4)),
                  (SYM6, {}), (None, {}), ([[1, 2], [3, 4]], dict(normalize=False))]:
        np.testing.assert_array_equal(tops.setup_filter(f, **kw).numpy(),
                                      np.asarray(jops.setup_filter(f, **kw)))


# --------------------------------------------------------- conv2d_resample

@pytest.mark.parametrize("k,up,down,groups", [
    (3, 1, 1, 1), (3, 2, 1, 1), (3, 1, 2, 1), (1, 2, 1, 1),
    (1, 1, 2, 1), (4, 2, 1, 1), (3, 1, 1, 2), (3, 2, 2, 1),
])
def test_conv2d_resample_matches_jax(k, up, down, groups):
    rng = np.random.default_rng(42)
    in_ch, out_ch = 4, 6
    x = rng.standard_normal((2, 8, 8, in_ch)).astype(np.float32)
    w = rng.standard_normal((k, k, in_ch // groups, out_ch)).astype(np.float32)
    fj, ft = jops.setup_filter([1, 3, 3, 1]), tops.setup_filter([1, 3, 3, 1])
    kw = dict(up=up, down=down, padding=k // 2, groups=groups, flip_weight=(up == 1))
    out = jops.conv2d_resample(jnp.asarray(x), jnp.asarray(w), f=fj, **kw)
    cot = rng.standard_normal(out.shape).astype(np.float32)
    want, (gx, gw) = _jax_vjp(lambda x, w: jops.conv2d_resample(x, w, f=fj, **kw), (x, w), cot)
    got, (tx, tw) = _torch_vjp(lambda x, w: tops.conv2d_resample(x, w, f=ft, **kw),
                               (_nchw(x), _oihw(w)), _nchw(cot))
    np.testing.assert_allclose(_nhwc(got), want, **TOL)
    np.testing.assert_allclose(_nhwc(tx), gx, **TOL)
    np.testing.assert_allclose(_hwio(tw), gw, **TOL)


# -------------------------------------------------------- modulated_conv2d

@pytest.mark.parametrize("up,demodulate,fused,noise", [
    (1, True, False, False),
    (2, True, False, True),
    (1, False, False, False),
    (1, True, True, False),
    (2, True, True, False),
])
def test_modulated_conv2d_matches_jax(up, demodulate, fused, noise):
    rng = np.random.default_rng(3)
    n, in_ch, out_ch, k, res = 2, 4, 5, 3, 8
    x = rng.standard_normal((n, res, res, in_ch)).astype(np.float32)
    w = rng.standard_normal((k, k, in_ch, out_ch)).astype(np.float32)
    s = rng.standard_normal((n, in_ch)).astype(np.float32) + 1.0
    nz = rng.standard_normal((n, res * up, res * up, 1)).astype(np.float32)
    fj, ft = jops.setup_filter([1, 3, 3, 1]), tops.setup_filter([1, 3, 3, 1])
    kw = dict(up=up, padding=k // 2, demodulate=demodulate, flip_weight=(up == 1),
              fused_modconv=fused)
    nj = jnp.asarray(nz) if noise else None
    nt = _nchw(nz) if noise else None
    out = jops.modulated_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), noise=nj,
                                resample_filter=fj, **kw)
    cot = rng.standard_normal(out.shape).astype(np.float32)
    want, (gx, gw, gs) = _jax_vjp(
        lambda x, w, s: jops.modulated_conv2d(x, w, s, noise=nj, resample_filter=fj, **kw),
        (x, w, s), cot)
    got, (tx, tw, ts) = _torch_vjp(
        lambda x, w, s: tops.modulated_conv2d(x, w, s, noise=nt, resample_filter=ft, **kw),
        (_nchw(x), _oihw(w), torch.from_numpy(s)), _nchw(cot))
    np.testing.assert_allclose(_nhwc(got), want, **TOL)
    np.testing.assert_allclose(_nhwc(tx), gx, **TOL)
    np.testing.assert_allclose(_hwio(tw), gw, **TOL)
    np.testing.assert_allclose(ts.numpy(), gs, **TOL)


# ---------------------------------------------------------- conv2d_gradfix

@pytest.mark.parametrize("transpose,stride,padding,out_pad,groups,k", [
    (False, 1, 1, 0, 1, 3), (False, 2, 0, 0, 1, 3), (False, 2, 1, 0, 2, 3),
    (False, 1, 0, 0, 4, 4), (True, 2, 0, 0, 1, 3), (True, 2, 1, 1, 2, 3), (True, 1, 0, 0, 1, 1),
])
def test_conv2d_gradfix_matches_autograd_to_second_order(transpose, stride, padding, out_pad,
                                                         groups, k):
    """Forward, gradients and gradients of gradients (w.r.t. input and
    weight) equal PyTorch's own, in float64."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 4, 7, 6)))
    w_shape = (4, 8 // groups, k, k) if transpose else (8, 4 // groups, k, k)
    w = torch.from_numpy(rng.standard_normal(w_shape))

    def ref(x, w):
        if transpose:
            return F.conv_transpose2d(x, w, stride=stride, padding=padding,
                                      output_padding=out_pad, groups=groups)
        return F.conv2d(x, w, stride=stride, padding=padding, groups=groups)

    def fix(x, w):
        if transpose:
            return conv2d_gradfix.conv_transpose2d(x, w, stride, padding, out_pad, groups)
        return conv2d_gradfix.conv2d(x, w, stride, padding, groups)

    def grads(fn):
        xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fn(xs, ws)
        cot = torch.from_numpy(np.random.default_rng(12).standard_normal(y.shape))
        gx, gw = torch.autograd.grad((torch.tanh(y) * cot).sum(), (xs, ws), create_graph=True)
        ggx, ggw = torch.autograd.grad(gx.square().sum() + (gw ** 3).sum(), (xs, ws))
        return [t.detach() for t in (y, gx, gw, ggx, ggw)]

    for got, want in zip(grads(fix), grads(ref), strict=True):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


# ------------------------------------------------------------- grid_sample

def test_grid_sample_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 9, 3)).astype(np.float32)
    grid = rng.random((2, 5, 6, 2)).astype(np.float32) * 2.4 - 1.2  # incl. out-of-bounds
    cot = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)
    want, (gx,) = _jax_vjp(lambda x: jops.grid_sample(x, jnp.asarray(grid)), (x,), cot)
    got, (tx,) = _torch_vjp(lambda x: tops.grid_sample(x, torch.from_numpy(grid)),
                            (_nchw(x),), _nchw(cot))
    np.testing.assert_allclose(_nhwc(got), want, **TOL)
    np.testing.assert_allclose(_nhwc(tx), gx, **TOL)


def test_grid_sample_second_order_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 6, 5, 2)).astype(np.float32)
    grid = rng.random((1, 4, 4, 2)).astype(np.float32) * 2 - 1

    def f_j(x):
        return jnp.sum(jnp.tanh(jops.grid_sample(x, jnp.asarray(grid))) ** 2)

    want = jax.grad(lambda x: jnp.sum(jax.grad(f_j)(x) ** 2))(jnp.asarray(x))
    xt = _nchw(x).requires_grad_(True)
    (g1,) = torch.autograd.grad(
        torch.tanh(tops.grid_sample(xt, torch.from_numpy(grid))).square().sum(), xt,
        create_graph=True)
    (g2,) = torch.autograd.grad(g1.square().sum(), xt)
    np.testing.assert_allclose(_nhwc(g2), np.asarray(want), **TOL)


def test_affine_grid_matches_jax():
    rng = np.random.default_rng(6)
    theta = rng.standard_normal((2, 2, 3)).astype(np.float32) * 0.5
    want = jops.affine_grid(jnp.asarray(theta), 6, 7)
    got = tops.affine_grid(torch.from_numpy(theta), 6, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
