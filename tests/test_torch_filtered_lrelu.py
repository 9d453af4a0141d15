"""The port's ``filtered_lrelu`` against the JAX function, on the CPU.

Same numpy inputs on both sides; NHWC there, NCHW here.  Filters are the
StyleGAN3 designs (Kaiser, separable 1-D; jinc, radial 2-D).  Tolerance
1e-5 of the largest reference value: both sides run the same float32
sums (a zero-stuffed, padded depthwise convolution) in another order.
Every pass takes the FIR kernels' route (on the CPU their plain form):
the radial ↓2 ones (2-D filters) and the separable factor-4 ones too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gantrack_tpu.models.stylegan3 import design_lowpass_filter as j_design
from gantrack_tpu.ops.filtered_lrelu import filtered_lrelu as j_filtered_lrelu
from gantrack_tpu_torch.models.stylegan3 import design_lowpass_filter
from gantrack_tpu_torch.ops import filtered_lrelu
from gantrack_tpu_torch.ops.upfirdn2d import Filter, filter_taps
from gantrack_tpu_torch.utils import profiling


def _filters(up, down, radial):
    rate = 16 * max(up, down)
    fu = design_lowpass_filter(6 * up, 4.0, 6.0, rate) if up > 1 else None
    fd = design_lowpass_filter(6 * down, 4.0, 6.0, rate, radial=radial) if down > 1 else None
    return fu, fd


def _filter(f):
    return None if f is None else Filter(f)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


CASES = [(1, 1, False), (2, 1, False), (2, 2, False), (4, 2, False), (2, 2, True),
         (4, 2, True), (1, 2, True), (4, 4, False)]


@pytest.mark.parametrize("up,down,radial", CASES)
def test_filtered_lrelu_matches_jax(up, down, radial):
    rng = np.random.default_rng(up * 10 + down)
    x = rng.standard_normal((2, 12, 10, 3)).astype(np.float32) * 2
    b = rng.standard_normal(3).astype(np.float32)
    fu, fd = _filters(up, down, radial)
    pad = [5, 4, 6, 3] if (up > 1 or down > 1) else 0
    kw = dict(up=up, down=down, padding=pad, gain=1.3, slope=0.2, clamp=1.5)
    want = np.asarray(j_filtered_lrelu(
        jnp.asarray(x), None if fu is None else jnp.asarray(fu),
        None if fd is None else jnp.asarray(fd), jnp.asarray(b), **kw))
    with profiling.recording() as rec:
        got = filtered_lrelu(torch.from_numpy(x).permute(0, 3, 1, 2), _filter(fu), _filter(fd),
                             torch.from_numpy(b), **kw)
    _close(got.permute(0, 2, 3, 1).numpy(), want)
    if down == 1:  # nothing filters after the clamp: it is active
        assert np.abs(want).max() == pytest.approx(1.5)
    # Both passes take the FIR kernels' route, a radial ↓2 one too.
    assert sum(rec.under("upfirdn2d.plain_route").values()) == 0
    assert rec.counters["upfirdn2d.kernel_route"] == 2


def test_designed_filters_equal_the_jax_designs():
    for args in [(12, 4.0, 6.0, 32.0, False), (24, 8.0, 3.5, 64.0, False),
                 (12, 4.0, 6.0, 32.0, True), (1, 4.0, 6.0, 32.0, False)]:
        a, b = design_lowpass_filter(*args), j_design(*args)
        assert (a is None and b is None) or np.array_equal(a, b)
    assert filter_taps(design_lowpass_filter(12, 4.0, 6.0, 32.0, True)) is None  # not rank 1


@pytest.mark.parametrize("up,down,radial", [(2, 2, False), (4, 2, True)])
def test_filtered_lrelu_gradient_matches_jax(up, down, radial):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 9, 8, 2)).astype(np.float32)
    b = rng.standard_normal(2).astype(np.float32)
    fu, fd = _filters(up, down, radial)
    kw = dict(up=up, down=down, padding=[6, 5, 6, 5], slope=0.2, clamp=2.0)
    jfu, jfd = jnp.asarray(fu), jnp.asarray(fd)
    gx_want, gb_want = jax.grad(
        lambda xi, bi: jnp.sum(jnp.sin(j_filtered_lrelu(xi, jfu, jfd, bi, **kw))),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    out = filtered_lrelu(xt, Filter(fu), Filter(fd), bt, **kw)
    gx, gb = torch.autograd.grad(torch.sin(out).sum(), [xt, bt])
    _close(gx.permute(0, 2, 3, 1).numpy(), np.asarray(gx_want))
    _close(gb.numpy(), np.asarray(gb_want))
