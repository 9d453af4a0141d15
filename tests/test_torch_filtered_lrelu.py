"""The port's ``filtered_lrelu`` against the JAX function, on the CPU.

Same numpy inputs on both sides; NHWC there, NCHW here.  Filters are the
StyleGAN3 designs (Kaiser, separable 1-D; jinc, radial 2-D).  Tolerance
1e-5 of the largest reference value: both sides run the same float32
sums (a zero-stuffed, padded depthwise convolution) in another order.
Every spec inside the fused kernel's contract takes the fused route (on
the CPU its plain form: f32 inside, one rounding, the same codes and
backward), the radial ↓2 ones (2-D filters) and the ×4 ones too; ↓4
keeps the composed route (the FIR kernels' plain form).  The fused
``Function``'s backward is checked to second order in float64, and the
route decision with its counter names.
"""

import importlib

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

# The module (``gantrack_tpu_torch.ops`` exports the function by its name).
flrl = importlib.import_module("gantrack_tpu_torch.ops.filtered_lrelu")


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
         (4, 2, True), (1, 2, True), (4, 4, False), (4, 1, False), (1, 2, False)]


def _route(up, down):
    """The counters of one call: ↓4, and ×4 without ↓2, lie outside the
    fused kernel."""
    why = "down=4" if down == 4 else "up=4, down=1" if (up, down) == (4, 1) else ""
    if why:
        return {f"filtered_lrelu.composed_route/{why}": 1, "upfirdn2d.kernel_route": 2}
    return {"filtered_lrelu.fused_route": 1}


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
    # One fused call, a radial ↓2 one too; ↓4 and ×4 ↓1 composed on the
    # FIR kernels.
    assert rec.counters == _route(up, down)


def test_designed_filters_equal_the_jax_designs():
    for args in [(12, 4.0, 6.0, 32.0, False), (24, 8.0, 3.5, 64.0, False),
                 (12, 4.0, 6.0, 32.0, True), (1, 4.0, 6.0, 32.0, False)]:
        a, b = design_lowpass_filter(*args), j_design(*args)
        assert (a is None and b is None) or np.array_equal(a, b)
    assert filter_taps(design_lowpass_filter(12, 4.0, 6.0, 32.0, True)) is None  # not rank 1


@pytest.mark.parametrize("up,down,radial", CASES)
def test_filtered_lrelu_gradient_matches_jax(up, down, radial):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 9, 8, 2) if down < 4 else (1, 12, 10, 2)).astype(np.float32)
    b = rng.standard_normal(2).astype(np.float32)
    fu, fd = _filters(up, down, radial)
    kw = dict(up=up, down=down, padding=[6, 5, 6, 5], slope=0.2, clamp=2.0)
    jfu = None if fu is None else jnp.asarray(fu)
    jfd = None if fd is None else jnp.asarray(fd)
    gx_want, gb_want = jax.grad(
        lambda xi, bi: jnp.sum(jnp.sin(j_filtered_lrelu(xi, jfu, jfd, bi, **kw))),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    with profiling.recording() as rec:
        out = filtered_lrelu(xt, _filter(fu), _filter(fd), bt, **kw)
    assert rec.counters == _route(up, down)
    gx, gb = torch.autograd.grad(torch.sin(out).sum(), [xt, bt])
    _close(gx.permute(0, 2, 3, 1).numpy(), np.asarray(gx_want))
    _close(gb.numpy(), np.asarray(gb_want))


@pytest.mark.parametrize("up,down,radial",
                         [c for c in CASES if "filtered_lrelu.fused_route" in _route(*c[:2])])
def test_fused_function_passes_gradgradcheck(up, down, radial):
    """float64, tiny: the fused ``Function``'s backward and its backward's
    backward (the read mode with the codes fixed) against finite
    differences; inputs lie off the kinks by far more than the step."""
    fu, fd = (_filter(f) for f in _filters(up, down, radial))
    g = torch.Generator().manual_seed(10 * up + down + radial)
    x = (torch.randn((1, 1, 7, 7), generator=g, dtype=torch.float64) * 2).requires_grad_(True)
    b = torch.randn(1, generator=g, dtype=torch.float64).requires_grad_(True)
    kw = dict(up=up, down=down, padding=[5, 4, 6, 3], gain=1.3, slope=0.2, clamp=1.5)

    def f(xi, bi):
        return filtered_lrelu(xi, fu, fd, bi, **kw)

    with profiling.recording() as rec:
        assert torch.autograd.gradcheck(f, (x, b), eps=1e-6, atol=1e-6)
        assert torch.autograd.gradgradcheck(f, (x, b), eps=1e-6, atol=1e-6)
    assert rec.counters["filtered_lrelu.fused_route"] > 0
    assert rec.under("filtered_lrelu.composed_route") == {}


def _layer_calls(cfg):
    """(name, input, filtered_lrelu kwargs) of every layer of StyleGAN3-T
    or -R at 256², as ``SynthesisLayer.forward`` calls it, on a narrow net
    (the channels do not change a call's spec) and one plane a channel."""
    from gantrack_tpu_torch.models.stylegan3 import SynthesisNetwork

    r = cfg == "sg3r"
    net = SynthesisNetwork(w_dim=8, img_resolution=256, img_channels=1, channel_base=64,
                           channel_max=4, conv_kernel=1 if r else 3, use_radial_filters=r)
    for name in net.layer_names:
        m = getattr(net, name)
        torgb = m.spec.is_torgb
        size = m.spec.in_size + m.conv_kernel - 1
        dtype = torch.bfloat16 if m.spec.use_bf16 else torch.float32
        x = torch.zeros((1, 1, size, size), dtype=dtype)
        yield name, x, dict(fu=m.up_filter, fd=m.down_filter, up=m.up_factor,
                            down=m.down_factor, padding=m.padding,
                            gain=1.0 if torgb else 2 ** 0.5, slope=1.0 if torgb else 0.2,
                            clamp=m.conv_clamp)


# The up factor of each layer of both at 256², L0 to L13 (each ↓2; L14,
# toRGB, is up1_down1), and the fused kernel its spec names: -R's radial
# down-filters are 2-D at L0-L11.
UP = (2, 2, 2, 4, 2, 4, 2, 4, 2, 2, 4, 2, 2, 2)
STYLEGAN3_KERNELS = {
    "sg3t": [f"up{u}_down2" for u in UP] + ["up1_down1"],
    "sg3r": [f"up{u}_down2" + ("_down2d" if i < 12 else "") for i, u in enumerate(UP)]
    + ["up1_down1"],
}


@pytest.mark.parametrize("cfg", ["sg3t", "sg3r"])
def test_every_stylegan3_layer_takes_the_fused_route(cfg):
    """The route of each layer's spec (its filters, factors, pads and
    dtype), counted once a call, and the kernel its spec names."""
    kernels = []
    for name, x, kw in _layer_calls(cfg):
        spec, why = flrl.fused_spec(x, kw["fu"], kw["fd"], None, kw["up"], kw["down"],
                                    kw["padding"], kw["gain"], kw["slope"], kw["clamp"])
        assert spec is not None, (name, why)
        kernels.append(spec.kernel)
        with profiling.recording() as rec:
            y = filtered_lrelu(x, **kw)
        assert rec.counters == {"filtered_lrelu.fused_route": 1}, name
        assert y.dtype == x.dtype and tuple(y.shape[2:]) == spec.out_hw
    assert kernels == STYLEGAN3_KERNELS[cfg]


def _lowpass(taps, radial=False):
    return Filter(design_lowpass_filter(taps, 4.0, 6.0, 64.0, radial=radial))


# Specs outside the fused kernel's contract: (label, call, the composed
# route's reason).
OUTSIDE = [
    ("down4", lambda x: dict(fd=_lowpass(24), down=4), "down=4"),
    ("float16", lambda x: dict(x=x.half()), "cpu torch.float16"),
    ("up3", lambda x: dict(fu=_lowpass(12), up=3, padding=[6, 5, 6, 5]),
     "up-filter: up=3, down=1"),
    ("2-D up-filter", lambda x: dict(fu=_lowpass(12, radial=True), up=2, padding=[5, 5, 5, 5]),
     "2-D up-filter"),
    ("filter at factor 1", lambda x: dict(fu=_lowpass(4), padding=[2, 1, 2, 1]),
     "up-filter: a filter at factor 1"),
    ("14 taps at x2", lambda x: dict(fu=_lowpass(14), up=2, padding=[7, 6, 7, 6]),
     "up-filter: 14 x 14 taps at factor 2 (at most 12)"),
]


@pytest.mark.parametrize("label,call,why", OUTSIDE, ids=[o[0] for o in OUTSIDE])
def test_a_spec_outside_the_contract_keeps_the_composed_route(label, call, why):
    x = torch.randn((1, 3, 40, 40))
    kw = dict(x=x, b=torch.zeros(3), clamp=256.0, **{"fu": None, "fd": None})
    kw.update(call(x))
    spec, got = flrl.fused_spec(kw["x"], kw["fu"], kw["fd"], kw["b"], kw.get("up", 1),
                                kw.get("down", 1), kw.get("padding", 0), 1.0, 0.2, 256.0)
    assert spec is None and got == why
    with profiling.recording() as rec:
        y = filtered_lrelu(**kw)
    assert rec.counters[f"filtered_lrelu.composed_route/{why}"] == 1
    assert "filtered_lrelu.fused_route" not in rec.counters
    want = flrl._composed(kw["x"], kw["fu"], kw["fd"], kw["b"], kw.get("up", 1),
                          kw.get("down", 1), [0] * 4 if "padding" not in kw else kw["padding"],
                          float(np.sqrt(2)), 0.2, 256.0)
    assert torch.equal(y, want)


def test_codes_round_trip_and_the_conventions_at_the_thresholds():
    """Samples exactly at 0 and ±clamp on the toRGB spec (no filters, gain
    1): 0 takes the slope (``leaky_relu``'s backward), ±clamp passes its
    gradient (``clamp``'s), past it none; the codes pack 16 a word and
    unpack to the same values."""
    vals = torch.tensor([0.0, 256.0, -512.0, 255.0, 260.0, -600.0, 3.5, -3.5])
    x = vals.repeat(3, 5).reshape(1, 1, 3, 40).requires_grad_(True)
    with profiling.recording() as rec:
        y = filtered_lrelu(x, gain=1.0, slope=0.5, clamp=256.0)
    assert rec.counters == {"filtered_lrelu.fused_route": 1}
    assert torch.equal(y, torch.where(vals > 0, vals, vals * 0.5).clamp(-256, 256)
                       .repeat(3, 5).reshape(1, 1, 3, 40))
    (dx,) = torch.autograd.grad(y.sum(), [x])
    want = torch.tensor([0.5, 1.0, 0.5, 1.0, 0.0, 0.0, 1.0, 0.5])
    assert torch.equal(dx, want.repeat(3, 5).reshape(1, 1, 3, 40))
    spec, _ = flrl.fused_spec(x, None, None, None, 1, 1, 0, 1.0, 0.5, 256.0)
    _, sign = flrl.fused_planes(x.detach().reshape(1, 3, 40), spec)
    assert sign.dtype == torch.int32 and tuple(sign.shape) == (1, 3, spec.words)
    codes = flrl.unpack_codes(sign, spec)
    assert torch.equal(codes[0, 0, :8], torch.tensor([1, 0, 1, 0, 2, 2, 0, 1]))
    assert torch.equal(flrl.pack_codes(codes, spec), sign)
