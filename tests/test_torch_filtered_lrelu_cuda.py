"""The fused ``filtered_lrelu`` kernel (``csrc/filtered_lrelu.cu``) on the
card, at every layer of StyleGAN3-T and StyleGAN3-R at 256² (``sg3t-256``,
``sg3r-256``: L0–L14 at their full canvases and pads, fewer planes), in
bfloat16 and float32.

Needs an NVIDIA card and ``nvcc``; skips without a card.  Imports no JAX,
so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_filtered_lrelu_cuda.py

Held against (a) the plain form of the same semantics in float64 on the
card, on the same rounded input: float32 1e-5 of the largest reference
value, bfloat16 1e-2 of it (the output's rounding); (b) the composed route
(``bias_act`` and the FIR kernels) in float32 on the same rounded input
and cotangent: forward, ``dx``, ``db`` and a second-order gradient through
``create_graph``, 1e-4 of the largest value in float32, 2e-2 in bfloat16
(the fused route rounds each output and gradient once); (c) the codes against the composed route's masks
(``leaky_relu``'s ``v > 0``, ``clamp``'s ``|y| > clamp``) in float32,
where the intermediate lies off the thresholds by more than its rounding,
and exactly at 0 and ±clamp; (d) itself: two runs are equal bit for bit.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

from gantrack_tpu_torch.ops.upfirdn2d import upfirdn2d
from gantrack_tpu_torch.utils import profiling

# The module (``gantrack_tpu_torch.ops`` exports the function by its name).
flrl = importlib.import_module("gantrack_tpu_torch.ops.filtered_lrelu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused filtered_lrelu kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _layers(cfg):
    """(name, input size, dtype, filtered_lrelu kwargs) of every layer of
    StyleGAN3-T or -R at 256², as ``SynthesisLayer.forward`` calls it
    (the channels do not change a call's spec; narrow ones build fast)."""
    from gantrack_tpu_torch.models.stylegan3 import SynthesisNetwork

    r = cfg == "sg3r"
    net = SynthesisNetwork(w_dim=8, img_resolution=256, img_channels=1, channel_base=64,
                           channel_max=4, conv_kernel=1 if r else 3, use_radial_filters=r)
    out = []
    for name in net.layer_names:
        layer = getattr(net, name)
        torgb = layer.spec.is_torgb
        kw = dict(fu=layer.up_filter, fd=layer.down_filter, up=layer.up_factor,
                  down=layer.down_factor, padding=layer.padding, gain=1.0 if torgb else 2 ** 0.5,
                  slope=1.0 if torgb else 0.2, clamp=layer.conv_clamp)
        size = layer.spec.in_size + layer.conv_kernel - 1
        dtype = torch.bfloat16 if layer.spec.use_bf16 else torch.float32
        out.append((f"{cfg}.{name}", size, dtype, kw))
    return out


CASES = [(cfg, i, dtype) for cfg in ("sg3t", "sg3r") for i in range(15)
         for dtype in (torch.float32, torch.bfloat16)]
IDS = [f"{cfg}-L{i}-{str(dtype)[6:]}" for cfg, i, dtype in CASES]


def _inputs(cfg, i, dtype, dev, planes=(2, 3)):
    name, size, _, kw = _layers(cfg)[i]
    g = torch.Generator().manual_seed(1000 * (cfg == "sg3r") + 10 * i + (dtype == torch.bfloat16))
    # The scale of a layer's input: conv_clamp's 256 is reached on some samples.
    x = torch.randn((*planes, size, size), generator=g) * (40.0 if i == 14 else 1.5)
    b = torch.randn(planes[1], generator=g) * 0.3
    return x.to(dev, dtype), b.to(dev, dtype), kw


def _err(a, b):
    return float((a.detach().double() - b.detach().double()).abs().max())


def _scale(t):
    return float(t.detach().double().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,i,dtype", CASES, ids=IDS)
def test_fused_kernel_matches_the_plain_form(cuda_device, cfg, i, dtype):
    x, b, kw = _inputs(cfg, i, dtype, cuda_device)
    spec, why = flrl.fused_spec(x, kw["fu"], kw["fd"], b, kw["up"], kw["down"], kw["padding"],
                                kw["gain"], kw["slope"], kw["clamp"])
    assert spec is not None, why
    n, c, h, w = x.shape
    planes = x.reshape(n * c, h, w)
    with profiling.recording() as rec:
        y, sign = flrl.fused_planes(planes, spec, b, None, c)
    assert rec.counters == {f"filtered_lrelu.launch/{spec.kernel}": 1}
    want, want_sign = flrl._plain_planes(planes.double(), spec, b.double(), None, c)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert y.dtype == dtype and y.shape == want.shape
    assert _err(y, want) <= tol * _scale(want)
    # The codes equal the float64 form's but where f32 and f64 sums fall on
    # either side of a threshold.
    assert float((sign != want_sign).double().mean()) < 1e-3

    # Read mode (the backward) against the plain form on the same codes.
    adj = spec.adjoint()
    g = torch.randn((n * c, *spec.out_hw), device=cuda_device).to(dtype)
    dx, same = flrl.fused_planes(g, adj, sign=sign)
    assert same is sign
    dx_want, _ = flrl._plain_planes(g.double(), adj, None, sign, c)
    assert dx.shape == planes.shape and _err(dx, dx_want) <= tol * _scale(dx_want)


# Factors inside the kernel's contract that no StyleGAN3 layer makes:
# (up, down, a radial down-filter), the filters as the CPU tests design them.
OTHER = [(2, 1, False), (1, 2, False), (1, 2, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("up,down,radial", OTHER)
def test_other_factors_match_the_plain_form(cuda_device, up, down, radial, dtype):
    from gantrack_tpu_torch.models.stylegan3 import design_lowpass_filter
    from gantrack_tpu_torch.ops.upfirdn2d import Filter

    rate = 16 * max(up, down)
    fu = Filter(design_lowpass_filter(6 * up, 4.0, 6.0, rate)) if up > 1 else None
    fd = Filter(design_lowpass_filter(6 * down, 4.0, 6.0, rate, radial=radial)) if down > 1 else None
    g = torch.Generator().manual_seed(up + 3 * down + radial)
    x = (torch.randn((2, 3, 70, 67), generator=g) * 1.5).to(cuda_device, dtype)
    b = (torch.randn(3, generator=g) * 0.3).to(cuda_device, dtype)
    spec, why = flrl.fused_spec(x, fu, fd, b, up, down, [5, 4, 6, 3], 2 ** 0.5, 0.2, 1.5)
    assert spec is not None, why
    planes = x.reshape(6, 70, 67)
    y, sign = flrl.fused_planes(planes, spec, b, None, 3)
    want, want_sign = flrl._plain_planes(planes.double(), spec, b.double(), None, 3)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert _err(y, want) <= tol * _scale(want)
    assert float((sign != want_sign).double().mean()) < 1e-3
    adj = spec.adjoint()
    gy = torch.randn((6, *spec.out_hw), generator=g).to(cuda_device, dtype)
    dx, _ = flrl.fused_planes(gy, adj, sign=sign)
    dx_want, _ = flrl._plain_planes(gy.double(), adj, None, sign, 3)
    assert _err(dx, dx_want) <= tol * _scale(dx_want)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,i,dtype", CASES, ids=IDS)
def test_fused_route_matches_the_composed_route(cuda_device, cfg, i, dtype):
    """Forward, ``dx`` and ``db`` under one cotangent ``gy``, and the
    gradient of ``|dx|²`` in ``gy`` (``create_graph``: the backward's own
    backward), against the composed route in float32 on the same (rounded)
    inputs and cotangent."""
    x, b, kw = _inputs(cfg, i, dtype, cuda_device)
    kernel = rec_kernel(x, b, kw)
    outs = {}
    for route in ("fused", "composed"):
        cast = (lambda t: t) if route == "fused" else (lambda t: t.float())
        xr, br = cast(x).clone().requires_grad_(True), cast(b).clone().requires_grad_(True)
        with profiling.recording() as rec:
            if route == "fused":
                y = flrl.filtered_lrelu(xr, b=br, **kw)
            else:
                y = flrl._composed(xr, b=br, **{**kw, "padding": list(kw["padding"])})
        if route == "fused":
            assert rec.counters == {"filtered_lrelu.fused_route": 1,
                                    f"filtered_lrelu.launch/{kernel}": 1}
            g = torch.Generator().manual_seed(7 + i)
            gy = torch.randn(y.shape, generator=g).to(cuda_device, dtype)
        gr = cast(gy).clone().requires_grad_(True)
        dx, db = torch.autograd.grad(y, [xr, br], gr, create_graph=True)
        (ddy,) = torch.autograd.grad((dx.float() ** 2).sum(), [gr])
        outs[route] = (y, dx, db, ddy)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want, what in zip(outs["fused"], outs["composed"], ("y", "dx", "db", "ddy")):
        assert got.dtype == dtype and got.shape == want.shape, what
        assert _err(got, want) <= tol * _scale(want), what


def rec_kernel(x, b, kw):
    spec, _ = flrl.fused_spec(x, kw["fu"], kw["fd"], b, kw["up"], kw["down"], kw["padding"],
                              kw["gain"], kw["slope"], kw["clamp"])
    return spec.kernel


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,i", [(cfg, i) for cfg in ("sg3t", "sg3r") for i in range(15)])
def test_codes_are_the_composed_masks(cuda_device, cfg, i):
    """float32: the codes against ``v > 0`` and ``|lrelu(v)·gain| > clamp``
    of the composed route's intermediate ``v``, off the thresholds by more
    than the sums' rounding; planes of zeros give ``v = 0`` exactly (code
    1: the slope at 0)."""
    x, b, kw = _inputs(cfg, i, torch.float32, cuda_device, planes=(2, 4))
    x[1, 2:] = 0  # two planes of zeros
    b[2:] = 0
    spec, _ = flrl.fused_spec(x, kw["fu"], kw["fd"], b, kw["up"], kw["down"], kw["padding"],
                              kw["gain"], kw["slope"], kw["clamp"])
    n, c, h, w = x.shape
    _, sign = flrl.fused_planes(x.reshape(n * c, h, w), spec, b, None, c)
    codes = flrl.unpack_codes(sign, spec).reshape(n, c, *spec.mid_hw)
    v = upfirdn2d(x + b[None, :, None, None], kw["fu"], up=kw["up"], padding=kw["padding"],
                  gain=kw["up"] ** 2)
    y = torch.where(v > 0, v, v * kw["slope"]) * kw["gain"]
    want = torch.where(v > 0, 0, 1)
    if kw["clamp"] is not None:
        want = torch.where(y.abs() > kw["clamp"], 2, want)
    tol = 1e-5 * _scale(v)
    away = ((v.abs() > tol) & ((y.abs() - (kw["clamp"] or 0)).abs() > tol * kw["gain"]))
    assert bool((codes[away] == want[away]).all())
    assert bool((codes[1, 2:] == 1).all())
    assert float(away[0].double().mean()) > 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_codes_and_gradient_exactly_at_zero_and_the_clamp(cuda_device, dtype):
    """The toRGB spec (no filters, gain 1, slope 1) on samples exactly at
    0 and ±clamp: not clamped, the gradient passes (``clamp``'s backward);
    past it, clamped with no gradient; ``leaky_relu``'s slope at 0."""
    vals = torch.tensor([0.0, 256.0, -512.0, 255.0, 260.0, -600.0, 3.5, -3.5], device=cuda_device)
    x = vals.repeat(40, 40).reshape(1, 1, 40, 320).to(dtype).requires_grad_(True)
    with profiling.recording() as rec:
        y = flrl.filtered_lrelu(x, gain=1.0, slope=0.5, clamp=256.0)
    assert rec.counters["filtered_lrelu.fused_route"] == 1
    assert torch.equal(y.float(), torch.where(vals > 0, vals, vals * 0.5).clamp(-256, 256)
                       .repeat(40, 40).reshape(1, 1, 40, 320))
    (dx,) = torch.autograd.grad(y.float().sum(), [x])
    want = torch.tensor([0.5, 1.0, 0.5, 1.0, 0.0, 0.0, 1.0, 0.5], device=cuda_device)
    assert torch.equal(dx.float(), want.repeat(40, 40).reshape(1, 1, 40, 320))
    spec, _ = flrl.fused_spec(x, None, None, None, 1, 1, 0, 1.0, 0.5, 256.0)
    _, sign = flrl.fused_planes(x.detach().reshape(1, 40, 320), spec)
    codes = flrl.unpack_codes(sign, spec)
    assert torch.equal(codes[0, 0, :8].cpu(), torch.tensor([1, 0, 1, 0, 2, 2, 0, 1]))


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,i,dtype", CASES, ids=IDS)
def test_two_runs_are_equal_bit_for_bit(cuda_device, cfg, i, dtype):
    x, b, kw = _inputs(cfg, i, dtype, cuda_device)
    runs = []
    for _ in range(2):
        xr, br = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
        y = flrl.filtered_lrelu(xr, b=br, **kw)
        dx, db = torch.autograd.grad((y.float() ** 2).sum(), [xr, br])
        runs.append((y, dx, db))
    for a, c in zip(*runs):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_every_stylegan3_layer_takes_the_fused_route(cuda_device):
    """A generator pass of each configuration: one fused call a layer, no
    composed call, no FIR call."""
    for cfg in ("sg3t", "sg3r"):
        with profiling.recording() as rec:
            for i in range(15):
                x, b, kw = _inputs(cfg, i, _layers(cfg)[i][2], cuda_device, planes=(1, 2))
                flrl.filtered_lrelu(x, b=b, **kw)
        assert rec.counters["filtered_lrelu.fused_route"] == 15
        assert rec.under("filtered_lrelu.composed_route") == {}
        assert rec.under("fir.launch") == {} and rec.under("upfirdn2d") == {}
        torch.cuda.synchronize()


@pytest.mark.cuda
def test_a_spec_outside_the_contract_keeps_the_composed_route(cuda_device):
    from gantrack_tpu_torch.models.stylegan3 import design_lowpass_filter
    from gantrack_tpu_torch.ops.upfirdn2d import Filter

    fd = Filter(design_lowpass_filter(24, 4.0, 6.0, 64.0))
    x = torch.randn((1, 2, 40, 40), device=cuda_device)
    with profiling.recording() as rec:
        y = flrl.filtered_lrelu(x, fd=fd, down=4, clamp=256.0)
    # The composed route: bias_act, upfirdn2d without a filter (K5 with one
    # tap), then the ↓4 FIR kernel.
    assert rec.counters == {"filtered_lrelu.composed_route/down=4": 1,
                            "upfirdn2d.kernel_route": 2, "fir.launch/same": 1,
                            "fir.launch/down4": 1}
    assert y.shape == (1, 2, 5, 5)
    assert np.isfinite(float(y.abs().max()))
    spec, why = flrl.fused_spec(x.half(), None, None, None, 1, 1, 0, 1.0, 0.2, 256.0)
    assert spec is None and why == "cuda torch.float16"
