"""The operation and byte counts against what PyTorch's flop counter sees
the program run, and against the FIR bound of the program's chip checks."""

import os
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import (FlopCounterMode, _FlopCounterMode, conv_backward_flop,
                                      conv_flop_count)

from h100_bench import core
from h100_bench.counts import fir as fir_counts
from h100_bench.counts import inception as inception_counts
from h100_bench.counts import stylegan2 as counts

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
aten = torch.ops.aten


def _filter(w_shape, groups) -> bool:
    """A depthwise FIR filter (one input channel a group, one output)."""
    return w_shape[1] == 1 and w_shape[0] == groups


def _conv(x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed, *args,
          out_shape=None, **kwargs):
    groups = args[-1] if args else kwargs.get("groups", 1)
    return 0 if _filter(w_shape, groups) else conv_flop_count(x_shape, w_shape, out_shape,
                                                              transposed=transposed)


def _conv_backward(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation,
                   transposed, _output_padding, groups, output_mask, out_shape, **kwargs):
    if _filter(w_shape, groups):
        return 0
    return conv_backward_flop.__wrapped__(grad_out_shape, x_shape, w_shape, _bias, _stride,
                                          _padding, _dilation, transposed, _output_padding,
                                          groups, output_mask, out_shape)


class Flops(FlopCounterMode):
    """PyTorch's flop counter over the matrix work alone (the FIR filters'
    depthwise convolutions left out, as the counts leave them out),
    without its per-module tracker, whose backward hooks refuse
    ``torch.autograd.grad`` over inputs that are no leaves."""

    def __init__(self):
        super().__init__(display=False, custom_mapping={
            aten.convolution: _conv, aten._convolution: _conv,
            aten.convolution_backward: _conv_backward})

    def __enter__(self):
        self.flop_counts.clear()
        self.mode = _FlopCounterMode(self)
        self.mode.__enter__()
        return self

    def __exit__(self, *args):
        out = self.mode.__exit__(*args)
        self.mode = None
        return out


def _program_extra(model, phase, batch):
    """Weight gradients the program's convolutions (``conv2d_gradfix``)
    form although nothing needs them: D's in G-main and in R1's first
    backward, G's in the path length's first backward."""
    net = {"gmain": ("d",), "dr1": ("d",), "gpl": ("synth", "torgb")}.get(phase, ())
    b = batch // 2 if phase == "gpl" else batch
    return sum(2 * layer["macs"] * b for layer in counts.layers(model)
               if layer["role"] in net and layer["name"] not in ("b4.fc", "b4.out"))


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    from h100_bench.kinds import train

    config = core.load_json(FIXTURES, "configs", "tiny-sg2.json")
    traffic = core.load_json(FIXTURES, "traffic", "train-tiny.json")
    ctx = core.Context(cell={"name": "tiny"}, config=config, traffic=traffic, seed=5, seconds=0,
                       trace=False, t0=0.0, tmpdir=str(tmp_path_factory.mktemp("run")),
                       device=torch.device("cpu"))
    s = train.prepare(ctx)
    _, (dataset, loader, state, stepper) = train.program_readings(s)
    yield s, loader, state, stepper
    loader.close()


@pytest.mark.parametrize("gpl,dr1", [(False, False), (True, False), (False, True)])
def test_step_flops_agree_with_the_flop_counter(tiny_run, gpl, dr1):
    from gantrack_tpu_torch.training.loop import to_device_batch

    s, loader, state, stepper = tiny_run
    img, lab = to_device_batch(*next(loader), s.device)
    with Flops() as fc:
        stepper.run(state, img, lab, gpl, dr1)
    batch = stepper.cfg.batch_size
    want = sum(counts.step_flops(s.model, batch, gpl, dr1).values())
    phases = ["gmain", "dmain"] + (["gpl"] if gpl else []) + (["dr1"] if dr1 else [])
    extra = sum(_program_extra(s.model, ph, batch) for ph in phases)
    assert want < fc.get_total_flops()
    assert want + extra == pytest.approx(fc.get_total_flops(), rel=0.01)


def test_generator_and_inception_flops_agree_with_the_flop_counter():
    from gantrack_tpu_torch.models.inception import InceptionV3Features
    from gantrack_tpu_torch.tools.train import make_generator

    model = core.load_json(FIXTURES, "configs", "tiny-sg2.json")["model"]
    G = make_generator("stylegan2", resolution=model["resolution"], channels=model["channels"],
                       c_dim=0, cbase=model["cbase"], cmax=model["cmax"],
                       map_depth=model["map_depth"], num_fp16_res=0)
    with torch.no_grad(), Flops() as fc:
        G(torch.randn(4, 512), None, noise_mode="const")
    assert sum(counts.phase_flops(model, "generate", 4).values()) == \
        pytest.approx(fc.get_total_flops(), rel=1e-6)
    with torch.device("meta"):
        net = InceptionV3Features(variant="tfslim")
    with torch.no_grad(), Flops() as fc:
        net(torch.empty(2, 3, 256, 256, device="meta"))
    # The counter also sees TF1's resize, two matrix products an image,
    # which the counts leave to the filters.
    resize = 2 * 3 * (299 * 256 * 256 + 299 * 299 * 256)
    assert 2 * (inception_counts.flops_per_image() + resize) == \
        pytest.approx(fc.get_total_flops(), rel=1e-6)


def _fir_calls():
    """FIR calls of the claro and StyleGAN3-T steps (spec, planes, dtype)."""
    import importlib

    fir = importlib.import_module("gantrack_tpu_torch.ops.fir")
    upfirdn2d = importlib.import_module("gantrack_tpu_torch.ops.upfirdn2d")
    f4 = upfirdn2d.setup_filter([1, 3, 3, 1])
    t4 = upfirdn2d.filter_taps(f4)
    f12 = upfirdn2d.setup_filter(list(np.hanning(14)[1:-1]))
    t12 = upfirdn2d.filter_taps(f12)
    return [
        (fir.fir_spec(f4, t4, 1, 1, [2, 2, 2, 2], False, 1)[0], (2048, 256, 256), "bfloat16"),
        (fir.fir_spec(f4, t4, 1, 2, [1, 1, 1, 1], False, 1)[0], (2048, 256, 256), "bfloat16"),
        (fir.fir_spec(f4, t4, 2, 1, [2, 1, 2, 1], False, 4)[0], (32, 128, 128), "float32"),
        (fir.fir_spec(f12, t12, 1, 2, [0, 0, 0, 0], False, 1)[0], (4096, 562, 562), "bfloat16"),
        (fir.fir_spec(f12, t12, 2, 1, [-11, -11, -11, -11], False, 4)[0], (2048, 278, 278),
         "bfloat16"),
    ]


@pytest.mark.parametrize("call", range(5))
def test_fir_bound_agrees_with_the_chip_checks(call):
    sys.path.insert(0, core.ROOT)
    import chip_smoke

    spec, shape, dtype = _fir_calls()[call]
    oh, ow = spec.out_size(*shape[1:])
    x = torch.empty(shape, dtype=getattr(torch, dtype), device="meta")
    y = torch.empty((shape[0], oh, ow), dtype=x.dtype, device="meta")
    taps_per_out = (len(spec.taps_y) + len(spec.taps_x)) / (2 if spec.form == "up2" else 1)
    want = chip_smoke._bound(chip_smoke._nbytes(x, y), y.numel() * 2 * taps_per_out)["bound_ms"]
    got = fir_counts.least_seconds(spec.form, (len(spec.taps_y), len(spec.taps_x)), spec.pads,
                                   shape, dtype)
    assert got * 1e3 == pytest.approx(want, rel=1e-12)


def test_claro_counts_stay_under_the_peak_at_the_measured_rate():
    """A share of the peak from these counts cannot pass 100 % at any
    rate the card reaches: claro's least time a step averaged over its
    cycle is a few tens of ms, its measured step some hundreds."""
    model = core.load_json(core.ROOT, "h100_bench", "configs", "claro-sg2ada-256.json")["model"]
    least = sum(counts.least_seconds(counts.step_flops(model, 32, s % 4 == 0, s % 16 == 0))
                for s in range(16)) / 16
    assert 0.015 < least < 0.04
