"""StyleGAN3-R in the H100 benchmark's terms, on the CPU: the port's
``stylegan3-r`` generator against the benchmark's plain reference, D's
blur ramp against the reference's blur, and the ``train_dblur`` kind's
checked steps, program against the blurred reference, all in float32 at
a tiny width.  The reference imports nothing of the program."""

import contextlib
import os

import numpy as np
import pytest
import torch

from h100_bench import core
from h100_bench.kinds import train, train_dblur
from h100_bench.reference import blur as ref_blur
from h100_bench.reference import nets as ref_nets
from h100_bench.reference import stylegan3 as ref_sg3
from h100_bench.reference.numerics import Numerics

pytestmark = pytest.mark.long  # over 250 s of the tier-1 run: started first

FIXTURES = os.path.join(core.ROOT, "h100_bench", "tests", "fixtures")
TINY_R = dict(family="stylegan3-r", resolution=32, channels=1, cbase=512, cmax=32,
              num_fp16_res=0, map_depth=2, mbstd_group=4)


def _program_generator(model):
    from gantrack_tpu_torch.tools.train import make_generator

    return make_generator(model["family"], resolution=model["resolution"],
                          channels=model["channels"], c_dim=0, cbase=model["cbase"],
                          cmax=model["cmax"], map_depth=2, num_fp16_res=model["num_fp16_res"])


def test_the_generator_matches_the_reference_on_shared_weights():
    """Doubled channels, 1x1 convs and radial down-filters, as both
    build them from the same configuration."""
    from gantrack_tpu_torch.utils import profiling

    G, _ = ref_nets.build(TINY_R, "cpu")
    Gp = _program_generator(TINY_R)
    assert G.names == list(Gp.synthesis.layer_names)
    layers = [getattr(G.synthesis, n) for n in G.names]
    assert max(int(n.split("_")[2]) for n in G.names) == 2 * TINY_R["cmax"]
    assert {layer.kernel for layer in layers} == {1}
    assert sum(layer.fd.ndim == 2 and layer.fd.shape[0] > 1 for layer in layers) == 12
    wg = ref_sg3.make_weights(G, torch.Generator().manual_seed(3))
    G.load_state_dict(wg, strict=True)
    Gp.load_state_dict(wg, strict=True)
    z = torch.randn(4, 512, generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), profiling.recording() as rec:
        want = G(z, Numerics())
        got = Gp(z, None, noise_mode="const")
    assert got.shape == want.shape == (4, 1, 32, 32)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    # Every layer takes the fused filtered_lrelu route, the 12 with radial
    # down-filters (↓2, 12 x 12) too: no FIR call, none composed.
    assert rec.counters["filtered_lrelu.fused_route"] == len(G.names)
    assert rec.under("filtered_lrelu.composed_route") == {} and rec.under("upfirdn2d") == {}


@pytest.mark.parametrize("sigma", [10.0, 3.3, 0.0])
def test_the_blur_matches_the_reference(sigma):
    from gantrack_tpu_torch.training.loss import StyleGAN2Loss

    img = torch.randn(3, 2, 32, 32, generator=torch.Generator().manual_seed(2))
    got = StyleGAN2Loss(None, None)._blur(img, sigma)
    want = ref_blur.blur(img, sigma)
    assert got.shape == img.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    if sigma == 0.0:
        assert got is img
    else:  # a low-pass that keeps the mean away from the borders
        assert float(got.std()) < 0.5 * float(img.std())


def test_the_blur_ramp_matches_the_reference():
    from gantrack_tpu_torch.training.loss import StyleGAN2Loss, StyleGAN2LossConfig

    for batch in (32, 64):
        init, fade = ref_blur.ramp("stylegan3-r", batch)
        assert (init, fade) == (10.0, batch * 200 / 32)
        loss = StyleGAN2Loss(None, None, StyleGAN2LossConfig(blur_init_sigma=10.0,
                                                             blur_fade_kimg=batch * 200 / 32))
        for nimg in (0, 32, 512, 896, 1e5, fade * 1e3, fade * 2e3):
            assert loss.blur_sigma(nimg) == pytest.approx(ref_blur.sigma(nimg, init, fade))
    assert ref_blur.ramp("stylegan3-t", 32) == ref_blur.ramp("stylegan2", 32) == (0.0, 0.0)
    assert ref_blur.sigma(512, 10.0, 200.0) == pytest.approx(9.9744)  # 59 taps in the window
    assert int(np.floor(3 * ref_blur.sigma(512, 10.0, 200.0))) == 29


def _float32(config):
    config = dict(config)
    config["cli"] = [a for a in config["cli"] if not a.startswith("--num-fp16-res")] + \
        ["--num-fp16-res=0"]
    config["model"] = dict(config["model"], num_fp16_res=0)
    return config


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The tiny ``stylegan3-r`` cell's set-up, in float32 on the CPU, and
    its blurred reference's readings."""
    config = _float32(core.load_json(FIXTURES, "configs", "tiny-sg3r.json"))
    traffic = core.load_json(FIXTURES, "traffic", "train-dblur-tiny.json")
    ctx = core.Context(cell={}, config=config, traffic=traffic, seed=3_000_000_017, seconds=0,
                       trace=False, t0=0.0, tmpdir=str(tmp_path_factory.mktemp("sg3r")),
                       device=torch.device("cpu"))
    s = train.prepare(ctx)
    with train_dblur.blurred(ctx):
        return s, train.reference_readings(s)


def _program_readings(s):
    from gantrack_tpu_torch.training import augment

    saved = augment.AugmentPipe.__init__.__defaults__
    augment.AugmentPipe.__init__.__defaults__ = ("fused", torch.float32)
    try:
        prog, run = train.program_readings(s)
    finally:
        augment.AugmentPipe.__init__.__defaults__ = saved
    run[1].close()
    return prog


def test_training_steps_match_the_blurred_reference(tiny_run):
    """Three float32 steps through the ``train_dblur`` kind: the first
    step's losses agree to rounding, the later ones to Adam's
    amplification of it, and every check passes."""
    s, ref = tiny_run
    prog = _program_readings(s)
    assert set(prog["losses"][0]) >= set(ref["losses"][0]) >= {"Loss/G/loss", "Loss/D/loss",
                                                               "Loss/D/reg"}
    for k, v in ref["losses"][0].items():
        assert prog["losses"][0][k] == pytest.approx(v, rel=2e-5, abs=1e-7), k
    for step in (1, 2):
        for k, v in ref["losses"][step].items():
            assert prog["losses"][step][k] == pytest.approx(v, rel=1e-3), (step, k)
    numbers = train.compare(prog, ref, ref)
    limits = s.ctx.config["limits"]["train"]
    assert numbers["loader_gap"] < limits["loader_gap"]
    assert numbers["loss_gap"] < limits["loss_gap"]


def test_a_program_without_the_blur_fails_the_loss_check(tiny_run, monkeypatch):
    from gantrack_tpu_torch.training.loss import StyleGAN2Loss

    s, ref = tiny_run
    monkeypatch.setattr(StyleGAN2Loss, "_blur", lambda self, img, sigma: img)
    prog = _program_readings(s)
    numbers = train.compare(prog, ref, ref)
    assert numbers["loss_gap"] > s.ctx.config["limits"]["train"]["loss_gap"]


def test_a_stylegan3r_loss_pass_records_the_blur_span_and_its_taps():
    from gantrack_tpu_torch.models.stylegan2 import Discriminator
    from gantrack_tpu_torch.training.loss import StyleGAN2Loss, StyleGAN2LossConfig
    from gantrack_tpu_torch.utils import profiling

    G = _program_generator(TINY_R)
    D = Discriminator(c_dim=0, img_resolution=32, img_channels=1, channel_base=512,
                      channel_max=32, num_fp16_res=0)
    loss = StyleGAN2Loss(G, D, StyleGAN2LossConfig(style_mixing_prob=0.0, pl_weight=0.0,
                                                   blur_init_sigma=10.0, blur_fade_kimg=200.0))
    z = torch.randn(4, 512, generator=torch.Generator().manual_seed(4))
    real = torch.randn(4, 1, 32, 32, generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    p = torch.tensor(0.0)
    with profiling.recording() as rec:
        loss.gmain(z, None, gen, p, cur_nimg=0)
        loss.dmain(z, None, real, None, gen, p, cur_nimg=512)
        loss.dr1(real, None, gen, p, cur_nimg=512)
    blurs = [sp for sp in rec.spans if sp[0] == "d_blur"]
    assert [sp[5]["sigma"] for sp in blurs] == pytest.approx([10.0, 9.9744, 9.9744])
    assert all(sp[2] <= sp[3] for sp in blurs)
    assert rec.under("loss.blur") == {"61": 1, "59": 2}
    # The blurs of more than 32 taps an axis take the plain route.
    assert rec.counters["upfirdn2d.plain_route/61 x 61 taps (at most 32 per axis)"] == 1
    assert rec.counters["upfirdn2d.plain_route/59 x 59 taps (at most 32 per axis)"] == 2
    # No blur once the ramp has faded, and nothing recorded without a recorder.
    with profiling.recording() as late:
        loss.gmain(z, None, gen, p, cur_nimg=200_000)
    assert not [sp for sp in late.spans if sp[0] == "d_blur"]
    assert not late.under("loss.blur")


def test_the_kind_blurs_the_reference_and_records_the_traced_cycle(monkeypatch):
    """Inside ``blurred``: the reference's trainer blurs with the ramp of
    the configuration's family and batch, and the profiler that
    ``train._traced`` opens runs the program's recorder, whose spans and
    counters the report adds to the record; all three are put back
    after."""
    from h100_bench import trace
    from h100_bench.reference import training as ref_training
    from gantrack_tpu_torch.utils import profiling

    @contextlib.contextmanager
    def host_profiler(device, host=True, warm=None):
        with saved_profiler(device, host=True, warm=warm) as prof:
            yield prof

    saved_profiler = trace.profiler
    monkeypatch.setattr(trace, "profiler", host_profiler)
    monkeypatch.setattr(trace, "report", lambda record: None)
    reported = (trace.profiler, trace.report, ref_training.Trainer)
    config = core.load_json(FIXTURES, "configs", "tiny-sg3r.json")
    ctx = core.Context(cell={}, config=config, traffic={}, seed=1, seconds=0, trace=True, t0=0.0,
                       tmpdir="", device=torch.device("cpu"))
    G, D = ref_nets.build(TINY_R, "cpu")
    cfg = ref_training.StepConfig(batch=32, glr=0.0025, dlr=0.0025, gamma=0.4096, ema_kimg=10.0)
    record = {"counters": {"steps": 2}}
    with train_dblur.blurred(ctx):
        tr = ref_training.Trainer(G, D, cfg, None, Numerics(), [torch.Generator()], 0.0)
        with trace.profiler(torch.device("cpu"), host=False, warm=lambda: None):
            for _ in range(3):
                with profiling.span("d_blur", sigma=9.9744):
                    profiling.count("loss.blur/59")
                    torch.ones(8).sum()
            profiling.count("upfirdn2d.plain_route/2-D filter, not separable", 2)
            profiling.count("upfirdn2d.kernel_route", 6)
        trace.report(record)
    assert isinstance(tr, ref_blur.BlurTrainer)
    assert (tr.blur_init_sigma, tr.blur_fade_kimg) == (10.0, 200.0)
    assert [sp[0] for sp in record["program_spans"]] == ["d_blur"] * 3
    assert all(sp[2] <= sp[3] for sp in record["program_spans"])
    assert record["program_counters"]["loss.blur/59"] == 3
    assert record["program_counters"]["upfirdn2d.kernel_route"] == 6
    assert (trace.profiler, trace.report, ref_training.Trainer) == reported
