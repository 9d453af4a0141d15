"""The plain float32 references against the program's modules at a tiny
width on the CPU.  The test imports both; the references import nothing
of the program."""

import ast
import os

import numpy as np
import pytest
import torch

from h100_bench import core
from h100_bench.reference import augment as ref_augment
from h100_bench.reference import inception as ref_inception
from h100_bench.reference import stylegan2 as ref_sg2
from h100_bench.reference import weights
from h100_bench.reference.numerics import Numerics

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
MODEL = dict(resolution=32, channels=1, cbase=512, cmax=32, num_fp16_res=0, map_depth=2)
REF = os.path.join(core.ROOT, "h100_bench", "reference")


def test_the_references_import_nothing_of_the_program():
    for f in os.listdir(REF):
        if f.endswith(".py"):
            tree = ast.parse(open(os.path.join(REF, f)).read())
            names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
            names += [n.module for n in ast.walk(tree)
                      if isinstance(n, ast.ImportFrom) and n.level == 0]
            assert not [m for m in names if m.split(".")[0].startswith("gantrack")], f


def test_reference_precision_flags():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    for nm in (Numerics(), Numerics(stated=True), Numerics("fp8")):
        with nm.matmul_precision():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
    with Numerics("tf32").matmul_precision():
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == saved


def test_controls_round_where_bfloat16_is_stated():
    x = torch.linspace(-3, 3, 101)
    assert torch.equal(Numerics("tf32").low(x), Numerics(stated=True).low(x))
    assert torch.equal(Numerics(stated=True).low(x), x.bfloat16().float())


def test_control_rounds_to_float8_and_back_through_gradients():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = Numerics("fp8").low(x)
    # e4m3 keeps 3 bits of mantissa: a relative error up to 2**-4.
    assert 0 < (y - x).abs().max() and bool(((y - x).abs() <= x.abs() / 16 + 1e-6).all())
    assert y.unique().numel() < 101
    (g,) = torch.autograd.grad((y * torch.linspace(0, 1, 101)).sum(), x)
    assert g.unique().numel() < 101
    assert torch.equal(Numerics().low(x), x)


@pytest.fixture(scope="module")
def nets():
    from gantrack_tpu_torch.models.stylegan2 import Discriminator
    from gantrack_tpu_torch.tools.train import make_generator

    G, D = ref_sg2.build(MODEL, "cpu")
    Gp = make_generator("stylegan2", resolution=32, channels=1, c_dim=0, cbase=512, cmax=32,
                        map_depth=2, num_fp16_res=0)
    Dp = Discriminator(c_dim=0, img_resolution=32, img_channels=1, channel_base=512,
                       channel_max=32, num_fp16_res=0)
    gen = torch.Generator().manual_seed(3)
    wg, wd = weights.make_weights(G, gen), weights.make_weights(D, gen)
    for net, w in ((G, wg), (Gp, wg), (D, wd), (Dp, wd)):
        weights.load(net, w)
    return G, D, Gp, Dp


def test_generator_and_discriminator(nets):
    G, D, Gp, Dp = nets
    z = torch.randn(4, 512, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        img = G(z, Numerics(), noise_mode="const")
        assert torch.allclose(img, Gp(z, None, noise_mode="const"), atol=1e-5)
        assert torch.allclose(D(img, Numerics()), Dp(img, None), atol=1e-5)


def test_random_noise_draws_like_the_program(nets):
    G, _, Gp, _ = nets
    z = torch.randn(2, 512, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = G(z, Numerics(), noise_mode="random", generator=torch.Generator().manual_seed(9))
        b = Gp(z, None, noise_mode="random", generator=torch.Generator().manual_seed(9))
    assert torch.allclose(a, b, atol=1e-5)


def test_augment_matches_the_program_in_float32():
    from gantrack_tpu_torch.training.augment import AugmentConfig, AugmentPipe

    opts = dict(xflip=1.0, xint=1.0, scale=1.0, rotate=1.0, aniso=1.0, xfrac=1.0, xint_max=0.05,
                rotate_max=3 / 360, scale_std=0.05, aniso_std=0.05, xfrac_std=0.05)
    ref = ref_augment.AugmentPipe(opts, 32, 32)
    prog = AugmentPipe(AugmentConfig(**opts), 32, 32, 1, impl="unfused",
                       compute_dtype=torch.float32)
    assert ref.margin == prog.margin
    x = torch.rand(8, 1, 32, 32, generator=torch.Generator().manual_seed(2)) * 2 - 1
    for p in (0.0, 0.3, 1.0):
        a = ref(x, p, torch.Generator().manual_seed(4), Numerics())
        b = prog(x, torch.tensor(p), torch.Generator().manual_seed(4))
        assert torch.allclose(a, b, atol=2e-5), p


def test_training_steps_match_the_program_in_float32(tmp_path):
    """Three steps of the reference against the program's stepper, both
    float32 (the program's augment image path too): the first step's
    losses agree to rounding, the later ones to Adam's amplification of
    it."""
    from h100_bench.kinds import train

    config = core.load_json(FIXTURES, "configs", "tiny-sg2.json")
    config["cli"] = [a for a in config["cli"] if not a.startswith("--num-fp16-res")] + \
        ["--num-fp16-res=0"]
    config["model"] = dict(config["model"], num_fp16_res=0)
    traffic = core.load_json(FIXTURES, "traffic", "train-tiny.json")
    ctx = core.Context(cell={}, config=config, traffic=traffic, seed=11, seconds=0, trace=False,
                       t0=0.0, tmpdir=str(tmp_path), device=torch.device("cpu"))
    s = train.prepare(ctx)

    from gantrack_tpu_torch.training import augment

    saved = augment.AugmentPipe.__init__.__defaults__
    augment.AugmentPipe.__init__.__defaults__ = ("fused", torch.float32)
    try:
        prog, run = train.program_readings(s)
    finally:
        augment.AugmentPipe.__init__.__defaults__ = saved
    run[1].close()
    ref = train.reference_readings(s)
    for k, v in ref["losses"][0].items():
        assert prog["losses"][0][k] == pytest.approx(v, rel=2e-5, abs=1e-7), k
    for k, v in ref["losses"][1].items():
        assert prog["losses"][1][k] == pytest.approx(v, rel=1e-4), k
    numbers = train.compare(prog, ref, ref)
    assert numbers["loader_gap"] < 1e-6


def test_inception_matches_the_program():
    from gantrack_tpu_torch.models.inception import InceptionV3Features

    ref = ref_inception.InceptionV3()
    prog = InceptionV3Features(variant="tfslim")
    w = weights.make_weights(ref, torch.Generator().manual_seed(0))
    weights.load(ref, w)
    prog.load_state_dict(w)
    x = torch.rand(2, 3, 48, 48, generator=torch.Generator().manual_seed(1)) * 255
    with torch.no_grad():
        a, b = ref(x), prog(x)
    assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)
    assert np.isfinite(a.numpy()).all() and a.abs().max() > 0
