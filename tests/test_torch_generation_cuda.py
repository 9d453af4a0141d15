"""Gradient accumulation and the projector on the card, at claro width.

Needs an NVIDIA card and ``nvcc``; skips without a card.  Imports no JAX,
so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_generation_cuda.py

* The G-main gradient of a ``micro_batches=2`` step is twice the
  ``micro_batches=1`` gradient when each sample's loss is its own
  (minibatch-std group 1, no augment, const noise), for StyleGAN2 at the
  claro width (cbase 16384, cmax 512, 256², the 4 highest resolutions in
  bf16): relative norm error ≤ 2e-2 over all of G's gradients and ≤ 5e-2
  for each weight or bias whose gradient norm is at least 1e-2 of the
  largest (the bf16 layers' convolutions sum in another order at another
  batch size).  The scalar noise strengths are held by the first bound
  only: each one's gradient is a sum over every pixel and channel of its
  layer that nearly cancels, and moved by up to 27 % on the card (4 × 4,
  float32 at b4) where the weights moved by well under 5 %.  An average
  instead of a sum would be off by 0.5.
* The same check in float32 (``num_fp16_res=0`` in G and D), the same
  seeds and shapes, under the numerics every entry point of the port runs
  (the ``cuda_device`` fixture: ``precision.configure_device_numerics``,
  TF32 off and cuDNN's deterministic algorithms): every gradient tensor of
  G, the scalar noise strengths included, at relative norm error ≤ 1e-3
  (bound fixed before the first run on the card).  With cuDNN's default
  float32 algorithms it failed at the scalar noise strengths (1.3e-3 to
  4.9e-3 in four runs; ROADMAP C11): those are not deterministic, and two
  identical ``micro_batches=1`` steps moved those nearly cancelling sums
  by up to 3.4e-3 (``split_numerics.py spread``).  The chunked step's
  gradient is also held, bit for bit, to the sum of the two chunks
  stepped alone at the same shapes: the accumulation adds nothing of its
  own.
* One projector step (forward and backward through G's synthesis with the
  noise buffers replaced, and a VGG16 at 224² for LPIPS) on the FIR
  kernels K5–K7 against the same step with every ``upfirdn2d`` call on the
  plain version: loss at rel 1e-3, gradients of w and of every noise
  buffer at relative norm error ≤ 1e-2 (bf16 layers, the sums in another
  order).
"""

import os
import sys

import numpy as np
import pytest
import torch

from gantrack_tpu_torch.ops import fir
from gantrack_tpu_torch.tools import projector
from gantrack_tpu_torch.tools.train import make_generator
from gantrack_tpu_torch.utils import profiling

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CLARO = dict(resolution=256, channels=1, c_dim=0, cbase=16384, cmax=512, map_depth=2)


@pytest.fixture
def cuda_device():
    """The card under the numerics every entry point of the port runs
    (``precision.configure_device_numerics``: no TF32, cuDNN's
    deterministic algorithms)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the FIR kernels have no CPU mode")
    from gantrack_tpu_torch.precision import configure_device_numerics

    return configure_device_numerics("cuda")


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))


@pytest.mark.cuda
def test_accumulated_gmain_gradient_is_twice_the_whole_batch(cuda_device, monkeypatch):
    from gantrack_tpu_torch.models.stylegan2 import Discriminator
    from gantrack_tpu_torch.training import loss as tloss
    from gantrack_tpu_torch.training import step as tstep
    from gantrack_tpu_torch.training.train_state import create_train_state

    torch.manual_seed(0)
    G0 = make_generator("stylegan2", **CLARO)
    D0 = Discriminator(c_dim=0, img_resolution=256, img_channels=1, channel_base=16384,
                       channel_max=512, epilogue_kwargs=dict(mbstd_group_size=1))
    z = torch.randn((4, 512), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    reals = torch.randn((4, 1, 256, 256), generator=torch.Generator().manual_seed(2))
    grads = {}
    apply = tstep._apply
    for micro in (1, 2):
        G, D = make_generator("stylegan2", **CLARO), Discriminator(
            c_dim=0, img_resolution=256, img_channels=1, channel_base=16384, channel_max=512,
            epilogue_kwargs=dict(mbstd_group_size=1))
        G.load_state_dict(G0.state_dict())
        D.load_state_dict(D0.state_dict())
        G, D = G.to(cuda_device), D.to(cuda_device)
        state = create_train_state(G, D, 0.0025, 0.0025)
        loss = tloss.StyleGAN2Loss(G, D, tloss.StyleGAN2LossConfig(
            r1_gamma=0.4096, style_mixing_prob=0.0, noise_mode="const"))
        stepper = tstep.TrainStepper(loss, tstep.TrainStepConfig(
            batch_size=4, z_dim=512, micro_batches=micro), torch.Generator(cuda_device))
        seen = []
        monkeypatch.setattr(tstep, "_apply", lambda opt, p, g, seen=seen: seen.append(
            [x.clone() for x in g]) or apply(opt, p, g))
        with profiling.recording() as rec:
            stepper.run(state, reals.to(cuda_device), None, False, False,
                        draws={"z_gmain": z, "z_dmain": z})
        launches = rec.under("fir.launch")
        assert launches.get("same", 0) > 0 and launches.get("up2", 0) > 0
        grads[micro] = seen[0]
    names = [n for n, _ in G0.named_parameters()]
    assert _rel(torch.cat([g.flatten() * 2 for g in grads[1]]),
                torch.cat([g.flatten() for g in grads[2]])) <= 2e-2
    largest = max(float(g.norm()) for g in grads[2])
    errs = {n: _rel(a * 2, b) for n, a, b in zip(names, grads[1], grads[2])
            if b.numel() > 1 and float(b.norm()) >= 1e-2 * largest}
    worst = sorted(errs, key=errs.get)[-3:]
    assert errs[worst[-1]] <= 5e-2, [(n, errs[n]) for n in worst]


def _float32_gmain_grads(device, monkeypatch, micro, z, reals):
    """G's G-main gradients of one float32 claro step (G and D at
    ``num_fp16_res=0``, minibatch-std group 1, const noise, no mixing) at
    ``micro`` chunks, from the seed-0 weights (``chip_smoke.claro_float32``)."""
    import chip_smoke
    from gantrack_tpu_torch.training import step as tstep

    G, _, state, _, stepper = chip_smoke.claro_float32(device, z.shape[0], mbstd=(1, 1),
                                                       mixing=0.0, micro=micro)
    seen = []
    apply = tstep._apply
    monkeypatch.setattr(tstep, "_apply", lambda opt, p, g: seen.append(
        [x.clone() for x in g]) or apply(opt, p, g))
    stepper.run(state, reals.to(device), None, False, False, draws={"z_gmain": z, "z_dmain": z})
    monkeypatch.setattr(tstep, "_apply", apply)
    return seen[0], [n for n, _ in G.named_parameters()]


def _float32_inputs(device):
    z = torch.randn((4, 512), generator=torch.Generator().manual_seed(1)).to(device)
    reals = torch.randn((4, 1, 256, 256), generator=torch.Generator().manual_seed(2))
    return z, reals


def _assert_twice(grads1, grads2, names, bound):
    errs = {n: _rel(a * 2, b) for n, a, b in zip(names, grads1, grads2)}
    worst = sorted(errs, key=errs.get)[-3:]
    print("float32 accumulation, worst relative errors:", [(n, errs[n]) for n in worst])
    assert errs[worst[-1]] <= bound, [(n, errs[n]) for n in worst]


@pytest.mark.cuda
def test_accumulated_gmain_gradient_is_twice_the_whole_batch_float32(cuda_device, monkeypatch):
    # The fixture's setting, the product's: the former
    # ``..._float32_deterministic_cudnn`` twin is now this same check.
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.allow_tf32
    z, reals = _float32_inputs(cuda_device)
    grads1, names = _float32_gmain_grads(cuda_device, monkeypatch, 1, z, reals)
    grads2, _ = _float32_gmain_grads(cuda_device, monkeypatch, 2, z, reals)
    _assert_twice(grads1, grads2, names, 1e-3)


@pytest.mark.cuda
def test_accumulated_chunks_equal_the_chunks_stepped_alone_bit_for_bit(cuda_device, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    z, reals = _float32_inputs(cuda_device)
    grads2, names = _float32_gmain_grads(cuda_device, monkeypatch, 2, z, reals)
    alone = [_float32_gmain_grads(cuda_device, monkeypatch, 1, z[j:j + 2], reals[j:j + 2])[0]
             for j in (0, 2)]
    for name, got, a, b in zip(names, grads2, *alone):
        assert torch.equal(got, a + b), name


@pytest.mark.cuda
def test_projector_step_on_the_kernels_matches_the_plain_route(cuda_device, monkeypatch):
    from gantrack_tpu_torch.models.vgg import lpips_features, random_vgg

    torch.manual_seed(0)
    G = make_generator("stylegan2", **CLARO).to(cuda_device).eval().requires_grad_(False)
    vgg = random_vgg(0, device=cuda_device)
    cfg = projector.ProjectorConfig()
    target = np.tanh(np.random.default_rng(0).standard_normal((256, 256, 1))).astype(np.float32)
    w_avg, _ = projector.compute_w_stats(G, 1000)
    gen = torch.Generator().manual_seed(1)
    noise0 = {n: torch.randn(b.shape, generator=gen)
              for n, b in projector.noise_buffers(G).items()}

    def step():
        w = w_avg.clone().requires_grad_(True)
        noise = {n: b.to(cuda_device).requires_grad_(True) for n, b in noise0.items()}
        modes = projector.target_modalities(target, cuda_device)
        feature_fn = lambda x: lpips_features(vgg, x)  # noqa: E731
        with torch.no_grad():
            feats = [feature_fn(m) for m in modes]
        loss, *_ = projector.projection_loss(G, w, noise, modes, feats, feature_fn, cfg)
        grads = torch.autograd.grad(loss, [w, *noise.values()])
        return loss.detach(), grads

    with profiling.recording() as rec:
        loss_k, grads_k = step()
    torch.cuda.synchronize()
    launches = rec.under("fir.launch")
    assert all(launches.get(k, 0) > 0 for k in ("same", "down2", "up2")), launches
    assert not rec.under("upfirdn2d.plain_route")
    monkeypatch.setattr(fir, "fir_spec", lambda *a, **k: (None, "forced plain"))
    with profiling.recording() as rec:
        loss_p, grads_p = step()
    assert rec.under("upfirdn2d.plain_route").get("forced plain", 0) > 0
    np.testing.assert_allclose(float(loss_k), float(loss_p), rtol=1e-3)
    for i, (a, b) in enumerate(zip(grads_k, grads_p)):
        assert _rel(a, b) <= 1e-2, (i, _rel(a, b))
