"""Exact resume on the card, under the numerics every entry point runs.

Needs an NVIDIA card and ``nvcc``; skips without a card.  Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_resume_cuda.py

``tests/test_torch_loop.py``'s resume check on the CUDA device after
``precision.configure_device_numerics`` (no TF32, cuDNN's deterministic
algorithms): 3 steps → checkpoint → restore into fresh objects → 3 more
steps equals 6 uninterrupted steps bit for bit (every parameter and
buffer of G, D and G_ema, both optimizers' moments, ``pl_mean`` and the
ADA state), for StyleGAN2 and StyleGAN3-T at a small width (16², float32;
the augment pipe's K1/K2 and the FIR kernels K5–K7 on the path).  The
JAX package promises the same of its steps on the TPU
(``tests/test_resume_exactness.py``).
"""

import numpy as np
import pytest
import torch

from gantrack_tpu_torch.models import stylegan2 as tsg2
from gantrack_tpu_torch.models import stylegan3 as tsg3
from gantrack_tpu_torch.precision import configure_device_numerics
from gantrack_tpu_torch.training import augment as taug
from gantrack_tpu_torch.training import loss as tloss
from gantrack_tpu_torch.training import step as tstep
from gantrack_tpu_torch.training.train_state import create_train_state
from gantrack_tpu_torch.utils import profiling
from gantrack_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

RES, ZDIM, BATCH = 16, 8, 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the FIR and upwarp kernels have no CPU mode")
    return configure_device_numerics("cuda")


def _stepper(device, seed=0, sg3=False):
    """``tests/test_torch_loop.py``'s state and stepper, on ``device``."""
    torch.manual_seed(seed)
    if sg3:
        g = tsg3.Generator(z_dim=ZDIM, c_dim=0, w_dim=ZDIM, img_resolution=RES, img_channels=1,
                           channel_base=256, channel_max=16, num_fp16_res=0,
                           synthesis_kwargs=dict(num_layers=6))
    else:
        g = tsg2.Generator(z_dim=ZDIM, c_dim=0, w_dim=ZDIM, img_resolution=RES, img_channels=1,
                           mapping_kwargs=dict(num_layers=2),
                           synthesis_kwargs=dict(channel_base=128, channel_max=32,
                                                 num_fp16_res=0))
    d = tsg2.Discriminator(c_dim=0, img_resolution=RES, img_channels=1, channel_base=128,
                           channel_max=32, num_fp16_res=0,
                           epilogue_kwargs=dict(mbstd_group_size=2))
    state = create_train_state(g.to(device), d.to(device), 0.002, 0.002, g_reg_interval=2,
                               d_reg_interval=3)
    state.ada_p = torch.tensor(0.5, device=device)
    pipe = taug.AugmentPipe(taug.medical_augment_config(), RES, RES, 1)
    loss_cfg = tloss.StyleGAN2LossConfig(r1_gamma=1.0)
    if sg3:  # no path length, no mixing; the blur fades inside the 6 steps
        loss_cfg = tloss.StyleGAN2LossConfig(r1_gamma=1.0, style_mixing_prob=0.0, pl_weight=0.0,
                                             blur_init_sigma=1.0, blur_fade_kimg=0.02)
    loss = tloss.StyleGAN2Loss(g, d, loss_cfg, augment_fn=pipe)
    cfg = tstep.TrainStepConfig(batch_size=BATCH, z_dim=ZDIM, ada_target=0.6, ada_interval=2,
                                g_reg_interval=2, d_reg_interval=3)  # all phases in 6 steps
    return state, tstep.TrainStepper(loss, cfg, torch.Generator(device).manual_seed(seed))


def _leaves(state):
    out = [t for m in (state.G, state.D, state.G_ema) for t in m.state_dict().values()]
    for opt in (state.opt_g, state.opt_d):
        for s in opt.state_dict()["state"].values():
            out += [v for v in s.values() if isinstance(v, torch.Tensor)]
    return out + [state.pl_mean, state.ada_p, state.ada_signs]


@pytest.mark.cuda
@pytest.mark.parametrize("sg3", [False, True], ids=["stylegan2", "stylegan3-t"])
def test_resume_matches_uninterrupted_on_the_card(cuda_device, tmp_path, sg3):
    rng = np.random.default_rng(7)
    imgs = [torch.from_numpy(rng.standard_normal((BATCH, 1, RES, RES)).astype(np.float32))
            .to(cuda_device) for _ in range(6)]
    state_a, stepper_a = _stepper(cuda_device, sg3=sg3)
    with profiling.recording() as rec:
        for b in imgs:
            stepper_a(state_a, b)

    state_b, stepper_b = _stepper(cuda_device, sg3=sg3)
    for b in imgs[:3]:
        stepper_b(state_b, b)
    path = save_checkpoint(str(tmp_path / "ckpt"), state_b, stepper_b.generator)

    state_c, stepper_c = _stepper(cuda_device, seed=1, sg3=sg3)  # other weights until restored
    load_checkpoint(path, state_c, stepper_c.generator)
    assert state_c.step == 3
    for b in imgs[3:]:
        stepper_c(state_c, b)

    assert state_c.step == state_a.step == 6 and state_c.cur_nimg == 6 * BATCH
    leaves_a, leaves_c = _leaves(state_a), _leaves(state_c)
    assert len(leaves_a) == len(leaves_c)  # a dropped leaf fails, not truncates
    assert all(p.is_cuda for p in state_a.G.parameters())
    for i, (a, c) in enumerate(zip(leaves_a, leaves_c, strict=True)):
        assert torch.equal(a, c), f"leaf {i} differs by {float((a - c).abs().max()):.3e}"
    # The steps ran on the hand kernels (the augment's warp pair, the FIRs).
    assert rec.counters.get("upwarp.launch/upwarp", 0) > 0
    assert rec.counters.get("fir.launch/same", 0) > 0
