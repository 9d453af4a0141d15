"""The data-parallel step on the card: an NCCL group of one rank.

Needs an NVIDIA card and ``nvcc``; skips without a card.  Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_parallel_cuda.py

Four claro steps (cbase 16384, cmax 512, 256², the 4 highest
resolutions in bf16, ADA through K1/K2, batch 8), one of each phase
variant, from one state and one seed: without a process group, then in
an NCCL group of world 1 (each phase's gradients all-reduced and divided
by 1, the EMA buffers and the moments too), then without a group again.
The three states are bit-equal: the collectives of one rank change no
bit, and the step is deterministic (cuDNN's deterministic algorithms).
"""

import socket

import pytest
import torch
import torch.distributed as dist

from gantrack_tpu_torch.parallel import mesh as pm
from gantrack_tpu_torch.tools.train import make_generator
from gantrack_tpu_torch.utils import profiling

CLARO = dict(resolution=256, channels=1, c_dim=0, cbase=16384, cmax=512, map_depth=2)
BATCH = 8


@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    return torch.device("cuda", torch.cuda.current_device())


def _four_steps(device, mesh):
    from gantrack_tpu_torch.models.stylegan2 import Discriminator
    from gantrack_tpu_torch.training.augment import AugmentPipe, medical_augment_config
    from gantrack_tpu_torch.training.loss import StyleGAN2Loss, StyleGAN2LossConfig
    from gantrack_tpu_torch.training.step import TrainStepConfig, TrainStepper
    from gantrack_tpu_torch.training.train_state import create_train_state

    torch.manual_seed(0)
    G = make_generator("stylegan2", **CLARO).to(device)
    D = Discriminator(c_dim=0, img_resolution=256, img_channels=1, channel_base=16384,
                      channel_max=512, epilogue_kwargs=dict(mbstd_group_size=4)).to(device)
    state = create_train_state(G, D, 0.0025, 0.0025)
    state.ada_p = torch.tensor(0.5, device=device)
    pipe = AugmentPipe(medical_augment_config(), 256, 256, 1)
    loss = StyleGAN2Loss(G, D, StyleGAN2LossConfig(r1_gamma=0.4096), augment_fn=pipe)
    stepper = TrainStepper(loss, TrainStepConfig(batch_size=BATCH, z_dim=512, ada_target=0.6),
                           torch.Generator(device).manual_seed(0), mesh=mesh)
    reals = torch.randn((BATCH, 1, 256, 256), generator=torch.Generator().manual_seed(2))
    with profiling.recording() as rec:
        for flags in ((True, True), (False, False), (True, False), (False, True)):
            stepper.run(state, reals.to(device), None, *flags)
    launches = rec.under("upwarp.launch")
    assert launches.get("upwarp", 0) > 0 and launches.get("upsplat", 0) > 0
    out = {f"{name}.{k}": v.detach().cpu() for name in ("G", "D", "G_ema")
           for k, v in getattr(state, name).state_dict().items()}
    out.update(pl_mean=state.pl_mean.cpu(), ada_p=state.ada_p.cpu(),
               ada_signs=state.ada_signs.cpu())
    return out


@pytest.mark.cuda
def test_nccl_world_one_step_is_bit_equal_to_no_group(cuda_device, monkeypatch):
    before = _four_steps(cuda_device, pm.Mesh())
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", LOCAL_RANK=str(cuda_device.index), WORLD_SIZE="1",
                     MASTER_ADDR="localhost", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    assert pm.initialize_distributed("cuda")
    try:
        assert dist.get_backend() == "nccl"
        grouped = _four_steps(cuda_device, pm.create_mesh(1, "cuda"))
    finally:
        dist.destroy_process_group()
    after = _four_steps(cuda_device, pm.Mesh())
    assert set(before) == set(grouped) == set(after)
    for name in before:
        assert torch.equal(before[name], after[name]), f"{name}: the step is not deterministic"
        assert torch.equal(before[name], grouped[name]), f"{name}: the NCCL group changed bits"
