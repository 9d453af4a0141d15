"""The 3×3 conv CUDA kernels (K8, K9) and the probes (P1–P6) against their
plain PyTorch versions.

Needs an NVIDIA card and ``nvcc``; skips without a card.  Imports no JAX,
so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_conv3x3_cuda.py

The bfloat16 shapes whose width is a multiple of 8 run the wgmma kernels
(TMA-fed), the others the general mma.sync kernels; float32 images of at
most 64 pixels run the kernel that packs whole images into a block.

Tolerances: float32 1e-5 of the largest reference value (the kernels run
full float32 FMA and sum in another order than cuDNN/cuBLAS with TF32
off); bfloat16 1e-2 of it against the float32 plain version on the same
bf16-rounded inputs (float32 sums in both; the one rounding of the output
dominates).  K9 must be bitwise deterministic.  The probes are exact on
small integers: every product and sum is representable; the matrix probe
also holds on normal draws, to 1e-5 of the largest value for a float32
result (a float32 operand is split into two tf32 terms, not rounded to
one) and 1e-2 for a bfloat16 result.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gantrack_tpu_torch.ops import conv3x3 as c3
from gantrack_tpu_torch.ops import probes
from gantrack_tpu_torch.utils import profiling

# The 4x4 layers of the full-width training step, an image smaller than
# the kernels' tile, at the batch sizes the step gives them: G's last-but-
# one conv (batch and half batch) and D's epilogue conv with the
# minibatch-stddev channel (twice the batch and the batch).
STEP_4X4 = [(32, 512, 512, 4, 4), (16, 512, 512, 4, 4), (64, 513, 512, 4, 4), (32, 513, 512, 4, 4)]
# (N, Ci, Co, H, W): tile-aligned, ragged in every extent, channels that
# are no multiple of a tile, a 4x4 image, and one wide image.
SHAPES = [
    (2, 64, 64, 16, 16),
    (1, 64, 128, 16, 16),
    (2, 128, 64, 8, 8),
    (3, 40, 72, 19, 37),
    (2, 513, 24, 4, 4),
    (1, 16, 8, 5, 130),
] + STEP_4X4


# Edges of the redesigned kernels' tiles.  bfloat16 (wgmma): H, W no multiple
# of the pixel tile but W % 8 == 0; Ci, Co no multiple of their tiles; N = 1;
# both box widths (64 pixels above W = 32, 32 below) and both channel tiles
# (128, 64 where Co <= 64); more pixel tiles than K9's splits.
WGMMA_EDGES = [
    (1, 16, 64, 4, 64), (2, 40, 72, 24, 40), (1, 513, 512, 7, 8), (1, 16, 128, 8, 32),
    (3, 64, 64, 19, 16), (1, 8, 8, 1, 8), (2, 24, 200, 13, 72), (5, 33, 65, 9, 136),
    (40, 32, 64, 12, 24), (1, 16, 130, 8, 16),
]
# float32, whole small images a block: 4x4, 5x8, 3x3, 8x8, 1x1; N no multiple
# of the images a block holds; Co no multiple of 4 (scalar weight copies).
FLAT_EDGES = [
    (33, 24, 40, 4, 4), (3, 40, 72, 5, 8), (5, 7, 9, 3, 3), (3, 20, 33, 8, 8), (70, 5, 6, 1, 1),
    (9, 513, 34, 2, 7),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the conv3x3 kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, shape, dtype, seed=0):
    n, ci, co, h, w = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, ci, h, w)).astype(np.float32))
    wt = rng.standard_normal((co, ci, 3, 3)) / np.sqrt(9 * ci)
    wt = torch.from_numpy(wt.astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((n, co, h, w)).astype(np.float32))
    return x.to(dev, dtype), wt.to(dev, dtype), g.to(dev, dtype)


def _close(got, ref, rel):
    assert got.shape == ref.shape
    assert float((got.float() - ref.float()).abs().max()) <= rel * float(ref.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_conv_and_wgrad_match_plain_on_card(cuda_device, shape, dtype, rel):
    x, w, g = _case(cuda_device, shape, dtype)
    with profiling.recording() as rec:
        out = c3.conv3x3(x, w)
        dw = c3.wgrad3x3(x, g)
    torch.cuda.synchronize()
    assert out.dtype == dtype and dw.dtype == dtype
    launches = rec.under("conv3x3.launch")
    assert launches.get("conv3x3") == 1
    assert launches.get("wgrad3x3") == 1
    _close(out, c3.conv3x3_plain(x.float(), w.float()), rel)
    _close(dw, c3.wgrad3x3_plain(x.float(), g.float()), rel)
    assert torch.equal(dw, c3.wgrad3x3(x, g)), "K9 is not bitwise deterministic"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WGMMA_EDGES)
def test_wgmma_kernels_at_tile_edges_on_card(cuda_device, shape):
    x, w, g = _case(cuda_device, shape, torch.bfloat16, seed=3)
    assert c3.conv_variant(x.shape, x.dtype) == c3.wgrad_variant(x.shape, x.dtype) == "wgmma"
    with profiling.recording() as rec:
        out, dw = c3.conv3x3(x, w), c3.wgrad3x3(x, g)
    torch.cuda.synchronize()
    assert rec.under("conv3x3.variant").get("conv3x3:wgmma") == 1
    assert rec.under("conv3x3.variant").get("wgrad3x3:wgmma") == 1
    ref, ref9 = c3.conv3x3_plain(x.float(), w.float()), c3.wgrad3x3_plain(x.float(), g.float())
    _close(out, ref, 1e-2)
    _close(dw, ref9, 1e-2)
    assert torch.equal(dw, c3.wgrad3x3(x, g)), "K9 (wgmma) is not bitwise deterministic"
    # The general kernels take the same shape and agree within the same limits.
    with profiling.recording() as rec:
        old, old9 = c3._conv_launch(x, w, "mma_sync"), c3._wgrad_launch(x, g, "mma_sync")
    assert rec.under("conv3x3.variant").get("conv3x3:mma_sync") == 1
    _close(old, ref, 1e-2)
    _close(old9, ref9, 1e-2)
    _close(out, old.float(), 1e-2)
    _close(dw, old9.float(), 1e-2)
    assert torch.equal(old9, c3._wgrad_launch(x, g, "mma_sync")), "K9 (mma_sync) not deterministic"


@pytest.mark.cuda
def test_wgmma_kernels_take_unaligned_views_on_card(cuda_device):
    """A contiguous view whose first element is not 16-byte aligned: the
    wrapper hands TMA an aligned copy."""
    x, w, g = _case(cuda_device, (3, 16, 64, 8, 16), torch.bfloat16, seed=4)
    flat = torch.zeros(x.numel() + 3, dtype=x.dtype, device=x.device)
    flat[3:] = x.flatten()
    xv = flat[3:].view(x.shape)
    assert xv.data_ptr() % 16 != 0 and xv.is_contiguous()
    assert torch.equal(c3.conv3x3(xv, w), c3.conv3x3(x, w))
    assert torch.equal(c3.wgrad3x3(xv, g), c3.wgrad3x3(x, g))


@pytest.mark.cuda
def test_forcing_a_variant_the_shape_does_not_allow_raises_on_card(cuda_device):
    x, w, g = _case(cuda_device, (1, 16, 16, 5, 9), torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        c3._conv_launch(x, w, "wgmma")
    with pytest.raises(ValueError, match="multiple of 8"):
        c3._wgrad_launch(x, g, "wgmma")
    with pytest.raises(ValueError, match="variant"):
        c3._conv_launch(x.float(), w.float(), "mma_sync")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLAT_EDGES)
def test_small_image_packing_on_card(cuda_device, shape):
    x, w, g = _case(cuda_device, shape, torch.float32, seed=5)
    assert c3.conv_variant(x.shape, x.dtype) == "f32_flat"
    with profiling.recording() as rec:
        out = c3.conv3x3(x, w)
    torch.cuda.synchronize()
    assert rec.under("conv3x3.variant").get("conv3x3:f32_flat") == 1
    _close(out, c3.conv3x3_plain(x, w), 1e-5)
    dw = c3.wgrad3x3(x, g)
    _close(dw, c3.wgrad3x3_plain(x, g), 1e-5)
    assert torch.equal(dw, c3.wgrad3x3(x, g)), "K9 (f32) is not bitwise deterministic"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 32, 64, 16, 64), (1, 24, 136, 9, 24), (2, 64, 64, 8, 8)])
def test_grad_of_grad_through_the_wgmma_kernels_on_card(cuda_device, shape):
    """The R1 form in bfloat16: every conv of both backward passes is a
    wgmma launch; against autograd of the plain version, which rounds at the
    same places and sums in another order (3e-2)."""
    x, w, _ = _case(cuda_device, shape, torch.bfloat16, seed=6)

    def r1(conv):
        xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad(torch.tanh(conv(xs, ws).float()).sum(), xs, create_graph=True)
        gw, ggx = torch.autograd.grad(gx.float().square().sum(), (ws, xs))
        return gx.detach(), gw, ggx

    with profiling.recording() as rec:
        got = r1(c3.conv3x3)
    ran = rec.under("conv3x3.variant")
    assert ran.get("conv3x3:wgmma", 0) >= 4 and ran.get("wgrad3x3:wgmma", 0) >= 1, ran
    assert ran.get("conv3x3:mma_sync", 0) == 0 and ran.get("wgrad3x3:mma_sync", 0) == 0
    for a, b in zip(got, r1(c3.conv3x3_plain)):
        _close(a, b, 3e-2)


@pytest.mark.cuda
def test_wgrad_is_the_library_weight_gradient_on_card(cuda_device):
    x, w, g = _case(cuda_device, (2, 64, 64, 16, 16), torch.float32, seed=1)
    ref = torch.ops.aten.convolution_backward(g, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0],
                                              1, [False, True, False])[1]
    _close(c3.wgrad3x3(x, g), ref, 1e-5)
    _close(c3.conv3x3(x, w), F.conv2d(x, w, padding=1), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 64, 16, 16), (1, 24, 40, 9, 21), STEP_4X4[0],
                                   STEP_4X4[2]])
def test_grad_and_grad_of_grad_through_kernels_on_card(cuda_device, shape):
    """The R1 form: d/dw of |d conv / dx|^2, against autograd of the plain
    version; every conv of both backward passes is a kernel launch."""
    x, w, _ = _case(cuda_device, shape, torch.float32, seed=2)

    def r1(conv):
        xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad(torch.tanh(conv(xs, ws)).sum(), xs, create_graph=True)
        gw, ggx = torch.autograd.grad(gx.square().sum(), (ws, xs))
        return gx.detach(), gw, ggx

    with profiling.recording() as rec:
        got = r1(c3.conv3x3)
    # forward, dgrad; then the dgrad's two gradients (a conv and a wgrad)
    # and the forward's input gradient once more.
    launches = rec.under("conv3x3.launch")
    assert launches.get("conv3x3", 0) >= 4 and launches.get("wgrad3x3", 0) >= 1, launches
    ref = r1(c3.conv3x3_plain)
    for a, b in zip(got, ref):
        _close(a, b, 1e-4)


@pytest.mark.cuda
def test_outside_the_contract_raises_on_card(cuda_device):
    x, w, g = _case(cuda_device, (1, 16, 16, 8, 8), torch.float32)
    with pytest.raises(ValueError, match="contract"):
        c3.conv3x3(x.half(), w.half())
    with pytest.raises(ValueError, match="contract"):
        c3.conv3x3(x, w[:, :, :1, :1])
    with pytest.raises(ValueError, match="contract"):
        c3.conv3x3(x, w[:, :8])
    with pytest.raises(ValueError, match="match"):
        c3.wgrad3x3(x, g[:, :, :4])


def _ints(dev, shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-4, 5, shape).astype(np.float32)).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(probes.matmul_cases())))
def test_probe_matmul_exact_on_card(cuda_device, case):
    label, m, k, n, adt, bdt, odt, b_t = probes.matmul_cases()[case]
    # bf16 results: keep |sum| small enough to be a bf16 integer (<= 256).
    a = _ints(cuda_device, (m, k), adt, case) if odt == torch.float32 else \
        torch.ones((m, k), dtype=adt, device=cuda_device)
    b = _ints(cuda_device, (n, k) if b_t else (k, n), bdt, case + 100)
    if odt == torch.bfloat16:
        b = (b.float().abs() < 2).to(bdt)
    got = probes.probe_matmul(a, b, odt, b_t)
    assert got.dtype == odt
    assert torch.equal(got, probes.probe_matmul_plain(a, b, odt, b_t)), label


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(probes.matmul_cases())))
def test_probe_matmul_on_normal_draws_on_card(cuda_device, case):
    label, m, k, n, adt, bdt, odt, b_t = probes.matmul_cases()[case]
    rng = np.random.default_rng(case)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda_device, adt)
    b = torch.from_numpy(rng.standard_normal((n, k) if b_t else (k, n)).astype(np.float32))
    b = b.to(cuda_device, bdt)
    ref = probes.probe_matmul_plain(a, b, odt, b_t)
    _close(probes.probe_matmul(a, b, odt, b_t), ref, 1e-5 if odt == torch.float32 else 1e-2)


@pytest.mark.cuda
def test_mosaic_probes_exact_on_card(cuda_device):
    dev = cuda_device
    bf = torch.bfloat16
    w = (_ints(dev, (9 * probes.C, probes.C), bf, 1).float().abs() < 2).to(bf)  # 0/1 weights
    x = _ints(dev, (4, 18, 34, 64), bf, 2)
    assert torch.equal(probes.probe_halo_tile(x, w), probes.probe_tile_plain(x, w))
    wide = _ints(dev, (4, 24, 40, 64), bf, 3)
    assert torch.equal(probes.probe_padded_tile(wide, w), probes.probe_tile_plain(wide, w))
    assert torch.equal(probes.probe_ring(wide), probes.probe_ring_plain(wide))
    pieces = _ints(dev, (9, 256, 64), bf, 4)
    assert torch.equal(probes.probe_concat(pieces), probes.probe_concat_plain(pieces))
    rows = _ints(dev, (40, 128), bf, 5)
    assert torch.equal(probes.probe_row_slice(rows), probes.probe_row_slice_plain(rows))
    sums = probes.run_probes(dev, verbose=False)
    assert sums["A halo-window-as-it-lies"] == 576.0 * 4 * 16 * 32 * 64
    assert sums["B padded-window-shifted-reads"] == 576.0 * 4 * 16 * 32 * 64
