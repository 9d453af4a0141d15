"""The FIR CUDA kernels (K5 same, K6 down2, K7 up2) against their plain
PyTorch version.

Needs an NVIDIA card and ``nvcc``; skips without a card.  Imports no JAX,
so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_fir_cuda.py

Tolerances: float32 1e-5 of the largest reference value (the same terms,
summed in another order); bfloat16 input 1e-2 of it against the plain
version in float32 on the same rounded input (the output's bf16 rounding
dominates); gradients of both orders 1e-5 in float32.
"""

import importlib

import numpy as np
import pytest
import scipy.signal
import torch
import torch.nn.functional as F

from gantrack_tpu_torch.ops import fir
from gantrack_tpu_torch.training.augment import WAVELETS

ufd = importlib.import_module("gantrack_tpu_torch.ops.upfirdn2d")

F4 = ufd.setup_filter([1, 3, 3, 1])
SYM6 = ufd.setup_filter(WAVELETS["sym6"])
F5 = ufd.setup_filter([1, 4, 6, 4, 1])  # generic tap count (not unrolled)
# A 12-tap StyleGAN3 low-pass (Kaiser; numtaps, cutoff, width, sampling rate).
SG3 = ufd.setup_filter(scipy.signal.firwin(numtaps=12, cutoff=32.0, width=16.0, fs=128.0))

# (filter, up, down, padding [px0, px1, py0, py1], flip, gain, shape)
CASES = [
    (F4, 1, 1, 0, False, 4.0, (2, 5, 35, 37)),             # G up-conv post-filter
    (F4, 1, 1, 2, False, 1.0, (2, 5, 32, 30)),             # D down-conv pre-filter
    (F4, 1, 2, 1, False, 1.0, (2, 5, 32, 34)),             # D skip
    (F4, 2, 1, [2, 1, 2, 1], False, 4.0, (2, 1, 16, 17)),  # G image skip (upsample2d)
    (SYM6, 1, 2, -1, True, 1.0, (3, 1, 60, 60)),           # augment crop-downsample
    (F4, 1, 1, [3, 1, -1, 2], True, 1.0, (1, 4, 21, 19)),
    (F4, 2, 1, [-1, 2, 0, -2], False, 1.0, (1, 3, 13, 11)),
    (F5, 1, 2, [2, 2, 1, 3], False, 1.0, (2, 2, 24, 25)),
    # Several output tiles per plane (K7: 64 rows; K5, K6: 16 rows), with
    # ragged edges.
    (F4, 2, 1, [1, 2, 2, 1], False, 4.0, (1, 2, 40, 45)),
    (SYM6, 1, 2, -1, True, 1.0, (1, 2, 100, 90)),
    (F5, 1, 1, [3, -1, 0, 2], False, 1.0, (1, 2, 50, 70)),
    # The x2 kernel at 12 taps (StyleGAN3's layers): pads (9, 8) (even p0)
    # and (-11, -12) (odd p0, cropping), mixed parities, tiles of 64 rows x
    # 116 columns with ragged edges, output widths whose row pitch forbids
    # the pair store (odd OW), and odd heights.
    (SG3, 2, 1, [9, 8, 9, 8], False, 4.0, (2, 3, 30, 41)),
    (SG3, 2, 1, [-11, -12, -11, -12], False, 4.0, (1, 3, 47, 37)),
    (SG3, 2, 1, [10, 10, 9, 8], True, 4.0, (1, 2, 70, 67)),    # OW 143: odd rows unaligned
    (SG3, 2, 1, [9, 8, -12, -12], False, 4.0, (1, 2, 45, 131)),  # odd p0, 3 column tiles
    (SG3, 2, 1, [-10, -11, 10, 11], False, 4.0, (2, 1, 38, 38)),
    # The same and ↓2 kernels at 12 taps (StyleGAN3's ↓2 down-filters, pads
    # 0): tiles of 16 rows x 58 columns, several each way with ragged edges
    # and an odd output width (OW 125: odd rows take scalar stores); an odd
    # canvas; a canvas smaller than one tile; and the same rate at 12 taps.
    (SG3, 1, 2, 0, False, 1.0, (2, 3, 150, 261)),
    (SG3, 1, 2, 0, False, 1.0, (1, 2, 83, 131)),
    (SG3, 1, 2, 0, False, 1.0, (2, 3, 30, 27)),
    (SG3, 1, 1, [3, -2, -1, 4], False, 1.0, (1, 2, 45, 150)),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the FIR kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _run(x, f, up, down, padding, flip, gain, kernel):
    fn = ufd.upfirdn2d if kernel else ufd.upfirdn2d_plain
    kw = dict(taps=ufd.filter_taps(f)) if kernel else {}
    return fn(x, f.to(x.device), up=up, down=down, padding=padding, flip_filter=flip, gain=gain,
              **kw)


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(CASES)))
def test_fir_kernel_matches_plain_on_card(cuda_device, case):
    f, up, down, padding, flip, gain, shape = CASES[case]
    rng = np.random.default_rng(case)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda_device)
    before, routed = dict(fir.LAUNCHES), fir.PLAIN_ROUTE.get("up=4, down=1", 0)
    got = _run(x, f, up, down, padding, flip, gain, kernel=True)
    ref = _run(x, f, up, down, padding, flip, gain, kernel=False)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert _max_err(got, ref) <= 1e-5 * float(ref.abs().max())
    form = "up2" if up == 2 else "down2" if down == 2 else "same"
    assert fir.LAUNCHES[f"fir_{form}"] == before[f"fir_{form}"] + 1

    xb = x.bfloat16()
    got_b = _run(xb, f, up, down, padding, flip, gain, kernel=True)
    ref_b = _run(xb.float(), f, up, down, padding, flip, gain, kernel=False)
    assert got_b.dtype == torch.bfloat16
    assert _max_err(got_b, ref_b) <= 1e-2 * float(ref_b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(CASES)))
def test_fir_autograd_to_second_order_on_card(cuda_device, case):
    """Gradient and gradient of gradient through the kernels (each
    backward is the adjoint kernel) equal autograd of the plain version."""
    f, up, down, padding, flip, gain, shape = CASES[case]
    rng = np.random.default_rng(100 + case)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda_device)

    def r1_like(kernel):
        xs = x.clone().requires_grad_(True)
        y = _run(xs, f, up, down, padding, flip, gain, kernel)
        w = torch.from_numpy(np.random.default_rng(7).standard_normal(y.shape).astype(np.float32))
        (gx,) = torch.autograd.grad((F.softplus(y) * w.to(y.device)).sum(), xs, create_graph=True)
        (ggx,) = torch.autograd.grad(gx.square().sum(), xs)
        return gx.detach(), ggx

    gk, ggk = r1_like(True)
    gp, ggp = r1_like(False)
    assert _max_err(gk, gp) <= 1e-5 * float(gp.abs().max())
    assert _max_err(ggk, ggp) <= 1e-5 * float(ggp.abs().max())


@pytest.mark.cuda
def test_fir_kernel_walks_more_planes_than_one_grid(cuda_device):
    """P above the 65535 blocks of gridDim.z (as metric batches reach)."""
    x = torch.randn((70000, 6, 6), device=cuda_device)
    spec = fir.FirSpec("same", (0.25, 0.5, 0.25), (0.5, 0.5), (1, 1, 0, 1))
    torch.testing.assert_close(fir.fir_planes(x, spec), fir.fir_plain(x, spec),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_upfirdn2d_outside_the_contract_takes_the_counted_plain_route_on_card(cuda_device):
    # A factor of 4 is outside the contract by the call's static spec: the
    # plain version runs, counted; no kernel is launched for it.
    x = torch.randn((1, 2, 8, 8), device=cuda_device)
    before, routed = dict(fir.LAUNCHES), fir.PLAIN_ROUTE.get("up=4, down=1", 0)
    got = ufd.upfirdn2d(x, F4.to(cuda_device), up=4, taps=ufd.filter_taps(F4))
    torch.testing.assert_close(got, ufd.upfirdn2d_plain(x, F4.to(cuda_device), up=4),
                               rtol=0, atol=0)
    assert fir.LAUNCHES == before
    assert fir.PLAIN_ROUTE["up=4, down=1"] == routed + 1
    with pytest.raises(ValueError, match="host taps"):
        ufd.upfirdn2d(x, F4.to(cuda_device))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ufd.upfirdn2d(x.double(), F4, taps=ufd.filter_taps(F4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fir_up2_walks_more_planes_than_its_grid(cuda_device, dtype):
    """The x2 kernel's grid holds about 64 blocks an SM; a block walks
    the planes p, p + gridDim.z, ...: 12 taps on 6000 planes of 38 x 38
    (the smallest StyleGAN3 x2 layer's size), and 70000 planes (above the
    65535 blocks of gridDim.z) with 4 taps."""
    for planes, hw, taps, pads in ((6000, 38, SG3, (9, 8, 9, 8)), (70000, 6, F4, (2, 1, 2, 1))):
        t = ufd.filter_taps(taps)[0]
        spec = fir.FirSpec("up2", t, t, pads)
        x = torch.randn((planes, hw, hw), device=cuda_device).to(dtype)
        ref = fir.fir_plain(x.float(), spec)
        got = fir.fir_planes(x, spec)
        assert got.dtype == dtype
        rel = 1e-5 if dtype == torch.float32 else 1e-2
        assert _max_err(got, ref) <= rel * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fir_up2_grid_size_leaves_the_bits_unchanged(cuda_device, dtype):
    """The grid of the x2 kernel (``blocks_per_sm``, which chip_smoke.py
    times) only spreads the planes over blocks: every grid size gives the
    same bits as the kernel's own choice, and a negative one is refused."""
    t = ufd.filter_taps(SG3)[0]
    spec = fir.FirSpec("up2", t, t, (9, 8, 9, 8))
    x = torch.randn((300, 45, 38), device=cuda_device).to(dtype)
    want = fir.fir_planes(x, spec)
    for bps in (1, 4, 64, 1024):
        assert torch.equal(fir.fir_planes(x, spec, blocks_per_sm=bps), want)
    with pytest.raises(RuntimeError):
        fir.fir_planes(x, spec, blocks_per_sm=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fir_same_and_down2_walk_more_planes_than_their_grid(cuda_device, dtype):
    """K5 and K6 hold about 128 blocks an SM; a block walks the planes p,
    p + gridDim.z, ...: 12 taps ↓2 on 6000 planes of 82 x 82 (StyleGAN3's
    smallest ↓2 canvas), 4 taps same on 4000 planes of 35 x 35, and
    70000 planes (above the 65535 blocks of gridDim.z) of each form."""
    t12, t4 = ufd.filter_taps(SG3)[0], ufd.filter_taps(F4)[0]
    for planes, hw, spec in ((6000, 82, fir.FirSpec("down2", t12, t12, (0, 0, 0, 0))),
                             (4000, 35, fir.FirSpec("same", t4, t4, (0, 0, 0, 0))),
                             (70000, 9, fir.FirSpec("down2", t4, t4, (1, 1, 1, 1))),
                             (70000, 7, fir.FirSpec("same", t4, t4, (2, 2, 2, 2)))):
        x = torch.randn((planes, hw, hw), device=cuda_device).to(dtype)
        ref = fir.fir_plain(x.float(), spec)
        got = fir.fir_planes(x, spec)
        assert got.dtype == dtype
        rel = 1e-5 if dtype == torch.float32 else 1e-2
        assert _max_err(got, ref) <= rel * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["same", "down2"])
def test_fir_grid_size_leaves_the_bits_unchanged(cuda_device, form, dtype):
    """The grid of K5 and K6 (``blocks_per_sm``, which chip_smoke.py
    times) only spreads the planes over blocks: every grid size gives the
    same bits as the kernel's own choice, at 12 taps and at 4, and a
    negative one is refused."""
    for f in (SG3, F4):
        t = ufd.filter_taps(f)[0]
        spec = fir.FirSpec(form, t, t, (0, 0, 0, 0))
        x = torch.randn((300, 75, 131), device=cuda_device).to(dtype)
        want = fir.fir_planes(x, spec)
        for bps in (1, 4, 64, 1024):
            assert torch.equal(fir.fir_planes(x, spec, blocks_per_sm=bps), want)
    with pytest.raises(RuntimeError):
        fir.fir_planes(x, spec, blocks_per_sm=-1)
