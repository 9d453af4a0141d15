"""The FIR CUDA kernels (K5 same, K6 down2, K7 up2 and up4, the ↓4
kernel, and down2 and up2 with a 2-D filter) against their plain PyTorch
version.

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
from gantrack_tpu_torch.utils import profiling

ufd = importlib.import_module("gantrack_tpu_torch.ops.upfirdn2d")

F4 = ufd.setup_filter([1, 3, 3, 1])
SYM6 = ufd.setup_filter(WAVELETS["sym6"])
F5 = ufd.setup_filter([1, 4, 6, 4, 1])  # generic tap count (not unrolled)
# A 12-tap StyleGAN3 low-pass (Kaiser; numtaps, cutoff, width, sampling rate).
SG3 = ufd.setup_filter(scipy.signal.firwin(numtaps=12, cutoff=32.0, width=16.0, fs=128.0))
# A 24-tap one of StyleGAN3-T's ×4 layers (L10's design).
SG3X4 = ufd.setup_filter(scipy.signal.firwin(numtaps=24, cutoff=45.25, width=37.49, fs=512.0))

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
    # The ×4 kernel at StyleGAN3-T's four ×4 layers (24 taps, gain 16, the
    # cropping pads; fewer planes): canvases 38², 54², 86², 150² -> 114²,
    # 178², 306², 562² (tiles of 64 rows x 128 columns at bf16, 64 at f32,
    # ragged), and the ↓4 kernel at their adjoints (pads 29).
    (SG3X4, 4, 1, [-6, -9, -6, -9], False, 16.0, (2, 3, 38, 38)),
    (SG3X4, 4, 1, [-6, -9, -6, -9], False, 16.0, (1, 3, 54, 54)),
    (SG3X4, 4, 1, [-6, -9, -6, -9], False, 16.0, (1, 2, 86, 86)),
    (SG3X4, 4, 1, [-6, -9, -6, -9], False, 16.0, (1, 1, 150, 150)),
    (SG3X4, 1, 4, 29, True, 16.0, (2, 3, 114, 114)),
    (SG3X4, 1, 4, 29, True, 16.0, (1, 3, 178, 178)),
    (SG3X4, 1, 4, 29, True, 16.0, (1, 2, 306, 306)),
    (SG3X4, 1, 4, 29, True, 16.0, (1, 1, 562, 562)),
    # Every residue of the low pad, odd output widths (unaligned rows), the
    # generic tap loop (F4, F5), and outputs smaller than one tile.
    (SG3X4, 4, 1, [-5, -7, 3, 2], False, 16.0, (1, 2, 33, 29)),
    (SG3X4, 4, 1, [4, 2, -7, 1], True, 16.0, (2, 1, 20, 41)),
    (F5, 4, 1, [2, 1, -1, 3], False, 16.0, (1, 2, 25, 19)),
    (F4, 4, 1, [0, 0, 1, 2], False, 16.0, (1, 1, 5, 3)),
    (SG3X4, 1, 4, [29, 30, 27, 28], False, 1.0, (1, 2, 131, 97)),
    (F5, 1, 4, [3, -1, 0, 2], False, 1.0, (2, 2, 70, 301)),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the FIR kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _run(x, f, up, down, padding, flip, gain, kernel):
    kw = dict(up=up, down=down, padding=padding, flip_filter=flip, gain=gain)
    if kernel:
        return ufd.upfirdn2d(x, ufd.Filter(f), **kw)
    return ufd.upfirdn2d_plain(x, f.to(x.device), **kw)


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(CASES)))
def test_fir_kernel_matches_plain_on_card(cuda_device, case):
    f, up, down, padding, flip, gain, shape = CASES[case]
    rng = np.random.default_rng(case)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda_device)
    with profiling.recording() as rec:
        got = _run(x, f, up, down, padding, flip, gain, kernel=True)
        ref = _run(x, f, up, down, padding, flip, gain, kernel=False)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert _max_err(got, ref) <= 1e-5 * float(ref.abs().max())
    form = f"up{up}" if up > 1 else f"down{down}" if down > 1 else "same"
    assert rec.under("fir.launch").get(form) == 1

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
    # A factor of 3 is outside the contract by the call's static spec: the
    # plain version runs, counted; no kernel is launched for it.
    x = torch.randn((1, 2, 8, 8), device=cuda_device)
    with profiling.recording() as rec:
        got = ufd.upfirdn2d(x, ufd.Filter(F4), up=3)
    torch.testing.assert_close(got, ufd.upfirdn2d_plain(x, F4.to(cuda_device), up=3),
                               rtol=0, atol=0)
    assert rec.under("fir.launch") == {}
    assert rec.under("upfirdn2d.plain_route") == {"up=3, down=1": 1}
    with pytest.raises(ValueError, match="host taps"):
        ufd.upfirdn2d(x, F4.to(cuda_device))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ufd.upfirdn2d(x.double(), ufd.Filter(F4))


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


def _x4_specs():
    t = ufd.filter_taps(SG3X4)[0]
    return t, fir.FirSpec("up4", t, t, (-6, -9, -6, -9)), fir.FirSpec("down4", t, t,
                                                                      (29, 29, 29, 29))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fir_x4_walks_more_planes_than_its_grid(cuda_device, dtype):
    """The ×4 kernel and the ↓4 kernel walk the planes p, p + gridDim.z,
    ...: 24 taps on 6000 planes of 38² (up4, StyleGAN3-T's smallest ×4
    canvas) and of 114² (its ↓4 adjoint), and 70000 planes (above the
    65535 blocks of gridDim.z) of small canvases."""
    t, up4, down4 = _x4_specs()
    for planes, hw, spec in ((6000, 38, up4), (6000, 114, down4),
                             (70000, 10, fir.FirSpec("up4", t, t, (-2, -3, -2, -3))),
                             (70000, 24, fir.FirSpec("down4", t, t, (1, 1, 1, 1)))):
        x = torch.randn((planes, hw, hw), device=cuda_device).to(dtype)
        ref = fir.fir_plain(x.float(), spec)
        got = fir.fir_planes(x, spec)
        assert got.dtype == dtype and got.shape == ref.shape
        rel = 1e-5 if dtype == torch.float32 else 1e-2
        assert _max_err(got, ref) <= rel * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["up4", "down4"])
def test_fir_x4_grid_size_leaves_the_bits_unchanged(cuda_device, form, dtype):
    """The grid of the ×4 and ↓4 kernels only spreads the planes over
    blocks (no atomics): every grid size gives the same bits as the
    kernel's own choice, at 24 taps and on the generic tap loop, and a
    negative one is refused."""
    t, up4, down4 = _x4_specs()
    t5 = ufd.filter_taps(F5)[0]
    specs = ((up4, fir.FirSpec("up4", t5, t5, (1, 2, 3, 0))) if form == "up4"
             else (down4, fir.FirSpec("down4", t5, t5, (1, 2, 3, 0))))
    for spec in specs:
        hw = (45, 38) if form == "up4" else (131, 150)
        x = torch.randn((300, *hw), device=cuda_device).to(dtype)
        want = fir.fir_planes(x, spec)
        for bps in (1, 4, 64, 1024):
            assert torch.equal(fir.fir_planes(x, spec, blocks_per_sm=bps), want)
        assert torch.equal(fir.fir_planes(x, spec), want)  # the same launch again
    with pytest.raises(RuntimeError):
        fir.fir_planes(x, spec, blocks_per_sm=-1)


@pytest.mark.cuda
def test_stylegan3_t_x4_layer_takes_the_x4_kernels(cuda_device):
    """A StyleGAN3-T ×4 layer's ``filtered_lrelu`` (L3's geometry, bf16)
    takes the kernels both ways: no plain-route call; the forward counts
    one up4 launch (and one down2), the backward one down4 (and one
    up2)."""
    from gantrack_tpu_torch.ops import filtered_lrelu

    fu, fd = ufd.Filter(SG3X4), ufd.Filter(SG3)
    x = torch.randn((2, 8, 38, 38), device=cuda_device, dtype=torch.bfloat16, requires_grad=True)
    b = torch.zeros(8, device=cuda_device, dtype=torch.bfloat16)
    with profiling.recording() as rec:
        y = filtered_lrelu(x, fu, fd, b, up=4, down=2, padding=[-6, -9, -6, -9])
        assert y.shape == (2, 8, 52, 52)
        launched = dict(rec.under("fir.launch"))
        (g,) = torch.autograd.grad(y.float().square().sum(), x)
    torch.cuda.synchronize()
    assert launched == {"up4": 1, "down2": 1}
    assert rec.under("fir.launch") == {"up4": 1, "down2": 1, "up2": 1, "down4": 1}
    assert rec.under("upfirdn2d.plain_route") == {}
    assert bool(torch.isfinite(g).all())


def _radial(numtaps=12, cutoff=22.6, width=17.25, rate=128.0):
    """A radial (2-D) jinc low-pass of StyleGAN3-R's layers, as a ``Filter``."""
    from gantrack_tpu_torch.models.stylegan3 import design_lowpass_filter

    return ufd.Filter(design_lowpass_filter(numtaps, cutoff, width, rate, radial=True))


# (numtaps, up, down, padding [px0, px1, py0, py1], gain, [N, C, H, W]):
# StyleGAN3-R's radial down-filter (12 x 12, ↓2, pads 0: the filtered
# lrelu's second pass) at L10's and L0's canvases (fewer planes) and its
# ×2 adjoint (pads 11, 10); ragged tiles both ways, odd canvases and
# widths (unaligned rows), odd low pads (the ×2 form's pairs start at an
# odd output), cropping pads, a canvas smaller than one tile, and smaller
# filters (the generic path).
CASES_2D = [
    (12, 1, 2, 0, 1.0, (1, 2, 562, 562)),
    (12, 1, 2, 0, 1.0, (2, 3, 82, 82)),
    (12, 2, 1, [11, 10, 11, 10], 4.0, (1, 2, 276, 276)),
    (12, 2, 1, [11, 10, 11, 10], 1.0, (2, 3, 36, 36)),
    (12, 1, 2, [3, -2, -1, 4], 1.0, (1, 2, 71, 93)),
    (12, 1, 2, 0, 1.0, (1, 1, 13, 15)),
    (12, 2, 1, [10, 9, -2, 3], 1.0, (1, 2, 37, 45)),
    (12, 2, 1, [5, 6, 6, 5], 1.0, (1, 1, 4, 5)),
    (5, 1, 2, [2, 1, 3, 3], 1.0, (1, 2, 40, 75)),
    (7, 2, 1, [4, 0, -2, 3], 1.0, (1, 2, 19, 38)),
]


def _run_2d(x, case, kernel):
    numtaps, up, down, padding, gain, _ = CASES_2D[case]
    f = _radial(numtaps)
    kw = dict(up=up, down=down, padding=padding, gain=gain)
    if kernel:
        return ufd.upfirdn2d(x, f, **kw)
    return ufd.upfirdn2d_plain(x, f.on(x.device), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(CASES_2D)))
def test_2d_fir_kernels_match_plain_on_card(cuda_device, case):
    """Both 2-D forms against the plain version: float32 at 1e-5, bf16
    input at 1e-2 against the plain version in float32 on the same
    rounded input; one launch of the 2-D form, no plain-route call."""
    shape = CASES_2D[case][-1]
    rng = np.random.default_rng(300 + case)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda_device)
    with profiling.recording() as rec:
        got = _run_2d(x, case, kernel=True)
    ref = _run_2d(x, case, kernel=False)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert _max_err(got, ref) <= 1e-5 * float(ref.abs().max())
    form = "up2_2d" if CASES_2D[case][1] == 2 else "down2_2d"
    assert rec.under("fir.launch") == {form: 1}
    assert rec.under("upfirdn2d.plain_route") == {}

    xb = x.bfloat16()
    got_b = _run_2d(xb, case, kernel=True)
    ref_b = _run_2d(xb.float(), case, kernel=False)
    assert got_b.dtype == torch.bfloat16
    assert _max_err(got_b, ref_b) <= 1e-2 * float(ref_b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", [1, 3, 4, 6, 8, 9])
def test_2d_fir_autograd_to_second_order_on_card(cuda_device, case):
    """Gradient and gradient of gradient through the 2-D kernels (each
    backward the other 2-D form) equal autograd of the plain version."""
    shape = CASES_2D[case][-1]
    x = torch.from_numpy(np.random.default_rng(400 + case).standard_normal(shape)
                         .astype(np.float32)).to(cuda_device)

    def r1_like(kernel):
        xs = x.clone().requires_grad_(True)
        y = _run_2d(xs, case, kernel)
        w = torch.from_numpy(np.random.default_rng(7).standard_normal(y.shape).astype(np.float32))
        (gx,) = torch.autograd.grad((F.softplus(y) * w.to(y.device)).sum(), xs, create_graph=True)
        (ggx,) = torch.autograd.grad(gx.square().sum(), xs)
        return gx.detach(), ggx

    with profiling.recording() as rec:
        gk, ggk = r1_like(True)
    gp, ggp = r1_like(False)
    assert _max_err(gk, gp) <= 1e-5 * float(gp.abs().max())
    assert _max_err(ggk, ggp) <= 1e-5 * float(ggp.abs().max())
    assert set(rec.under("fir.launch")) == {"down2_2d", "up2_2d"}


def _specs_2d():
    f, f5 = _radial(), _radial(5)
    down, _ = fir.fir_spec(f, f.taps, 1, 2, 0, False, 1.0)
    up, _ = fir.fir_spec(f, f.taps, 2, 1, [11, 10, 11, 10], False, 4.0)
    small, _ = fir.fir_spec(f5, f5.taps, 1, 2, [1, 2, 0, 1], False, 1.0)
    return down, up, small


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_2d_fir_walks_more_planes_than_its_grid(cuda_device, dtype):
    """The 2-D kernels walk the planes p, p + gridDim.z, ...: 6000 planes
    of StyleGAN3-R's smallest canvases (82² ↓2, 36² ×2), and 70000 planes
    (above the 65535 blocks of gridDim.z) of small ones."""
    down, up, small = _specs_2d()
    for planes, hw, spec in ((6000, 82, down), (6000, 36, up), (70000, 14, down),
                             (70000, 6, up), (70000, 9, small)):
        x = torch.randn((planes, hw, hw), device=cuda_device).to(dtype)
        ref = fir.fir_plain(x.float(), spec)
        got = fir.fir_planes(x, spec)
        assert got.dtype == dtype and got.shape == ref.shape
        rel = 1e-5 if dtype == torch.float32 else 1e-2
        assert _max_err(got, ref) <= rel * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_2d_fir_grid_size_leaves_the_bits_unchanged(cuda_device, dtype):
    """The grid of the 2-D kernels only spreads the planes over blocks (no
    atomics, a fixed order of sums): every grid size gives the bits of the
    kernel's own choice, at 12 x 12 and on the generic path, and a
    negative one is refused."""
    for spec in _specs_2d():
        hw = (45, 38) if spec.form == "up2" else (131, 150)
        x = torch.randn((300, *hw), device=cuda_device).to(dtype)
        want = fir.fir_planes(x, spec)
        for bps in (1, 4, 64, 1024):
            assert torch.equal(fir.fir_planes(x, spec, blocks_per_sm=bps), want)
        with pytest.raises(RuntimeError):
            fir.fir_planes(x, spec, blocks_per_sm=-1)


@pytest.mark.cuda
def test_stylegan3_r_layer_takes_the_2d_kernels(cuda_device):
    """One StyleGAN3-R layer (L4 of ``sg3r-256``: bf16, 1024 channels,
    52² at batch 2, its radial filter and pads as ``SynthesisLayer`` sets
    them) takes the kernels both ways: the forward launches down2_2d
    (after the ×2 up-filter), the backward up2_2d (and down2), with no
    plain-route call."""
    from gantrack_tpu_torch.models import stylegan3 as sg3

    net = sg3.SynthesisNetwork(w_dim=512, img_resolution=256, img_channels=1,
                               channel_base=65536, channel_max=1024, num_layers=14,
                               num_critical=2, conv_kernel=1, use_radial_filters=True)
    layer = getattr(net, net.layer_names[4]).to(cuda_device)
    assert isinstance(layer.down_filter.taps, ufd.Taps2D)
    assert layer.down_filter.host.shape == (12, 12) and layer.down_factor == 2
    spec = layer.spec
    x = torch.randn((2, spec.in_channels, spec.in_size, spec.in_size), device=cuda_device,
                    dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn((2, 512), device=cuda_device)
    with profiling.recording() as rec:
        y = layer(x, w)
        assert y.shape == (2, spec.out_channels, spec.out_size, spec.out_size)
        launched = dict(rec.under("fir.launch"))
        (g,) = torch.autograd.grad(y.float().square().sum(), x)
    torch.cuda.synchronize()
    assert launched == {"up2": 1, "down2_2d": 1}
    assert rec.under("fir.launch") == {"up2": 1, "down2_2d": 1, "up2_2d": 1, "down2": 1}
    assert rec.under("upfirdn2d.plain_route") == {}
    assert bool(torch.isfinite(g).all())
