"""Smoke test of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``gantrack_tpu_torch/csrc`` (one ``nvcc``
per source, all started together), then:

0. prints the card's name and power limit, the kernel build times and,
   for ``conv3x3.cu``, each kernel's registers, static shared memory and
   spills as ``ptxas`` reports them and the number of ``HGMMA``
   instructions in the built library;
1. holds each kernel against its plain PyTorch version at the shapes of
   the main paths, and times both, beside the kernel's bound (the larger
   of its bytes over the card's memory rate and its operations over the
   card's float32 rate) and, where one PyTorch call computes the same
   function, that call (timed here, used nowhere in the port):
   the upwarp pair K1/K2 (64 planes of 406 × 403, out 524², transforms
   drawn from ``medical_augment_config`` at p = 1; timed at 64 and 32
   planes one call at a time, back to back and cold, with the share of
   their blocks that read from device memory), the resample FIR
   K5–K7 (``ops/fir.py``) at the five FIR shapes of the claro step and
   four ↓2 and four ×2 shapes of StyleGAN3-T (12 taps; forward alone and
   forward + backward, one call at a time, back to back and cold; each
   kernel also at several grid sizes), and
   the affine warp pair K3/K4 (``ops/warp.py``) at the shape of the
   unfused augment chain (64 planes of 812 × 806, out 524², bf16) and of
   the equivariance metrics (8 planes of 256², float32), each with
   adjointness and gradients of both orders (K3's bytes are the input
   samples its taps reach at the call's map), K3 timed one call at a time,
   back to back and cold, with its device time and the ctypes path's floor
   (1 plane of 1 × 1); the probes P1–P6
   (``ops/probes.py``), exact on ones and on small integers; and the 3×3
   implicit-GEMM conv pair K8/K9 (``ops/conv3x3.py``) at the six shapes
   of the claro step in the step's dtypes and at a small float32 shape,
   with gradient and gradient of gradient, K9 bitwise equal over two
   calls, and kernel, plain and library times forward and
   forward + backward (their bound reckons bf16 matrix operations at the
   tensor cores' rate); every bf16 shape must take the ``wgmma`` kernels,
   the general ``mma.sync`` kernels are held against the same references
   and timed in turns with them, and the float32 shapes are also timed on
   a cold L2;
2. trains 32 steps of the claro recipe (batch 32, cbase 16384, 1 kimg)
   through the port's CLI on a synthetic 256² dataset, with
   ``--metrics=fid1k`` at the snapshot; checks the outcome and that every
   kernel ran, and times each phase variant of the step;
3. runs ``calc_metrics`` on the run's checkpoint: fid10k and kid10k with
   the default (random projection) detector, and fid1k with a
   ``tfslim`` InceptionV3 of seeded random weights at 299²; times the
   generator pass of each detector;
4. trains StyleGAN3-T at its published width and depth (cbase 32768,
   cmax 512, 14 layers, mapping depth 2, bf16 in the 4 highest rates)
   through the CLI on the same dataset for 1 kimg at the largest batch of
   32, 16, 8 that fits the card, with ``--metrics=eqt1k_int,eqr1k`` at the
   snapshot, then runs ``calc_metrics --cfg=stylegan3-t
   --metrics=fid1k,eqr1k`` on the checkpoint; times each phase variant,
   profiles one step (FIR rows named by form and tap count), tries the
   metrics' generator pass at batch 128, 64
   and 32 (the batch the CLIs pick must fit in half the card), and prints
   the ``upfirdn2d`` calls that took the plain version because no FIR
   kernel covers their form (only the ×4 up-filters may);
5. runs the claro recipe with the augment pipe built ``impl="unfused"``
   (upsample2d → affine warp → downsample2d) for one plain and one
   +Greg+Dreg step, which launches K3 and K4, and holds the unfused
   chain against the fused one (K1) on one batch;
6. runs the probes through their entry point (``probes.run_probes``), and
   the claro step with ``conv_impl="kernel"`` (every dense 3×3 stride-1
   conv of G and D through K8/K9) in its four variants beside the library
   route from the same state and seed (every bf16 conv of it must take
   the ``wgmma`` kernels), profiles one step of it, and takes one plain
   step with every augment section on;
7. trains the claro recipe for 2 kimg through the CLI with
   ``--metric-async`` (fid1k at kimg 1 on a background thread over a copy
   of G_ema, at kimg 2 in the loop): the rows, the copy's size and time,
   the peak device memory with the thread overlapping training;
8. prints the kernel report and, last, the device line.

Any failed check raises, so the exit code is non-zero.  Without a CUDA
device the script exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
NET_ARGS = ["--cbase=16384", "--cmax=512", "--map-depth=2"]
CLARO_ARGS = [
    "--cfg=stylegan2", "--batch=32", "--gamma=0.4096", *NET_ARGS, "--glr=0.0025",
    "--dlr=0.0025", "--aug=ada", "--target=0.6", "--mirror=1", "--kimg=1", "--tick=1",
    "--snap=1", "--metrics=fid1k",
]
# name: (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "upwarp": ("upwarp.cu", "gantrack_tpu/ops/pallas/upwarp.py:137"),
    "upsplat": ("upwarp.cu", "gantrack_tpu/ops/pallas/upwarp.py:179"),
    "fir_same": ("fir.cu", "gantrack_tpu/ops/attic/fir.py:100"),
    "fir_down2": ("fir.cu", "gantrack_tpu/ops/attic/fir.py:117"),
    "fir_up2": ("fir.cu", "gantrack_tpu/ops/attic/fir.py:144"),
    "warp": ("warp.cu", "gantrack_tpu/ops/pallas/warp.py:87"),
    "splat": ("warp.cu", "gantrack_tpu/ops/pallas/warp.py:114"),
    "conv3x3": ("conv3x3.cu", "gantrack_tpu/ops/attic/conv3x3.py:145"),
    "wgrad3x3": ("conv3x3.cu", "gantrack_tpu/ops/attic/conv3x3.py:188"),
    "probe_matmul": ("probe.cu", "scripts/probe_matmul.py:25"),
    "probe_halo_tile": ("probe.cu", "scripts/probe_mosaic.py:33"),
    "probe_padded_tile": ("probe.cu", "scripts/probe_mosaic.py:62"),
    "probe_ring": ("probe.cu", "scripts/probe_mosaic.py:91"),
    "probe_concat": ("probe.cu", "scripts/probe_mosaic.py:113"),
    "probe_row_slice": ("probe.cu", "scripts/probe_mosaic.py:130"),
}
# Published peaks of one H100 SXM: device memory rate, float32 outside the
# tensor cores (the elementwise and FIR kernels sum in float32 on CUDA
# cores), and dense bf16 on the tensor cores (the matrix kernels).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
# The dense 3x3 stride-1 convs of the claro step at batch 32: (Ci, Co, H),
# the step's dtype there and the batch sizes the step gives the layer.  D
# b256..b8 conv0 and G b8..b256 conv1 share the first six; then G b4 conv1
# and D's epilogue conv (512 channels and the minibatch-stddev map) at 4x4,
# an image smaller than the kernels' tile.  G's layers see the batch and,
# in the path-length pass, half of it; D's see the batch (G's loss, R1) and
# twice it (D's loss on the generated and the real images together).
# Everything is checked and timed at the first batch size of a shape; at
# the others K8, K9 and K9's determinism are checked.
_G_AND_D, _G, _D = (32, 16, 64), (32, 16), (64, 32)
CONV_SHAPES = [
    (64, 64, 256, "bf16", _G_AND_D), (128, 128, 128, "bf16", _G_AND_D),
    (256, 256, 64, "bf16", _G_AND_D), (512, 512, 32, "bf16", _G_AND_D),
    (512, 512, 16, "f32", _G_AND_D), (512, 512, 8, "f32", _G_AND_D),
    (512, 512, 4, "f32", _G), (513, 512, 4, "f32", _D),
]
# The 3x3 layers of the claro networks that are no stride-1 conv (G conv0
# up 2, D conv1 down 2) and stay on the library under conv_impl="kernel",
# as ``conv3x3.library_reason`` words them.  The 1x1 layers (to/from RGB,
# skips) take no conv_impl at all.
CLARO_LIBRARY_ROUTE = ("up=2, down=1", "up=1, down=2")
EVERY_AUG_OPT = ("xflip,rotate90,xint,scale,rotate,aniso,xfrac,brightness,contrast,lumaflip,hue,"
                 "saturation,imgfilter,noise,cutout")
SG3_ARGS = [
    "--cfg=stylegan3-t", "--gamma=0.4096", "--cbase=32768", "--cmax=512", "--glr=0.0025",
    "--dlr=0.0025", "--aug=ada", "--target=0.6", "--mirror=1", "--kimg=1", "--tick=1",
    "--snap=1", "--metrics=eqt1k_int,eqr1k",
]
# The only upfirdn2d calls of StyleGAN3-T that no FIR kernel covers (the
# reason as ``fir.fir_spec`` words it): the x4 up-filters of its layers.
SG3_T_PLAIN_ROUTE = ("up=4, down=1",)
# The FIR calls of phase 1: name, [N, C, H, W], dtype of the step, then
# the upfirdn2d arguments.  The first of each form is the one the kernel
# report quotes: for K5 the claro step's, for K6 and K7 StyleGAN3-T's
# largest call, where most of their time is (the claro image skip moves
# 2 MB, so its time is the wrapper's host work).
FIR_SHAPES = [
    ("G up-conv post-filter (same)", (32, 64, 259, 259), "bf16",
     dict(filter="f4", padding=0, gain=4)),
    ("D down-conv pre-filter (same, pads 2)", (32, 64, 256, 256), "bf16",
     dict(filter="f4", padding=2)),
] + [
    # StyleGAN3-T's ↓2 down-filters at batch 16 (filtered_lrelu of its
    # layers, on the canvas the ×2 or ×4 up-filter made): 12 taps, pads 0.
    (f"StyleGAN3-T {label} (down2, 12 taps)", shape, dtype,
     dict(filter="sg3", down=2, padding=0))
    for label, shape, dtype in (
        ("562² -> 276²", (16, 256, 562, 562), "bf16"),
        ("522² -> 256²", (16, 128, 522, 522), "bf16"),
        ("306² -> 148²", (16, 512, 306, 306), "bf16"),
        ("82² -> 36²", (16, 512, 82, 82), "f32"))
] + [
    ("D skip (down2)", (32, 64, 256, 256), "bf16", dict(filter="f4", down=2, padding=1)),
    ("augment crop-downsample (down2, 12 taps)", (64, 1, 524, 524), "bf16",
     dict(filter="sym6", down=2, padding=-1, flip_filter=True)),
] + [
    # StyleGAN3-T's ×2 up-filters at batch 16 (filtered_lrelu of its
    # layers): 12 taps, gain 4, the pads of the up-rate grid.
    (f"StyleGAN3-T {label} (up2, 12 taps)", shape, dtype,
     dict(filter="sg3", up=2, padding=[p0, p1, p0, p1], gain=4))
    for label, shape, dtype, (p0, p1) in (
        ("278² -> 562²", (16, 128, 278, 278), "bf16", (9, 8)),
        ("278² -> 522² (cropping pads)", (16, 128, 278, 278), "bf16", (-11, -12)),
        ("86² -> 178²", (16, 512, 86, 86), "bf16", (9, 8)),
        ("38² -> 82²", (16, 512, 38, 38), "f32", (9, 8)))
] + [
    ("G image skip upsample2d (up2)", (32, 1, 128, 128), "f32",
     dict(filter="f4", up=2, padding=[2, 1, 2, 1], gain=4)),
]
# Grid sizes of the FIR kernels (blocks an SM) timed beside their own
# choice (``kBlocksPerSM``, ``kUpBlocksPerSM`` of csrc/fir.cu).
FIR_BLOCKS_PER_SM = (2, 4, 8, 16, 32, 64, 128, 256, 1024)
# Plane counts of the augment's K1/K2 calls: Dmain's fake ‖ real, Gmain's.
UPWARP_PLANES = (64, 32)
# A 12-tap StyleGAN3 low-pass of the ×2 layers (Kaiser, as the generator
# designs it: numtaps, cutoff, transition width, sampling rate).
SG3_FILTER = (12, 32.0, 16.0, 128.0)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _cli_device(cli, args):
    """The device the training CLI picks for ``args``: the card, which
    every check of a run's launches below relies on."""
    import torch

    device = torch.device(cli.build_parser().parse_args(
        ["--outdir=", "--data=", "--batch=1", *args]).device)
    if device.type != "cuda":
        raise AssertionError(f"the CLI picked {device}, not the card")
    return device


def _max_err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def _check(name: str, err: float, limit: float) -> None:
    ok = err <= limit
    print(f"  {name}: err {err:.3e}  limit {limit:.3e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: error {err} above limit {limit}")


def _bound(nbytes: float, flops: float, flop_rate: float = F32_FLOP_PER_S) -> dict:
    """The least time (ms) the card could take: each input read once and
    each output written once over the memory rate, or the operations over
    ``flop_rate`` (float32 on the CUDA cores; ``BF16_TC_FLOP_PER_S`` for a
    bf16 matrix kernel), whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _reset(*counters) -> None:
    for counter in counters:
        for k in counter:
            counter[k] = 0


def _kernel_counters() -> list:
    from gantrack_tpu_torch.ops import conv3x3 as c3
    from gantrack_tpu_torch.ops import fir, probes
    from gantrack_tpu_torch.ops import upwarp as uw
    from gantrack_tpu_torch.ops import warp as wp

    return [uw.LAUNCHES, fir.LAUNCHES, wp.LAUNCHES, c3.LAUNCHES, c3.VARIANTS, probes.LAUNCHES]


def _reset_launches() -> None:
    """Every kernel's count, and the plain- and library-route counts, to 0."""
    from gantrack_tpu_torch.ops import conv3x3 as c3
    from gantrack_tpu_torch.ops import fir

    _reset(*_kernel_counters())
    fir.PLAIN_ROUTE.clear()
    c3.LIBRARY_ROUTE.clear()


def _read_launches(must_run, plain_route=(), library_route=None) -> dict:
    """The kernels' launch counts since the last reset; raises if one of
    ``must_run`` was launched no time, or if an ``upfirdn2d`` call took
    the plain version for another reason than those of ``plain_route``
    (none, for a path whose FIR calls all lie inside the kernels'
    contract).  ``library_route`` is None for a path on the default
    ``conv_impl="library"``, which must launch no conv3x3 kernel; on the
    kernel route it names the only reasons a conv may stay on the library."""
    from gantrack_tpu_torch.ops import conv3x3 as c3
    from gantrack_tpu_torch.ops import fir

    counts = {k: n for counter in _kernel_counters() for k, n in counter.items()}
    for k in must_run:
        if counts[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by this run: {counts}")
    if not set(fir.PLAIN_ROUTE) <= set(plain_route):
        raise AssertionError(f"FIR calls left the kernels for the plain version: "
                             f"{fir.PLAIN_ROUTE}; allowed on this path: {list(plain_route)}")
    if library_route is None and (counts["conv3x3"] or counts["wgrad3x3"] or c3.LIBRARY_ROUTE):
        raise AssertionError(f"the default conv route launched conv3x3 kernels: {counts}")
    if not set(c3.LIBRARY_ROUTE) <= set(library_route or ()):
        raise AssertionError(f"convs left the kernel route for the library: {c3.LIBRARY_ROUTE}; "
                             f"allowed on this path: {list(library_route)}")
    return counts


_L2_FLUSH = []


def _median_ms(fn, reps: int = 20, cold: bool = False) -> float:
    """Median time of ``fn`` over ``reps`` launches (CUDA events), one
    call at a time: each is synchronised, so the wrapper's host work of a
    call is inside its time.  The launches follow each other, so what fits
    the 50 MB L2 stays there; ``cold`` writes a 256 MB buffer before each
    timed launch (outside the events), so that ``fn`` finds its inputs in
    device memory."""
    import torch

    if cold and not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"))
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if cold:
            _L2_FLUSH[0].zero_()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _b2b_ms(fn, reps: int = 20) -> float:
    """Mean time of ``fn`` over ``reps`` calls back to back between two
    CUDA events: the host enqueues ahead of the device, so a call's host
    work hides behind the previous call's kernels."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _count_hgmma(library: str) -> str:
    """How many ``HGMMA`` instructions (what ``wgmma`` compiles to) the built
    library holds, where the toolkit has ``cuobjdump``."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return "no cuobjdump in the toolkit: HGMMA instructions not counted"
    sass = subprocess.run([tool, "-sass", library], capture_output=True, text=True)
    if sass.returncode != 0:
        return f"cuobjdump failed ({sass.returncode}): HGMMA instructions not counted"
    n = sum("HGMMA" in line for line in sass.stdout.splitlines())
    if n == 0:
        raise AssertionError(f"no HGMMA instruction in {library}: the wgmma kernels are not in it")
    return f"{n} HGMMA instructions in the built library (cuobjdump -sass)"


def _upwarp_case(n: int, seed: int = 0):
    """The augment's K1/K2 call on ``n`` planes: transforms drawn from
    ``medical_augment_config`` at p = 1 on the card, their coefficients,
    the FIR (taps and tensor) and the shapes ``(h1, w1, oh, ow)``."""
    import torch

    from gantrack_tpu_torch.ops import upwarp as uw
    from gantrack_tpu_torch.training.augment import AugmentPipe, medical_augment_config

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    pipe = AugmentPipe(medical_augment_config(), 256, 256, 1)
    theta, oh, ow = pipe.warp_geometry(pipe.sample_geometric(n, 1.0, dev, gen))
    mx0, mx1, my0, my1 = pipe.margin
    h1, w1 = 256 + my0 + my1, 256 + mx0 + mx1
    coeffs = uw.warp_coefficients(theta, 2 * h1, 2 * w1, oh, ow)
    return coeffs, pipe.hz_geom_taps, pipe.hz_geom.to(dev), (h1, w1, oh, ow), gen


def time_upwarp(card: str) -> dict:
    """K1 and K2 in bf16 at the augment's shapes, 64 planes (Dmain: fake ‖
    real) and 32 (Gmain), one call at a time, back to back and on a cold
    L2 (``_median_ms``, ``_b2b_ms``).  It passes only the wrappers' common
    arguments, so it times another checkout's package as well.  Returns
    {planes: {kernel: (one call, back to back, cold)}} in ms."""
    import torch

    from gantrack_tpu_torch.ops import upwarp as uw

    out = {}
    for n in UPWARP_PLANES:
        coeffs, taps, _, (h1, w1, oh, ow), gen = _upwarp_case(n)
        xb = torch.randn((n, h1, w1), device="cuda", generator=gen).bfloat16()
        gb = torch.randn((n, oh, ow), device="cuda", generator=gen).bfloat16()
        calls = {"K1": lambda: uw.upwarp_planes(xb, coeffs, taps, oh, ow),
                 "K2": lambda: uw.upsplat_planes(gb, coeffs, taps, h1, w1)}
        out[n] = {name: (_median_ms(fn), _b2b_ms(fn), _median_ms(fn, cold=True))
                  for name, fn in calls.items()}
        print(f"  upwarp pair, bf16 {n} x {h1}x{w1} <-> {oh}x{ow}, on {card}, ms (one call at a "
              f"time / back to back / cold L2): "
              + "; ".join(f"{name} {t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f}"
                          for name, t in out[n].items()))
        del xb, gb
    return out


def check_kernels(card: str) -> dict:
    """Phase 1: K1/K2 against the plain version at the augment's shapes,
    their times (``time_upwarp``) and the share of their blocks that read
    from device memory (K1's direct gather, K2's unstaged cotangents).
    Returns {kernel: {max_abs_err, ms, ms_b2b, plain_ms, ...}} at 64
    planes: ``ms`` one call at a time, as for every kernel of the line,
    ``ms_b2b`` back to back."""
    import torch
    import torch.nn.functional as F

    from gantrack_tpu_torch.ops import upwarp as uw

    # The plain versions run through cuDNN: keep it out of TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    n = UPWARP_PLANES[0]
    coeffs, taps, fir, (h1, w1, oh, ow), gen = _upwarp_case(n)
    print(f"phase 1: {n} planes {h1}x{w1} -> {oh}x{ow}")

    def plain(x, c=coeffs):
        return uw.up_affine_warp_plain(x[:, None], c, fir, oh, ow)[:, 0]

    def plain_adjoint(g, c=coeffs):
        x = torch.zeros((g.shape[0], h1, w1), device=dev, dtype=g.dtype, requires_grad=True)
        return torch.autograd.grad(plain(x, c), x, g)[0]

    x = torch.randn((n, h1, w1), device=dev, generator=gen)
    g = torch.randn((n, oh, ow), device=dev, generator=gen)

    # f32: same sample positions, the sums run in another order.
    ref = plain(x)
    err_k1 = _max_err(uw.upwarp_planes(x, coeffs, taps, oh, ow), ref)
    _check("K1 f32 vs plain", err_k1, 1e-5 * float(ref.abs().max()))
    ref2 = plain_adjoint(g)
    k2 = uw.upsplat_planes(g, coeffs, taps, h1, w1)
    err_k2 = _max_err(k2, ref2)
    _check("K2 f32 vs plain adjoint", err_k2, 1e-5 * float(ref2.abs().max()))
    # bf16 input, f32 sums: against the plain version in f32 on the same
    # bf16-rounded input; the bf16 rounding of the output dominates.
    xb, gb = x.bfloat16(), g.bfloat16()
    refb = plain(xb.float())
    err_k1b = _max_err(uw.upwarp_planes(xb, coeffs, taps, oh, ow), refb)
    _check("K1 bf16 vs plain", err_k1b, 1e-2 * float(refb.abs().max()))
    refb2 = plain_adjoint(gb.float())
    _check("K2 bf16 vs plain adjoint", _max_err(uw.upsplat_planes(gb, coeffs, taps, h1, w1), refb2),
           1e-2 * float(refb2.abs().max()))
    # Adjointness <K1 x, g> = <x, K2 g>.
    lhs = float((uw.upwarp_planes(x, coeffs, taps, oh, ow).double() * g.double()).sum())
    rhs = float((x.double() * k2.double()).sum())
    _check("adjointness <K1 x,g> vs <x,K2 g> (relative)", abs(lhs - rhs) / abs(lhs), 1e-5)
    same = torch.equal(k2, uw.upsplat_planes(g, coeffs, taps, h1, w1))
    print(f"  K2 bitwise deterministic over two calls: {same}")
    if not same:
        raise AssertionError("K2 is not bitwise deterministic")
    # The blocks whose box exceeded the shared buffer at the augment's draws
    # (p = 1): K1's direct gather, K2's cotangents read from device memory.
    direct = torch.zeros(1, dtype=torch.int32, device=dev)
    unstaged = torch.zeros(1, dtype=torch.int32, device=dev)
    uw.upwarp_planes(xb, coeffs, taps, oh, ow, direct_blocks=direct)
    uw.upsplat_planes(gb, coeffs, taps, h1, w1, global_blocks=unstaged)
    for name, count, blocks in (("K1 blocks that took the direct gather", direct,
                                 uw.upwarp_blocks(n, oh, ow)),
                                ("K2 blocks that read their cotangents from device memory",
                                 unstaged, uw.upsplat_blocks(n, h1, w1))):
        print(f"  {name} at the augment's draws (p = 1): {int(count)} of {blocks} "
              f"({100 * int(count) / blocks:.2f} %)")

    # Gradient and gradient-of-gradient through UpWarp (an R1-like
    # penalty), on 4 planes, against autograd of the plain version.
    c4 = coeffs[:4].contiguous()
    w = torch.randn((4, oh, ow), device=dev, generator=gen)

    def r1_like(warp):
        x4 = x[:4].clone().requires_grad_(True)
        loss = (F.softplus(warp(x4)) * w).sum()
        (gx,) = torch.autograd.grad(loss, x4, create_graph=True)
        (ggx,) = torch.autograd.grad(gx.square().sum(), x4)
        return gx.detach(), ggx

    gk, ggk = r1_like(lambda t: uw.UpWarp.apply(t, c4, taps, oh, ow))
    gp, ggp = r1_like(lambda t: plain(t, c4))
    _check("grad through UpWarp vs plain", _max_err(gk, gp), 1e-5 * float(gp.abs().max()))
    _check("grad-of-grad through UpWarp vs plain", _max_err(ggk, ggp), 1e-5 * float(ggp.abs().max()))

    # Times at the training dtype (bf16).
    t = time_upwarp(card)
    t_p1 = _median_ms(lambda: plain(xb), 5)
    t_p2 = _median_ms(lambda: plain_adjoint(gb), 5)
    # Bound: planes and output moved once; per output pixel 2 x 7 folded
    # weights (~4 flops each) and a 7 x 7 weighted sum (2 flops a tap).  K2 is
    # the transpose: the same products.  No single PyTorch call computes
    # either (upsample + grid_sample is two), so there is no library time.
    flops = n * oh * ow * (2 * 49 + 2 * 7 * 4)
    b1 = _bound(_nbytes(xb, gb, coeffs), flops)
    print(f"  plain versions (bf16, one call at a time, median of 5) on {card}: K1 {t_p1:.4f} ms, "
          f"K2 {t_p2:.4f} ms; bound {b1['bound_ms']:.4f} ms ({b1['bound_by']}) for each at "
          f"{n} planes")
    return {
        "upwarp": {"max_abs_err": err_k1, "ms": t[n]["K1"][0], "ms_b2b": t[n]["K1"][1],
                   "plain_ms": t_p1, **b1,
                   "library_ms": None, "dtype": "bf16", "library_dtype": None,
                   "ms_at_library_dtype": None},
        "upsplat": {"max_abs_err": err_k2, "ms": t[n]["K2"][0], "ms_b2b": t[n]["K2"][1],
                    "plain_ms": t_p2, **b1,
                    "library_ms": None, "dtype": "bf16", "library_dtype": None,
                    "ms_at_library_dtype": None},
    }


def check_fir(card: str) -> dict:
    """Phase 1 (FIR): K5–K7 against the plain ``upfirdn2d`` at the step's
    FIR shapes, and at StyleGAN3-T's ↓2 and ×2 shapes.  Each shape is timed
    forward alone and forward + backward, one call at a time, back to back
    and (forward) on a cold L2, beside its bound and the one library call
    that computes it, and the kernel is also timed at the grid sizes of
    ``FIR_BLOCKS_PER_SM``.  Returns {kernel: {max_abs_err, ms,
    plain_ms, ...}} for the first shape of each form: the forward alone
    (the kernel itself; its backward is the adjoint form's kernel), one
    call at a time."""
    import importlib

    import torch
    import torch.nn.functional as F

    from gantrack_tpu_torch.models.stylegan3 import design_lowpass_filter
    from gantrack_tpu_torch.ops import fir
    from gantrack_tpu_torch.training.augment import WAVELETS

    ufd = importlib.import_module("gantrack_tpu_torch.ops.upfirdn2d")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    filters = {"f4": ufd.setup_filter([1, 3, 3, 1]), "sym6": ufd.setup_filter(WAVELETS["sym6"]),
               "sg3": torch.from_numpy(design_lowpass_filter(*SG3_FILTER))}
    report = {}
    for label, shape, step_dtype, call in FIR_SHAPES:
        kw = dict(call)
        f_host = filters[kw.pop("filter")]
        f, taps = f_host.to(dev), ufd.filter_taps(f_host)
        spec, _ = fir.fir_spec(f_host, taps, kw.get("up", 1), kw.get("down", 1),
                               kw.get("padding", 0), kw.get("flip_filter", False),
                               kw.get("gain", 1))
        name = f"fir_{spec.form}"

        def kernel(x):
            return ufd.upfirdn2d(x, f, taps=taps, **kw)

        def plain(x):
            return ufd.upfirdn2d_plain(x, f, **kw)

        x = torch.randn(shape, device=dev, generator=gen)
        ref = plain(x)
        got = kernel(x)
        print(f"phase 1 FIR {label}: {list(shape)} -> {list(ref.shape)} ({name}, pads "
              f"{spec.pads})")
        err = _max_err(got, ref)
        _check(f"{name} f32 vs plain", err, 1e-5 * float(ref.abs().max()))
        xb = x.bfloat16()  # bf16 input, f32 sums: the output's rounding dominates
        refb = plain(xb.float())
        _check(f"{name} bf16 vs plain", _max_err(kernel(xb), refb), 1e-2 * float(refb.abs().max()))
        del refb
        # Adjointness <K x, g> = <x, K^T g> through the adjoint kernel.
        g = torch.randn(ref.shape, device=dev, generator=gen)
        n, c, h, w = shape
        ktg = fir.fir_planes(g.reshape(n * c, *ref.shape[2:]), spec.adjoint(h, w))
        lhs = float((got.double() * g.double()).sum())
        rhs = float((x.reshape(n * c, h, w).double() * ktg.double()).sum())
        _check(f"{name} adjointness (relative)", abs(lhs - rhs) / abs(lhs), 1e-5)
        # Gradient and gradient of gradient (an R1-like penalty) on 2 images.
        x2, w2 = x[:2].contiguous(), torch.randn(ref[:2].shape, device=dev, generator=gen)

        def r1_like(fn):
            xs = x2.clone().requires_grad_(True)
            (gx,) = torch.autograd.grad((F.softplus(fn(xs)) * w2).sum(), xs, create_graph=True)
            (ggx,) = torch.autograd.grad(gx.square().sum(), xs)
            return gx.detach(), ggx

        (gk, ggk), (gp, ggp) = r1_like(kernel), r1_like(plain)
        _check(f"{name} grad vs plain", _max_err(gk, gp), 1e-5 * float(gp.abs().max()))
        _check(f"{name} grad-of-grad vs plain", _max_err(ggk, ggp), 1e-5 * float(ggp.abs().max()))
        del gk, ggk, gp, ggp, x2, w2
        # The one PyTorch call: a depthwise conv (stride 1 or 2, after a view
        # that crops), or the depthwise transposed conv (stride 2).
        lib32 = _fir_library_call(spec, c, dev, torch.float32)
        if lib32 is not None:
            _check(f"{name} library call vs plain (f32, same function)",
                   _max_err(lib32(x), ref), 1e-5 * float(ref.abs().max()))
        # Times at the step's dtype, median of 20 (or of 5: ``slow``).
        xs = xb if step_dtype == "bf16" else x
        xt = xs.clone().requires_grad_(True)
        gt = g.to(xt.dtype)
        del ref, got, ktg, lib32
        lib = _fir_library_call(spec, c, dev, xt.dtype)
        # The plain version and the library's depthwise transposed conv take
        # 10-100 ms a call at StyleGAN3's shapes: 5 of those, 20 of the rest.
        slow = 5 if gt.numel() >= 5e7 else 20
        t = {"fwd": _median_ms(lambda: kernel(xs)), "fwd b2b": _b2b_ms(lambda: kernel(xs)),
             "fwd cold": _median_ms(lambda: kernel(xs), cold=True),
             "fb": _median_ms(lambda: torch.autograd.grad(kernel(xt), xt, gt)),
             "fb b2b": _b2b_ms(lambda: torch.autograd.grad(kernel(xt), xt, gt)),
             "fwd plain": _median_ms(lambda: plain(xs), slow),
             "fb plain": _median_ms(lambda: torch.autograd.grad(plain(xt), xt, gt), slow)}
        if lib is not None:
            t.update({"lib fwd": _median_ms(lambda: lib(xs), slow),
                      "lib fwd b2b": _b2b_ms(lambda: lib(xs), slow),
                      "lib fwd cold": _median_ms(lambda: lib(xs), slow, cold=True),
                      "lib fb": _median_ms(lambda: torch.autograd.grad(lib(xt), xt, gt), slow),
                      "lib fb b2b": _b2b_ms(lambda: torch.autograd.grad(lib(xt), xt, gt), slow)})
        # Bound of the forward: x and the output once; a separable pass of
        # ky then kx taps per output (half of them for the polyphase up2),
        # 2 flops a tap.  Forward + backward: twice that.
        ky, kx = len(spec.taps_y), len(spec.taps_x)
        taps_per_out = (ky + kx) / (2 if spec.form == "up2" else 1)
        bound_f = _bound(_nbytes(xt, gt), gt.numel() * 2 * taps_per_out)
        bound = _bound(2 * _nbytes(xt, gt), 2 * gt.numel() * 2 * taps_per_out)

        def three(prefix):
            if f"{prefix}fwd" not in t:
                return "none (no single call)"
            return (f"{t[prefix + 'fwd']:.4f} / {t[prefix + 'fwd b2b']:.4f} / "
                    f"{t[prefix + 'fwd cold']:.4f}")

        fb_lib = (f"{t['lib fb']:.4f} / {t['lib fb b2b']:.4f}" if lib is not None
                  else "none (no single call)")
        print(f"  {name} {step_dtype} on {card}, ms (one call at a time / back to back / cold L2): "
              f"forward kernel {three('')}, library {three('lib ')}, bound "
              f"{bound_f['bound_ms']:.4f} ({bound_f['bound_by']}); forward+backward (one call at "
              f"a time / back to back) kernel {t['fb']:.4f} / {t['fb b2b']:.4f}, library {fb_lib}, "
              f"plain {t['fb plain']:.4f}, bound {bound['bound_ms']:.4f} ({bound['bound_by']}); "
              f"forward plain {t['fwd plain']:.4f}")
        planes = xs.reshape(n * c, h, w)
        grid = {bps: _b2b_ms(lambda: fir.fir_planes(planes, spec, blocks_per_sm=bps))
                for bps in FIR_BLOCKS_PER_SM}
        print(f"  {name} grid on {card}: forward ms back to back by blocks an SM "
              + ", ".join(f"{bps}: {ms:.4f}" for bps, ms in grid.items())
              + f"; fastest {min(grid, key=grid.get)}; the kernel's own choice "
              f"{_b2b_ms(lambda: fir.fir_planes(planes, spec)):.4f}")
        del planes
        if name not in report:
            # Kernel, plain version and library call all run at the step's dtype.
            t_l = t.get("lib fwd")
            report[name] = {"max_abs_err": err, "ms": t["fwd"], "plain_ms": t["fwd plain"],
                            **bound_f, "library_ms": t_l, "dtype": step_dtype,
                            "library_dtype": step_dtype if t_l is not None else None,
                            "ms_at_library_dtype": t["fwd"] if t_l is not None else None}
        del x, xb, xs, xt, g, gt, lib
        torch.cuda.empty_cache()
    return report


def _fir_library_call(spec, channels: int, dev, dtype):
    """One ``torch.nn.functional`` call that computes the FIR of ``spec``
    on ``[N, channels, H, W]``, or None where no one call does: for same
    and down2 the depthwise ``F.conv2d`` (stride 1 or 2) where each axis
    has equal pads or pads ≤ 0 (a view crops those first); for up2 the
    depthwise ``F.conv_transpose2d(stride=2, padding=q)`` with
    q = k − 1 − p0 ≥ 0 and p1 = p0 − 1 (p1 = p0 through
    ``output_padding``)."""
    import torch
    import torch.nn.functional as F

    ty = torch.tensor(spec.taps_y, dtype=torch.float64)
    tx = torch.tensor(spec.taps_x, dtype=torch.float64)
    w2 = torch.outer(ty, tx)  # correlation taps, gain folded in
    py0, py1, px0, px1 = spec.pads
    ky, kx = len(ty), len(tx)
    if spec.form == "up2":
        q, extra = (ky - 1 - py0, kx - 1 - px0), (py1 - py0 + 1, px1 - px0 + 1)
        if min(q) < 0 or not set(extra) <= {0, 1}:
            return None
        w = w2.flip([0, 1]).to(dev, dtype)[None, None].repeat(channels, 1, 1, 1)
        return lambda x: F.conv_transpose2d(x, w, stride=2, padding=q, output_padding=extra,
                                            groups=channels)
    w = w2.to(dev, dtype)[None, None].repeat(channels, 1, 1, 1)
    stride = 2 if spec.form == "down2" else 1
    if py0 == py1 >= 0 and px0 == px1 >= 0:
        return lambda x: F.conv2d(x, w, stride=stride, padding=(py0, px0), groups=channels)
    if max(spec.pads) <= 0:
        def crop_conv(x):
            h, wd = x.shape[2:]
            return F.conv2d(x[:, :, -py0:h + py1, -px0:wd + px1], w, stride=stride,
                            groups=channels)
        return crop_conv
    return None


def _warp_cases(seed: int = 2):
    """K3's two calls on the card: the unfused augment chain's (bf16 in the
    step, 64 planes of 812 × 806 → 524², transforms drawn from
    ``medical_augment_config`` at p = 1) and the equivariance metrics'
    (float32, 8 planes of 256², rotations).  Returns [(label, theta, h, w,
    oh, ow, step dtype)] and the generator, drawn on past the thetas."""
    import torch

    from gantrack_tpu_torch.training.augment import AugmentPipe, medical_augment_config

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    pipe = AugmentPipe(medical_augment_config(), 256, 256, 1, impl="unfused")
    theta_aug, oh_aug, ow_aug = pipe.warp_geometry(pipe.sample_geometric(64, 1.0, dev, gen))
    mx0, mx1, my0, my1 = pipe.margin
    angle = torch.rand(8, device=dev, generator=gen) * 6.28
    zeros = torch.zeros_like(angle)
    theta_eq = torch.stack([torch.stack([angle.cos(), angle.sin(), zeros], 1),
                            torch.stack([-angle.sin(), angle.cos(), zeros], 1)], 1)
    return [
        ("unfused augment chain", theta_aug, 2 * (256 + my0 + my1), 2 * (256 + mx0 + mx1),
         oh_aug, ow_aug, "bf16"),
        ("equivariance metrics (eqr)", theta_eq, 256, 256, 256, 256, "f32"),
    ], gen


def _device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device time (ms) of a launch of the kernel whose name holds
    ``kernel`` over ``reps`` calls of ``fn`` (one launch each), as
    ``torch.profiler`` reads them; NaN where it saw none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [ev.device_time for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA and kernel in ev.name]
    if len(times) != reps:
        print(f"  the profiler saw {len(times)} of {reps} launches of {kernel}")
    return sum(times) / 1e3 / len(times) if times else float("nan")


def _warp_reads(coeffs, h: int, w: int, oh: int, ow: int):
    """What K3 reads at this map: the number of input samples (of
    ``P × h × w``) that some output's taps reach with a nonzero weight, as
    ``warp_kernel``'s ``axis_taps`` takes them, and the number of outputs
    (of ``P × oh × ow``) that read any sample."""
    import torch

    from gantrack_tpu_torch.ops.grid_sample import sample_positions

    def taps(f, n):
        fl = torch.floor(f)
        on = (fl >= -1) & (fl <= n - 1)
        w1 = f - fl
        i0 = torch.where(on, fl, torch.zeros_like(fl)).long()
        return i0, on & (i0 >= 0) & (1 - w1 != 0), on & (i0 + 1 < n) & (w1 != 0)

    read = hit = 0
    for p in range(coeffs.shape[0]):
        fx, fy = sample_positions(coeffs[p:p + 1], oh, ow)
        x0, rx0, rx1 = taps(fx[0], w)
        y0, ry0, ry1 = taps(fy[0], h)
        seen = torch.zeros(h * w, dtype=torch.bool, device=coeffs.device)
        any_tap = torch.zeros_like(rx0)
        for dy, ry in ((0, ry0), (1, ry1)):
            for dx, rx in ((0, rx0), (1, rx1)):
                m = ry & rx
                seen[((y0 + dy) * w + x0 + dx)[m]] = True
                any_tap |= m
        read += int(seen.sum())
        hit += int(any_tap.sum())
    return read, hit


def time_warp(card: str) -> dict:
    """K3 at its two calls (``_warp_cases``) one call at a time, back to
    back and on a cold L2 (``_median_ms``, ``_b2b_ms``), with its device
    time from the profiler; and the ctypes path's floor: ``warp_planes``
    on 1 plane of 1 × 1 → 1 × 1, one call at a time and back to back.  It
    passes only the wrappers' common arguments, so it times another
    checkout's package as well.  Returns {label: {"one", "b2b", "cold",
    "device"}, "floor": {"one", "b2b"}} in ms."""
    import torch

    from gantrack_tpu_torch.ops import warp as wp
    from gantrack_tpu_torch.ops.grid_sample import warp_coefficients

    cases, gen = _warp_cases()
    out = {}
    for label, theta, h, w, oh, ow, dtype in cases:
        n = theta.shape[0]
        coeffs = warp_coefficients(theta, h, w, oh, ow)
        x = torch.randn((n, h, w), device="cuda", generator=gen)
        x = x.bfloat16() if dtype == "bf16" else x

        def k3():
            return wp.warp_planes(x, coeffs, oh, ow)

        t = {"one": _median_ms(k3), "b2b": _b2b_ms(k3), "cold": _median_ms(k3, cold=True),
             "device": _device_ms(k3, "warp_kernel")}
        out[label] = t
        print(f"  K3, {dtype} {n} x {h}x{w} -> {oh}x{ow} ({label}), on {card}, ms: one call at a "
              f"time {t['one']:.4f} / back to back {t['b2b']:.4f} / cold L2 {t['cold']:.4f}; "
              f"device time (profiler, mean of 20) {t['device']:.4f}")
        del x
    x1 = torch.randn((1, 1, 1), device="cuda", generator=gen)
    c1 = warp_coefficients(torch.eye(2, 3, device="cuda")[None], 1, 1, 1, 1)
    floor = {"one": _median_ms(lambda: wp.warp_planes(x1, c1, 1, 1)),
             "b2b": _b2b_ms(lambda: wp.warp_planes(x1, c1, 1, 1))}
    out["floor"] = floor
    print(f"  K3's ctypes path's floor (warp_planes, 1 plane 1x1 -> 1x1) on {card}: one call at "
          f"a time {floor['one']:.4f} ms, back to back {floor['b2b']:.4f} ms")
    return out


def check_warp(card: str) -> dict:
    """Phase 1 (warp): K3/K4 against ``affine_warp_plain`` at the shape of
    the unfused augment chain (bf16 in the step) and of the equivariance
    metrics (float32), K3's times (``time_warp``).  Returns the report of
    the first shape: ``ms`` one call at a time, ``ms_b2b`` back to back."""
    import torch
    import torch.nn.functional as F

    from gantrack_tpu_torch.ops import warp as wp
    from gantrack_tpu_torch.ops.grid_sample import warp_coefficients

    dev = torch.device("cuda")
    shapes, gen = _warp_cases()
    report = {}
    for label, theta, h, w, oh, ow, step_dtype in shapes:
        n = theta.shape[0]
        coeffs = warp_coefficients(theta, h, w, oh, ow)
        print(f"phase 1 warp, {label}: {n} planes {h}x{w} -> {oh}x{ow}")

        def plain(x, c=coeffs):
            return wp.affine_warp_plain(x[:, None], c, oh, ow)[:, 0]

        def plain_adjoint(g, c=coeffs):
            x = torch.zeros((g.shape[0], h, w), device=dev, dtype=g.dtype, requires_grad=True)
            return torch.autograd.grad(plain(x, c), x, g)[0]

        x = torch.randn((n, h, w), device=dev, generator=gen)
        g = torch.randn((n, oh, ow), device=dev, generator=gen)
        ref = plain(x)
        k3 = wp.warp_planes(x, coeffs, oh, ow)
        err_k3 = _max_err(k3, ref)
        _check("K3 f32 vs plain", err_k3, 1e-5 * float(ref.abs().max()))
        ref4 = plain_adjoint(g)
        k4 = wp.splat_planes(g, coeffs, h, w)
        err_k4 = _max_err(k4, ref4)
        _check("K4 f32 vs plain adjoint", err_k4, 1e-5 * float(ref4.abs().max()))
        xb, gb = x.bfloat16(), g.bfloat16()
        refb = plain(xb.float())
        _check("K3 bf16 vs plain", _max_err(wp.warp_planes(xb, coeffs, oh, ow), refb),
               1e-2 * float(refb.abs().max()))
        refb4 = plain_adjoint(gb.float())
        _check("K4 bf16 vs plain adjoint", _max_err(wp.splat_planes(gb, coeffs, h, w), refb4),
               1e-2 * float(refb4.abs().max()))
        lhs = float((k3.double() * g.double()).sum())
        rhs = float((x.double() * k4.double()).sum())
        _check("adjointness <K3 x,g> vs <x,K4 g> (relative)", abs(lhs - rhs) / abs(lhs), 1e-5)
        same = torch.equal(k4, wp.splat_planes(g, coeffs, h, w))
        print(f"  K4 bitwise deterministic over two calls: {same}")
        if not same:
            raise AssertionError("K4 is not bitwise deterministic")
        for planes in (xb, x):
            if not torch.equal(wp.warp_planes(planes, coeffs, oh, ow),
                               wp.warp_planes(planes, coeffs, oh, ow)):
                raise AssertionError(f"K3 {planes.dtype} is not bitwise the same over two calls")
        print("  K3 bits the same over two calls (bf16, f32): True")

        c4 = coeffs[:4].contiguous()
        wgt = torch.randn((4, oh, ow), device=dev, generator=gen)

        def r1_like(warp):
            x4 = x[:4].clone().requires_grad_(True)
            (gx,) = torch.autograd.grad((F.softplus(warp(x4)) * wgt).sum(), x4, create_graph=True)
            (ggx,) = torch.autograd.grad(gx.square().sum(), x4)
            return gx.detach(), ggx

        gk, ggk = r1_like(lambda t: wp.Warp.apply(t, c4, oh, ow))
        gp, ggp = r1_like(lambda t: plain(t, c4))
        _check("grad through Warp vs plain", _max_err(gk, gp), 1e-5 * float(gp.abs().max()))
        _check("grad-of-grad through Warp vs plain", _max_err(ggk, ggp),
               1e-5 * float(ggp.abs().max()))

        # The one PyTorch call that computes K3, and its backward for K4.
        # It runs on float32 planes also where the step's are bf16: it takes
        # grid and image in one type, and a bf16 grid rounds the positions to
        # 8 bits, which is another function.
        xs, gs = (xb, gb) if step_dtype == "bf16" else (x, g)

        def library(t):
            grid = F.affine_grid(theta.float(), (n, 1, oh, ow), align_corners=False)
            return F.grid_sample(t[:, None], grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=False)[:, 0]

        # Same function; its positions come from another order of operations.
        _check("F.grid_sample(F.affine_grid) vs plain (f32)", _max_err(library(x), ref),
               1e-3 * float(ref.abs().max()))
        xl = x.clone().requires_grad_(True)
        out_l = library(xl)
        t_p3 = _median_ms(lambda: plain(xs))
        t_l3 = _median_ms(lambda: library(x))
        t_k4 = _median_ms(lambda: wp.splat_planes(gs, coeffs, h, w))
        t_p4 = _median_ms(lambda: plain_adjoint(gs))
        t_l4 = _median_ms(lambda: torch.autograd.grad(out_l, xl, g, retain_graph=True))
        # Like against like: the kernels on the library call's float32 planes,
        # and the library's sampler alone, its grid built outside the timing.
        t_k3_f32 = _median_ms(lambda: wp.warp_planes(x, coeffs, oh, ow))
        t_k4_f32 = _median_ms(lambda: wp.splat_planes(g, coeffs, h, w))
        b2b_k4 = _b2b_ms(lambda: wp.splat_planes(g, coeffs, h, w))
        b2b_l4 = _b2b_ms(lambda: torch.autograd.grad(out_l, xl, g, retain_graph=True))
        grid = F.affine_grid(theta.float(), (n, 1, oh, ow), align_corners=False)
        t_l3_sampler = _median_ms(lambda: F.grid_sample(
            x[:, None], grid, mode="bilinear", padding_mode="zeros", align_corners=False))
        del grid
        # Bounds: per output pixel two positions (4 flops each), four weights
        # (6) and four taps (8); K4, the transpose, does the same products.
        # Bytes: K3 reads the input samples this map's taps reach and writes
        # every output; K4 reads the cotangents of the outputs that read a
        # sample and writes every input pixel; each reads the coefficients.
        read, hit = _warp_reads(coeffs, h, w, oh, ow)
        item = xs.element_size()
        bound = _bound(read * item + _nbytes(gs, coeffs), n * oh * ow * 22)
        bound4 = _bound(hit * item + _nbytes(xs, coeffs), n * oh * ow * 22)
        print(f"  K3's taps reach {read} of the {xs.numel()} input samples; {hit} of the "
              f"{gs.numel()} outputs read one")
        print(f"  times ({step_dtype}, median of 20, CUDA events) on {card}: K3 below, "
              f"plain {t_p3:.4f} ms, F.grid_sample(F.affine_grid) on f32 {t_l3:.4f} ms; K4 "
              f"{t_k4:.4f} ms, plain adjoint {t_p4:.4f} ms, its backward on f32 {t_l4:.4f} ms; "
              f"bound K3 {bound['bound_ms']:.4f} ms ({bound['bound_by']}), K4 "
              f"{bound4['bound_ms']:.4f} ms ({bound4['bound_by']})")
        print(f"  on the same f32 planes: K3 {t_k3_f32:.4f} ms against the library call "
              f"{t_l3:.4f} ms (F.grid_sample alone, grid given: {t_l3_sampler:.4f} ms); K4 "
              f"{t_k4_f32:.4f} ms against its backward {t_l4:.4f} ms (back to back: K4 "
              f"{b2b_k4:.4f} ms, backward {b2b_l4:.4f} ms)")
        if not report:
            report = {
                "warp": {"max_abs_err": err_k3, "plain_ms": t_p3, **bound,
                         "library_ms": t_l3, "dtype": step_dtype, "library_dtype": "f32",
                         "ms_at_library_dtype": t_k3_f32},
                "splat": {"max_abs_err": err_k4, "ms": t_k4, "plain_ms": t_p4, **bound4,
                          "library_ms": t_l4, "dtype": step_dtype, "library_dtype": "f32",
                          "ms_at_library_dtype": t_k4_f32},
            }
        del x, g, xb, gb, ref, ref4, refb, refb4, k3, k4, xl, out_l
    torch.cuda.empty_cache()
    t = time_warp(card)[shapes[0][0]]
    report["warp"].update(ms=t["one"], ms_b2b=t["b2b"])
    return report


def check_probes(card: str) -> dict:
    """Phase 1 (probes): P1-P6 against their plain versions, exact on the
    JAX scripts' inputs (ones) and on small integers (every product and
    sum is representable); P1 also on normal draws, where a float32 result
    holds to 1e-5 of the largest value (float32 sums in another order; a
    float32 operand is not rounded to tf32) and a bfloat16 result to 1e-2
    (its one rounding).  Returns the report of each probe kernel."""
    import torch
    import torch.nn.functional as F

    from gantrack_tpu_torch.ops import probes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    bf = torch.bfloat16
    th, w, c = probes.TH, probes.W, probes.C

    def ints(shape, dtype, lo=-4, hi=5):
        return torch.randint(lo, hi, shape, device=dev, generator=gen).to(dtype)

    def exact(label, got, ref):
        same = got.dtype == ref.dtype and torch.equal(got, ref)
        print(f"  {label}: {'exact' if same else 'DIFFERS'}")
        if not same:
            raise AssertionError(f"{label}: kernel and plain version differ")

    def entry(kernel, plain, library, nbytes, flops, rate=BF16_TC_FLOP_PER_S):
        """Times of the kernel, its plain version and the one PyTorch call
        that computes the same (all bf16 in, the probe's result out), and
        the kernel's largest difference from the plain version."""
        return {"max_abs_err": _max_err(kernel(), plain()), "ms": _median_ms(kernel),
                "plain_ms": _median_ms(plain), **_bound(nbytes, flops, rate),
                "library_ms": _median_ms(library), "dtype": "bf16", "library_dtype": "bf16",
                "ms_at_library_dtype": _median_ms(kernel)}

    def show(name, e):
        print(f"  {name} (median of 20, CUDA events) on {card}: kernel {e['ms']:.4f} ms, plain "
              f"{e['plain_ms']:.4f} ms, bound {e['bound_ms']:.6f} ms ({e['bound_by']}), library "
              f"{e['library_ms']:.4f} ms; max |kernel - plain| {e['max_abs_err']:.3e}")

    report = {}
    print("phase 1 probes: P1 one tile product per operand / result type pair")
    for i, (label, m, k, n, adt, bdt, odt, b_t) in enumerate(probes.matmul_cases()):
        for what, make in (("ones", lambda shape, dt: torch.ones(shape, dtype=dt, device=dev)),
                           ("integers", ints)):
            a, b = make((m, k), adt), make((n, k) if b_t else (k, n), bdt)
            exact(f"P1 {label}, {what}", probes.probe_matmul(a, b, odt, b_t),
                  probes.probe_matmul_plain(a, b, odt, b_t))
        an = torch.randn((m, k), device=dev, generator=gen).to(adt)
        bn = torch.randn((n, k) if b_t else (k, n), device=dev, generator=gen).to(bdt)
        ref = probes.probe_matmul_plain(an, bn, odt, b_t)
        _check(f"P1 {label}, normal draws", _max_err(probes.probe_matmul(an, bn, odt, b_t), ref),
               (1e-5 if odt == torch.float32 else 1e-2) * float(ref.abs().max()))
        if i == 0:
            # torch.matmul gives the same product rounded to bf16.
            report["probe_matmul"] = entry(
                lambda: probes.probe_matmul(a, b, odt, b_t),
                lambda: probes.probe_matmul_plain(a, b, odt, b_t), lambda: torch.matmul(a, b),
                _nbytes(a, b) + m * n * 4, 2 * m * k * n)
            show("P1 bf16xbf16->f32 48x128x128 (library: torch.matmul, bf16 result)",
                 report["probe_matmul"])

    wk = torch.ones((9 * c, c), dtype=bf, device=dev)
    w01 = ints((9 * c, c), bf, 0, 2)
    flops = 2 * 4 * th * w * c * 9 * c
    for name, fn, rows, cols in (("probe_halo_tile", probes.probe_halo_tile, th + 2, w + 2),
                                 ("probe_padded_tile", probes.probe_padded_tile, th + 8, w + 8)):
        print(f"phase 1 probes: {name}, 4 windows [{rows}, {cols}, {c}] -> [4, {th}, {w}, {c}]")
        ones = torch.ones((4, rows, cols, c), dtype=bf, device=dev)
        got = fn(ones, wk)
        exact(f"{name} on ones", got, probes.probe_tile_plain(ones, wk))
        if not bool((got == 576).all()):
            raise AssertionError(f"{name}: not 576 everywhere on ones")
        print("  576 everywhere on ones")
        x = ints((4, rows, cols, c), bf)
        exact(f"{name} on integers", fn(x, w01), probes.probe_tile_plain(x, w01))
        # The one PyTorch call: the conv of the window (channels last) with
        # the weights as OIHW, prepared outside the timing.
        win = x[:, :th + 2, :w + 2].permute(0, 3, 1, 2)
        w4 = w01.reshape(3, 3, c, c).permute(3, 2, 0, 1).contiguous()
        ref = probes.probe_tile_plain(x, w01)
        _check(f"{name}: F.conv2d computes the same tile (bf16 output)",
               _max_err(F.conv2d(win, w4).permute(0, 2, 3, 1), ref), 1e-2 * float(ref.abs().max()))
        report[name] = entry(lambda: fn(x, w01), lambda: probes.probe_tile_plain(x, w01),
                             lambda: F.conv2d(win, w4),
                             (4 * (th + 2) * (w + 2) * c + 9 * c * c + 4 * th * w * c) * 2, flops)
        show(name, report[name])

    wide = ints((4, th + 8, w + 8, c), bf, -8, 9)
    pieces = ints((9, 256, c), bf, -8, 9)
    rows = ints((40, 128), bf, -8, 9)
    # Copies: no operations.  The one PyTorch call that computes each is
    # written out here, apart from the module's plain version.
    for name, fn, plain, library, arg, moved in (
            ("probe_ring", probes.probe_ring, probes.probe_ring_plain,
             lambda: wide[:, :th, :w].contiguous(), wide, 2 * 4 * th * w * c),
            ("probe_concat", probes.probe_concat, probes.probe_concat_plain,
             lambda: torch.cat(list(pieces), dim=-1), pieces, 2 * pieces.numel()),
            ("probe_row_slice", probes.probe_row_slice, probes.probe_row_slice_plain,
             lambda: rows[1:33].contiguous(), rows, 2 * 32 * 128)):
        print(f"phase 1 probes: {name}, {list(arg.shape)}")
        exact(f"{name} on ones", fn(torch.ones_like(arg)), plain(torch.ones_like(arg)))
        exact(f"{name} on integers", fn(arg), plain(arg))
        exact(f"{name}: the library call computes the same", library(), plain(arg))
        report[name] = entry(lambda: fn(arg), lambda: plain(arg), library, moved * 2, 0)
        show(name, report[name])
    return report


def _conv_r1(conv, x, w):
    """The R1 form: the input gradient of ``sum(tanh(conv(x, w)))`` and the
    gradients of its squared norm for ``w`` and ``x``."""
    import torch

    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(torch.tanh(conv(xs, ws).float()).sum(), xs, create_graph=True)
    gw, ggx = torch.autograd.grad(gx.float().square().sum(), (ws, xs))
    return gx.detach(), gw, ggx


def check_conv3x3(card: str) -> dict:
    """Phase 1 (conv3x3): K8/K9 against their plain versions at every dense
    3x3 shape the claro step gives them (``CONV_SHAPES``, at each of its
    batch sizes), in the step's dtype there, and at a small ragged
    float32 shape.  Returns the report of the first shape."""
    import torch
    import torch.nn.functional as F

    from gantrack_tpu_torch.ops import conv2d_gradfix
    from gantrack_tpu_torch.ops import conv3x3 as c3

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    report = {}

    def library_wgrad(x, g, w):
        return torch.ops.aten.convolution_backward(
            g, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [False, True, False])[1]

    shapes = [(n, ci, co, h, h, dt, i == 0) for ci, co, h, dt, batches in CONV_SHAPES
              for i, n in enumerate(batches)]
    shapes.append((3, 40, 72, 19, 37, "f32", True))
    for n, ci, co, h, wd, step_dtype, whole in shapes:
        dtype = torch.bfloat16 if step_dtype == "bf16" else torch.float32
        # f32: full-f32 FMA, the sums in another order.  bf16: f32 sums of
        # the same bf16-rounded inputs; the output's one rounding dominates.
        rel = 1e-2 if step_dtype == "bf16" else 1e-5
        x = torch.randn((n, ci, h, wd), device=dev, generator=gen).to(dtype)
        w = (torch.randn((co, ci, 3, 3), device=dev, generator=gen) / (9 * ci) ** 0.5).to(dtype)
        g = torch.randn((n, co, h, wd), device=dev, generator=gen).to(dtype)
        flops = 2 * n * h * wd * 9 * ci * co
        print(f"phase 1 conv3x3: x [{n}, {ci}, {h}, {wd}] {step_dtype}, w [{co}, {ci}, 3, 3]; "
              f"{flops / 1e9:.1f} GFLOP a call")
        v8, v9 = c3.conv_variant(x.shape, dtype), c3.wgrad_variant(x.shape, dtype)
        plan = c3.wgrad_plan(x.shape, co, dtype)
        print(f"  variants from the shape: K8 {v8}, K9 {v9} ({plan['splits']} splits, "
              f"{plan['scratch_bytes'] / 1e6:.1f} MB of scratch)")
        if step_dtype == "bf16" and (v8, v9) != ("wgmma", "wgmma"):
            raise AssertionError(f"a bf16 shape of the claro step left the wgmma kernels: "
                                 f"{c3.wgmma_reason(x.shape, dtype)}")
        _reset(c3.VARIANTS)
        ref = c3.conv3x3_plain(x.float(), w.float())
        err8 = _max_err(c3.conv3x3(x, w), ref)
        _check(f"K8 {step_dtype} ({v8}) vs plain", err8, rel * float(ref.abs().max()))
        ref9 = c3.wgrad3x3_plain(x.float(), g.float())
        k9 = c3.wgrad3x3(x, g)
        err9 = _max_err(k9, ref9)
        _check(f"K9 {step_dtype} ({v9}) vs plain", err9, rel * float(ref9.abs().max()))
        same = torch.equal(k9, c3.wgrad3x3(x, g))
        print(f"  K9 bitwise deterministic over two calls: {same}")
        if not same:
            raise AssertionError("K9 is not bitwise deterministic")
        ran = {k: n for k, n in c3.VARIANTS.items() if n}
        if ran != {f"conv3x3:{v8}": 1, f"wgrad3x3:{v9}": 2}:
            raise AssertionError(f"the launches took other variants than the shape picks: {ran}")
        if step_dtype == "bf16":
            # The general mma.sync kernels stay reachable (they take what TMA
            # cannot): held against the same references at the same limits.
            _check("K8 bf16 (mma_sync, forced) vs plain",
                   _max_err(c3._conv_launch(x, w, "mma_sync"), ref), rel * float(ref.abs().max()))
            _check("K9 bf16 (mma_sync, forced) vs plain",
                   _max_err(c3._wgrad_launch(x, g, "mma_sync"), ref9),
                   rel * float(ref9.abs().max()))
        del ref, ref9, k9
        if not whole:
            del x, w, g
            torch.cuda.empty_cache()
            continue

        # Gradient and gradient of gradient on two images, against autograd
        # of the plain version: in f32 (1e-4: three chained convs), and for
        # the bf16 shapes in bf16, where the plain version rounds at the same
        # places but sums in another order, so single roundings flip (3e-2).
        orders = [(torch.float32, 1e-4)] + ([(dtype, 3e-2)] if step_dtype == "bf16" else [])
        for dt, lim in orders:
            x2, w2 = x[:2].to(dt), w.to(dt)
            names = ("grad", "grad-of-grad (weights)", "grad-of-grad (input)")
            for name, a, b in zip(names, _conv_r1(c3.conv3x3, x2, w2),
                                  _conv_r1(c3.conv3x3_plain, x2, w2)):
                _check(f"{name} through conv3x3 vs plain, {str(dt).replace('torch.', '')}",
                       _max_err(a, b), lim * float(b.float().abs().max()))

        # Times: forward; K9; forward + backward (both gradients).  For the
        # bf16 shapes the general mma.sync kernels in the same call, in
        # turns; for the f32 shapes each also on a cold L2.
        xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        bf16 = step_dtype == "bf16"
        t = {}
        if bf16:
            t = {"K8 mma_sync": _median_ms(lambda: c3._conv_launch(x, w, "mma_sync")),
                 "K9 mma_sync": _median_ms(lambda: c3._wgrad_launch(x, g, "mma_sync"))}
        t.update({
            "K8": _median_ms(lambda: c3.conv3x3(x, w)),
            "K8 plain": _median_ms(lambda: c3.conv3x3_plain(x, w)),
            "K8 library": _median_ms(lambda: F.conv2d(x, w, padding=1)),
            "K9": _median_ms(lambda: c3.wgrad3x3(x, g)),
            "K9 plain": _median_ms(lambda: c3.wgrad3x3_plain(x, g)),
            "K9 library": _median_ms(lambda: library_wgrad(x, g, w)),
            "fwd+bwd": _median_ms(lambda: torch.autograd.grad(c3.conv3x3(xr, wr), (xr, wr), g)),
            "fwd+bwd library": _median_ms(lambda: torch.autograd.grad(
                conv2d_gradfix.conv2d(xr, wr, padding=1), (xr, wr), g)),
        })
        if bf16:
            again = {"K8": _median_ms(lambda: c3.conv3x3(x, w)),
                     "K9": _median_ms(lambda: c3.wgrad3x3(x, g)),
                     "K8 mma_sync": _median_ms(lambda: c3._conv_launch(x, w, "mma_sync")),
                     "K9 mma_sync": _median_ms(lambda: c3._wgrad_launch(x, g, "mma_sync"))}
            print("  in turns (mma_sync, wgmma, wgmma, mma_sync), ms: K8 "
                  f"{t['K8 mma_sync']:.4f}, {t['K8']:.4f}, {again['K8']:.4f}, "
                  f"{again['K8 mma_sync']:.4f}; K9 {t['K9 mma_sync']:.4f}, {t['K9']:.4f}, "
                  f"{again['K9']:.4f}, {again['K9 mma_sync']:.4f}")
        else:
            cold = {"K8": _median_ms(lambda: c3.conv3x3(x, w), cold=True),
                    "K8 library": _median_ms(lambda: F.conv2d(x, w, padding=1), cold=True),
                    "K9": _median_ms(lambda: c3.wgrad3x3(x, g), cold=True),
                    "K9 library": _median_ms(lambda: library_wgrad(x, g, w), cold=True)}
            print("  cold L2 (256 MB written before each launch), ms: K8 "
                  f"{cold['K8']:.4f} (warm {t['K8']:.4f}), F.conv2d {cold['K8 library']:.4f} "
                  f"(warm {t['K8 library']:.4f}); K9 {cold['K9']:.4f} (warm {t['K9']:.4f}), "
                  f"aten.convolution_backward (weight) {cold['K9 library']:.4f} "
                  f"(warm {t['K9 library']:.4f})")
        _check("library F.conv2d vs plain (same function)",
               _max_err(F.conv2d(x, w, padding=1), c3.conv3x3_plain(x.float(), w.float())),
               rel * float(c3.conv3x3_plain(x.float(), w.float()).abs().max()))
        rate = BF16_TC_FLOP_PER_S if step_dtype == "bf16" else F32_FLOP_PER_S
        b8 = _bound(_nbytes(x, w, g), flops, rate)   # x, w in; out (g's size) out
        b9 = _bound(_nbytes(x, g, w), flops, rate)
        tf = lambda ms, k=1: k * flops / ms / 1e9
        general = lambda k: f"; the mma.sync kernel {t[k + ' mma_sync']:.4f} ms" if bf16 else ""
        print(f"  times ({step_dtype}, median of 20, CUDA events) on {card}: K8 {t['K8']:.4f} ms "
              f"({tf(t['K8']):.1f} TFLOP/s; {v8}{general('K8')}), "
              f"plain {t['K8 plain']:.4f} ms, F.conv2d "
              f"{t['K8 library']:.4f} ms ({tf(t['K8 library']):.1f} TFLOP/s), bound "
              f"{b8['bound_ms']:.4f} ms ({b8['bound_by']}); K9 {t['K9']:.4f} ms "
              f"({tf(t['K9']):.1f} TFLOP/s; {v9}{general('K9')}), "
              f"plain {t['K9 plain']:.4f} ms, "
              f"aten.convolution_backward (weight) {t['K9 library']:.4f} ms "
              f"({tf(t['K9 library']):.1f} TFLOP/s), bound {b9['bound_ms']:.4f} ms "
              f"({b9['bound_by']}); forward+backward kernels {t['fwd+bwd']:.4f} ms "
              f"({tf(t['fwd+bwd'], 3):.1f} TFLOP/s), library {t['fwd+bwd library']:.4f} ms "
              f"({tf(t['fwd+bwd library'], 3):.1f} TFLOP/s)")
        if not report:
            report = {
                "conv3x3": {"max_abs_err": err8, "ms": t["K8"], "plain_ms": t["K8 plain"], **b8,
                            "library_ms": t["K8 library"], "dtype": step_dtype,
                            "library_dtype": step_dtype, "ms_at_library_dtype": t["K8"]},
                "wgrad3x3": {"max_abs_err": err9, "ms": t["K9"], "plain_ms": t["K9 plain"], **b9,
                             "library_ms": t["K9 library"], "dtype": step_dtype,
                             "library_dtype": step_dtype, "ms_at_library_dtype": t["K9"]},
            }
        del x, w, g, xr, wr
        torch.cuda.empty_cache()
    return report


def _synthetic_dataset(root: str, res: int = 256, count: int = 256) -> str:
    import numpy as np

    from gantrack_tpu_torch.data import pack_shards

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32)
    images = []
    for _ in range(count):  # smooth blobs + noise, in [0, 255]
        cx, cy, r = rng.uniform(0.25, 0.75, 2).tolist() + [rng.uniform(0.08, 0.27)]
        cx, cy, r = cx * res, cy * res, r * res
        img = 200 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r * r))
        images.append(np.clip(img + rng.normal(0, 8, img.shape), 0, 255)[:, :, None])
    data = os.path.join(root, "data")
    pack_shards(data, "train", images, [f"s{i}" for i in range(len(images))])
    return data


def train_claro(card: str, tmp: str, data: str, args=CLARO_ARGS, res: int = 256,
                batch: int = 32):
    """Phase 2: the claro recipe with fid1k through the CLI, which runs on
    the card by default.  Returns the run dir and the launch counts of
    the run."""
    import numpy as np
    import torch

    from gantrack_tpu_torch.ops import fir
    from gantrack_tpu_torch.tools import train as cli
    from gantrack_tpu_torch.training.loop import to_device_batch
    from gantrack_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint

    device = _cli_device(cli, args)
    argv = [f"--outdir={os.path.join(tmp, 'runs')}", f"--data={data}", *args]
    print(f"phase 2: python -m gantrack_tpu_torch.tools.train {' '.join(argv)}")

    # Log the FIR calls of the run (form, input shape, dtype, taps, pads).
    fir_calls = {}
    launch_fir = fir.fir_planes

    def logged(x, spec):
        key = (spec.form, tuple(x.shape), str(x.dtype).replace("torch.", ""),
               len(spec.taps_y), spec.pads)
        fir_calls[key] = fir_calls.get(key, 0) + 1
        return launch_fir(x, spec)

    fir.fir_planes = logged
    _reset_launches()
    t0 = time.perf_counter()
    try:
        run_dir = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        fir.fir_planes = launch_fir
    seconds = time.perf_counter() - t0
    launches = _read_launches(("upwarp", "upsplat", "fir_same", "fir_down2", "fir_up2"))
    print(f"  CLI run: {seconds:.1f} s wall (incl. setup, image grids and fid1k) on {card}; "
          f"kernel launches {launches}; no FIR call took the plain version")
    print(f"  FIR calls of the run ({len(fir_calls)} distinct; form, planes x H x W, dtype, "
          f"taps, pads (py0, py1, px0, px1): calls):")
    for key, n in sorted(fir_calls.items(), key=lambda kv: -kv[0][1][1] * kv[0][1][2]):
        print(f"    {key}: {n}")

    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        records = [json.loads(line) for line in f]
    keys = set().union(*records)
    for rec in records:
        for k, v in rec.items():
            if k.startswith("Loss/") and not np.isfinite(v):
                raise AssertionError(f"non-finite {k} in stats.jsonl: {v}")
    for k in ("Loss/pl_penalty", "Loss/r1_penalty", "Loss/G/loss", "Loss/D/loss",
              "Progress/augment"):
        if k not in keys:
            raise AssertionError(f"{k} missing from stats.jsonl")
    last = records[-1]
    print(f"  stats: kimg {last['Progress/kimg']}, ada_p {last['Progress/augment']:.6f}, "
          f"G_loss {last['Loss/G/loss']:.4f}, D_loss {last['Loss/D/loss']:.4f}, "
          f"pl_penalty {last['Loss/pl_penalty']:.4f}, r1_penalty {last['Loss/r1_penalty']:.4f}, "
          f"peak GPU mem {last.get('Resources/peak_gpu_mem_gb', float('nan')):.2f} GB")
    metric_rows = _metric_rows(run_dir, "fid1k")
    print(f"  fid1k at the snapshot: {metric_rows[-1]['results']['fid1k']:.4f}, metric tick "
          f"{metric_rows[-1]['total_time']:.2f} s on {card}")

    # The initial state of the same run, then the checkpoint on top.
    opts = cli.build_parser().parse_args(argv)
    _, loader, state, stepper = cli.build_training(cli.resolve_config(opts), opts, device)
    try:
        real_img, real_c = to_device_batch(*next(loader), device)
    finally:
        loader.close()
    init = {name: [p.detach().clone() for p in getattr(state, name).parameters()]
            for name in ("G", "D", "G_ema")}
    ckpt = latest_checkpoint(os.path.join(run_dir, "checkpoints"))
    load_checkpoint(ckpt, state, stepper.generator)
    steps = -(-1000 // batch)
    if state.step != steps or state.cur_nimg != steps * batch:
        raise AssertionError(f"checkpoint at step {state.step}, nimg {state.cur_nimg}")
    for name, before in init.items():
        after = list(getattr(state, name).parameters())
        if not any(not torch.equal(a, b) for a, b in zip(before, after)):
            raise AssertionError(f"{name} parameters did not change")
        if not all(torch.isfinite(p).all() for p in after):
            raise AssertionError(f"{name} has non-finite parameters")
    with torch.no_grad():
        z = torch.randn((4, 512), device=device, generator=torch.Generator(device).manual_seed(1))
        fakes = state.G_ema(z, None, noise_mode="const")
    if tuple(fakes.shape) != (4, 1, res, res) or not torch.isfinite(fakes).all():
        raise AssertionError(f"G_ema output {tuple(fakes.shape)} not finite/of shape")
    print(f"  checkpoint {os.path.basename(ckpt)} loads back: step {state.step}, "
          f"ada_p {float(state.ada_p):.6f}; G, D, G_ema changed; G_ema output finite")

    # Median step time of each phase variant (host clock around a
    # synchronised step), on the checkpointed state.
    variants = (("plain", (False, False)), ("+Greg", (True, False)), ("+Greg+Dreg", (True, True)))
    for label, ms in _step_times(stepper, state, real_img, real_c, variants).items():
        print(f"  step {label}: median {ms:.1f} ms of 3 (batch {batch}, {res}^2) on {card}")
    del state, stepper, real_img
    torch.cuda.empty_cache()
    return run_dir, launches


def _metric_rows(run_dir: str, metric: str) -> list:
    import numpy as np

    with open(os.path.join(run_dir, f"metric-{metric}.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for row in rows:
        for k, v in row["results"].items():
            if not np.isfinite(v):
                raise AssertionError(f"{metric}: non-finite {k} = {v}")
    if not rows:
        raise AssertionError(f"metric-{metric}.jsonl is empty")
    return rows


def run_calc_metrics(card: str, tmp: str, data: str, run_dir: str) -> None:
    """Phase 3: ``calc_metrics`` on the run's checkpoint with both
    detectors, then the generator-pass rate of each."""
    import torch

    from gantrack_tpu_torch.metrics import metric_utils
    from gantrack_tpu_torch.models import inception
    from gantrack_tpu_torch.tools import calc_metrics

    # Seeded random weights, He-scaled so that the features do not collapse
    # through the ReLU cascade (PyTorch's default init shrinks them to a
    # constant, and FID to 0).
    weights = os.path.join(tmp, "inception-tfslim-random.npz")
    model = inception.InceptionV3Features(variant="tfslim")
    gen = torch.Generator().manual_seed(0)
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            torch.nn.init.kaiming_normal_(m.weight, nonlinearity="relu", generator=gen)
    inception.save_npz(weights, model)
    base = [f"--network={run_dir}", f"--data={data}", *NET_ARGS]
    for metrics, extra in (("fid10k,kid10k", []), ("fid1k", [f"--detector-weights={weights}"])):
        argv = [*base, f"--metrics={metrics}", *extra]
        print(f"phase 3: python -m gantrack_tpu_torch.tools.calc_metrics {' '.join(argv)}")
        _reset_launches()
        t0 = time.perf_counter()
        results = calc_metrics.main(argv)
        torch.cuda.synchronize()
        launches = _read_launches(("fir_same", "fir_up2"))  # G_ema's synthesis
        print(f"  {results} in {time.perf_counter() - t0:.1f} s on {card}; kernel launches "
              f"{ {k: n for k, n in launches.items() if n} }; no FIR call took the plain version")
        for metric in metrics.split(","):
            _metric_rows(run_dir, metric)

    # Generator-pass rate per detector: 2048 images after one warm-up batch.
    from gantrack_tpu_torch.models.stylegan2 import Generator
    from gantrack_tpu_torch.utils.checkpoint import latest_checkpoint

    dev = torch.device("cuda")
    G = Generator(z_dim=512, c_dim=0, w_dim=512, img_resolution=256, img_channels=1,
                  mapping_kwargs=dict(num_layers=2),
                  synthesis_kwargs=dict(channel_base=16384, channel_max=512))
    payload = torch.load(latest_checkpoint(os.path.join(run_dir, "checkpoints")),
                         map_location="cpu", weights_only=True)
    G.load_state_dict(payload["G_ema"])
    G = G.to(dev).eval().requires_grad_(False)
    for label, detector in (("random projection", metric_utils.make_inception_detector(device=dev)),
                            ("InceptionV3 tfslim 299^2",
                             metric_utils.make_inception_detector(weights, device=dev))):
        opts = metric_utils.MetricOptions(
            generator=lambda z, c: G(z, c, noise_mode="const"), detector=detector,
            batch_size=256, device=dev)
        metric_utils.compute_feature_stats_for_generator(opts, max_items=256)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = metric_utils.compute_feature_stats_for_generator(opts, capture_mean_cov=True,
                                                                 max_items=2048)
        seconds = time.perf_counter() - t0
        print(f"  generator pass, {label}: {stats.num_items / seconds:.1f} img/s "
              f"(2048 images, batch 256, G_ema 256^2 + detector) on {card}")


def _step_times(stepper, state, real_img, real_c, variants, plain_route=(),
                reps: int = 4, library_route=None) -> dict:
    """Median step time (ms, host clock around a synchronised step) of
    each phase variant, the first step of each left out; before it, the
    kernel launches of one step of the variant (counted from 0, after
    the main path's count was read)."""
    import torch

    from gantrack_tpu_torch.ops import fir

    out = {}
    for label, flags in variants:
        _reset_launches()
        stepper.run(state, real_img, real_c, *flags)
        print(f"  kernel launches of one {label} step: "
              f"{ {k: n for k, n in _read_launches((), plain_route, library_route).items() if n} }"
              f"; plain-route FIR calls {dict(fir.PLAIN_ROUTE)}")
        times = []
        for i in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            stepper.run(state, real_img, real_c, *flags)
            torch.cuda.synchronize()
            if i > 0:
                times.append((time.perf_counter() - t) * 1e3)
        times.sort()
        out[label] = times[len(times) // 2]
    return out


def _pick_batch(cli, tmp: str, data: str, args, device, sizes=(32, 16, 8)) -> int:
    """The largest batch of ``sizes`` at which one +Dreg step fits the
    card with room to spare: its peak must stay under 80 % of the card's
    memory, because the CLI run also renders image grids and evaluates
    metrics between steps, and the caching allocator fragments (at batch
    32 the step alone peaked at 94 % of an 80 GB card and the run then ran
    out in G-main).  Running out of device memory here is the question
    asked, so it is caught; nothing else is."""
    import torch

    from gantrack_tpu_torch.training.loop import to_device_batch

    for batch in sizes:
        argv = [f"--outdir={tmp}", f"--data={data}", f"--batch={batch}", *args]
        opts = cli.build_parser().parse_args(argv)
        _, loader, state, stepper = cli.build_training(cli.resolve_config(opts), opts, device)
        try:
            real_img, real_c = to_device_batch(*next(loader), device)
        finally:
            loader.close()
        torch.cuda.reset_peak_memory_stats()
        try:
            stepper.run(state, real_img, real_c, False, True)
            torch.cuda.synchronize()
            fits = True
        except torch.cuda.OutOfMemoryError:
            fits = False
        peak = torch.cuda.max_memory_allocated() / 2**30
        total = torch.cuda.get_device_properties(device).total_memory / 2**30
        roomy = fits and peak <= 0.8 * total
        print(f"  batch {batch}: one +Dreg step "
              + (f"peaks at {peak:.2f} GiB of {total:.2f} GiB" if fits
                 else f"runs out of memory (at {peak:.2f} GiB of {total:.2f} GiB)")
              + ("" if roomy else ": not taken"))
        del state, stepper, real_img, real_c
        torch.cuda.empty_cache()
        if roomy:
            return batch
    raise AssertionError(f"no batch of {sizes} fits the card")


def _probe_metric_batch(cli, g_ema, card: str, res: int, sizes=(128, 64, 32)) -> None:
    """Which generator-pass batch of the metrics a StyleGAN3 generator at
    full width can take beside a resident training state: one batch of
    each of ``sizes`` through G_ema and the default detector, with its
    peak memory, for the trained StyleGAN3-T and for a StyleGAN3-R of
    random weights.  The batch the CLIs pick (``metric_batch``) must be
    one that ran and peaked under half the card's memory, which leaves the
    training step's cached blocks their room.  Running out of device
    memory is the question asked, so it is caught; nothing else is."""
    import torch

    from gantrack_tpu_torch.metrics import metric_utils

    dev = torch.device("cuda")
    total = torch.cuda.get_device_properties(dev).total_memory / 2**30
    g_r = cli.make_generator("stylegan3-r", resolution=res, channels=1, c_dim=0, cbase=32768,
                             cmax=512, map_depth=2).to(dev).eval().requires_grad_(False)
    detector = metric_utils.make_inception_detector(device=dev)
    for cfg, g in (("stylegan3-t", g_ema), ("stylegan3-r", g_r)):
        picked = cli.metric_batch(cfg, res)
        peaks = {}
        for batch in sizes:
            opts = metric_utils.MetricOptions(
                generator=lambda z, c, g=g: g(z, c, noise_mode="const"), detector=detector,
                batch_size=batch, device=dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            try:
                metric_utils.compute_feature_stats_for_generator(opts, max_items=batch)
                torch.cuda.synchronize()
                peaks[batch] = torch.cuda.max_memory_allocated() / 2**30
            except torch.cuda.OutOfMemoryError:
                peaks[batch] = None
        print(f"  metric batch, {cfg} at full width, {res}^2, beside the training state: peak GiB "
              f"of {total:.2f} by batch {peaks} on {card}; the CLIs take {picked}")
        if peaks.get(picked) is None or peaks[picked] > 0.5 * total:
            raise AssertionError(f"{cfg}: the metric batch {picked} does not fit in half the card")
    del g_r
    torch.cuda.empty_cache()


_FIR_FORMS = ("same (K5)", "down2 (K6)", "up2 (K7)")
# The warp kernels' rows by kernel name: K2's first version ran two
# kernels (the canvas pass, then the decimating FIR), both K2's.
_WARP_ROWS = {"upwarp_kernel": "K1 upwarp", "upsplat_kernel": "K2 upsplat",
              "splat2x_kernel": "K2 upsplat", "fir_down_kernel": "K2 upsplat",
              "warp_kernel": "K3 warp", "splat_kernel": "K4 splat"}
_HAND_ROWS = ("FIR ", "K1 ", "K2 ", "K3 ", "K4 ")
_DTYPES = {"__nv_bfloat16": "bf16", "float": "f32"}


def kernel_label(name: str) -> str:
    """A profiler row named by what it computes where it is a FIR kernel
    (``fir_kernel<T, form, taps>``: form 0 same, 1 down2, 2 up2; the ×2
    polyphase ``fir_up_kernel<T, factor, taps>``; taps 0 is the generic
    tap loop) or a warp kernel (K1–K4), else the kernel's own name."""
    import re

    m = re.search(r"\b(" + "|".join(_WARP_ROWS) + r")<([\w:]+)", name)
    if m:
        kind, dtype = m.groups()
        return f"{_WARP_ROWS[kind]}, {_DTYPES.get(dtype, dtype)} [{kind}]"
    m = re.search(r"\b(fir_kernel|fir_up_kernel)<([\w:]+), (\d+), (\d+)>", name)
    if not m:
        return name
    kind, dtype, form, taps = m.groups()
    what = _FIR_FORMS[int(form)] if kind == "fir_kernel" else f"up{form} (K7)"
    taps = taps if taps != "0" else "any"
    return f"FIR {what}, {taps} taps, {_DTYPES.get(dtype, dtype)} [{kind}]"


def _profile_step(stepper, state, real_img, real_c, flags, card: str, label: str) -> dict:
    """One profiled step: device time by kernel (FIR rows named by form
    and tap count, K1–K4 rows by kernel: ``kernel_label``), and the share
    of the depthwise-convolution kernels, which only the plain FIR route
    runs (its zero-stuffing and padding copies are elementwise kernels and
    not counted, so the share is a lower bound), of all hand-written
    kernels, of the conv3x3 pair K8/K9 among them, of each FIR form and of
    each warp kernel K1–K4.  Returns
    {"total_ms", "rows": {label: ms}}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stepper.run(state, real_img, real_c, *flags)
        torch.cuda.synchronize()
    rows = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            key = kernel_label(ev.name)
            rows[key] = rows.get(key, 0.0) + ev.device_time / 1e3
    total = sum(rows.values())
    if total <= 0:
        print(f"  profile of one {label} step: the profiler saw no device time")
        return {"total_ms": 0.0, "rows": {}}
    conv = sum(t for k, t in rows.items() if "conv3x3_" in k or "wgrad3x3_" in k
               or "wgrad_reduce_kernel" in k)
    hand = conv + sum(t for k, t in rows.items() if "gantrack" in k or k.startswith(_HAND_ROWS))
    depthwise = sum(t for k, t in rows.items() if "depthwise" in k.lower())
    forms = {form: sum(t for k, t in rows.items() if k.startswith(f"FIR {form}"))
             for form in ("same", "down2", "up2")}
    warps = {w: sum(t for k, t in rows.items() if k.startswith(w)) for w in _HAND_ROWS[1:]}
    print(f"  profile of one {label} step on {card}: {total:.1f} ms of device time in "
          f"{len(rows)} kernels; depthwise-conv kernels (the plain FIR route) {depthwise:.1f} ms "
          f"({100 * depthwise / total:.1f} %); hand-written kernels {hand:.1f} ms "
          f"({100 * hand / total:.1f} %), of which conv3x3/wgrad3x3 {conv:.1f} ms "
          f"({100 * conv / total:.1f} %); FIR by form: "
          + ", ".join(f"{k} {t:.2f} ms ({100 * t / total:.1f} %)" for k, t in forms.items())
          + "; warp kernels: "
          + ", ".join(f"{k.strip()} {t:.3f} ms ({100 * t / total:.2f} %)"
                      for k, t in warps.items()))
    for name, t in sorted(rows.items(), key=lambda kv: -kv[1])[:14]:
        print(f"    {t:8.2f} ms {100 * t / total:5.1f} %  {name[:100]}")
    return {"total_ms": total, "rows": rows}


def train_stylegan3(card: str, tmp: str, data: str, args=SG3_ARGS, res: int = 256):
    """Phase 4: StyleGAN3-T at full width through the CLI with the
    equivariance metrics at the snapshot, then ``calc_metrics`` on its
    checkpoint.  Returns the launch counts of both runs, summed."""
    import numpy as np
    import torch

    from gantrack_tpu_torch.ops import fir
    from gantrack_tpu_torch.tools import calc_metrics
    from gantrack_tpu_torch.tools import train as cli
    from gantrack_tpu_torch.training.loop import to_device_batch
    from gantrack_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint

    device = _cli_device(cli, args)
    print("phase 4: StyleGAN3-T at full width; the largest batch of 32, 16, 8 that fits")
    batch = _pick_batch(cli, tmp, data, args, device)
    argv = [f"--outdir={os.path.join(tmp, 'runs3')}", f"--data={data}", f"--batch={batch}", *args]
    print(f"phase 4: python -m gantrack_tpu_torch.tools.train {' '.join(argv)}")
    _reset_launches()
    t0 = time.perf_counter()
    run_dir = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read_launches(("upwarp", "upsplat", "fir_same", "fir_down2", "fir_up2", "warp"),
                              SG3_T_PLAIN_ROUTE)
    print(f"  CLI run: {seconds:.1f} s wall (incl. setup, image grids and the eq metrics) on "
          f"{card}; kernel launches {launches}")
    print(f"  upfirdn2d calls outside the FIR kernels' contract (plain route) in the run: "
          f"{sum(fir.PLAIN_ROUTE.values())}, by reason {dict(fir.PLAIN_ROUTE)}")
    if not fir.PLAIN_ROUTE:
        raise AssertionError("StyleGAN3's factor-4 filters did not take the plain route")

    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        records = [json.loads(line) for line in f]
    keys = set().union(*records)
    for rec in records:
        for k, v in rec.items():
            if k.startswith("Loss/") and not np.isfinite(v):
                raise AssertionError(f"non-finite {k} in stats.jsonl: {v}")
    for k in ("Loss/r1_penalty", "Loss/G/loss", "Loss/D/loss", "Progress/augment"):
        if k not in keys:
            raise AssertionError(f"{k} missing from stats.jsonl")
    if "Loss/pl_penalty" in keys:
        raise AssertionError("StyleGAN3 ran a path-length phase")
    last = records[-1]
    print(f"  stats: kimg {last['Progress/kimg']}, ada_p {last['Progress/augment']:.6f}, "
          f"G_loss {last['Loss/G/loss']:.4f}, D_loss {last['Loss/D/loss']:.4f}, "
          f"r1_penalty {last['Loss/r1_penalty']:.4f}, "
          f"peak GPU mem {last.get('Resources/peak_gpu_mem_gb', float('nan')):.2f} GB")
    for metric in ("eqt1k_int", "eqr1k"):
        row = _metric_rows(run_dir, metric)[-1]
        print(f"  {metric} at the snapshot: {row['results'][metric]:.4f} dB, metric tick "
              f"{row['total_time']:.2f} s on {card}")

    # The initial state of the same run, then the checkpoint on top.
    opts = cli.build_parser().parse_args(argv)
    _, loader, state, stepper = cli.build_training(cli.resolve_config(opts), opts, device)
    try:
        real_img, real_c = to_device_batch(*next(loader), device)
    finally:
        loader.close()
    names = state.G.synthesis.layer_names
    print(f"  G: {len(names)} layers {names[0]} .. {names[-1]}, mapping depth "
          f"{state.G.mapping.num_layers}, "
          f"{sum(p.numel() for p in state.G.parameters()) / 1e6:.2f} M parameters; bf16 layers "
          f"{sum(getattr(state.G.synthesis, n).spec.use_bf16 for n in names)}")
    if len(names) != 15 or state.G.mapping.num_layers != 2:
        raise AssertionError("not the published StyleGAN3-T depth (14 layers + toRGB, mapping 2)")
    init = {name: [p.detach().clone() for p in getattr(state, name).parameters()]
            for name in ("G", "D", "G_ema")}
    ckpt = latest_checkpoint(os.path.join(run_dir, "checkpoints"))
    load_checkpoint(ckpt, state, stepper.generator)
    steps = -(-1000 // batch)
    if state.step != steps or state.cur_nimg != steps * batch:
        raise AssertionError(f"checkpoint at step {state.step}, nimg {state.cur_nimg}")
    for name, before in init.items():
        after = list(getattr(state, name).parameters())
        if not any(not torch.equal(a, b) for a, b in zip(before, after)):
            raise AssertionError(f"{name} parameters did not change")
        if not all(torch.isfinite(p).all() for p in after):
            raise AssertionError(f"{name} has non-finite parameters")
    emas = [float(getattr(state.G.synthesis, n).magnitude_ema) for n in names]
    emas_ema = [float(getattr(state.G_ema.synthesis, n).magnitude_ema) for n in names]
    if any(e == 1.0 or not np.isfinite(e) for e in emas) or emas != emas_ema:
        raise AssertionError(f"magnitude_ema buffers not updated or not copied to G_ema: {emas}")
    with torch.no_grad():
        z = torch.randn((4, 512), device=device, generator=torch.Generator(device).manual_seed(1))
        fakes = state.G_ema(z, None, noise_mode="const")
    if tuple(fakes.shape) != (4, 1, res, res) or not torch.isfinite(fakes).all():
        raise AssertionError(f"G_ema output {tuple(fakes.shape)} not finite/of shape")
    print(f"  checkpoint {os.path.basename(ckpt)} loads back: step {state.step}, "
          f"ada_p {float(state.ada_p):.6f}; G, D, G_ema changed; magnitude_ema "
          f"{min(emas):.4f} .. {max(emas):.4f}; G_ema output finite")

    torch.cuda.reset_peak_memory_stats()
    times = _step_times(stepper, state, real_img, real_c,
                        (("plain", (False, False)), ("+Dreg", (False, True))), SG3_T_PLAIN_ROUTE)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for label, ms in times.items():
        print(f"  step {label}: median {ms:.1f} ms of 3 (batch {batch}, {res}^2) on {card}")
    print(f"  peak device memory over those steps: {peak:.2f} GiB (batch {batch}) on {card}")
    _profile_step(stepper, state, real_img, real_c, (False, False), card, "plain StyleGAN3-T")
    _probe_metric_batch(cli, state.G_ema, card, res)
    del state, stepper, real_img, fakes
    torch.cuda.empty_cache()

    argv = [f"--network={run_dir}", f"--data={data}", "--metrics=fid1k,eqr1k",
            *(a for a in args if a.startswith(("--cfg=", "--cbase=", "--cmax=")))]
    print(f"phase 4: python -m gantrack_tpu_torch.tools.calc_metrics {' '.join(argv)}")
    trained = dict(launches)
    _reset_launches()
    t0 = time.perf_counter()
    results = calc_metrics.main(argv)
    torch.cuda.synchronize()
    launches = _read_launches(("fir_down2", "fir_up2", "warp"), SG3_T_PLAIN_ROUTE)
    print(f"  {results} in {time.perf_counter() - t0:.1f} s on {card}; kernel launches "
          f"{ {k: n for k, n in launches.items() if n} }; plain-route FIR calls "
          f"{dict(fir.PLAIN_ROUTE)}")
    for metric in ("fid1k", "eqr1k"):
        _metric_rows(run_dir, metric)
    return {k: trained[k] + launches[k] for k in trained}


def run_unfused_augment(card: str, tmp: str, data: str, args=CLARO_ARGS):
    """Phase 5: the claro recipe with the augment pipe built
    ``impl="unfused"``: one plain and one +Greg+Dreg step on one batch
    (K3 forward; K4 in the backward; K3 again where R1 differentiates the
    backward), and the unfused chain against the fused one on one batch.
    Returns the launch counts of the two steps."""
    import torch

    from gantrack_tpu_torch.tools import train as cli
    from gantrack_tpu_torch.training.augment import AugmentPipe
    from gantrack_tpu_torch.training.loop import to_device_batch

    argv = [f"--outdir={tmp}", f"--data={data}", *args]
    opts = cli.build_parser().parse_args(argv)
    device = _cli_device(cli, args)
    print("phase 5: the claro step with AugmentPipe(impl='unfused') "
          "(upsample2d -> affine warp -> downsample2d)")
    _, loader, state, stepper = cli.build_training(cli.resolve_config(opts), opts, device,
                                                   augment_impl="unfused")
    try:
        real_img, real_c = to_device_batch(*next(loader), device)
    finally:
        loader.close()
    state.ada_p = torch.tensor(0.5, device=device)  # the gates open for half the draws
    _reset_launches()
    both = ("warp", "splat", "fir_same", "fir_down2", "fir_up2")
    m = stepper.run(state, real_img, real_c, False, False)
    plain = _read_launches(both)
    m2 = stepper.run(state, real_img, real_c, True, True)
    launches = _read_launches(both)
    for name, moments in (("plain", m), ("+Greg+Dreg", m2)):
        for k, v in moments.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"unfused {name} step: non-finite {k}")
    in_reg = {k: launches[k] - plain[k] for k in ("warp", "splat")}
    print(f"  plain step: warp {plain['warp']}, splat {plain['splat']} launches; +Greg+Dreg step: "
          f"warp {in_reg['warp']}, splat {in_reg['splat']}; upwarp/upsplat "
          f"{launches['upwarp']}/{launches['upsplat']}; losses finite; "
          f"r1_penalty {float(m2['Loss/r1_penalty'][1] / m2['Loss/r1_penalty'][0]):.6f}")
    if in_reg["warp"] <= plain["warp"] or launches["upwarp"] or launches["upsplat"]:
        raise AssertionError("R1's second differentiation did not go back through K3, or the "
                             "fused pair ran")

    # Unfused against fused on one batch with the same transforms, in the
    # step's bf16: the fused kernel rounds once, the unfused chain after
    # each of its three stages, so 2e-2 of the largest value.
    fused = AugmentPipe(stepper.loss.augment_fn.cfg, *real_img.shape[2:], real_img.shape[1])
    unfused = stepper.loss.augment_fn
    gen = torch.Generator(device=device).manual_seed(3)
    g_inv = unfused.sample_geometric(real_img.shape[0], 1.0, device, gen)
    a, b = unfused.apply_geometric(real_img, g_inv), fused.apply_geometric(real_img, g_inv)
    _check("unfused chain (K7, K3, K6) vs fused (K1, K6), bf16", _max_err(a, b),
           2e-2 * float(b.abs().max()))
    del state, stepper
    torch.cuda.empty_cache()
    return launches


def run_probe_path() -> dict:
    """Phase 6 (probes): every probe through the module's entry point, as
    ``python -m gantrack_tpu_torch.ops.probes`` runs them.  Returns the
    launch counts of the run."""
    from gantrack_tpu_torch.ops import probes

    print("phase 6: probes.run_probes (the scripts' inputs: ones)")
    _reset_launches()
    sums = probes.run_probes("cuda")
    launches = _read_launches(tuple(probes.LAUNCHES))
    tile = 576.0 * 4 * probes.TH * probes.W * probes.C
    want = {"A halo-window-as-it-lies": tile, "B padded-window-shifted-reads": tile,
            "C two-slot-ring-dynslot": 4.0 * probes.TH * probes.W * probes.C,
            "D concat-9x64": 256.0 * 9 * probes.C, "E row-offset-slice": 32.0 * 128}
    for label, value in want.items():
        if sums[label] != value:
            raise AssertionError(f"probe {label}: sum {sums[label]}, expected {value}")
    return launches


def run_kernel_route(card: str, tmp: str, data: str, args=CLARO_ARGS):
    """Phase 6 (conv route): the claro step with ``conv_impl="kernel"``
    beside the default ``"library"`` route, both built from the same seed,
    on one batch: the first plain step's losses of the two routes, then
    the launches and the step time of each phase variant on each route, a
    profile of one kernel-route step, and one plain step with every
    augment section on.  Returns the kernel route's launch counts, summed
    over one step of each variant."""
    import torch

    from gantrack_tpu_torch.ops import conv3x3 as c3
    from gantrack_tpu_torch.tools import train as cli
    from gantrack_tpu_torch.training.loop import to_device_batch

    argv = [f"--outdir={tmp}", f"--data={data}", *args]
    opts = cli.build_parser().parse_args(argv)
    device = _cli_device(cli, args)
    print("phase 6: the claro step with conv_impl='kernel' (D b256..b8 conv0, G b4..b256 conv1 "
          "and D's epilogue conv through K8/K9) beside conv_impl='library'")
    runs = {}
    for route in ("library", "kernel"):
        _, loader, state, stepper = cli.build_training(cli.resolve_config(opts), opts, device,
                                                       conv_impl=route)
        try:
            real_img, real_c = to_device_batch(*next(loader), device)
        finally:
            loader.close()
        state.ada_p = torch.tensor(0.5, device=device)  # the gates open for half the draws
        runs[route] = (state, stepper, real_img, real_c)

    variants = (("plain", (False, False)), ("+Greg", (True, False)), ("+Dreg", (False, True)),
                ("+Greg+Dreg", (True, True)))
    # The first step of both routes starts from equal weights and draws the
    # same numbers: its losses differ only by the convs' bf16 roundings
    # (f32 sums in another order flip single roundings of the activations),
    # 5e-2 of the larger of 1 and the loss.
    first = {}
    for route, (state, stepper, real_img, real_c) in runs.items():
        _reset_launches()
        first[route] = stepper.run(state, real_img, real_c, False, False)
        _read_launches(("conv3x3", "wgrad3x3") if route == "kernel" else (),
                       library_route=CLARO_LIBRARY_ROUTE if route == "kernel" else None)
    for key in ("Loss/G/loss", "Loss/D/loss", "Loss/scores/fake", "Loss/scores/real"):
        a, b = (float(first[r][key][1] / first[r][key][0]) for r in ("kernel", "library"))
        _check(f"first plain step, {key}: kernel route {a:.6f} vs library {b:.6f}", abs(a - b),
               5e-2 * max(1.0, abs(b)))

    state, stepper, real_img, real_c = runs["kernel"]
    total = {}
    per_variant = {}
    for label, flags in variants:
        _reset_launches()
        m = stepper.run(state, real_img, real_c, *flags)
        counts = _read_launches(("conv3x3", "wgrad3x3"), library_route=CLARO_LIBRARY_ROUTE)
        for k, v in m.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"kernel-route {label} step: non-finite {k}")
        per_variant[label] = counts
        total = {k: total.get(k, 0) + n for k, n in counts.items()}
        by_variant = {k: n for k, n in counts.items() if ":" in k and n}
        if (counts["conv3x3:mma_sync"] or counts["wgrad3x3:mma_sync"]
                or not counts["conv3x3:wgmma"] or not counts["wgrad3x3:wgmma"]):
            raise AssertionError(f"a bf16 conv of the {label} step left the wgmma kernels: "
                                 f"{by_variant}")
        print(f"  {label} step on the kernel route: conv3x3 {counts['conv3x3']}, wgrad3x3 "
              f"{counts['wgrad3x3']} launches, by variant {by_variant}; losses finite; convs left "
              f"to the library {dict(c3.LIBRARY_ROUTE)}")
    for label in ("+Greg", "+Dreg", "+Greg+Dreg"):
        for k in ("conv3x3", "wgrad3x3"):
            if per_variant[label][k] <= per_variant["plain"][k]:
                raise AssertionError(f"the {label} step launched {k} no more often than the plain "
                                     f"step: the second differentiation left the kernels")

    times = {route: _step_times(stepper, state, real_img, real_c, variants,
                                library_route=CLARO_LIBRARY_ROUTE if route == "kernel" else None)
             for route, (state, stepper, real_img, real_c) in runs.items()}
    for label, _ in variants:
        print(f"  step {label}: kernel route {times['kernel'][label]:.1f} ms, library route "
              f"{times['library'][label]:.1f} ms (median of 3, batch 32, 256^2) on {card}")
    for route, (state, stepper, real_img, real_c) in runs.items():
        _profile_step(stepper, state, real_img, real_c, (False, False), card,
                      f"plain claro ({route} route)")
    del runs, state, stepper
    torch.cuda.empty_cache()

    # Every augment section on, default routes: one plain step, finite.
    argv = [f"--outdir={tmp}", f"--data={data}", *args, f"--aug_opts={EVERY_AUG_OPT}"]
    opts = cli.build_parser().parse_args(argv)
    _, loader, state, stepper = cli.build_training(cli.resolve_config(opts), opts, device)
    try:
        real_img, real_c = to_device_batch(*next(loader), device)
    finally:
        loader.close()
    state.ada_p = torch.tensor(0.5, device=device)
    _reset_launches()
    m = stepper.run(state, real_img, real_c, False, False)
    _read_launches(("upwarp", "upsplat"))
    for k, v in m.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"every-augment step: non-finite {k}")
    print(f"  one plain step with --aug_opts={EVERY_AUG_OPT}: losses finite, G "
          f"{float(m['Loss/G/loss'][1] / m['Loss/G/loss'][0]):.4f}, D "
          f"{float(m['Loss/D/loss'][1] / m['Loss/D/loss'][0]):.4f}")
    del state, stepper
    torch.cuda.empty_cache()
    return total


def run_metric_async(card: str, tmp: str, data: str) -> dict:
    """Phase 7: the claro recipe through the CLI for 2 kimg with a snapshot
    and fid1k each kimg and ``--metric-async``: the kimg-1 metric runs on a
    background thread, on its own stream, on a copy of G_ema
    (``training.loop.metric_snapshot``, timed here on the card and on the
    host clock) while training goes on; the kimg-2 metric runs in the
    loop.  Checks the rows stamped 1 and 2, and prints the peak device
    memory before the thread (tick 1's record) and with it overlapping
    training (tick 2's).  Returns the run's launch counts."""
    import torch

    from gantrack_tpu_torch.tools import train as cli
    from gantrack_tpu_torch.training import loop

    args = [a for a in CLARO_ARGS if not a.startswith("--kimg=")] + ["--kimg=2", "--metric-async"]
    _cli_device(cli, args)
    argv = [f"--outdir={os.path.join(tmp, 'runs_async')}", f"--data={data}", *args]
    print(f"phase 7: python -m gantrack_tpu_torch.tools.train {' '.join(argv)}")
    copies = []
    snapshot = loop.metric_snapshot

    def timed_snapshot(state):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        snap = snapshot(state)
        b.record()
        nbytes = sum(t.numel() * t.element_size()
                     for t in (*snap.G_ema.parameters(), *snap.G_ema.buffers()))
        copies.append((a, b, (time.perf_counter() - t0) * 1e3, nbytes))
        return snap

    loop.metric_snapshot = timed_snapshot
    _reset_launches()
    t0 = time.perf_counter()
    try:
        run_dir = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        loop.metric_snapshot = snapshot
    seconds = time.perf_counter() - t0
    launches = _read_launches(("upwarp", "upsplat", "fir_same", "fir_down2", "fir_up2"))
    rows = _metric_rows(run_dir, "fid1k")
    if [row["kimg"] for row in rows] != [1, 2] or len(copies) != 1:
        raise AssertionError(f"fid1k rows at kimg {[row['kimg'] for row in rows]}, "
                             f"{len(copies)} copies of G_ema for the thread: expected 1, 2 and 1")
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        peaks = [json.loads(line).get("Resources/peak_gpu_mem_gb") for line in f]
    a, b, host_ms, nbytes = copies[0]
    print(f"  CLI run: {seconds:.1f} s wall on {card}; fid1k at kimg 1 (thread) "
          f"{rows[0]['results']['fid1k']:.4f} in {rows[0]['total_time']:.2f} s, at kimg 2 (loop) "
          f"{rows[1]['results']['fid1k']:.4f} in {rows[1]['total_time']:.2f} s")
    print(f"  the thread's copy of G_ema: {nbytes / 2**20:.2f} MiB, {a.elapsed_time(b):.3f} ms on "
          f"the card, {host_ms:.3f} ms on the host clock; peak device memory by tick (GiB): "
          + ", ".join(f"{p:.2f}" for p in peaks)
          + " (tick 1 before the thread, tick 2 with it overlapping training)")
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from gantrack_tpu_torch.ops import _nvcc

    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    for source, info in _nvcc.build_all().items():
        regs = sorted({line.split("Used ")[1].split(",")[0]
                       for line in info["log"].splitlines() if "registers" in line})
        print(f"build {source}: {info['seconds']:.1f} s with nvcc (sm_90a); registers {regs}")
    print(f"build: {time.perf_counter() - t0:.1f} s wall, all sources in parallel")
    conv_build = _nvcc.BUILD_INFO["conv3x3.cu"]
    for name, r in _nvcc.kernel_resources(conv_build["log"]).items():
        print(f"  conv3x3.cu {name}: {r['registers']} registers, {r['smem']} bytes of static shared "
              f"memory, spills {r['spill_stores']} / {r['spill_loads']} bytes (stores / loads)")
    print(f"  conv3x3.cu: {_count_hgmma(conv_build['path'])}")

    def timed(label, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        print(f"{label}: {time.perf_counter() - t:.1f} s wall")
        return result

    kernels = timed("phase 1 (K1/K2)", check_kernels, card)
    kernels.update(timed("phase 1 (FIR)", check_fir, card))
    kernels.update(timed("phase 1 (warp)", check_warp, card))
    kernels.update(timed("phase 1 (probes)", check_probes, card))
    kernels.update(timed("phase 1 (conv3x3)", check_conv3x3, card))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        data = _synthetic_dataset(tmp)
        run_dir, claro = timed("phase 2", train_claro, card, tmp, data)
        timed("phase 3", run_calc_metrics, card, tmp, data, run_dir)
        sg3 = timed("phase 4", train_stylegan3, card, tmp, data)
        unfused = timed("phase 5", run_unfused_augment, card, tmp, data)
        probed = timed("phase 6 (probes)", run_probe_path)
        routed = timed("phase 6 (conv route)", run_kernel_route, card, tmp, data)
        asynced = timed("phase 7", run_metric_async, card, tmp, data)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s wall since the build began")
    # Launches on the main paths: the claro run, the StyleGAN3 run with its
    # metrics, the unfused augment steps, the probes' run, the kernel-route
    # steps and the metric-async run, each counted from 0.
    paths = {"claro": claro, "stylegan3-t": sg3, "unfused augment": unfused, "probes": probed,
             "kernel conv route": routed, "claro, metric-async": asynced}
    launches = {k: sum(counts[k] for counts in paths.values()) for k in KERNELS}
    print("kernel launches by main path: "
          + "; ".join(f"{name} { {k: n for k, n in counts.items() if n} }"
                      for name, counts in paths.items()))
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was launched on no main path")
    report = [{"name": name, "route": "cuda", "source": f"gantrack_tpu_torch/csrc/{source}",
               "replaces": replaces, "launches": launches[name], **kernels[name]}
              for name, (source, replaces) in KERNELS.items()]
    jax_modules = [m for m in sys.modules
                   if m.split(".")[0] in ("gantrack_tpu", "jax", "flax", "optax", "orbax")]
    if jax_modules:
        raise AssertionError(f"the port imported JAX or the JAX package: {sorted(jax_modules)[:5]}")
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
