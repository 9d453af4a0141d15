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
   K5–K7 (``ops/fir.py``) at the five FIR shapes of the claro step,
   four ↓2 and four ×2 shapes of StyleGAN3-T (12 taps) and its four ×4
   and four ↓4 shapes (K7 at ×4 and the ↓4 kernel, 24 taps; forward
   alone and forward + backward, one call at a time, back to back and
   cold; each kernel also at several grid sizes), and
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
3. runs ``calc_metrics`` on the run's checkpoint: fid10k with the default
   (random projection) detector (kid10k runs in phase 13), and fid1k with a
   ``tfslim`` InceptionV3 of seeded random weights at 299²; times the
   generator pass of each detector;
4. trains StyleGAN3-T at its published width, depth and batch (cbase
   32768, cmax 512, 14 layers, mapping depth 2, bf16 in the 4 highest
   rates, batch 32) through the CLI on the same dataset for 1 kimg, its
   gradients accumulated over the largest chunk (``--batch-gpu``) of 32,
   16, 8, 4 that fits the card, with ``--metrics=eqt1k_int,eqr1k`` at the
   snapshot, then runs ``calc_metrics --cfg=stylegan3-t --metrics=fid1k``
   on the checkpoint; times each phase variant of the accumulated step at
   32, with its peak memory,
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
8. runs the generation leg on the claro and StyleGAN3-T checkpoints at
   full width through the port's tools: ``gen_images`` (32 seeds, ψ 0.7,
   StyleGAN3-T also rotated and translated), ``style_mixing``,
   ``gen_video``, ``capture_layers``, ``avg_spectra`` (256 reals, 256
   fakes), ``project`` on 2 slices for 200 steps with a random-weight
   VGG16 as the LPIPS network, w-space PPL on 2000 samples and the
   visualizer's routes on localhost, which launch K5, K6 and K7; PPL
   also with ``force_fp32=True`` from the same seed (ROADMAP C12);
9. runs the claro recipe data-parallel: the CLI under ``python -m
   torch.distributed.run --nproc_per_node=1`` (an NCCL group of one rank,
   32 steps) after the four phase variants of its step, against the same
   without a process group, bit for bit; with two cards, also two ranks
   in ``rng_mode="global_sample"`` against one (each phase's gradient,
   the one rank's leaky-ReLU and clamp branches replayed near their
   thresholds: ``KinkPins``);
10. trains CycleGAN ``resnet_9blocks`` and pix2pix ``unet_256`` (ngf 64,
   256², batch 1) through ``train_i2i`` on synthetic PNG sets, runs
   ``test_i2i`` on each checkpoint, times the trainer's iteration (host
   clock and device time) with its peak memory, and holds one generator
   forward on the card against the CPU;
11. writes 4 synthetic CT volumes (256 × 256 × 40, HU; one as an
   uncompressed DICOM series), runs ``python -m
   gantrack_tpu_torch.tools.dataset_tool`` through DICOM → NIfTI →
   normalised → body mask → slice pickles → split zip → packed shards,
   writes a ``network-snapshot-*.pkl`` of phase 2's checkpoint (NVIDIA-named
   stand-ins with ``init_kwargs``), checks that the state resumed from it
   holds its G_ema bit for bit, trains the claro recipe from it on the
   packed set for 1 kimg with fid1k (K1, K2, K5–K7), and runs
   ``calc_metrics`` and ``gen_images`` on the pickle;
12. builds StyleGAN3-R at its published width (``--cbase=32768
   --cmax=512``, which the CLI doubles) and batch 32 through the CLI's
   build, in the largest chunk of 32, 16, 8, 4 that fits; from one state
   takes one +Dreg and three plain steps with D's input blur at sigma 10
   (61 taps), with host times, peak memory, the launches (K1, K2, K5–K7)
   and the plain-route FIR calls (only ``SG3_R_PLAIN_REASONS``, the blur
   among them), profiles one step of each variant, and loads a saved
   checkpoint into a fresh build bit for bit;
13. drives the research tools on the host: ``generate_jobs`` (a 2 × 2
   sweep, each script through the training CLI's parser, checks and
   config), ``analysis`` on phase 2's run (the emitted metric loop's
   first line through ``calc_metrics``, the trend, the best snapshot, a
   dry-run clean-up), ``stats_dashboard`` on localhost,
   ``analyze_dataset`` and ``create_label_files`` on phase 11's volumes
   and slice pickles, and the claro TIFF stage (``prepare_dataset`` on
   raw 512² float32 TIFFs in HU → ``dataset_tool process_tiff`` →
   ``snap_zip`` → ``pack``, opened by the port's dataset), none of it
   with PIL, OpenCV, pandas, PyYAML or click;
14. prints the kernel report and, last, the device line.

Any failed check raises, so the exit code is non-zero.  Without a CUDA
device the script exits with code 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
NET_ARGS = ["--cbase=16384", "--cmax=512", "--map-depth=2"]
# ``--devices=1``: one process on one card however many the machine shows,
# so the kernels' counts are this process's (the CLI's default is every
# visible GPU, one process each).
CLARO_ARGS = [
    "--cfg=stylegan2", "--batch=32", "--gamma=0.4096", *NET_ARGS, "--glr=0.0025",
    "--dlr=0.0025", "--aug=ada", "--target=0.6", "--mirror=1", "--kimg=1", "--tick=1",
    "--snap=1", "--metrics=fid1k", "--devices=1",
]
# name: (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "upwarp": ("upwarp.cu", "gantrack_tpu/ops/pallas/upwarp.py:137"),
    "upsplat": ("upwarp.cu", "gantrack_tpu/ops/pallas/upwarp.py:179"),
    "fir_same": ("fir.cu", "gantrack_tpu/ops/attic/fir.py:100"),
    "fir_down2": ("fir.cu", "gantrack_tpu/ops/attic/fir.py:117"),
    "fir_up2": ("fir.cu", "gantrack_tpu/ops/attic/fir.py:144"),
    # StyleGAN3's factor 4: XLA convolutions in the JAX package, no TPU kernel.
    "fir_up4": ("fir.cu", "gantrack_tpu/ops/upfirdn2d.py:146 (XLA)"),
    "fir_down4": ("fir.cu", "gantrack_tpu/ops/upfirdn2d.py:146 (XLA)"),
    # StyleGAN3-R's radial 2-D filters: XLA convolutions there too.
    "fir_down2_2d": ("fir.cu", "gantrack_tpu/ops/upfirdn2d.py:146 (XLA)"),
    "fir_up2_2d": ("fir.cu", "gantrack_tpu/ops/upfirdn2d.py:146 (XLA)"),
    # StyleGAN3's filtered leaky ReLU, which the JAX package composes from
    # XLA ops (no TPU kernel): one fused pass a direction.
    "filtered_lrelu": ("filtered_lrelu.cu", "gantrack_tpu/ops/filtered_lrelu.py (XLA)"),
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
CLARO_LIBRARY_REASONS = ("up=2, down=1", "up=1, down=2")
EVERY_AUG_OPT = ("xflip,rotate90,xint,scale,rotate,aniso,xfrac,brightness,contrast,lumaflip,hue,"
                 "saturation,imgfilter,noise,cutout")
SG3_ARGS = [
    "--cfg=stylegan3-t", "--gamma=0.4096", "--cbase=32768", "--cmax=512", "--glr=0.0025",
    "--dlr=0.0025", "--aug=ada", "--target=0.6", "--mirror=1", "--kimg=1", "--tick=1",
    "--snap=1", "--metrics=eqt1k_int,eqr1k", "--devices=1",
]
# The upfirdn2d calls of StyleGAN3-T that no FIR kernel covers (the reason
# as ``fir.fir_spec`` words it): none, since its x4 up-filters and their
# adjoints take the x4 kernels.
SG3_T_PLAIN_REASONS = ()
# Those of StyleGAN3-R: D's input blur at its initial sigma of 10 (61 taps;
# it fades over 200 kimg) (``fir.fir_spec``'s words; its radial (2-D)
# down-filters take the 2-D kernels; a step of -r at 256^2 and narrow
# widths on the CPU takes this one and no other).
SG3_R_PLAIN_REASONS = ("61 x 61 taps (at most 32 per axis)",)
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
] + [
    # StyleGAN3-T's ×4 up-filters at batch 16 (filtered_lrelu of L10, L7,
    # L5, L3): 24 taps, gain 16, the cropping pads of its layers.
    (f"StyleGAN3-T {label} (up4, 24 taps)", shape, "bf16",
     dict(filter="sg3x4", up=4, padding=[-6, -9, -6, -9], gain=16))
    for label, shape in (("150² -> 562²", (16, 256, 150, 150)),
                         ("86² -> 306²", (16, 512, 86, 86)),
                         ("54² -> 178²", (16, 512, 54, 54)),
                         ("38² -> 114²", (16, 512, 38, 38)))
] + [
    # Their ↓4 adjoints (the generator's backward): 24 taps, pads 29.
    (f"StyleGAN3-T {label} (down4, 24 taps)", shape, "bf16",
     dict(filter="sg3x4", down=4, padding=29, gain=16))
    for label, shape in (("562² -> 150²", (16, 256, 562, 562)),
                         ("306² -> 86²", (16, 512, 306, 306)),
                         ("178² -> 54²", (16, 512, 178, 178)),
                         ("114² -> 38²", (16, 512, 114, 114)))
] + [
    # StyleGAN3-R's radial 12 x 12 down-filters at L10 and L7 (batch 8 a
    # chunk, ``sg3r-256``: the filtered lrelu's ↓2, pads 0) and their ×2
    # adjoints (the generator's backward: pads 11, 10, the taps unflipped).
    (f"StyleGAN3-R {label}", shape, "bf16", dict(filter=f"sg3r_{layer}", **kw))
    for layer, label, shape, kw in (
        ("L10", "L10 562² -> 276² (down2, 12 x 12 taps)", (8, 512, 562, 562),
         dict(down=2, padding=0)),
        ("L7", "L7 306² -> 148² (down2, 12 x 12 taps)", (8, 1024, 306, 306),
         dict(down=2, padding=0)),
        ("L10", "L10 276² -> 562² (up2, 12 x 12 taps)", (8, 512, 276, 276),
         dict(up=2, padding=[11, 10, 11, 10], flip_filter=True)),
        ("L7", "L7 148² -> 306² (up2, 12 x 12 taps)", (8, 1024, 148, 148),
         dict(up=2, padding=[11, 10, 11, 10], flip_filter=True)))
]
# Grid sizes of the FIR kernels (blocks an SM) timed beside their own
# choice (``kBlocksPerSM``, ``kUpBlocksPerSM`` of csrc/fir.cu).
FIR_BLOCKS_PER_SM = (2, 4, 8, 16, 32, 64, 128, 256, 1024)
# FIR kernels that no main path launches since StyleGAN3's layers take the
# fused filtered_lrelu kernel (their only callers were those layers' two
# FIR passes): upfirdn2d still routes such calls to them, and phase 1 runs
# them at StyleGAN3's shapes.
OFF_THE_MAIN_PATHS = ("fir_up4", "fir_down4", "fir_down2_2d", "fir_up2_2d")
# Plane counts of the augment's K1/K2 calls: Dmain's fake ‖ real, Gmain's.
UPWARP_PLANES = (64, 32)
# A 12-tap StyleGAN3 low-pass of the ×2 layers (Kaiser, as the generator
# designs it: numtaps, cutoff, transition width, sampling rate).
SG3_FILTER = (12, 32.0, 16.0, 128.0)
# The 24-tap low-pass of its ×4 layers (L10's design).
SG3X4_FILTER = (24, 45.254833995939045, 37.49033200812191, 512.0)


def reference_stand_in(net, init_kwargs=None):
    """A copy of the port's network ``net`` (on the CPU) as a NVIDIA pickle
    holds its network: the resample filters in the state dict (the
    reference persists them), the ``in_channels`` / ``out_channels`` its
    conv layers carry, D's minibatch-std settings on a ``b4.mbstd`` layer
    (``group_size``, ``num_channels``; None without one) in place of the
    port's epilogue attributes and, when given, the ``init_kwargs`` that
    NVIDIA's ``persistence`` keeps.  It unpickles without the NVIDIA tree
    (and is not meant to run)."""
    import copy

    import torch

    from gantrack_tpu_torch.ops.upfirdn2d import Filter

    net = copy.deepcopy(net).cpu()
    for module in list(net.modules()):
        for name in ("resample_filter", "up_filter", "down_filter"):
            if isinstance(module.__dict__.get(name), Filter):
                module.register_buffer(name, module.__dict__.pop(name).host.clone())
        weight = getattr(module, "weight", None)
        if isinstance(weight, torch.nn.Parameter) and weight.ndim == 4:
            module.out_channels, module.in_channels = int(weight.shape[0]), int(weight.shape[1])
        if hasattr(module, "mbstd_group_size"):  # D's epilogue
            layer = torch.nn.Module()
            layer.group_size, layer.num_channels = module.mbstd_group_size, module.mbstd_num_channels
            del module.mbstd_group_size, module.mbstd_num_channels
            module.mbstd = layer if layer.num_channels > 0 else None
    if init_kwargs is not None:
        net.init_args, net.init_kwargs = (), dict(init_kwargs)
    return net


def write_reference_pickle(path: str, G, D, G_ema, g_kwargs=None, d_kwargs=None) -> str:
    """A ``network-snapshot-*.pkl`` of stand-ins (``reference_stand_in``)
    for G, D and G_ema, with the keys of the reference's snapshot."""
    import pickle

    data = {"G": reference_stand_in(G, g_kwargs), "D": reference_stand_in(D, d_kwargs),
            "G_ema": reference_stand_in(G_ema, g_kwargs), "augment_pipe": None,
            "training_set_kwargs": None}
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


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


# The probes' kernels, as ``probes.launch/<probe>`` counts them.
PROBES = ("probe_matmul", "probe_halo_tile", "probe_padded_tile", "probe_ring", "probe_concat",
          "probe_row_slice")
# The program's recorder (``utils.profiling``) that counts the kernels'
# launches and the routes for these checks: installed at first use, for
# the rest of the process.
_RECORDING: list = []


def _recorder():
    from gantrack_tpu_torch.utils import profiling

    if not _RECORDING:
        context = profiling.recording()
        _RECORDING.append((context, context.__enter__()))
    return _RECORDING[0][1]


def _reset_launches() -> None:
    """Every kernel's count, and the plain- and library-route counts, to 0."""
    rec = _recorder()
    rec.counters.clear()
    rec.spans.clear()


def _launch_counts() -> dict:
    """The kernels' launches since the last reset: ``upwarp``, ``upsplat``,
    ``fir_<form>``, ``warp``, ``splat``, ``conv3x3``, ``wgrad3x3``, each
    conv3x3 variant (``<wrapper>:<variant>``) and each probe, 0 for those
    not launched."""
    from gantrack_tpu_torch.ops import conv3x3 as c3

    rec = _recorder()
    counts = dict.fromkeys(("upwarp", "upsplat", "fir_same", "fir_down2", "fir_up2", "fir_up4",
                            "fir_down4", "fir_down2_2d", "fir_up2_2d", "filtered_lrelu", "warp",
                            "splat", "conv3x3", "wgrad3x3", *c3.VARIANTS, *PROBES), 0)
    for prefix, head in (("upwarp.launch", ""), ("fir.launch", "fir_"), ("warp.launch", ""),
                         ("conv3x3.launch", ""), ("conv3x3.variant", ""), ("probes.launch", "")):
        counts.update({head + k: n for k, n in rec.under(prefix).items()})
    counts["filtered_lrelu"] = sum(rec.under("filtered_lrelu.launch").values())
    return counts


def _plain_route() -> dict:
    """The ``upfirdn2d`` calls that took the plain version since the last
    reset, by reason."""
    return _recorder().under("upfirdn2d.plain_route")


def _no_composed_route() -> None:
    """Raise if a ``filtered_lrelu`` call since the last reset left the
    fused kernel for the composed route (every StyleGAN3 layer's spec lies
    inside its contract)."""
    composed = _recorder().under("filtered_lrelu.composed_route")
    if composed:
        raise AssertionError(f"filtered_lrelu calls took the composed route: {composed}")


def _library_route() -> dict:
    """The ``conv_impl="kernel"`` calls that stayed on the library since
    the last reset, by reason."""
    return _recorder().under("conv3x3.library_route")


def _read_launches(must_run, plain_route=(), library_route=None) -> dict:
    """The kernels' launch counts since the last reset; raises if one of
    ``must_run`` was launched no time, or if an ``upfirdn2d`` call took
    the plain version for another reason than those of ``plain_route``
    (none, for a path whose FIR calls all lie inside the kernels'
    contract).  ``library_route`` is None for a path on the default
    ``conv_impl="library"``, which must launch no conv3x3 kernel; on the
    kernel route it names the only reasons a conv may stay on the library."""
    counts = _launch_counts()
    for k in must_run:
        if counts[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by this run: {counts}")
    if not set(_plain_route()) <= set(plain_route):
        raise AssertionError(f"FIR calls left the kernels for the plain version: "
                             f"{_plain_route()}; allowed on this path: {list(plain_route)}")
    if library_route is None and (counts["conv3x3"] or counts["wgrad3x3"] or _library_route()):
        raise AssertionError(f"the default conv route launched conv3x3 kernels: {counts}")
    if not set(_library_route()) <= set(library_route or ()):
        raise AssertionError(f"convs left the kernel route for the library: {_library_route()}; "
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
    return coeffs, pipe.hz_geom.taps[0], pipe.hz_geom.on(dev), (h1, w1, oh, ow), gen


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


def _sg3r_filters() -> dict:
    """StyleGAN3-R's radial down-filters of L10 and L7 as ``sg3r-256``'s
    synthesis network designs them (host tensors)."""
    from gantrack_tpu_torch.models.stylegan3 import SynthesisNetwork

    net = SynthesisNetwork(w_dim=512, img_resolution=256, img_channels=1, channel_base=65536,
                           channel_max=1024, conv_kernel=1, use_radial_filters=True)
    return {f"sg3r_{name.split('_')[0]}": getattr(net, name).down_filter.host
            for name in net.layer_names if name.startswith(("L10_", "L7_"))}


def check_fir(card: str) -> dict:
    """Phase 1 (FIR): K5–K7, the ↓4 kernel and the 2-D forms against the
    plain ``upfirdn2d`` at the step's FIR shapes, at StyleGAN3-T's ↓2, ×2,
    ×4 and ↓4 shapes and at StyleGAN3-R's radial ↓2 and ×2 shapes.  Each shape is timed
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
               "sg3": torch.from_numpy(design_lowpass_filter(*SG3_FILTER)),
               "sg3x4": torch.from_numpy(design_lowpass_filter(*SG3X4_FILTER)),
               **_sg3r_filters()}
    report = {}
    for label, shape, step_dtype, call in FIR_SHAPES:
        kw = dict(call)
        f_host = filters[kw.pop("filter")]
        f = ufd.Filter(f_host)
        spec, _ = fir.fir_spec(f_host, f.taps, kw.get("up", 1), kw.get("down", 1),
                               kw.get("padding", 0), kw.get("flip_filter", False),
                               kw.get("gain", 1))
        name = f"fir_{spec.kernel}"

        def kernel(x):
            return ufd.upfirdn2d(x, f, **kw)

        def plain(x):
            return ufd.upfirdn2d_plain(x, f.on(dev), **kw)

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
        # ky then kx taps per output (a half or a quarter of them for the
        # polyphase up2 and up4), or the ky * kx taps of a 2-D filter (a
        # quarter at up2), 2 flops a tap.  Forward + backward: twice that.
        ky, kx = len(spec.taps_y), len(spec.taps_x)
        up = fir.FACTORS[spec.form][0]
        taps_per_out = ky * kx / up ** 2 if spec.taps_2d else (ky + kx) / up
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


# The fused filtered_lrelu rows of phase 1: StyleGAN3-T's L10 and L7 at
# its chunk of 16, StyleGAN3-R's at its chunk of 8 (``sg3t-256``,
# ``sg3r-256``), bf16: (label, configuration, layer).
FLRL_ROWS = (("StyleGAN3-T L10", "t", "L10", 16), ("StyleGAN3-T L7", "t", "L7", 16),
             ("StyleGAN3-R L10", "r", "L10", 8), ("StyleGAN3-R L7", "r", "L7", 8))


def flrl_layer(cfg: str, layer: str, batch: int):
    """A StyleGAN3 layer's ``filtered_lrelu`` call as ``SynthesisLayer``
    makes it at 256² (``cfg`` "t" or "r" at the benchmark's widths):
    (input shape [batch, C, H, W], the call's keyword arguments)."""
    from gantrack_tpu_torch.models.stylegan3 import SynthesisNetwork

    r = cfg == "r"
    net = SynthesisNetwork(w_dim=8, img_resolution=256, img_channels=1,
                           channel_base=65536 if r else 32768, channel_max=1024 if r else 512,
                           conv_kernel=1 if r else 3, use_radial_filters=r)
    name = next(n for n in net.layer_names if n.startswith(layer + "_"))
    m = getattr(net, name)
    size = m.spec.in_size + m.conv_kernel - 1
    kw = dict(fu=m.up_filter, fd=m.down_filter, up=m.up_factor, down=m.down_factor,
              padding=m.padding, gain=2 ** 0.5, slope=0.2, clamp=m.conv_clamp)
    return (batch, m.spec.out_channels, size, size), kw


def _flrl_work(spec) -> tuple:
    """Multiply-adds of one pass of the fused kernel (the polyphase up
    pass, separable or 2-D, then the down pass) and the samples of its mid
    grid."""
    from gantrack_tpu_torch.ops.fir import FACTORS

    (ih, iw), (mh, mw), (oh, ow) = spec.in_hw, spec.mid_hw, spec.out_hw
    u, d = FACTORS[spec.up.form][0], FACTORS[spec.down.form][1]
    ku, kd = len(spec.up.taps_y), len(spec.down.taps_y)
    if spec.up.taps_2d:
        up = mh * mw * (ku / u) ** 2
    else:
        up = (mh * iw + mh * mw) * ku / u
    down = oh * ow * kd * kd if spec.down.taps_2d else (oh * mw + oh * ow) * kd
    return up + down, mh * mw


def _device_ops(fn) -> int:
    """The kernels and copies that one call of ``fn`` puts on the card, as
    the profiler records them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type.name == "CUDA")


def check_filtered_lrelu(card: str) -> dict:
    """Phase 1 (fused filtered_lrelu): the fused kernel at ``FLRL_ROWS``
    against the composed route (``bias_act`` and the FIR kernels, the
    ``plain_ms`` of its row) and the plain form in float64 (on 4 planes),
    forward alone and forward + backward, one call at a time and back to
    back, beside its bound: the input, output and code bytes over the
    memory rate, or the multiply-adds as f32 FMAs, whichever is larger;
    and the device ops a call of each route puts on the card.  Returns the
    first row as the kernel's report entry."""
    import importlib

    import torch

    flrl = importlib.import_module("gantrack_tpu_torch.ops.filtered_lrelu")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    report = {}
    for label, cfg, layer, batch in FLRL_ROWS:
        shape, kw = flrl_layer(cfg, layer, batch)
        x = (torch.randn(shape, device=dev, generator=gen) * 1.5).bfloat16()
        b = (torch.randn(shape[1], device=dev, generator=gen) * 0.3).bfloat16()
        spec, why = flrl.fused_spec(x, kw["fu"], kw["fd"], b, kw["up"], kw["down"],
                                    kw["padding"], kw["gain"], kw["slope"], kw["clamp"])
        if spec is None:
            raise AssertionError(f"{label}: outside the fused kernel's contract ({why})")
        n, c, h, w = shape
        pads = list(kw["padding"])

        def fused(xi):
            return flrl.filtered_lrelu(xi, b=b, **kw)

        def composed(xi):
            return flrl._composed(xi, kw["fu"], kw["fd"], b, kw["up"], kw["down"], pads, kw["gain"],
                             kw["slope"], kw["clamp"])

        got, ref = fused(x), composed(x)
        print(f"phase 1 fused filtered_lrelu {label}: bf16 {list(shape)} -> {list(got.shape)} "
              f"({spec.kernel}, mid {spec.mid_hw}; backward {spec.adjoint().kernel})")
        err = _max_err(got, ref)
        _check(f"{label} fused vs composed (bf16)", err, 4e-2 * float(ref.abs().max()))
        x4, b4 = x[:1, :4].contiguous(), b[:4].contiguous()
        spec4, _ = flrl.fused_spec(x4, kw["fu"], kw["fd"], b4, kw["up"], kw["down"],
                                   kw["padding"], kw["gain"], kw["slope"], kw["clamp"])
        planes = x4.reshape(4, h, w)
        y4, sign4 = flrl.fused_planes(planes, spec4, b4, None, 4)
        want4, _ = flrl._plain_planes(planes.double(), spec4, b4.double(), None, 4)
        _check(f"{label} fused vs plain form (float64)", _max_err(y4, want4),
               1e-2 * float(want4.abs().max()))
        del got, ref, y4, sign4, want4
        xt = x.clone().requires_grad_(True)
        gt = torch.randn((n, c, *spec.out_hw), device=dev, generator=gen).bfloat16()
        t = {"fwd": _median_ms(lambda: fused(x)), "fwd b2b": _b2b_ms(lambda: fused(x)),
             "fb": _median_ms(lambda: torch.autograd.grad(fused(xt), xt, gt)),
             "fb b2b": _b2b_ms(lambda: torch.autograd.grad(fused(xt), xt, gt)),
             "fwd plain": _median_ms(lambda: composed(x), 5),
             "fb plain": _median_ms(lambda: torch.autograd.grad(composed(xt), xt, gt), 5)}
        launches = {k: _device_ops(f) for k, f in (
            ("fwd", lambda: fused(x)), ("fb", lambda: torch.autograd.grad(fused(xt), xt, gt)),
            ("fwd plain", lambda: composed(x)),
            ("fb plain", lambda: torch.autograd.grad(composed(xt), xt, gt)))}
        macs_f, mid = _flrl_work(spec)
        macs_b, _ = _flrl_work(spec.adjoint())
        words = n * c * spec.mid_hw[0] * spec.words * 4
        bound_f = _bound(_nbytes(x, gt) + words, n * c * macs_f * 2)
        bound = _bound(2 * _nbytes(x, gt) + 2 * words, n * c * (macs_f + macs_b) * 2)
        print(f"  fused filtered_lrelu {label} bf16 on {card}, ms (one call at a time / back to "
              f"back): forward {t['fwd']:.4f} / {t['fwd b2b']:.4f}, composed {t['fwd plain']:.4f}, "
              f"bound {bound_f['bound_ms']:.4f} ({bound_f['bound_by']}); forward+backward "
              f"{t['fb']:.4f} / {t['fb b2b']:.4f}, composed {t['fb plain']:.4f}, bound "
              f"{bound['bound_ms']:.4f} ({bound['bound_by']}); {macs_f * n * c / 1e9:.2f} + "
              f"{macs_b * n * c / 1e9:.2f} G multiply-adds, {mid * n * c / 1e9:.3f} G mid samples, "
              f"codes {words / 2**20:.1f} MiB; device ops a call: forward {launches['fwd']} "
              f"(composed {launches['fwd plain']}), forward+backward {launches['fb']} "
              f"(composed {launches['fb plain']})")
        if "filtered_lrelu" not in report:
            report["filtered_lrelu"] = {"max_abs_err": err, "ms": t["fwd"],
                                        "plain_ms": t["fwd plain"], **bound_f, "library_ms": None,
                                        "dtype": "bf16", "library_dtype": None,
                                        "ms_at_library_dtype": None}
        del x, xt, gt
        torch.cuda.empty_cache()
    return report


def _fir_library_call(spec, channels: int, dev, dtype):
    """One ``torch.nn.functional`` call that computes the FIR of ``spec``
    on ``[N, channels, H, W]``, or None where no one call does: for same,
    down2 and down4 the depthwise ``F.conv2d`` (stride 1, 2 or 4) where
    each axis has equal pads or pads ≤ 0 (a view crops those first); for
    up2 and up4 the depthwise ``F.conv_transpose2d(stride=u, padding=q)``
    with q = k − 1 − p0 ≥ 0 and p1 − p0 + u − 1 in 0 .. u − 1 (the
    ``output_padding``)."""
    import torch
    import torch.nn.functional as F

    from gantrack_tpu_torch.ops import fir

    ty = torch.tensor(spec.taps_y, dtype=torch.float64)
    tx = torch.tensor(spec.taps_x, dtype=torch.float64)
    # Correlation taps, gain folded in.
    w2 = torch.tensor(spec.taps_2d, dtype=torch.float64) if spec.taps_2d else torch.outer(ty, tx)
    py0, py1, px0, px1 = spec.pads
    ky, kx = len(ty), len(tx)
    up, stride = fir.FACTORS[spec.form]
    if up > 1:
        q, extra = (ky - 1 - py0, kx - 1 - px0), (py1 - py0 + up - 1, px1 - px0 + up - 1)
        if min(q) < 0 or not set(extra) <= set(range(up)):
            return None
        w = w2.flip([0, 1]).to(dev, dtype)[None, None].repeat(channels, 1, 1, 1)
        return lambda x: F.conv_transpose2d(x, w, stride=up, padding=q, output_padding=extra,
                                            groups=channels)
    w = w2.to(dev, dtype)[None, None].repeat(channels, 1, 1, 1)
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
        _reset_launches()
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
        ran = {k: n for k, n in _launch_counts().items() if ":" in k and n}
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
          f"peak GPU mem {last.get('Resources/peak_gb_in_use', float('nan')):.2f} GB")
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
    # kid10k with the default detector runs in phase 13, through the metric
    # loop that tools/analysis.py emits for this run.
    for metrics, extra in (("fid10k", []), ("fid1k", [f"--detector-weights={weights}"])):
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

    out = {}
    for label, flags in variants:
        _reset_launches()
        stepper.run(state, real_img, real_c, *flags)
        print(f"  kernel launches of one {label} step: "
              f"{ {k: n for k, n in _read_launches((), plain_route, library_route).items() if n} }"
              f"; plain-route FIR calls {_plain_route()}")
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


def _pick_batch_gpu(cli, tmp: str, data: str, args, device, batch: int = 32,
                    sizes=(32, 16, 8, 4)) -> int:
    """The largest chunk of ``sizes`` (``--batch-gpu``) at which one +Dreg
    step of ``--batch=batch`` fits the card with room to spare: its peak
    must stay under 80 % of the card's memory, because the CLI run also
    renders image grids and evaluates metrics between steps, and the
    caching allocator fragments (unaccumulated, batch 32 peaked at 94 % of
    an 80 GB card and the run then ran out in G-main).  Running out of
    device memory here is the question asked, so it is caught; nothing
    else is."""
    import torch

    from gantrack_tpu_torch.training.loop import to_device_batch

    for batch_gpu in sizes:
        argv = [f"--outdir={tmp}", f"--data={data}", f"--batch={batch}",
                f"--batch-gpu={batch_gpu}", *args]
        opts = cli.build_parser().parse_args(argv)
        cli.check_slice(opts)
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
        print(f"  batch {batch} in chunks of {batch_gpu}: one +Dreg step "
              + (f"peaks at {peak:.2f} GiB of {total:.2f} GiB" if fits
                 else f"runs out of memory (at {peak:.2f} GiB of {total:.2f} GiB)")
              + ("" if roomy else ": not taken"))
        del state, stepper, real_img, real_c
        torch.cuda.empty_cache()
        if roomy:
            return batch_gpu
    raise AssertionError(f"batch {batch} fits the card in no chunk of {sizes}")


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
_HAND_ROWS = ("FIR ", "K1 ", "K2 ", "K3 ", "K4 ", "fused filtered_lrelu")
_DTYPES = {"__nv_bfloat16": "bf16", "float": "f32"}


def kernel_label(name: str) -> str:
    """A profiler row named by what it computes where it is a FIR kernel
    (``fir_kernel<T, form, taps>``: form 0 same, 1 down2, 2 up2; the
    polyphase ``fir_up_kernel<T, factor, taps>``; ``fir_down4_kernel<T,
    taps>``; the 2-D forms ``fir_kernel<T, 1, KY, KX>`` and
    ``fir_up_kernel<T, 2, KY, KX>``; taps 0 is the generic tap loop) or a
    warp kernel (K1–K4), else the kernel's own name."""
    import re

    m = re.search(r"\b(" + "|".join(_WARP_ROWS) + r")<([\w:]+)", name)
    if m:
        kind, dtype = m.groups()
        return f"{_WARP_ROWS[kind]}, {_DTYPES.get(dtype, dtype)} [{kind}]"
    m = re.search(r"\bfiltered_lrelu_kernel<([\w:]+), (\d), (\d), (\w+), (\w+)>", name)
    if m:
        dtype, up, down, up2d, down2d = m.groups()
        tag = " 2-D up" if up2d == "true" else " 2-D down" if down2d == "true" else ""
        return (f"fused filtered_lrelu up{up} down{down}{tag}, {_DTYPES.get(dtype, dtype)} "
                f"[filtered_lrelu_kernel]")
    m = re.search(r"\b(fir_kernel|fir_up_kernel)<([\w:]+), (\d+), (\d+), (\d+)>", name)
    if m:  # a 2-D filter: (form or factor), KY, KX
        kind, dtype, form, ky, kx = m.groups()
        what = "down2 2-D" if kind == "fir_kernel" else f"up{form} 2-D"
        size = f"{ky} x {kx}" if ky != "0" else "any"
        return f"FIR {what}, {size} taps, {_DTYPES.get(dtype, dtype)} [{kind}]"
    m = re.search(r"\b(fir_down4_kernel)<([\w:]+), (\d+)>", name)
    if m:
        kind, dtype, taps = m.groups()
        form, what = "4", "down4"
    else:
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
    {"total_ms", "rows": {label: ms}}.  Also the host and the device
    milliseconds of each phase of the step (the program's top-level spans,
    ``utils.profiling``; the device's by the launches made inside them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gantrack_tpu_torch.ops import fir
    from gantrack_tpu_torch.utils import profiling

    with profiling.recording() as rec, \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stepper.run(state, real_img, real_c, *flags)
        torch.cuda.synchronize()
    device, share = profiling.launched_device_us(rec.spans, prof)
    phases = [f"{n} {(b - a) / 1e6:.1f} / {us / 1e3:.1f}"
              for (n, parent, a, b, _, _), us in zip(rec.spans, device) if parent is None]
    print(f"  phases of one {label} step, host / device ms (the device's by launch; "
          f"{share!r} of its busy time launched in them): {', '.join(phases)}")
    blur: dict = {}
    for (n, parent, a, b, _, _), us in zip(rec.spans, device):
        if n == "d_blur":  # StyleGAN3-R's D input blur, by the phase it ran in
            while rec.spans[parent][1] is not None:
                parent = rec.spans[parent][1]
            phase = rec.spans[parent][0]
            host_ms, device_ms = blur.get(phase, (0.0, 0.0))
            blur[phase] = (host_ms + (b - a) / 1e6, device_ms + us / 1e3)
    if blur:
        print(f"  D's blur (the d_blur spans) of one {label} step by phase, host / device ms: "
              + ", ".join(f"{n} {h:.2f} / {d:.2f}" for n, (h, d) in blur.items()))
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
             for form in fir.FORMS}
    warps = {w: sum(t for k, t in rows.items() if k.startswith(w)) for w in _HAND_ROWS[1:5]}
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
    """Phase 4: StyleGAN3-T at full width and its published batch 32
    (gradients accumulated over chunks of ``--batch-gpu``) through the CLI
    with the equivariance metrics at the snapshot, then ``calc_metrics``
    on its checkpoint.  Returns the run dir and the launch counts of both
    runs, summed."""
    import numpy as np
    import torch

    from gantrack_tpu_torch.tools import calc_metrics
    from gantrack_tpu_torch.tools import train as cli
    from gantrack_tpu_torch.training.loop import to_device_batch
    from gantrack_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint

    device = _cli_device(cli, args)
    batch = 32
    print(f"phase 4: StyleGAN3-T at full width, batch {batch}; the largest chunk (--batch-gpu) "
          "of 32, 16, 8 that fits")
    batch_gpu = _pick_batch_gpu(cli, tmp, data, args, device, batch)
    argv = [f"--outdir={os.path.join(tmp, 'runs3')}", f"--data={data}", f"--batch={batch}",
            f"--batch-gpu={batch_gpu}", *args]
    print(f"phase 4: python -m gantrack_tpu_torch.tools.train {' '.join(argv)}")
    _reset_launches()
    t0 = time.perf_counter()
    run_dir = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read_launches(("upwarp", "upsplat", "fir_same", "fir_down2", "filtered_lrelu",
                               "warp"), SG3_T_PLAIN_REASONS)
    _no_composed_route()
    print(f"  CLI run: {seconds:.1f} s wall (incl. setup, image grids and the eq metrics) on "
          f"{card}; kernel launches {launches}")
    print(f"  upfirdn2d calls outside the FIR kernels' contract (plain route) in the run: "
          f"{sum(_plain_route().values())}, by reason {_plain_route()}")
    if _plain_route():
        raise AssertionError(f"StyleGAN3-T calls took the plain route: {_plain_route()}")

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
          f"peak GPU mem {last.get('Resources/peak_gb_in_use', float('nan')):.2f} GB")
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

    # The accumulated step at 32 with its peak memory (the unaccumulated
    # step at 16, 1.979x faster in PR 10, is no longer timed here).
    variants = (("plain", (False, False)), ("+Dreg", (False, True)))
    label = f"batch {batch} in {stepper.cfg.micro_batches} chunks of {batch_gpu}"
    torch.cuda.reset_peak_memory_stats()
    times = _step_times(stepper, state, real_img, real_c, variants, SG3_T_PLAIN_REASONS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for variant, ms in times.items():
        print(f"  step {variant}, {label}: median {ms:.1f} ms of 3 ({res}^2; "
              f"{batch / ms * 1e3:.1f} img/s) on {card}")
    print(f"  peak device memory over those steps ({label}): {peak:.2f} GiB on {card}")
    _profile_step(stepper, state, real_img, real_c, (False, False), card, "plain StyleGAN3-T")
    _probe_metric_batch(cli, state.G_ema, card, res)
    del state, stepper, real_img, fakes
    torch.cuda.empty_cache()

    # fid1k only: the run's snapshot already evaluated eqt1k_int and eqr1k.
    argv = [f"--network={run_dir}", f"--data={data}", "--metrics=fid1k",
            *(a for a in args if a.startswith(("--cfg=", "--cbase=", "--cmax=")))]
    print(f"phase 4: python -m gantrack_tpu_torch.tools.calc_metrics {' '.join(argv)}")
    trained = dict(launches)
    _reset_launches()
    t0 = time.perf_counter()
    results = calc_metrics.main(argv)
    torch.cuda.synchronize()
    launches = _read_launches(("filtered_lrelu",), SG3_T_PLAIN_REASONS)
    _no_composed_route()
    print(f"  {results} in {time.perf_counter() - t0:.1f} s on {card}; kernel launches "
          f"{ {k: n for k, n in launches.items() if n} }; plain-route FIR calls "
          f"{_plain_route()}")
    _metric_rows(run_dir, "fid1k")
    return run_dir, {k: trained[k] + launches[k] for k in trained}


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
    launches = _read_launches(PROBES)
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
                       library_route=CLARO_LIBRARY_REASONS if route == "kernel" else None)
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
        counts = _read_launches(("conv3x3", "wgrad3x3"), library_route=CLARO_LIBRARY_REASONS)
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
              f"to the library {_library_route()}")
    for label in ("+Greg", "+Dreg", "+Greg+Dreg"):
        for k in ("conv3x3", "wgrad3x3"):
            if per_variant[label][k] <= per_variant["plain"][k]:
                raise AssertionError(f"the {label} step launched {k} no more often than the plain "
                                     f"step: the second differentiation left the kernels")

    times = {route: _step_times(stepper, state, real_img, real_c, variants,
                                library_route=CLARO_LIBRARY_REASONS if route == "kernel" else None)
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
        peaks = [json.loads(line).get("Resources/peak_gb_in_use") for line in f]
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


def _record_fir_calls():
    """Start noting every FIR kernel call: ``({(spec, planes shape, dtype):
    calls}, stop)``; ``stop()`` puts the plain wrapper back."""
    from gantrack_tpu_torch.ops import fir

    calls = {}
    launch = fir.fir_planes

    def recording(x, spec, **kw):
        key = (spec, tuple(x.shape), x.dtype)
        calls[key] = calls.get(key, 0) + 1
        return launch(x, spec, **kw)

    fir.fir_planes = recording
    return calls, lambda: setattr(fir, "fir_planes", launch)


def check_fir_calls(card: str, calls: dict, path: str) -> None:
    """Every distinct FIR call a path made (its spec, planes and dtype),
    once more on a seeded random input: the kernel against ``fir_plain``
    at phase 1's limits, 1e-5 of the largest output in float32 and 1e-2
    in bf16 (the output's rounding).  These launches are not the path's."""
    import torch

    from gantrack_tpu_torch.ops import fir

    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {}
    for (spec, shape, dtype), n in calls.items():
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        ref = fir.fir_plain(x.float(), spec)
        err = _max_err(fir.fir_planes(x, spec), ref)
        limit = (1e-2 if dtype == torch.bfloat16 else 1e-5) * float(ref.abs().max())
        name = f"fir_{spec.kernel}"
        label = f"{list(shape)} {str(dtype)[6:]} pads {spec.pads}, {len(spec.taps_y)} taps"
        if err > limit:
            raise AssertionError(f"{path}: {name} {label}: error {err} above limit {limit}")
        count, total, most = worst.get(name, (0, 0, (-1.0, "")))
        worst[name] = (count + 1, total + n, max(most, (err / limit, label)))
        del x, ref
    torch.cuda.empty_cache()
    for name, (count, total, (ratio, label)) in sorted(worst.items()):
        print(f"  {name} on {path}'s own shapes: {count} distinct calls (of {total} on the "
              f"path), each against the plain version; worst error {ratio:.3f} of its limit, "
              f"at {label} on {card}")


def compare_generation_routes(card: str, G, G3, vgg, target) -> None:
    """The generation leg's two uses of the FIR kernels end to end, once on
    the kernels and once with every kernel call replaced by its plain
    version (``fir_plain`` in float32 on the same input, rounded to the
    input's dtype, as phase 1 holds the kernels), on the same inputs: one
    projector step (forward and backward through the claro synthesis at
    batch 1, VGG16 LPIPS at 224²) at the card test's limits (loss rel
    1e-3; gradients of w and of each noise buffer at relative norm error
    ≤ 1e-2), and the images of two seeds, ψ 0.7, at batch 1 of claro and
    of the rotated and translated StyleGAN3-T (relative norm error
    ≤ 1e-2)."""
    import torch

    from gantrack_tpu_torch.models.vgg import lpips_features
    from gantrack_tpu_torch.ops import fir
    from gantrack_tpu_torch.tools import gen_images, projector

    dev = torch.device("cuda")
    cfg = projector.ProjectorConfig()
    w_avg, _ = projector.compute_w_stats(G, 1000)
    gen = torch.Generator().manual_seed(1)
    noise0 = {n: torch.randn(b.shape, generator=gen)
              for n, b in projector.noise_buffers(G).items()}
    feature_fn = lambda x: lpips_features(vgg, x)  # noqa: E731
    z = [gen_images.seed_latent(seed, G.z_dim).to(dev) for seed in (0, 1)]

    def run():
        w = w_avg.clone().requires_grad_(True)
        noise = {n: b.to(dev).requires_grad_(True) for n, b in noise0.items()}
        modes = projector.target_modalities(target, dev)
        with torch.no_grad():
            feats = [feature_fn(m) for m in modes]
        loss, *_ = projector.projection_loss(G, w, noise, modes, feats, feature_fn, cfg)
        grads = torch.autograd.grad(loss, [w, *noise.values()])
        with torch.no_grad():
            images = [g(zi, None, truncation_psi=0.7, noise_mode="const")
                      for g in (G, G3) for zi in z]
        torch.cuda.synchronize()
        return float(loss.detach()), grads, images

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))

    _reset_launches()
    loss_k, grads_k, images_k = run()
    if not set(_plain_route()) <= set(SG3_T_PLAIN_REASONS):
        raise AssertionError(f"FIR calls left the kernels: {_plain_route()}")
    launch, launched = fir.fir_planes, _launch_counts()
    fir.fir_planes = lambda x, spec, **kw: fir.fir_plain(x.float(), spec).to(x.dtype)
    try:
        loss_p, grads_p, images_p = run()
    finally:
        fir.fir_planes = launch
    if _launch_counts() != launched:
        raise AssertionError("the plain run launched FIR kernels")
    _reset_launches()
    _check("projector step loss, kernels vs plain (relative)", abs(loss_k - loss_p) / abs(loss_p),
           1e-3)
    _check(f"projector step gradients of w and {len(grads_k) - 1} noise buffers, kernels vs "
           "plain (worst relative norm error)", max(map(rel, grads_k, grads_p)), 1e-2)
    for i, label in enumerate(("claro seed 0", "claro seed 1", "StyleGAN3-T rotated seed 0",
                               "StyleGAN3-T rotated seed 1")):
        _check(f"{label} image, kernels vs plain (relative norm error)",
               rel(images_k[i], images_p[i]), 1e-2)
    print(f"  (the generation leg's kernels against the plain route on {card})")


def run_generation(card: str, tmp: str, data: str, claro_dir: str, sg3_dir: str) -> dict:
    """Phase 8: the generation leg on phase 2's claro checkpoint and phase
    4's StyleGAN3-T checkpoint, at full width, through the port's tools:
    ``gen_images`` (32 seeds, ψ 0.7; StyleGAN3-T also rotated and
    translated), ``style_mixing`` 3×3, ``gen_video`` as a frame directory,
    ``capture_layers`` for one seed, ``avg_spectra`` on 256 reals and 256
    fakes, ``project`` on 2 dataset slices for 200 steps each with a
    seeded random-weight VGG16 at 224² as the LPIPS network (the loss must
    fall and the noise buffers stay normalised), ``compute_ppl`` in w space
    at the path's end on 2000 samples with the same VGG16 as its detector,
    and the visualizer served on localhost with its three routes fetched.
    Every PNG must decode with the port's reader.  K5, K6 and K7 must
    launch.  Then every distinct FIR call of the phase is checked against
    the plain version (``check_fir_calls``), and the projector step and
    the batch-1 images against the plain route end to end
    (``compare_generation_routes``).  Returns the launch counts of the
    phase."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from gantrack_tpu_torch.data import open_dataset
    from gantrack_tpu_torch.metrics import metric_utils
    from gantrack_tpu_torch.metrics.ppl import compute_ppl
    from gantrack_tpu_torch.models.vgg import lpips_features, random_vgg
    from gantrack_tpu_torch.tools import (avg_spectra, capture_layers, gen_images, gen_video,
                                          projector, style_mixing, visualizer)
    from gantrack_tpu_torch.utils.checkpoint import decode_png

    claro = [f"--network={claro_dir}", "--resolution=256", "--channels=1", *NET_ARGS]
    sg3 = [f"--network={sg3_dir}", "--resolution=256", "--channels=1",
           *(a for a in SG3_ARGS if a.startswith(("--cfg=", "--cbase=", "--cmax=")))]
    out = os.path.join(tmp, "generation")
    dev = torch.device("cuda")

    def png(path, shape):
        with open(path, "rb") as f:
            pixels = decode_png(f.read())
        if pixels.shape != shape or pixels.min() == pixels.max():
            raise AssertionError(f"{path}: {pixels.shape} (want {shape}), "
                                 f"range {pixels.min()}..{pixels.max()}")
        return pixels

    def timed_call(label, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        print(f"  {label}: {seconds:.2f} s wall on {card}")
        return result, seconds

    _reset_launches()
    fir_calls, stop_recording = _record_fir_calls()
    for name, net, extra in (("claro", claro, []),
                             ("stylegan3-t", sg3, ["--rotate=10", "--translate=0.1,-0.05"])):
        paths, seconds = timed_call(
            f"gen_images {name}, 32 seeds, psi 0.7 {' '.join(extra)} (checkpoint load included)",
            gen_images.main,
            [*net, "--seeds=0-31", "--trunc=0.7", *extra, f"--outdir={out}/{name}"])
        if len(paths) != 32:
            raise AssertionError(f"gen_images wrote {len(paths)} images")
        first = [png(p, (256, 256)) for p in paths[:2]]
        if np.array_equal(*first):
            raise AssertionError("two seeds gave the same image")
    (grid,), _ = timed_call("style_mixing 3x3 (checkpoint load included)", style_mixing.main,
                            [*claro, "--rows=0-2", "--cols=3-5", f"--outdir={out}/mix"])
    png(grid, (4 * 256, 4 * 256))
    frames, _ = timed_call(
        "gen_video 2x1 grid, 2 keyframes, 4 frames each (checkpoint load included)",
        gen_video.main, [*claro, "--seeds=0-3", "--grid=2x1", "--w-frames=4",
                         f"--output={out}/video"])
    names = sorted(os.listdir(f"{out}/video"))
    if frames != 8 or len(names) != 8:
        raise AssertionError(f"gen_video: {frames} frames, files {names}")
    png(os.path.join(out, "video", names[-1]), (256, 512))
    written, _ = timed_call("capture_layers seed 0 (checkpoint load included)", capture_layers.main,
                            [*claro, "--seeds=0", "--layer=b(64|256)/conv1$", "--save-pngs",
                             f"--outdir={out}/layers"])
    if written[0] != ["synthesis/b64/conv1", "synthesis/b256/conv1"]:
        raise AssertionError(f"capture_layers wrote {written}")
    act = np.load(os.path.join(out, "layers", "seed0000", "synthesis_b256_conv1.npy"))
    if act.shape != (256, 256, 64) or not np.isfinite(act).all():
        raise AssertionError(f"b256 conv1 activations {act.shape}")
    png(os.path.join(out, "layers", "seed0000", "synthesis_b256_conv1.png"), (8 * 256, 8 * 256))
    spectra, _ = timed_call(
        "avg_spectra, 256 reals and 256 fakes (checkpoint load included)", avg_spectra.main,
        [*claro, f"--data={data}", "--num=256", f"--outdir={out}/spectra"])
    if not all(np.isfinite(v).all() for v in spectra.values()):
        raise AssertionError("non-finite spectra")
    print(f"  spectra: azimuthal average at the highest bin, real {spectra['az_real'][-1]:.4e}, "
          f"generated {spectra['az_fake'][-1]:.4e}")

    opts = visualizer.build_parser().parse_args(claro)
    G = gen_images.load_generator(opts, dev)
    httpd = visualizer.serve(visualizer.RenderEngine(G, 1), "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        t = time.perf_counter()
        with urllib.request.urlopen(f"{base}/api/render?seed=1&psi=0.7&mix_seed=2&mix_cutoff=6",
                                    timeout=120) as r:
            render_ms = r.headers["X-Render-Ms"]
            img = decode_png(r.read())
        with urllib.request.urlopen(f"{base}/api/layers", timeout=120) as r:
            layers = json.loads(r.read())["layers"]
        with urllib.request.urlopen(f"{base}/api/layer?name=synthesis/b64/conv1&seed=1",
                                    timeout=120) as r:
            grid = decode_png(r.read())
        seconds = time.perf_counter() - t
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
    if img.shape != (256, 256) or grid.shape != (8 * 64, 8 * 64) or len(layers) < 20:
        raise AssertionError(f"visualizer: render {img.shape}, layer grid {grid.shape}, "
                             f"{len(layers)} layers")
    print(f"  visualizer on localhost: /api/render ({render_ms} ms to render), /api/layers "
          f"({len(layers)} layers), /api/layer: {seconds:.2f} s wall for the three on {card}")

    vgg = random_vgg(0, device=dev)
    feature_fn = lambda x: lpips_features(vgg, x)  # noqa: E731
    dataset = open_dataset(data)
    cfg = projector.ProjectorConfig(num_steps=200)
    for idx in (0, 1):
        target = np.asarray(dataset[idx][0], np.float32) / 127.5 - 1.0
        torch.cuda.reset_peak_memory_stats()
        result, seconds = timed_call(
            f"project slice {idx}, {cfg.num_steps} steps", projector.project, G, target,
            feature_fn, cfg)
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = result["losses"]
        rms = {n: float(np.sqrt(np.mean(b ** 2))) for n, b in result["noise"].items()}
        means = {n: float(np.mean(b)) for n, b in result["noise"].items()}
        print(f"  project slice {idx}: {seconds / cfg.num_steps * 1e3:.2f} ms a step (wall over "
              f"the call, w statistics and target features included), peak {peak:.2f} GiB on "
              f"{card}; loss {losses[0]:.2f} -> {losses[-1]:.2f} (best {min(losses):.2f} at "
              f"step {result['best_step']}); {len(rms)} noise buffers, RMS "
              f"{min(rms.values()):.6f}..{max(rms.values()):.6f}")
        if not losses[-1] < losses[0] or not np.isfinite(losses).all():
            raise AssertionError(f"projection loss did not fall: {losses[0]} -> {losses[-1]}")
        if max(abs(r - 1) for r in rms.values()) > 1e-3 or max(map(abs, means.values())) > 1e-3:
            raise AssertionError(f"noise buffers not normalised: RMS {rms}, means {means}")

    mopts = metric_utils.MetricOptions(
        generator=lambda z, c: G(z, c, noise_mode="const"),
        mapping=lambda z, c: G.mapping(z, c),
        synthesis=lambda ws: G.synthesis(ws, noise_mode="const"),
        z_dim=G.z_dim, detector=metric_utils.make_vgg_detector(seed=0, device=dev), device=dev)
    value, seconds = timed_call("compute_ppl w space, end, 2000 samples (VGG16 detector)",
                                compute_ppl, mopts, 2000, 1e-4, "w", "end")
    if not np.isfinite(value) or value <= 0:
        raise AssertionError(f"PPL {value}")
    print(f"  ppl (w, end, 2000 samples, random-weight VGG16): {value:.4f}")
    # ROADMAP C12: the same seed with the pairs synthesised in float32 (as
    # NVIDIA's PPLSampler does), beside the bf16 layers both packages use.
    mopts32 = dataclasses.replace(
        mopts, synthesis=lambda ws: G.synthesis(ws, noise_mode="const", force_fp32=True))
    value32, _ = timed_call("compute_ppl as above, synthesis with force_fp32=True",
                            compute_ppl, mopts32, 2000, 1e-4, "w", "end")
    if not np.isfinite(value32) or value32 <= 0:
        raise AssertionError(f"PPL (force_fp32) {value32}")
    print(f"  C12: ppl of the claro checkpoint, seed {mopts.seed}, 2000 samples: {value:.6f} as "
          f"is (top 4 resolutions in bf16), {value32:.6f} with force_fp32=True, on {card}")
    launches = _read_launches(("fir_same", "fir_down2", "fir_up2", "filtered_lrelu"),
                              SG3_T_PLAIN_REASONS)
    stop_recording()
    print(f"  kernel launches of the generation leg: "
          f"{ {k: n for k, n in launches.items() if n} }")

    check_fir_calls(card, fir_calls, "the generation leg")
    G3 = gen_images.load_generator(visualizer.build_parser().parse_args(sg3), dev)
    gen_images.set_input_transform(G3, (0.1, -0.05), 10.0)
    target = np.asarray(dataset[0][0], np.float32) / 127.5 - 1.0
    compare_generation_routes(card, G, G3, vgg, target)
    del G, G3, vgg
    torch.cuda.empty_cache()
    return launches


# Phase 9: the claro recipe data-parallel.  The CLI runs under torchrun
# (``python -m torch.distributed.run --nproc_per_node=1``) inside this
# script's worker mode, which runs the module as ``-m`` would
# (``runpy``), so the kernels' counts of that process can be read.
DP_ARGS = [a for a in CLARO_ARGS if not a.startswith("--metrics=")] + ["--metrics=none"]
DP_VARIANTS = ((True, True), (False, False), (True, False), (False, True))


def _digest(tensors: dict) -> dict:
    import hashlib

    return {k: hashlib.sha256(v.detach().contiguous().cpu().numpy().tobytes()).hexdigest()
            for k, v in sorted(tensors.items())}


def _state_tensors(state) -> dict:
    out = {f"{name}.{k}": v for name in ("G", "D", "G_ema")
           for k, v in getattr(state, name).state_dict().items()}
    out.update(pl_mean=state.pl_mean, ada_p=state.ada_p, ada_signs=state.ada_signs)
    return out


def dp_worker(out_path: str, argv: list) -> int:
    """One rank of phase 9 (or the run without a process group): the four
    phase variants of the step from the CLI's build, then the CLI itself
    as ``python -m gantrack_tpu_torch.tools.train`` runs it; writes the
    digests of both states and the kernels' counts to ``out_path``."""
    import runpy

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from gantrack_tpu_torch.parallel import mesh as pm
    from gantrack_tpu_torch.tools import train as cli
    from gantrack_tpu_torch.training.loop import to_device_batch
    from gantrack_tpu_torch.utils.checkpoint import latest_checkpoint

    # cuDNN's deterministic algorithms, so that two runs may be held bit for bit.
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    started = pm.initialize_distributed("cuda")
    try:
        mesh = pm.create_mesh(None if dist.is_initialized() else 1, "cuda")
        device = torch.device("cuda", torch.cuda.current_device())
        opts = cli.build_parser().parse_args(argv)
        _, loader, state, stepper = cli.build_training(cli.resolve_config(opts), opts, device,
                                                      mesh=mesh)
        try:
            real_img, real_c = to_device_batch(*next(loader), device)
        finally:
            loader.close()
        _reset_launches()
        for flags in DP_VARIANTS:
            stepper.run(state, real_img, real_c, *flags)
        variants = _digest(_state_tensors(state))
        del state, stepper
        saved = sys.argv
        sys.argv = ["gantrack_tpu_torch.tools.train", *argv]
        try:
            runpy.run_module("gantrack_tpu_torch.tools.train", run_name="__main__",
                             alter_sys=True)
        finally:
            sys.argv = saved
        torch.cuda.synchronize()
        launches = _read_launches(("upwarp", "upsplat", "fir_same", "fir_down2", "fir_up2"))
        outdir = opts.outdir
        (run_dir,) = [os.path.join(outdir, d) for d in os.listdir(outdir)]
        payload = torch.load(latest_checkpoint(os.path.join(run_dir, "checkpoints")),
                             map_location="cpu", weights_only=True)
        ckpt = {f"{name}.{k}": v for name in ("G", "D", "G_ema") for k, v in payload[name].items()}
        ckpt.update({k: payload[k] for k in ("pl_mean", "ada_p", "ada_signs")})
        result = dict(world=mesh.world, backend=dist.get_backend() if dist.is_initialized()
                      else None, variants=variants, checkpoint=_digest(ckpt),
                      step=payload["step"], launches=launches)
    finally:
        if started:
            dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(result, f)
    return 0


# The 2-rank global_sample check (only where the machine has 2 cards):
# one +Greg+Dreg step at claro width in float32 (TF32 off, cuDNN's
# deterministic algorithms), two NCCL ranks against one rank without a
# group on the same global batch of 8.  Two runs that split a batch
# otherwise round otherwise, and where a pre-activation lies within a
# rounding of a leaky ReLU's kink or of a clamp the two take different
# branches: on one card such flips move the G-main gradient by up to
# 2.5e-3 (relative norm) against 1e-6 with the branches pinned, whether
# the batch is split or z is scaled by 1 + 2^-23, on the FIR kernels and
# on their plain version alike (``split_numerics.py``; ROADMAP C13).  The
# check therefore replays the one-rank run's branch at every element
# within 1e-3 of a kink or clamp (``KinkPins``) in the two ranks' run, and
# holds each phase's gradient (relative norm over the phase's flattened
# gradient) at this bound, fixed before its first run; the unpinned
# gradients' errors and the flips are printed beside it.
GLOBAL_SAMPLE_GRAD_BOUND = 1e-4


def claro_float32(device, batch: int, *, mbstd=(4, 0), mixing: float = 0.9, micro: int = 1,
                  rng_mode: str = "device", mesh=None, res: int = 256, cbase: int = 16384,
                  cmax: int = 512):
    """The float32 claro G and D (``num_fp16_res=0``, seed-0 weights), a
    fresh train state, the loss (r1 0.4096, const noise, ``mixing``) and a
    stepper of global batch ``batch`` whose generator is seeded 0:
    what ``gs_worker`` and ``split_numerics.py`` step.  ``res``, ``cbase``
    and ``cmax`` shrink it for a rehearsal on the CPU."""
    import torch

    sys.path.insert(0, ROOT)
    from gantrack_tpu_torch.models.stylegan2 import Discriminator
    from gantrack_tpu_torch.tools.train import make_generator
    from gantrack_tpu_torch.training import step as tstep
    from gantrack_tpu_torch.training.loss import StyleGAN2Loss, StyleGAN2LossConfig
    from gantrack_tpu_torch.training.train_state import create_train_state

    torch.manual_seed(0)
    G = make_generator("stylegan2", resolution=res, channels=1, c_dim=0, cbase=cbase, cmax=cmax,
                       map_depth=2, num_fp16_res=0).to(device)
    D = Discriminator(c_dim=0, img_resolution=res, img_channels=1, channel_base=cbase,
                      channel_max=cmax, num_fp16_res=0,
                      epilogue_kwargs=dict(mbstd_group_size=mbstd[0],
                                           mbstd_num_channels=mbstd[1])).to(device)
    state = create_train_state(G, D, 0.0025, 0.0025)
    loss = StyleGAN2Loss(G, D, StyleGAN2LossConfig(r1_gamma=0.4096, style_mixing_prob=mixing,
                                                   pl_batch_shrink=1, noise_mode="const"))
    stepper = tstep.TrainStepper(loss, tstep.TrainStepConfig(
        batch_size=batch, z_dim=512, micro_batches=micro, rng_mode=rng_mode),
        torch.Generator(device).manual_seed(0), mesh=mesh)
    return G, D, state, loss, stepper


class KinkPins:
    """The branches of ``bias_act``'s leaky ReLU and clamp, recorded in one
    run and replayed in another, as a stand-in for
    ``models.stylegan2.bias_act`` (``with pins.active(): ...``).

    ``record`` (``row0`` None) runs ``bias_act`` unchanged and keeps, for
    each call in order, the elements whose pre-activation lies within
    ``band`` of the kink (relative to the call's rms) or whose activation
    lies within ``band`` of the clamp (relative to the clamp), with the
    branch each took; ``keep`` also keeps every pre-activation.
    ``replay(row0)`` runs the calls of another run whose batch holds the
    recorded samples ``row0, row0 + 1, ...`` and makes each of those
    elements take the recorded branch (``only``: in the calls named
    there, the others as they are); ``flips`` counts, per call, the
    elements whose own branch was the other one, and ``drift`` (with
    ``keep``) the largest difference of the pre-activation from the
    recorded one, relative to its rms."""

    def __init__(self, band: float = 1e-3, keep: bool = False):
        self.band, self.keep = band, keep
        self.calls, self.kept = [], []
        self.row0 = self.only = None
        self.k = 0
        self.flips, self.drift = [], []

    def replay(self, row0: int, only=None) -> "KinkPins":
        """Replay from sample ``row0`` on; ``only`` (call indices) pins
        those calls alone."""
        self.row0, self.only, self.k, self.flips, self.drift = row0, only, 0, [], []
        return self

    def active(self):
        import contextlib

        from gantrack_tpu_torch.models import stylegan2

        @contextlib.contextmanager
        def patched():
            saved = stylegan2.bias_act
            stylegan2.bias_act = self
            try:
                yield self
            finally:
                stylegan2.bias_act = saved
            if self.row0 is not None and self.k != len(self.calls):
                raise AssertionError(f"replayed {self.k} of {len(self.calls)} recorded calls")

        return patched()

    def __call__(self, x, b=None, dim=1, act="linear", alpha=None, gain=None, clamp=None):
        import torch
        import torch.nn.functional as F

        from gantrack_tpu_torch.ops.bias_act import activation_funcs, bias_act

        if act not in ("linear", "lrelu"):
            raise ValueError(f"KinkPins knows no activation {act!r}")
        spec = activation_funcs[act]
        alpha = float(alpha if alpha is not None else spec.def_alpha)
        gain = float(gain if gain is not None else spec.def_gain)
        if self.row0 is None:
            with torch.no_grad():
                pre = x
                if b is not None:
                    shape = [1] * x.ndim
                    shape[dim % x.ndim] = -1
                    pre = x + b.reshape(shape).to(x.dtype)
                flat = pre.reshape(pre.shape[0], -1)
                rec = {"shape": tuple(pre.shape)}
                if act == "lrelu":
                    rms = flat.float().square().mean().sqrt()
                    n, j = torch.nonzero(flat.abs() <= self.band * rms, as_tuple=True)
                    rec["kink"] = (n, j, flat[n, j] > 0)
                if clamp is not None:
                    y = F.leaky_relu(flat, alpha) if act == "lrelu" else flat
                    y = y * gain if gain != 1 else y
                    n, j = torch.nonzero((y.abs() - clamp).abs() <= self.band * clamp,
                                         as_tuple=True)
                    rec["clamp"] = (n, j, y[n, j].abs() <= clamp)
                self.calls.append(rec)
                if self.keep:
                    self.kept.append(pre.detach().clone())
            return bias_act(x, b, dim=dim, act=act, alpha=alpha, gain=gain, clamp=clamp)
        rec = self.calls[self.k]
        if tuple(x.shape[1:]) != rec["shape"][1:]:
            raise AssertionError(f"call {self.k}: shape {tuple(x.shape)} against {rec['shape']}")
        if self.only is not None and self.k not in self.only:
            self.flips.append((rec["shape"], 0))
            self.k += 1
            return bias_act(x, b, dim=dim, act=act, alpha=alpha, gain=gain, clamp=clamp)
        if b is not None:
            shape = [1] * x.ndim
            shape[dim % x.ndim] = -1
            x = x + b.reshape(shape).to(x.dtype)
        rows = x.shape[0]
        flat = x.reshape(rows, -1)
        if self.keep:
            ref = self.kept[self.k][self.row0:self.row0 + rows].reshape(rows, -1)
            rms = ref.float().square().mean().sqrt().clamp(min=1e-30)
            self.drift.append(float((flat.detach() - ref).abs().max() / rms))
        flipped = 0

        def pinned(own, key):
            nonlocal flipped
            n, j, took = (t.to(x.device) for t in rec[key])
            keep = (n >= self.row0) & (n < self.row0 + rows)
            n, j, took = n[keep] - self.row0, j[keep], took[keep]
            flipped += int((own[n, j] != took).sum())
            own = own.clone()
            own[n, j] = took
            return own

        y = flat
        if act == "lrelu":
            with torch.no_grad():
                slope = torch.where(pinned(flat > 0, "kink"), 1.0, alpha).to(x.dtype)
            y = y * slope
        if gain != 1:
            y = y * gain
        if clamp is not None:
            with torch.no_grad():
                inside = pinned(y.abs() <= clamp, "clamp")
                edge = torch.sign(y) * clamp
            y = torch.where(inside, y, edge)
        self.flips.append((rec["shape"], flipped))
        self.k += 1
        return y.reshape(x.shape)

    def state(self) -> list:
        """The records on the host, for ``torch.save``."""
        return [{k: v if k == "shape" else tuple(t.cpu() for t in v) for k, v in rec.items()}
                for rec in self.calls]

    @classmethod
    def from_state(cls, calls: list, band: float = 1e-3) -> "KinkPins":
        pins = cls(band)
        pins.calls = calls
        return pins


def _phase_grads(stepper, state, reals, pins=None) -> list:
    """Each phase's gradient (averaged over the ranks, flattened, on the
    host) of one +Greg+Dreg step, with ``pins`` in place of ``bias_act``."""
    import contextlib

    import torch

    from gantrack_tpu_torch.training import step as tstep

    grads = []
    apply = tstep._apply
    tstep._apply = lambda opt, p, g: grads.append(torch.cat(
        [x.flatten() for x in g]).cpu()) or apply(opt, p, g)
    try:
        with pins.active() if pins is not None else contextlib.nullcontext():
            stepper.run(state, reals, None, True, True)
    finally:
        tstep._apply = apply
    return grads


def gs_worker(out_path: str, pins_path: str, device_type: str = "cuda",
              small: bool = False) -> int:
    """One rank of the 2-rank ``global_sample`` check, or the one-rank run
    without a group.  Alone: one +Greg+Dreg step of ``claro_float32`` on a
    batch of 8, recording its kinks to ``pins_path``.  In a group: the same
    step on the rank's half, once as it is and once replaying the one-rank
    run's kinks (``KinkPins``); rank 0 saves each phase's gradient of both
    and the flips summed over the ranks.  ``small`` (16², narrow) and
    ``device_type="cpu"`` (gloo) make the rehearsal on the CPU."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from gantrack_tpu_torch.parallel import mesh as pm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    size = dict(res=16, cbase=256, cmax=32) if small else {}
    started = pm.initialize_distributed(device_type)
    try:
        mesh = pm.create_mesh(None if dist.is_initialized() else 1, device_type)
        device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
                  else torch.device("cpu"))
        res = size.get("res", 256)
        reals = torch.randn((8, 1, res, res), generator=torch.Generator().manual_seed(2))
        reals = pm.shard_batch(mesh, reals).to(device)

        def step(pins=None):
            _, _, state, _, stepper = claro_float32(device, 8, rng_mode="global_sample",
                                                    mesh=mesh, **size)
            return _phase_grads(stepper, state, reals, pins)

        if mesh.world == 1:
            pins = KinkPins()
            grads = step(pins)
            torch.save(pins.state(), pins_path)
            torch.save({"grads": grads, "world": 1}, out_path)
            return 0
        unpinned = step()
        pins = KinkPins.from_state(torch.load(pins_path, weights_only=True))
        pinned = step(pins.replay(mesh.rank * reals.shape[0]))
        flips = torch.tensor([float(sum(f for _, f in pins.flips))], device=device)
        dist.all_reduce(flips)
        if mesh.is_main:
            held = sum(len(rec[k][0]) for rec in pins.calls for k in ("kink", "clamp")
                       if k in rec)
            torch.save({"grads": pinned, "unpinned": unpinned, "world": mesh.world,
                        "flips": float(flips), "pinned": held}, out_path)
    finally:
        if started:
            dist.destroy_process_group()
    return 0


def _torchrun(nproc: int, args: list, timeout: int = 600) -> None:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", *args]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(f"{' '.join(cmd)} failed ({out.returncode}):\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-5000:]}")


def run_data_parallel(card: str, tmp: str, data: str) -> dict:
    """Phase 9: the claro recipe in an NCCL group of one rank under
    torchrun, against the same run without a group: the four phase
    variants of the step from the CLI's build and the CLI's own 32 steps
    (three variants: its schedule never takes D-reg alone), both bit-equal
    (an all-reduce over one rank and a division by 1 change no bit).
    Returns the kernels' counts of the group's run.  With two cards,
    also two ranks in ``global_sample`` against one."""
    import torch

    runs = {}
    for label, nproc in (("nccl", 1), ("none", 0)):
        out = os.path.join(tmp, f"dp_{label}.json")
        argv = [f"--outdir={os.path.join(tmp, 'runs_dp_' + label)}", f"--data={data}", *DP_ARGS]
        t0 = time.perf_counter()
        if nproc:
            print(f"phase 9: python -m torch.distributed.run --standalone --nproc_per_node=1 "
                  f"-m gantrack_tpu_torch.tools.train {' '.join(argv)}")
            _torchrun(1, [__file__, "--dp-worker", out, *argv])
        else:
            print("phase 9: the same without a process group")
            res = subprocess.run([sys.executable, __file__, "--dp-worker", out, *argv], cwd=ROOT,
                                 capture_output=True, text=True, timeout=600)
            if res.returncode != 0:
                raise AssertionError(f"the run without a group failed:\n{res.stderr[-5000:]}")
        with open(out) as f:
            runs[label] = json.load(f)
        print(f"  {label}: {time.perf_counter() - t0:.1f} s wall (a process, the build, four "
              f"steps and the CLI's {runs[label]['step']} steps); world {runs[label]['world']}, "
              f"backend {runs[label]['backend']}")
    nccl, none = runs["nccl"], runs["none"]
    if nccl["backend"] != "nccl" or nccl["world"] != 1 or none["backend"] is not None:
        raise AssertionError(f"phase 9 ran {nccl['backend']}/{nccl['world']} against "
                             f"{none['backend']}")
    for what in ("variants", "checkpoint"):
        differ = [k for k in none[what] if nccl[what].get(k) != none[what][k]]
        if differ or set(nccl[what]) != set(none[what]):
            raise AssertionError(f"phase 9: the NCCL group changed the bits of the {what}: "
                                 f"{differ[:5]}")
        print(f"  the {what} ({len(none[what])} tensors) bit-equal with and without the group")
    print(f"  kernel launches of the group's run {nccl['launches']}")

    if torch.cuda.device_count() > 1:
        check_global_sample(tmp)
    else:
        print(f"  the 2-rank NCCL global_sample check was not run: this machine shows "
              f"{torch.cuda.device_count()} CUDA device (it needs 2)")
    return {k: nccl["launches"].get(k, 0) for k in KERNELS}


def check_global_sample(tmp: str, device_type: str = "cuda", small: bool = False) -> None:
    """Two ranks in ``rng_mode="global_sample"`` (NCCL on the card, gloo
    for the rehearsal on the CPU) against one rank without a group: each
    phase's gradient of one +Greg+Dreg step (``gs_worker``), the two
    ranks replaying the one rank's kinks, at ``GLOBAL_SAMPLE_GRAD_BOUND``;
    prints the unpinned errors and the flips beside it."""
    import torch

    outs = {n: os.path.join(tmp, f"gs_{n}.pt") for n in (1, 2)}
    pins = os.path.join(tmp, "gs_pins.pt")
    extra = [device_type] + (["small"] if small else [])
    res = subprocess.run([sys.executable, __file__, "--gs-worker", outs[1], pins, *extra],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"the one-rank global_sample run failed:\n{res.stderr[-5000:]}")
    _torchrun(2, [__file__, "--gs-worker", outs[2], pins, *extra])
    one, two = (torch.load(outs[n], weights_only=True) for n in (1, 2))
    if (one["world"], two["world"]) != (1, 2) or len(one["grads"]) != 4:
        raise AssertionError(f"global_sample ran on {one['world']} and {two['world']} ranks, "
                             f"{len(one['grads'])} phases")
    print(f"  global_sample, 2 ranks against 1: {two['flips']:.0f} of {two['pinned']} pinned "
          f"elements took the other branch unpinned")
    for phase, a, b, u in zip(("G-main", "G-reg", "D-main", "D-reg"), one["grads"],
                              two["grads"], two["unpinned"]):
        norm = a.double().norm().clamp(min=1e-30)
        unpinned = float((a.double() - u.double()).norm() / norm)
        print(f"  global_sample, {phase}: unpinned relative norm error {unpinned:.3e}")
        _check(f"global_sample 2 ranks against 1, {phase} gradient, kinks pinned "
               f"(relative norm)", float((a.double() - b.double()).norm() / norm),
               GLOBAL_SAMPLE_GRAD_BOUND)


# Phase 10: CycleGAN and pix2pix at the JAX defaults' full width.
I2I_MODELS = (("cycle_gan", "resnet_9blocks", "unaligned"), ("pix2pix", "unet_256", "aligned"))
I2I_ITERS = 30
# One generator forward (batch 1, 256^2, TF32 off) on the card against the
# port on the CPU with the same weights: max |difference| of the tanh
# output.  Fixed before its first run.
I2I_FORWARD_BOUND = 2e-4


def _i2i_datasets(root: str) -> dict:
    """Synthetic 256² RGB PNGs (smooth colour blobs): unaligned
    ``trainA/B`` (8 each), ``testA/B`` (2); aligned AB pairs ``train``
    (8), ``test`` (2), B a colour transform of A."""
    import numpy as np

    from gantrack_tpu_torch.utils.checkpoint import save_png

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float32)

    def blob():
        cx, cy, r = rng.uniform(64, 192), rng.uniform(64, 192), rng.uniform(20, 60)
        g = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r * r))
        col = rng.uniform(40, 255, 3)
        return np.clip(g[:, :, None] * col + rng.normal(0, 6, (256, 256, 3)), 0, 255)

    roots = {"unaligned": os.path.join(root, "unaligned"), "aligned": os.path.join(root, "aligned")}
    for phase, n in (("train", 8), ("test", 2)):
        for side in "AB":
            d = os.path.join(roots["unaligned"], phase + side)
            os.makedirs(d)
            for i in range(n):
                save_png(os.path.join(d, f"{i}.png"), blob().astype(np.uint8))
        d = os.path.join(roots["aligned"], phase)
        os.makedirs(d)
        for i in range(n):
            a = blob()
            b = 255 - a[:, :, ::-1]
            save_png(os.path.join(d, f"{i}.png"), np.concatenate([a, b], axis=1).astype(np.uint8))
    return roots


def run_i2i(card: str, tmp: str) -> None:
    """Phase 10: CycleGAN ``resnet_9blocks`` and pix2pix ``unet_256`` (ngf
    64, 256², batch 1, the JAX defaults) through ``train_i2i`` for
    ``I2I_ITERS`` iterations on a synthetic set, then ``test_i2i`` on each
    checkpoint (the HTML sheet and its PNGs); ms per iteration (host
    clock, synchronised, and device time from the profiler) and peak
    memory of the trainer; one generator forward on the card against the
    port on the CPU."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gantrack_tpu_torch.models.image2image import define_G
    from gantrack_tpu_torch.tools import test_i2i, train_i2i
    from gantrack_tpu_torch.utils.checkpoint import decode_png

    roots = _i2i_datasets(os.path.join(tmp, "i2i_data"))
    for model, netg, kind in I2I_MODELS:
        ckpts = os.path.join(tmp, "i2i_ckpt")
        argv = [f"--dataroot={roots[kind]}", f"--name={model}", f"--model={model}",
                f"--checkpoints-dir={ckpts}", f"--max-iters={I2I_ITERS}", "--print-freq=10",
                "--save-epoch-freq=1000"]
        print(f"phase 10: python -m gantrack_tpu_torch.tools.train_i2i {' '.join(argv)}")
        t0 = time.perf_counter()
        run_dir = train_i2i.main(argv)
        torch.cuda.synchronize()
        print(f"  train_i2i: {time.perf_counter() - t0:.1f} s wall for {I2I_ITERS} iterations "
              f"(with the build and the data)")

        # The trainer alone on one fixed batch.
        opts = train_i2i.build_parser().parse_args(argv)
        train_i2i.resolve(opts)
        device = torch.device("cuda", torch.cuda.current_device())
        trainer = train_i2i.build_trainer(opts, 8, device)
        gen = torch.Generator().manual_seed(1)
        real_a = torch.rand((1, 3, 256, 256), generator=gen).mul(2).sub(1).to(device)
        real_b = torch.rand((1, 3, 256, 256), generator=gen).mul(2).sub(1).to(device)
        for _ in range(3):
            trainer.optimize_parameters(real_a, real_b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        times = []
        for _ in range(10):
            t = time.perf_counter()
            trainer.optimize_parameters(real_a, real_b)  # ends in a host read of the losses
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                trainer.optimize_parameters(real_a, real_b)
            torch.cuda.synchronize()
        rows = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                rows[ev.name[:80]] = rows.get(ev.name[:80], 0.0) + ev.device_time / 1e3 / 3
        device_ms = sum(rows.values())
        times.sort()
        print(f"  {model} ({netg}, ngf 64, 256^2, batch 1): {times[len(times) // 2]:.2f} ms per "
              f"iteration, median of 10 (host clock; {times[0]:.2f}-{times[-1]:.2f}), "
              f"{device_ms:.2f} ms of device time an iteration (profiler, 3 iterations), peak "
              f"{peak:.2f} GiB, on {card}")
        for name, ms in sorted(rows.items(), key=lambda kv: -kv[1])[:6]:
            print(f"    {ms:8.2f} ms {100 * ms / device_ms:5.1f} %  {name}")

        web = test_i2i.main([f"--dataroot={roots[kind]}", f"--name={model}",
                             f"--model={model}", f"--checkpoints-dir={ckpts}",
                             f"--results-dir={os.path.join(tmp, 'i2i_results')}",
                             "--num-test=2"])
        pngs = sorted(os.listdir(os.path.join(web, "images")))
        with open(os.path.join(web, "index.html")) as f:
            html = f.read()
        want = 2 * 3  # real_A, fake_B and rec_A (CycleGAN) or real_B (pix2pix)
        if len(pngs) != want or not all(f'src="images/{p}"' in html for p in pngs):
            raise AssertionError(f"test_i2i wrote {pngs} and a sheet that does not show them")
        for p in pngs:
            with open(os.path.join(web, "images", p), "rb") as f:
                img = decode_png(f.read())
            if img.shape != (256, 256, 3):
                raise AssertionError(f"{p}: shape {img.shape}")
        print(f"  test_i2i: {len(pngs)} PNGs and index.html in {web}")

        # One generator forward on the card against the CPU, the run's weights.
        sd = torch.load(test_i2i.latest_checkpoint(os.path.join(run_dir, "checkpoints")),
                        map_location="cpu", weights_only=True)["trainer"]["nets"]
        sd = sd["g_a"] if "g_a" in sd else sd["g"]
        g = define_G(3, 3, 64, netg, use_dropout=model == "pix2pix")
        g.load_state_dict(sd)
        g.eval()
        x = torch.rand((1, 3, 256, 256), generator=torch.Generator().manual_seed(3)) * 2 - 1
        with torch.no_grad():
            want_cpu = g(x)
            got = g.to(device)(x.to(device)).cpu()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{model}: non-finite generator output on the card")
        _check(f"{model} {netg} forward, card against the CPU (max abs)",
               float((got - want_cpu).abs().max()), I2I_FORWARD_BOUND)
        del trainer, g
        torch.cuda.empty_cache()
    print(f"  phase 10 on {card}")


# Phase 11: volumes → dataset_tool → a NVIDIA-style pickle of the claro
# checkpoint → the claro recipe resumed from it → calc_metrics / gen_images
# on the pickle.
P11_PATIENTS, P11_DEPTH, P11_RES = 4, 40, 256
# The dataset tool's steps of phase 11, in order: step, source, dest, flags.
P11_STEPS = (
    ("process_dicom_2_nifti", "dicom", "raw/CT", []),
    ("process_nifti_normalized", "raw", "normalized", ["--hu-min=-1000", "--hu-max=1000"]),
    ("mask_nifti", "normalized", "mask", []),
    ("snap_pickle", "normalized", "pickles", []),
    ("snap_zip", "pickles", "zipped", []),
    ("pack", "zip", "packed", ["--modalities=CT"]),
)


def _dicom_element(group: int, elem: int, vr: bytes, value: bytes) -> bytes:
    """One explicit-VR little-endian data element."""
    import struct

    if len(value) % 2:
        value += b" " if vr != b"OW" else b"\x00"
    head = struct.pack("<HH", group, elem) + vr
    if vr in (b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN"):
        return head + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return head + struct.pack("<H", len(value)) + value


def write_dicom_series(directory: str, volume, spacing=(0.8, 0.8, 2.5)) -> None:
    """An uncompressed (explicit VR little endian) DICOM series of an int16
    ``[H, W, D]`` volume in HU: one file a slice, slope 1, intercept 0."""
    import struct

    os.makedirs(directory, exist_ok=True)
    rows, cols, depth = volume.shape
    meta = _dicom_element(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2.1")
    for k in range(depth):
        body = b"".join([
            _dicom_element(0x0018, 0x0050, b"DS", f"{spacing[2]}".encode()),
            _dicom_element(0x0020, 0x0013, b"IS", str(k + 1).encode()),
            _dicom_element(0x0020, 0x0032, b"DS", f"0\\0\\{spacing[2] * k}".encode()),
            _dicom_element(0x0020, 0x0037, b"DS", b"1\\0\\0\\0\\1\\0"),
            _dicom_element(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
            _dicom_element(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
            _dicom_element(0x0028, 0x0030, b"DS", f"{spacing[0]}\\{spacing[1]}".encode()),
            _dicom_element(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
            _dicom_element(0x0028, 0x0103, b"US", struct.pack("<H", 1)),
            _dicom_element(0x0028, 0x1052, b"DS", b"0"),
            _dicom_element(0x0028, 0x1053, b"DS", b"1"),
            _dicom_element(0x7FE0, 0x0010, b"OW", volume[:, :, k].astype("<i2").tobytes()),
        ])
        with open(os.path.join(directory, f"{k:04d}.dcm"), "wb") as f:
            f.write(b"\x00" * 128 + b"DICM" + meta + body)


def _ct_volume(rng, res: int = P11_RES, depth: int = P11_DEPTH):
    """A synthetic CT volume in HU (int16): air, an elliptic body of soft
    tissue with two lungs and a spine, and noise."""
    import numpy as np

    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / res - 0.5
    a, b = rng.uniform(0.34, 0.42), rng.uniform(0.26, 0.32)
    vol = np.empty((res, res, depth), np.float32)
    for k in range(depth):
        t = k / depth
        body = (xx / a) ** 2 + (yy / b) ** 2 <= 1
        sl = np.where(body, 40.0, -1000.0)
        for cx in (-0.15, 0.15):
            lung = ((xx - cx) / (0.11 + 0.03 * t)) ** 2 + (yy / 0.17) ** 2 <= 1
            sl[lung] = -850.0
        sl[(xx ** 2 + (yy - 0.2) ** 2) <= 0.035 ** 2] = 700.0
        vol[:, :, k] = sl + rng.normal(0, 20, (res, res))
    return np.clip(vol, -1024, 3071).astype(np.int16)


def reference_pickle_of_checkpoint(path: str, ckpt: str, cbase: int = 16384, cmax: int = 512,
                                   map_depth: int = 2, res: int = 256) -> dict:
    """A ``network-snapshot-*.pkl`` of a claro checkpoint of the port: its
    G, D and G_ema as stand-ins for NVIDIA's networks
    (``write_reference_pickle``) with the ``init_kwargs`` NVIDIA's train
    script gives them; returns the G_ema state dict it holds."""
    import torch

    from gantrack_tpu_torch.models.stylegan2 import Discriminator
    from gantrack_tpu_torch.tools.train import make_generator

    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    common = dict(c_dim=0, img_resolution=res, img_channels=1)
    nets = {}
    for name in ("G", "G_ema"):
        nets[name] = make_generator("stylegan2", resolution=res, channels=1, c_dim=0,
                                    cbase=cbase, cmax=cmax, map_depth=map_depth)
        nets[name].load_state_dict(payload[name])
    nets["D"] = Discriminator(**common, channel_base=cbase, channel_max=cmax)
    nets["D"].load_state_dict(payload["D"])
    g_kwargs = dict(z_dim=512, w_dim=512, mapping_kwargs={"num_layers": map_depth},
                    synthesis_kwargs=dict(channel_base=cbase, channel_max=cmax, num_fp16_res=4,
                                          conv_clamp=256), **common)
    d_kwargs = dict(channel_base=cbase, channel_max=cmax, num_fp16_res=4, conv_clamp=256,
                    epilogue_kwargs={"mbstd_group_size": 4}, **common)
    write_reference_pickle(path, nets["G"], nets["D"], nets["G_ema"], g_kwargs, d_kwargs)
    return payload["G_ema"]


def run_volume_route(card: str, tmp: str, claro_dir: str) -> dict:
    """Phase 11: the front of the main path and the pickle route.  Writes
    4 synthetic CT volumes (256 × 256 × 40, int16 HU; the first as an
    uncompressed DICOM series), runs ``python -m
    gantrack_tpu_torch.tools.dataset_tool`` through DICOM → NIfTI →
    normalised → masked → slice pickles → split zip → packed shards, builds
    a ``network-snapshot-*.pkl`` of phase 2's claro checkpoint, checks
    that the CLI's state resumed from it holds the pickle's G_ema bit for
    bit before any step, trains the claro recipe (full width, batch 32,
    fid1k) from it on the packed set for 1 kimg, then runs
    ``calc_metrics`` and ``gen_images`` on the pickle.  K1, K2 and K5–K7
    must launch.  Returns the launch counts of the resumed run and the two
    tools."""
    import numpy as np
    import torch

    from gantrack_tpu_torch.data import open_dataset
    from gantrack_tpu_torch.data.preprocess.nifti import read_nifti, write_nifti
    from gantrack_tpu_torch.tools import calc_metrics, gen_images
    from gantrack_tpu_torch.tools import train as cli
    from gantrack_tpu_torch.utils.checkpoint import decode_png, latest_checkpoint

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "volumes")
    rng = np.random.default_rng(11)
    volumes = [_ct_volume(rng, P11_RES, P11_DEPTH) for _ in range(P11_PATIENTS)]
    write_dicom_series(os.path.join(root, "dicom", "P000"), volumes[0])
    os.makedirs(os.path.join(root, "raw", "CT"))
    for p in range(1, P11_PATIENTS):
        write_nifti(os.path.join(root, "raw", "CT", f"P{p:03d}.nii.gz"), volumes[p],
                    zooms=(0.8, 0.8, 2.5))
    print(f"phase 11: {P11_PATIENTS} CT volumes {P11_RES}x{P11_RES}x{P11_DEPTH} int16 (HU), "
          f"P000 as a DICOM series of {P11_DEPTH} files: "
          f"{time.perf_counter() - t_phase:.1f} s to write")

    paths = {"dicom": os.path.join(root, "dicom"), "raw": os.path.join(root, "raw")}
    step_seconds = {}
    for step, source, dest, flags in P11_STEPS:
        src = paths[source]
        paths[dest.split("/")[0]] = os.path.join(root, dest.split("/")[0])
        argv = [f"--processing_step={step}", f"--source={src}",
                f"--dest={os.path.join(root, dest)}", *flags]
        t = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "gantrack_tpu_torch.tools.dataset_tool",
                              *argv], cwd=ROOT, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t
        if out.returncode != 0:
            raise AssertionError(f"dataset_tool {step} failed:\n{out.stdout[-2000:]}"
                                 f"\n{out.stderr[-4000:]}")
        # The tool's last line gives the stage's own seconds; the rest of
        # the wall is the process starting (interpreter and imports).
        work = float(re.findall(r"done -> .* in ([0-9.]+) s", out.stdout)[-1])
        n_vol = 1 if step == "process_dicom_2_nifti" else P11_PATIENTS
        step_seconds[step] = (wall, wall - work, work / n_vol)
        print(f"  python -m gantrack_tpu_torch.tools.dataset_tool {' '.join(argv)}: "
              f"{wall:.3f} s wall = {wall - work:.3f} s start-up + {work:.3f} s in the step, "
              f"{work / n_vol:.3f} s a volume ({n_vol} of {P11_RES}x{P11_RES}x{P11_DEPTH})")
        if step == "process_dicom_2_nifti":
            vol, zooms = read_nifti(os.path.join(root, "raw", "CT", "P000.nii.gz"))
            if not np.array_equal(vol, volumes[0].astype(np.float32)) or \
                    not np.allclose(zooms, (0.8, 0.8, 2.5), rtol=1e-5):
                raise AssertionError(f"the DICOM series read back as {vol.shape} {vol.dtype}, "
                                     f"zooms {zooms}, not the volume written")
        elif step == "mask_nifti":
            mask, _ = read_nifti(os.path.join(root, "mask", "CT", "P000.nii.gz"))
            share = float(mask.mean())
            if mask.shape != (P11_RES, P11_RES, P11_DEPTH) or not 0.1 < share < 0.6:
                raise AssertionError(f"body mask {mask.shape}, body share {share:.3f}")
            print(f"    body mask of P000: {share:.3f} of the voxels")
        elif step == "snap_zip":
            (paths["zip"],) = [os.path.join(root, "zipped", f)
                               for f in os.listdir(os.path.join(root, "zipped"))
                               if f.endswith(".zip")]
    data = paths["packed"]
    dataset = open_dataset(data)
    kept = P11_DEPTH - 2 * 10  # the default --pop-range drops 10 slices at each end
    with open(os.path.join(root, "zipped", "train_val_test_ids",
                           os.path.basename(paths["zip"])[:-4] + ".json")) as f:
        # The tool lists every directory of its source as a patient, the run
        # dir of the step before included (as the JAX tool does).
        n_train = sum(p.startswith("P") for p in json.load(f)["train"])
    if (len(dataset), dataset.resolution, dataset.num_channels) != (n_train * kept, P11_RES, 1):
        raise AssertionError(f"packed train split: {len(dataset)} items at "
                             f"{dataset.resolution}^2 x {dataset.num_channels}; want "
                             f"{n_train * kept} at {P11_RES}^2 x 1")
    print(f"  packed train split: {len(dataset)} slices of {n_train} patients, "
          f"{dataset.resolution}^2 x {dataset.num_channels}")

    pkl = os.path.join(root, "network-snapshot-000001.pkl")
    t = time.perf_counter()
    g_ema = reference_pickle_of_checkpoint(pkl, latest_checkpoint(os.path.join(claro_dir,
                                                                              "checkpoints")),
                                           res=P11_RES)
    print(f"  {os.path.basename(pkl)} of phase 2's checkpoint (G, D, G_ema as NVIDIA-named "
          f"stand-ins with init_kwargs): {os.path.getsize(pkl) / 2**20:.1f} MiB, "
          f"{time.perf_counter() - t:.1f} s")

    args = [a for a in CLARO_ARGS]
    argv = [f"--outdir={os.path.join(root, 'runs')}", f"--data={data}", *args,
            f"--resume={pkl}"]
    device = _cli_device(cli, args)
    opts = cli.build_parser().parse_args(argv)
    _, loader, state, stepper = cli.build_training(cli.resolve_config(opts), opts, device)
    loader.close()
    resumed = state.G_ema.state_dict()
    for k, v in g_ema.items():
        if not torch.equal(resumed[k].cpu(), v):
            raise AssertionError(f"the resumed G_ema's {k} differs from the pickle's")
    if state.step != 0 or state.opt_g.state or stepper.cfg.ema_rampup is not None:
        raise AssertionError("a pickle resume must start a fresh optimizer and counters")
    print(f"  --resume={os.path.basename(pkl)}: the state's G_ema equals the pickle's bit for bit "
          f"({len(g_ema)} tensors) before any step; step 0, Adam fresh")
    del state, stepper
    torch.cuda.empty_cache()

    print(f"phase 11: python -m gantrack_tpu_torch.tools.train {' '.join(argv)}")
    _reset_launches()
    t = time.perf_counter()
    run_dir = cli.main(argv)
    torch.cuda.synchronize()
    train_seconds = time.perf_counter() - t
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        records = [json.loads(line) for line in f]
    for rec in records:
        if not all(np.isfinite(v) for k, v in rec.items() if k.startswith("Loss/")):
            raise AssertionError(f"non-finite losses in the resumed run: {rec}")
    last = records[-1]
    for key in ("Resources/cpu_mem_gb", "Resources/gb_in_use", "Resources/peak_gb_in_use",
                "Resources/gb_limit"):
        if key not in last:
            raise AssertionError(f"{key} missing from the tick record")
    fid = _metric_rows(run_dir, "fid1k")[-1]
    print(f"  resumed run: {train_seconds:.1f} s wall; tick {last['Progress/tick']}: "
          f"{last['Timing/sec_per_kimg']:.2f} sec/kimg, Resources/peak_gb_in_use "
          f"{last['Resources/peak_gb_in_use']:.2f} GiB of {last['Resources/gb_limit']:.2f}, "
          f"cpu_mem_gb {last['Resources/cpu_mem_gb']:.2f}, ada_p {last['Progress/augment']:.4f}; "
          f"fid1k {fid['results']['fid1k']:.4f} on {card}")

    argv = [f"--network={pkl}", f"--data={data}", "--metrics=fid1k", *NET_ARGS]
    print(f"phase 11: python -m gantrack_tpu_torch.tools.calc_metrics {' '.join(argv)}")
    t = time.perf_counter()
    results = calc_metrics.main(argv)
    print(f"  {results} in {time.perf_counter() - t:.1f} s")
    argv = [f"--network={pkl}", "--seeds=0-7", "--trunc=0.7",
            f"--outdir={os.path.join(root, 'images')}"]
    print(f"phase 11: python -m gantrack_tpu_torch.tools.gen_images {' '.join(argv)}")
    t = time.perf_counter()
    written = gen_images.main(argv)
    torch.cuda.synchronize()
    for p in written:
        with open(p, "rb") as f:
            if decode_png(f.read()).shape != (P11_RES, P11_RES):
                raise AssertionError(f"{p}: not a {P11_RES}^2 image")
    print(f"  {len(written)} images in {time.perf_counter() - t:.1f} s")
    launches = _read_launches(("upwarp", "upsplat", "fir_same", "fir_down2", "fir_up2"))
    print(f"  kernel launches of the resumed run and the two tools: "
          f"{ {k: n for k, n in launches.items() if n} }")
    print(f"  phase 11: {time.perf_counter() - t_phase:.1f} s wall; dataset_tool steps "
          "(wall / start-up / host seconds a volume) "
          + ", ".join(f"{k} {w:.3f} / {s:.3f} / {v:.3f}"
                      for k, (w, s, v) in step_seconds.items()) + f"; on {card}")
    return launches


# Phase 12: StyleGAN3-R at its published width (the CLI doubles --cbase and
# --cmax for -r) and batch 32, from the CLI's build: one +Dreg and three
# plain steps with D's input blur at its initial sigma of 10 (61 taps),
# where every -r run starts.
SG3_R_ARGS = [a for a in SG3_ARGS if not a.startswith(("--cfg=", "--metrics="))] + [
    "--cfg=stylegan3-r", "--metrics=none"]
SG3_R_BLUR_SIGMA = 10.0


def _train_state_tensors(state, generator) -> dict:
    """Everything a checkpoint restores: the networks, both optimizers'
    moments and step counters, the loss and ADA state, the step
    generator's state."""
    import torch

    out = {k: v.detach().cpu() for k, v in _state_tensors(state).items()}
    for name in ("opt_g", "opt_d"):
        for i, s in getattr(state, name).state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": torch.as_tensor(v).cpu() for k, v in s.items()})
    out["generator"] = generator.get_state()
    out["counters"] = torch.tensor([state.step, state.cur_nimg])
    return out


def train_stylegan3r(card: str, tmp: str, data: str, args=SG3_R_ARGS, res: int = 256,
                     batch: int = 32) -> dict:
    """Phase 12: StyleGAN3-R at full width and its published batch 32 on
    phase 2's dataset, through the training CLI's build (``build_training``
    of its parsed flags), gradients accumulated over the largest chunk
    that fits.  From one state, one +Dreg step, then three plain steps,
    each with the blur at sigma 10: host time, peak memory, the kernels'
    launches and the plain-route FIR calls (only ``SG3_R_PLAIN_REASONS``;
    the 61-tap blur must be one); then one profiled step of each variant
    (device time, the plain route's share); then a checkpoint saved and
    loaded into a fresh state of the CLI's build, bit for bit.  Returns
    the launch counts of the four steps."""
    import torch

    from gantrack_tpu_torch.tools import train as cli
    from gantrack_tpu_torch.training.loop import to_device_batch
    from gantrack_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    t_phase = time.perf_counter()
    device = _cli_device(cli, args)
    print(f"phase 12: StyleGAN3-R at full width, batch {batch}; the largest chunk (--batch-gpu) "
          "of 32, 16, 8, 4 that fits")
    batch_gpu = _pick_batch_gpu(cli, tmp, data, args, device, batch)
    argv = [f"--outdir={os.path.join(tmp, 'runs3r')}", f"--data={data}", f"--batch={batch}",
            f"--batch-gpu={batch_gpu}", *args]
    print(f"phase 12: the build of python -m gantrack_tpu_torch.tools.train {' '.join(argv)}")

    def build():
        opts = cli.build_parser().parse_args(argv)
        cli.check_slice(opts)
        _, loader, state, stepper = cli.build_training(cli.resolve_config(opts), opts, device)
        return loader, state, stepper

    loader, state, stepper = build()
    cmax = cli.build_parser().parse_args(argv).cmax
    try:
        real_img, real_c = to_device_batch(*next(loader), device)
    finally:
        loader.close()
    names = state.G.synthesis.layer_names
    g_params = sum(p.numel() for p in state.G.parameters())
    d_params = sum(p.numel() for p in state.D.parameters())
    channels = [getattr(state.G.synthesis, n).spec.out_channels for n in names]
    print(f"  G: {len(names)} layers {names[0]} .. {names[-1]}, channels {max(channels)} .. "
          f"{min(channels)}, {g_params / 1e6:.2f} M parameters; D {d_params / 1e6:.2f} M; "
          f"blur sigma {stepper.loss.blur_sigma(0)} at kimg 0, fading over "
          f"{stepper.loss.cfg.blur_fade_kimg:g} kimg")
    if len(names) != 15 or max(channels) != 2 * cmax or \
            stepper.loss.blur_sigma(0) != SG3_R_BLUR_SIGMA:
        raise AssertionError(f"not the published StyleGAN3-R (14 layers + toRGB, {2 * cmax} "
                             f"channels at most, blur sigma {SG3_R_BLUR_SIGMA})")

    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times, counts = {}, {}
    for label, flags, reps in (("+Dreg", (False, True), 1), ("plain", (False, False), 3)):
        before = _launch_counts()
        for _ in range(reps):
            state.cur_nimg = 0  # the blur at sigma 10, its 61 taps
            torch.cuda.synchronize()
            t = time.perf_counter()
            moments = stepper.run(state, real_img, real_c, *flags)
            torch.cuda.synchronize()
            times.setdefault(label, []).append((time.perf_counter() - t) * 1e3)
            for k, v in moments.items():
                if k.startswith("Loss/") and not torch.isfinite(v).all():
                    raise AssertionError(f"{label} step: non-finite {k} {v.tolist()}")
        counts[label] = {k: (n - before[k]) / reps for k, n in _launch_counts().items()
                         if n > before[k]}
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = _read_launches(("upwarp", "upsplat", "fir_same", "fir_down2", "filtered_lrelu"),
                              SG3_R_PLAIN_REASONS)
    _no_composed_route()
    plain = _plain_route()
    blur = f"{2 * int(3 * SG3_R_BLUR_SIGMA) + 1} x {2 * int(3 * SG3_R_BLUR_SIGMA) + 1} taps"
    if not any(reason.startswith(blur) for reason in plain):
        raise AssertionError(f"D's input blur ({blur}) never took the plain route: {plain}")
    losses = {k: float(v[1] / v[0]) for k, v in moments.items() if k.startswith("Loss/")}
    print(f"  steps from one state, batch {batch} in {stepper.cfg.micro_batches} chunks of "
          f"{batch_gpu}: +Dreg {times['+Dreg'][0]:.1f} ms; plain "
          + " / ".join(f"{t:.1f}" for t in times["plain"]) + f" ms (host clock); "
          f"{batch / sorted(times['plain'])[1] * 1e3:.2f} img/s plain; peak {peak:.2f} GiB on "
          f"{card}")
    print(f"  losses of the last plain step: { {k: round(v, 4) for k, v in losses.items()} }")
    print(f"  kernel launches of the four steps: { {k: n for k, n in launches.items() if n} }; "
          f"a +Dreg step {counts['+Dreg']}, a plain step {counts['plain']}; plain-route FIR "
          f"calls {plain}")

    for label, flags in (("+Dreg", (False, True)), ("plain", (False, False))):
        state.cur_nimg = 0
        prof = _profile_step(stepper, state, real_img, real_c, flags, card,
                             f"{label} StyleGAN3-R (batch {batch}, chunks of {batch_gpu})")
        print(f"  device time of one {label} step: {prof['total_ms']:.1f} ms on {card}")

    ckpt = save_checkpoint(os.path.join(tmp, "ckpt3r"), state, stepper.generator)
    saved = _train_state_tensors(state, stepper.generator)
    del state, stepper, real_img, real_c, moments
    torch.cuda.empty_cache()
    loader, fresh, fresh_stepper = build()
    loader.close()
    load_checkpoint(ckpt, fresh, fresh_stepper.generator)
    loaded = _train_state_tensors(fresh, fresh_stepper.generator)
    if saved.keys() != loaded.keys():
        raise AssertionError(f"the reloaded state has other tensors: "
                             f"{sorted(saved.keys() ^ loaded.keys())[:5]}")
    differ = [k for k in saved if not torch.equal(saved[k], loaded[k])]
    if differ:
        raise AssertionError(f"the reloaded state differs in {differ[:5]}")
    print(f"  {os.path.basename(ckpt)}: {os.path.getsize(ckpt) / 2**20:.1f} MiB, loaded into a "
          f"fresh build bit for bit ({len(saved)} tensors: networks, Adam moments, counters, "
          f"ADA, the step generator)")
    del fresh, fresh_stepper
    torch.cuda.empty_cache()
    print(f"  phase 12: {time.perf_counter() - t_phase:.1f} s wall on {card}")
    return launches


# Phase 13: the research tools around a run, on the host of the card
# machine: a sweep of job scripts, the analysis of phase 2's run, the stats
# dashboard, the dataset reports on phase 11's volumes, and the claro TIFF
# stage from raw slices to a packed set.
P13_PATIENTS, P13_SLICES, P13_RAW = 5, 4, 512


def _raw_claro_tree(root: str, rng) -> tuple:
    """claro's raw layout: ``<patient>/images/<patient>_<slice>.tif``,
    float32 slices of 512² in HU (written by the port's TIFF encoder, as
    PIL writes them), a patient table with an ``image`` column and a box
    table keyed ``img ID``; one slice has no box."""
    import numpy as np

    from gantrack_tpu_torch.data.preprocess.tiff import write_tiff

    src = os.path.join(root, "raw")
    rows, boxes = [], []
    for p in range(P13_PATIENTS):
        for s in range(P13_SLICES):
            sid = f"C{p:03d}_{s:03d}"
            d = os.path.join(src, f"C{p:03d}", "images")
            os.makedirs(d, exist_ok=True)
            sl = _ct_volume(rng, P13_RAW, 1)[:, :, 0].astype(np.float32)
            write_tiff(os.path.join(d, f"{sid}.tif"), sl)
            rows.append(f"C{p:03d}/images/{sid}.tif")
            if (p, s) != (0, 0):
                y0, x0 = rng.integers(P13_RAW // 12, P13_RAW // 6, 2).tolist()
                boxes.append((sid, [y0, x0, P13_RAW - y0, P13_RAW - x0]))
    info = os.path.join(root, "patients_info.csv")
    with open(info, "w") as f:
        f.write("image\n" + "".join(f"{r}\n" for r in rows))
    box_file = os.path.join(root, "boxes.csv")
    with open(box_file, "w") as f:
        f.write('"img ID","box lung"\n' + "".join(f'"{s}","{b}"\n' for s, b in boxes))
    return src, info, box_file, len(boxes)


def run_tools(card: str, tmp: str, data: str, claro_dir: str) -> None:
    """Phase 13: the last tools of the port on the card machine's host
    (none launches a kernel but ``calc_metrics``): ``generate_jobs`` (a 2 ×
    2 sweep, every script parsed, checked and resolved by the training
    CLI), ``analysis`` on phase 2's run (the metric loop emitted and its
    first line run in-process, the trend, the best snapshot, a dry-run
    clean-up), ``stats_dashboard`` on localhost, ``analyze_dataset`` on
    phase 11's volumes, ``create_label_files`` on its slice pickles and
    split, and the claro TIFF stage: ``prepare_dataset`` → ``dataset_tool``
    ``process_tiff`` → ``snap_zip`` → ``pack``, opened by the port's
    dataset."""
    import shlex
    import threading
    import urllib.request

    import numpy as np

    from gantrack_tpu_torch.data import open_dataset
    from gantrack_tpu_torch.tools import (analysis, analyze_dataset, calc_metrics,
                                          create_label_files, dataset_tool, generate_jobs,
                                          prepare_dataset, stats_dashboard)
    from gantrack_tpu_torch.tools import train as cli

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "tools")
    os.makedirs(root)
    walls = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t
        return out

    # Jobs: the sweep's scripts, each a command the training CLI takes.
    sweep = os.path.join(root, "sweep.json")
    with open(sweep, "w") as f:
        json.dump({"gamma": [0.4096, 2.0], "cfg": ["stylegan2", "stylegan3-r"]}, f)
    defaults = json.dumps({"outdir": os.path.join(root, "runs"), "data": data, "batch": 32,
                           "cbase": 16384, "glr": 0.0025, "dlr": 0.0025, "kimg": 5000,
                           "snap": 50, "tick": 4, "mirror": 1, "aug": "ada"})
    argv = [f"--sweep={sweep}", f"--out-dir={os.path.join(root, 'jobs')}",
            f"--defaults={defaults}"]
    print(f"phase 13: python -m gantrack_tpu_torch.tools.generate_jobs {shlex.join(argv)}")
    scripts = timed("generate_jobs", generate_jobs.main, argv)
    for path in scripts:
        with open(path) as f:
            command = shlex.split(f.read().split("set -e\n", 1)[1].replace("\\\n", " "))
        if command[:3] != ["python", "-m", "gantrack_tpu_torch.tools.train"]:
            raise AssertionError(f"{path}: {command[:3]}")
        opts = cli.build_parser().parse_args(command[3:])
        cli.check_slice(opts)
        c = cli.resolve_config(opts)
        if (c["batch_size"], c["G"]["channel_base"], c["num_devices"]) != (32, 16384, 1):
            raise AssertionError(f"{path} resolved to {c}")
    print(f"  {len(scripts)} scripts, each parsed, checked and resolved by the training CLI")
    if len(scripts) != 4:
        raise AssertionError(f"{len(scripts)} scripts for a 2 x 2 sweep")

    # Run analysis on phase 2's run: the emitted metric loop's first line
    # through calc_metrics in-process, then the trend and the best snapshot.
    script = timed("emit_metric_loop", analysis.emit_metric_loop, claro_dir, data, "kid10k")
    with open(script) as f:
        lines = [line for line in f.read().splitlines() if "calc_metrics" in line]
    checkpoints = analysis.checkpoints(claro_dir)
    if len(lines) != len(checkpoints) or not checkpoints:
        raise AssertionError(f"{len(lines)} calc_metrics lines for checkpoints {checkpoints}")
    words = shlex.split(lines[0])
    print(f"phase 13: {lines[0]}")
    results = timed("calc_metrics (emitted)", calc_metrics.main, words[3:])
    trend = analysis.metric_trend(claro_dir, "kid10k")
    best = analysis.best_snapshot(claro_dir, "kid10k")
    if not best or not best[0].endswith(".pt") or not os.path.isfile(best[0]):
        raise AssertionError(f"best_snapshot named {best}")
    removed = analysis.clean_run_dir(claro_dir, dry_run=True, metric="kid10k")
    if len(removed) != max(len(checkpoints) - 1, 0) or analysis.checkpoints(claro_dir) != \
            checkpoints:
        raise AssertionError(f"clean_run_dir (dry run) removed {removed} of {checkpoints}")
    print(f"  {results}; kid10k trend {[(os.path.basename(s), round(v, 6)) for s, v in trend]}; "
          f"best {os.path.basename(best[0])} = {best[1]:.6f}; the dry-run clean-up would remove "
          f"{len(removed)} of {len(checkpoints)} checkpoints (the latest stays)")

    # The dashboard on localhost: one kimg a tick of stats.jsonl.
    with open(os.path.join(claro_dir, "stats.jsonl")) as f:
        ticks = sum(1 for line in f if line.strip())
    httpd = stats_dashboard.serve(claro_dir, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        t = time.perf_counter()
        page = urllib.request.urlopen(url + "/", timeout=30).read()
        series = json.loads(urllib.request.urlopen(url + "/api/series", timeout=30).read())
        walls["stats_dashboard"] = time.perf_counter() - t
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()
    if b"gantrack stats" not in page or len(series["kimg"]) != ticks or \
            not any(v is not None for v in series["loss_g"]) or "kid10k" not in series["metrics"]:
        raise AssertionError(f"dashboard: {len(series['kimg'])} kimg entries for {ticks} ticks, "
                             f"metrics {list(series['metrics'])}")
    print(f"  stats_dashboard on {url}: /api/series has {len(series['kimg'])} ticks as "
          f"stats.jsonl, metrics {sorted(series['metrics'])}")

    # Dataset reports on phase 11's volumes, slice pickles and split.
    volumes = os.path.join(tmp, "volumes")
    argv = [f"--source={os.path.join(volumes, 'raw')}",
            f"--out={os.path.join(root, 'volume_stats.csv')}"]
    print(f"phase 13: python -m gantrack_tpu_torch.tools.analyze_dataset {' '.join(argv)}")
    report = timed("analyze_dataset", analyze_dataset.main, argv)
    lo, hi = report["range"]["lower"], report["range"]["upper"]
    if len(report["rows"]) != P11_PATIENTS or not -1024 <= lo < hi <= 3071:
        raise AssertionError(f"analyze_dataset: {len(report['rows'])} volumes, range {lo}..{hi}")
    (split,) = [os.path.join(volumes, "zipped", "train_val_test_ids", f)
                for f in os.listdir(os.path.join(volumes, "zipped", "train_val_test_ids"))]
    labels = os.path.join(root, "labels.csv")
    with open(labels, "w") as f:
        f.write("id,label\n" + "".join(f"P{p:03d},{'ab'[p % 2]}\n" for p in range(P11_PATIENTS)))
    argv = [f"--patients-dir={os.path.join(volumes, 'pickles')}", f"--labels={labels}",
            f"--split-file={split}", f"--out-dir={os.path.join(root, 'labels')}"]
    print(f"phase 13: python -m gantrack_tpu_torch.tools.create_label_files {' '.join(argv)}")
    counts = timed("create_label_files", create_label_files.main, argv)
    pickles = sum(len(files) for d, _, files in os.walk(os.path.join(volumes, "pickles"))
                  if os.path.basename(d).startswith("P"))
    if sum(counts.values()) != pickles:
        raise AssertionError(f"create_label_files labelled {counts} of {pickles} slices")
    print(f"  {len(report['rows'])} volumes, pooled p1..p99 [{lo:.1f}, {hi:.1f}] HU; labels "
          f"{counts} of {pickles} slice pickles")

    # The claro TIFF stage.
    t = time.perf_counter()
    src, info, box_file, kept = _raw_claro_tree(os.path.join(root, "claro"),
                                                np.random.default_rng(13))
    walls["raw tree"] = time.perf_counter() - t
    interim = os.path.join(root, "claro", "interim")
    argv = [f"--source={src}", f"--dest={interim}", f"--patients-info={info}",
            f"--box-file={box_file}", f"--resolution={P11_RES}"]
    print(f"phase 13: python -m gantrack_tpu_torch.tools.prepare_dataset {' '.join(argv)}")
    timed("prepare_dataset", prepare_dataset.main, argv)
    written = sorted(os.listdir(os.path.join(interim, "images")))
    if len(written) != kept:
        raise AssertionError(f"prepare_dataset wrote {len(written)} slices of {kept} with a box")
    # prepare_dataset writes the slices flat; process_tiff reads a directory
    # a patient, so they are linked into one a patient (as the JAX tools
    # are chained), and its HU range is the [0, 255] the slices are now in.
    by_patient = os.path.join(root, "claro", "by_patient")
    for name in written:
        os.makedirs(os.path.join(by_patient, name.split("_")[0]), exist_ok=True)
        os.link(os.path.join(interim, "images", name),
                os.path.join(by_patient, name.split("_")[0], name))
    paths = {"by_patient": by_patient}
    for step, source, dest, flags in (
            ("process_tiff", "by_patient", "pickles",
             [f"--resolution={P11_RES}", "--hu-min=0", "--hu-max=255"]),
            ("snap_zip", "pickles", "zipped", []),
            ("pack", "zip", "packed", ["--modalities=CT"])):
        paths[dest] = os.path.join(root, "claro", dest)
        argv = [f"--processing_step={step}", f"--source={paths[source]}",
                f"--dest={paths[dest]}", *flags]
        print(f"phase 13: python -m gantrack_tpu_torch.tools.dataset_tool {' '.join(argv)}")
        timed(step, dataset_tool.main, argv)
        if step == "snap_zip":
            (paths["zip"],) = [os.path.join(paths[dest], f) for f in os.listdir(paths[dest])
                               if f.endswith(".zip")]
    with open(os.path.join(paths["zipped"], "train_val_test_ids",
                           os.path.basename(paths["zip"])[:-4] + ".json")) as f:
        train_patients = [p for p in json.load(f)["train"] if p.startswith("C")]
    want = sum(n.startswith(tuple(f"{p}_" for p in train_patients)) for n in written)
    dataset = open_dataset(paths["packed"])
    img = np.asarray(dataset[0][0], np.float64)
    if (len(dataset), dataset.resolution, dataset.num_channels) != (want, P11_RES, 1) or \
            not np.isfinite(img).all() or not 0 <= img.min() < img.max() <= 255:
        raise AssertionError(f"packed claro set: {len(dataset)} items at {dataset.resolution}^2 "
                             f"x {dataset.num_channels}, pixels {img.min()}..{img.max()}; want "
                             f"{want} at {P11_RES}^2 x 1 in [0, 255]")
    print(f"  claro TIFF stage: {P13_PATIENTS * P13_SLICES} raw slices {P13_RAW}^2 float32 HU, "
          f"{kept} with a box → {len(written)} TIFFs {P11_RES}^2 → pickles → zip → packed train "
          f"split of {len(dataset)} slices ({len(train_patients)} patients), "
          f"{dataset.resolution}^2 x {dataset.num_channels}, pixels {img.min():.1f}..{img.max():.1f}")
    print(f"  phase 13: {time.perf_counter() - t_phase:.1f} s wall; by tool (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()) + f"; on {card}")


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
    kernels.update(timed("phase 1 (fused filtered_lrelu)", check_filtered_lrelu, card))
    kernels.update(timed("phase 1 (warp)", check_warp, card))
    kernels.update(timed("phase 1 (probes)", check_probes, card))
    kernels.update(timed("phase 1 (conv3x3)", check_conv3x3, card))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        data = _synthetic_dataset(tmp)
        run_dir, claro = timed("phase 2", train_claro, card, tmp, data)
        timed("phase 3", run_calc_metrics, card, tmp, data, run_dir)
        sg3_dir, sg3 = timed("phase 4", train_stylegan3, card, tmp, data)
        unfused = timed("phase 5", run_unfused_augment, card, tmp, data)
        probed = timed("phase 6 (probes)", run_probe_path)
        routed = timed("phase 6 (conv route)", run_kernel_route, card, tmp, data)
        asynced = timed("phase 7", run_metric_async, card, tmp, data)
        generated = timed("phase 8", run_generation, card, tmp, data, run_dir, sg3_dir)
        parallel = timed("phase 9", run_data_parallel, card, tmp, data)
        timed("phase 10", run_i2i, card, tmp)
        resumed = timed("phase 11", run_volume_route, card, tmp, run_dir)
        sg3r = timed("phase 12", train_stylegan3r, card, tmp, data)
        timed("phase 13", run_tools, card, tmp, data, run_dir)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s wall since the build began")
    # Launches on the main paths: the claro run, the StyleGAN3 run with its
    # metrics, the unfused augment steps, the probes' run, the kernel-route
    # steps, the metric-async run, the generation leg, the data-parallel
    # run, the run resumed from a pickle with its tools and the StyleGAN3-R
    # steps, each counted from 0.
    paths = {"claro": claro, "stylegan3-t": sg3, "unfused augment": unfused, "probes": probed,
             "kernel conv route": routed, "claro, metric-async": asynced,
             "generation": generated, "claro, NCCL world 1": parallel,
             "claro, resumed from a NVIDIA pickle": resumed, "stylegan3-r": sg3r}
    launches = {k: sum(counts[k] for counts in paths.values()) for k in KERNELS}
    print("kernel launches by main path: "
          + "; ".join(f"{name} { {k: n for k, n in counts.items() if n} }"
                      for name, counts in paths.items()))
    for name, n in launches.items():
        if n <= 0 and name not in OFF_THE_MAIN_PATHS:
            raise AssertionError(f"kernel {name} was launched on no main path")
    report = [{"name": name, "route": "cuda", "source": f"gantrack_tpu_torch/csrc/{source}",
               "replaces": replaces, "launches": launches[name], **kernels[name]}
              for name, (source, replaces) in KERNELS.items()]
    jax_modules = [m for m in sys.modules
                   if m.split(".")[0] in ("gantrack_tpu", "jax", "flax", "optax", "orbax")]
    if jax_modules:
        raise AssertionError(f"the port imported JAX or the JAX package: {sorted(jax_modules)[:5]}")
    # Nor what the card machine lacks (a function may import PIL, PyYAML or
    # pandas where they are installed; no path of this run needs them).
    missing = [m for m in sys.modules
               if m.split(".")[0] in ("click", "PIL", "yaml", "pandas", "cv2")]
    if missing:
        raise AssertionError(f"the run imported {sorted(missing)[:5]}")
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["--gs-worker"]:
        sys.exit(gs_worker(sys.argv[2], sys.argv[3], *sys.argv[4:5],
                           small="small" in sys.argv[5:]))
    sys.exit(main())
