"""Smoke test of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``gantrack_tpu_torch/csrc`` (one ``nvcc``
per source, all started together), then:

0. prints the card's name and power limit and the kernel build times;
1. holds each kernel against its plain PyTorch version at the shapes of
   the claro StyleGAN2-ADA 256² training step, and times both:
   the upwarp pair K1/K2 (64 planes of 406 × 403, out 524², transforms
   drawn from ``medical_augment_config`` at p = 1) and the resample FIR
   K5–K7 (``ops/fir.py``) at the five FIR shapes of the step, with
   adjointness and gradients of both orders;
2. trains 32 steps of the claro recipe (batch 32, cbase 16384, 1 kimg)
   through the port's CLI on a synthetic 256² dataset, with
   ``--metrics=fid1k`` at the snapshot; checks the outcome and that every
   kernel ran, and times each phase variant of the step;
3. runs ``calc_metrics`` on the run's checkpoint: fid10k and kid10k with
   the default (random projection) detector, and fid1k with a
   ``tfslim`` InceptionV3 of seeded random weights at 299²; times the
   generator pass of each detector;
4. prints the kernel report and, last, the device line.

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
}
# The FIR calls of the claro step (phase 1): name, [N, C, H, W], dtype of
# the step, then the upfirdn2d arguments.  The first of each form is the
# one the kernel report quotes.
FIR_SHAPES = [
    ("G up-conv post-filter (same)", (32, 64, 259, 259), "bf16",
     dict(filter="f4", padding=0, gain=4)),
    ("D down-conv pre-filter (same, pads 2)", (32, 64, 256, 256), "bf16",
     dict(filter="f4", padding=2)),
    ("D skip (down2)", (32, 64, 256, 256), "bf16", dict(filter="f4", down=2, padding=1)),
    ("G image skip upsample2d (up2)", (32, 1, 128, 128), "f32",
     dict(filter="f4", up=2, padding=[2, 1, 2, 1], gain=4)),
    ("augment crop-downsample (down2, 12 taps)", (64, 1, 524, 524), "bf16",
     dict(filter="sym6", down=2, padding=-1, flip_filter=True)),
]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _check(name: str, err: float, limit: float) -> None:
    ok = err <= limit
    print(f"  {name}: err {err:.3e}  limit {limit:.3e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: error {err} above limit {limit}")


def _reset(*counters) -> None:
    for counter in counters:
        for k in counter:
            counter[k] = 0


def _median_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def check_kernels(card: str) -> dict:
    """Phase 1: each kernel against the plain version at the main path's
    shapes.  Returns {kernel: {max_abs_err, ms, plain_ms}}."""
    import torch
    import torch.nn.functional as F

    from gantrack_tpu_torch.ops import upwarp as uw
    from gantrack_tpu_torch.training.augment import AugmentPipe, medical_augment_config

    # The plain versions run through cuDNN: keep it out of TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    pipe = AugmentPipe(medical_augment_config(), 256, 256, 1)
    n = 64  # Dmain augments fake ‖ real: 2 × batch 32
    g_inv = pipe.sample_geometric(n, 1.0, dev, gen)
    theta, oh, ow = pipe.warp_geometry(g_inv)
    mx0, mx1, my0, my1 = pipe.margin
    h1, w1 = 256 + my0 + my1, 256 + mx0 + mx1
    print(f"phase 1: {n} planes {h1}x{w1} -> {oh}x{ow}, margin {pipe.margin}")
    coeffs = uw.warp_coefficients(theta, 2 * h1, 2 * w1, oh, ow)
    taps = pipe.hz_geom_taps
    fir = pipe.hz_geom.to(dev)

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

    # Times at the training dtype (bf16), median of 20 launches.
    t_k1 = _median_ms(lambda: uw.upwarp_planes(xb, coeffs, taps, oh, ow))
    t_p1 = _median_ms(lambda: plain(xb))
    t_k2 = _median_ms(lambda: uw.upsplat_planes(gb, coeffs, taps, h1, w1))
    t_p2 = _median_ms(lambda: plain_adjoint(gb))
    print(f"  times (bf16, median of 20, CUDA events) on {card}: "
          f"K1 {t_k1:.4f} ms, plain {t_p1:.4f} ms; K2 {t_k2:.4f} ms, plain adjoint {t_p2:.4f} ms")
    return {
        "upwarp": {"max_abs_err": err_k1, "ms": t_k1, "plain_ms": t_p1},
        "upsplat": {"max_abs_err": err_k2, "ms": t_k2, "plain_ms": t_p2},
    }


def check_fir(card: str) -> dict:
    """Phase 1 (FIR): K5–K7 against the plain ``upfirdn2d`` at the step's
    FIR shapes.  Returns {kernel: {max_abs_err, ms, plain_ms}} for the
    first shape of each form."""
    import importlib

    import torch
    import torch.nn.functional as F

    from gantrack_tpu_torch.ops import fir
    from gantrack_tpu_torch.training.augment import WAVELETS

    ufd = importlib.import_module("gantrack_tpu_torch.ops.upfirdn2d")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    filters = {"f4": ufd.setup_filter([1, 3, 3, 1]), "sym6": ufd.setup_filter(WAVELETS["sym6"])}
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
        print(f"phase 1 FIR {label}: {list(shape)} -> {list(ref.shape)} ({name})")
        err = _max_err(got, ref)
        _check(f"{name} f32 vs plain", err, 1e-5 * float(ref.abs().max()))
        xb = x.bfloat16()  # bf16 input, f32 sums: the output's rounding dominates
        refb = plain(xb.float())
        _check(f"{name} bf16 vs plain", _max_err(kernel(xb), refb), 1e-2 * float(refb.abs().max()))
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
        # Forward + backward at the step's dtype, median of 20.
        xt = (xb if step_dtype == "bf16" else x).requires_grad_(True)
        gt = g.to(xt.dtype)
        t_k = _median_ms(lambda: torch.autograd.grad(kernel(xt), xt, gt))
        t_p = _median_ms(lambda: torch.autograd.grad(plain(xt), xt, gt))
        print(f"  {name} forward+backward ({step_dtype}, median of 20, CUDA events) on {card}: "
              f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
        if name not in report:
            report[name] = {"max_abs_err": err, "ms": t_k, "plain_ms": t_p}
        del x, xb, ref, refb, got, g, ktg
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
    """Phase 2: the claro recipe with fid1k through the CLI, on the device
    the CLI picks from ``args`` (CUDA unless ``--device=cpu``).  Returns
    the run dir and the launch counts of the run."""
    import numpy as np
    import torch

    from gantrack_tpu_torch.ops import fir
    from gantrack_tpu_torch.ops import upwarp as uw
    from gantrack_tpu_torch.tools import train as cli
    from gantrack_tpu_torch.training.loop import to_device_batch
    from gantrack_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint

    device = torch.device(cli.build_parser().parse_args(["--outdir=", "--data=", *args]).device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

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
    _reset(uw.LAUNCHES, fir.LAUNCHES)
    t0 = time.perf_counter()
    try:
        run_dir = cli.main(argv)
        sync()
    finally:
        fir.fir_planes = launch_fir
    seconds = time.perf_counter() - t0
    launches = {**uw.LAUNCHES, **fir.LAUNCHES}
    print(f"  CLI run: {seconds:.1f} s wall (incl. setup, image grids and fid1k) on {card}; "
          f"kernel launches {launches}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched by the training run")
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
    for label, flags in (("plain", (False, False)), ("+Greg", (True, False)),
                         ("+Greg+Dreg", (True, True))):
        times = []
        for i in range(4):
            sync()
            t = time.perf_counter()
            stepper.run(state, real_img, real_c, *flags)
            sync()
            if i > 0:
                times.append((time.perf_counter() - t) * 1e3)
        times.sort()
        print(f"  step {label}: median {times[len(times) // 2]:.1f} ms of {len(times)} "
              f"(batch {batch}, {res}^2) on {card}")
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
    from gantrack_tpu_torch.ops import fir
    from gantrack_tpu_torch.ops import upwarp as uw
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
        _reset(uw.LAUNCHES, fir.LAUNCHES)
        t0 = time.perf_counter()
        results = calc_metrics.main(argv)
        torch.cuda.synchronize()
        launches = {k: n for k, n in fir.LAUNCHES.items() if n}
        print(f"  {results} in {time.perf_counter() - t0:.1f} s on {card}; FIR launches {launches}")
        for metric in metrics.split(","):
            _metric_rows(run_dir, metric)
        for k in ("fir_same", "fir_up2"):  # G_ema's synthesis
            if fir.LAUNCHES[k] <= 0:
                raise AssertionError(f"kernel {k} was not launched by calc_metrics")

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    os.environ["GANTRACK_JAX_CACHE"] = "off"
    from gantrack_tpu_torch.ops import _nvcc

    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    for source, info in _nvcc.build_all().items():
        regs = sorted({line.split("Used ")[1].split(",")[0]
                       for line in info["log"].splitlines() if "registers" in line})
        print(f"build {source}: {info['seconds']:.1f} s with nvcc (sm_90a); registers {regs}")
    print(f"build: {time.perf_counter() - t0:.1f} s wall, all sources in parallel")

    kernels = check_kernels(card)
    kernels.update(check_fir(card))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        data = _synthetic_dataset(tmp)
        run_dir, launches = train_claro(card, tmp, data)
        run_calc_metrics(card, tmp, data, run_dir)
    report = [{"name": name, "route": "cuda", "source": f"gantrack_tpu_torch/csrc/{source}",
               "replaces": replaces, "launches": launches[name], **kernels[name]}
              for name, (source, replaces) in KERNELS.items()]
    jax_modules = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "orbax")]
    if jax_modules:
        raise AssertionError(f"the port imported JAX: {sorted(jax_modules)[:5]}")
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
