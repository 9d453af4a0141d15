"""Training launcher CLI of the PyTorch port.

    python -m gantrack_tpu_torch.tools.train --outdir=runs --cfg=stylegan2 \\
        --data=<dataset dir> --batch=32 --gamma=0.4096 --cbase=16384 --cmax=512 \\
        --map-depth=2 --glr=0.0025 --dlr=0.0025 --aug=ada --target=0.6 \\
        --mirror=1 --metrics=fid50k_full

Same flag names as ``gantrack_tpu/tools/train.py`` (``argparse`` here).
Trains StyleGAN2-ADA (``--cfg=stylegan2``) or StyleGAN3
(``--cfg=stylegan3-t`` / ``stylegan3-r``: no path length, no style
mixing, mapping depth 2; ``-r`` doubles the channels, takes 1×1 convs and
radial filters, and fades a discriminator blur) on one CUDA device
(``--device=cpu`` trains on the CPU instead, for rehearsals at a tiny
size) and evaluates ``--metrics`` of G_ema (the ``eq*`` equivariance
metrics for StyleGAN3 only) at every ``--metric-snap``-th snapshot, with
the InceptionV3 of ``--detector-weights`` or, without weights, the random
projection detector.  No ``--batch-gpu`` accumulation, no freeze-D and no
``--metric-async``; those raise.  The
JAX CLI's ``--dtype`` (read by nothing) and ``--rng-impl`` (a TPU
generator) are not taken.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np
import torch


def _bool(value: str) -> bool:
    v = value.strip().lower()
    if v in ("1", "true", "t", "yes", "y"):
        return True
    if v in ("0", "false", "f", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {value!r}")


def _list(value: str) -> List[str]:
    return [] if value in ("", "none") else value.split(",")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gantrack_tpu_torch.tools.train",
                                description="Train StyleGAN2-ADA or StyleGAN3 with the PyTorch port.")
    p.add_argument("--outdir", required=True, help="Where to save the results")
    p.add_argument("--cfg", required=True, choices=["stylegan3-t", "stylegan3-r", "stylegan2"])
    p.add_argument("--data", required=True, help="Training data")
    p.add_argument("--modalities", default="MR_nonrigid_CT,MR_MR_T2")
    p.add_argument("--dataset", dest="dataset_name", default="Pelvis_2.1")
    p.add_argument("--split", default="train")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Train on the CUDA device (default) or on the CPU")
    p.add_argument("--devices", "--gpus", dest="num_devices", type=int, default=None)
    p.add_argument("--batch", type=int, required=True, help="Total batch size")
    p.add_argument("--batch-gpu", dest="batch_gpu", type=int, default=None)
    p.add_argument("--gamma", type=float, required=True, help="R1 weight")
    p.add_argument("--cond", type=_bool, default=False)
    p.add_argument("--mirror", type=_bool, default=False)
    p.add_argument("--aug", choices=["noaug", "ada", "fixed"], default="ada")
    p.add_argument("--ada_kimg", type=int, default=500)
    p.add_argument("--aug_opts", type=_list, default=_list("xflip,xint,scale,rotate,aniso,xfrac"))
    p.add_argument("--xint_max", type=float, default=0.05)
    p.add_argument("--rotate_max", type=int, default=3)
    p.add_argument("--xfrac_std", type=float, default=0.05)
    p.add_argument("--scale_std", type=float, default=0.05)
    p.add_argument("--aniso_std", type=float, default=0.05)
    p.add_argument("--resume", default=None)
    p.add_argument("--freezed", type=int, default=0)
    p.add_argument("--p", dest="aug_p", type=float, default=0.2)
    p.add_argument("--target", type=float, default=0.6)
    p.add_argument("--cbase", type=int, default=32768)
    p.add_argument("--cmax", type=int, default=512)
    p.add_argument("--glr", type=float, default=None)
    p.add_argument("--dlr", type=float, default=0.002)
    p.add_argument("--map-depth", dest="map_depth", type=int, default=None)
    p.add_argument("--mbstd-group", dest="mbstd_group", type=int, default=4)
    p.add_argument("--desc", default=None)
    p.add_argument("--metrics", type=_list, default=_list("fid50k_full"))
    p.add_argument("--metrics_cache", type=_bool, default=False,
                   help="Cache the dataset features under <run dir>/metric-cache")
    p.add_argument("--metric-snap", dest="metric_snap", type=int, default=1,
                   help="Evaluate metrics only on every N-th snapshot")
    p.add_argument("--metric-async", dest="metric_async", action="store_true",
                   help="Run the metrics of a snapshot that is not the last on a background "
                        "thread while training goes on")
    p.add_argument("--detector-weights", dest="detector_weights", default=None,
                   help="Converted InceptionV3 weights .npz for FID (tools/convert_detector.py)")
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--kimg", type=int, default=25000)
    p.add_argument("--tick", type=int, default=4)
    p.add_argument("--snap", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fp32", type=_bool, default=False)
    p.add_argument("--num-fp16-res", dest="num_fp16_res", type=int, default=4)
    p.add_argument("-n", "--dry-run", dest="dry_run", action="store_true")
    return p


def check_slice(opts) -> None:
    """Reject what this slice does not run, naming where it is queued."""
    from ..metrics import check_metric

    for m in opts.metrics:
        try:
            check_metric(m)
        except ValueError as e:
            raise SystemExit(f"--metrics: {e}") from None
        if m.startswith("eq") and opts.cfg == "stylegan2":
            raise SystemExit(f"--metrics: {m} needs a StyleGAN3 generator (--cfg=stylegan3-t|-r)")
    if opts.metric_snap < 1:
        raise SystemExit("--metric-snap: must be at least 1")
    if opts.num_devices not in (None, 1):
        raise SystemExit("--devices: one device in this slice (data parallelism: ROADMAP A7)")
    if opts.batch_gpu not in (None, opts.batch):
        raise SystemExit("--batch-gpu: no gradient accumulation in this slice (ROADMAP A7)")
    if opts.freezed:
        raise SystemExit("--freezed: freeze-D is not ported yet")


def resolve_config(opts) -> dict:
    num_fp16_res = 0 if opts.fp32 else opts.num_fp16_res
    return dict(
        cfg=opts.cfg, batch_size=opts.batch, total_kimg=opts.kimg, kimg_per_tick=opts.tick,
        snapshot_ticks=opts.snap, random_seed=opts.seed, metrics=opts.metrics,
        dataset=opts.data, device=opts.device,
        G=dict(z_dim=512, w_dim=512, channel_base=opts.cbase, channel_max=opts.cmax,
               num_fp16_res=num_fp16_res,
               map_depth=opts.map_depth or (8 if opts.cfg == "stylegan2" else 2)),
        D=dict(channel_base=opts.cbase, channel_max=opts.cmax, num_fp16_res=num_fp16_res,
               mbstd_group=opts.mbstd_group),
        glr=opts.glr if opts.glr is not None else (0.002 if opts.cfg == "stylegan2" else 0.0025),
        dlr=opts.dlr, gamma=opts.gamma, ema_kimg=opts.batch * 10 / 32,
        aug=opts.aug, target=opts.target,
    )


def main(argv: Optional[List[str]] = None) -> Optional[str]:
    """Parse ``argv``, train; returns the run dir (None on a dry run)."""
    opts = build_parser().parse_args(argv)
    check_slice(opts)
    c = resolve_config(opts)
    desc = f"{opts.dataset_name}-{opts.cfg}-batch{opts.batch}-gamma{opts.gamma:g}"
    if opts.desc:
        desc += f"-{opts.desc}"
    if opts.dry_run:
        print(json.dumps(c, indent=2))
        print("Dry run; exiting.")
        return None
    from ..utils.checkpoint import allocate_run_dir

    run_dir = allocate_run_dir(opts.outdir, desc)
    with open(os.path.join(run_dir, "training_options.json"), "wt") as f:
        json.dump(c, f, indent=2)
    print(f"Run dir: {run_dir}")
    train(c, opts, run_dir)
    return run_dir


def make_generator(cfg: str, *, resolution: int, channels: int, c_dim: int, cbase: int,
                   cmax: int, map_depth: int, num_fp16_res: int = 4, z_dim: int = 512,
                   w_dim: int = 512, conv_impl: str = "library"):
    """The generator of ``--cfg``: stylegan2, stylegan3-t or stylegan3-r
    (channels ×2, 1×1 convs, radial filters).  ``conv_impl`` is the
    StyleGAN2 layers' (StyleGAN3's keep the library convolution)."""
    if cfg == "stylegan2":
        from ..models.stylegan2 import Generator

        return Generator(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim, img_resolution=resolution,
                         img_channels=channels, mapping_kwargs=dict(num_layers=map_depth),
                         synthesis_kwargs=dict(channel_base=cbase, channel_max=cmax,
                                               num_fp16_res=num_fp16_res),
                         conv_impl=conv_impl)
    if conv_impl != "library":
        raise ValueError(f"conv_impl={conv_impl!r}: the StyleGAN3 layers have no kernel route")
    from ..models.stylegan3 import Generator as SG3Generator

    mult = 2 if cfg == "stylegan3-r" else 1
    return SG3Generator(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim, img_resolution=resolution,
                        img_channels=channels, channel_base=cbase * mult,
                        channel_max=cmax * mult, conv_kernel=1 if cfg == "stylegan3-r" else 3,
                        use_radial_filters=(cfg == "stylegan3-r"), num_fp16_res=num_fp16_res,
                        mapping_kwargs=dict(num_layers=map_depth))


# By how much the metrics' generator-pass batch of each ``--cfg`` is cut
# below the resolution rule.  A StyleGAN3 layer holds its activations at 2x
# or 4x its rate between its two filters, so its generator takes a smaller
# batch than StyleGAN2's.  At full width and 256^2 on an H100 80GB the pass
# peaks at 0.53 GiB an image for -t and 1.05 GiB for -r (twice the
# channels); the divisors keep it under half the card, beside a training
# state (``chip_smoke.py`` tries 128, 64 and 32 and checks the choice).
METRIC_BATCH_DIVISOR = {"stylegan2": 1, "stylegan3-t": 4, "stylegan3-r": 8}


def metric_batch(cfg: str, resolution: int) -> int:
    """The metrics' batch for ``--cfg`` at a resolution: the JAX rule
    (``auto_metric_batch``) over the family's divisor."""
    from ..metrics.metric_utils import auto_metric_batch

    return max(auto_metric_batch(resolution) // METRIC_BATCH_DIVISOR[cfg], 1)


def build_training(c: dict, opts, device: torch.device, augment_impl: str = "fused",
                   conv_impl: str = "library"):
    """Dataset, loader, networks, state, loss and stepper of a run.
    ``augment_impl`` is the ``impl`` of the augment pipe and ``conv_impl``
    who runs the dense 3×3 stride-1 convolutions of G and D (``"library"``:
    cuDNN; ``"kernel"``: ``ops.conv3x3``); neither has a CLI flag, as in
    the JAX CLI."""
    from ..data import InfiniteLoader, open_dataset
    from ..models.stylegan2 import Discriminator
    from ..training.augment import AugmentConfig, AugmentPipe
    from ..training.loss import StyleGAN2Loss, StyleGAN2LossConfig
    from ..training.step import TrainStepConfig, TrainStepper
    from ..training.train_state import create_train_state

    dataset_kwargs = dict(split=opts.split, xflip=opts.mirror, use_labels=opts.cond,
                          random_seed=opts.seed)
    if opts.data.endswith(".zip"):
        dataset_kwargs["modalities"] = opts.modalities.split(",") if opts.modalities else None
    dataset = open_dataset(opts.data, **dataset_kwargs)
    res, channels = dataset.resolution, dataset.num_channels
    if opts.cond and not dataset.has_labels:
        raise SystemExit("--cond=True requires labels specified in dataset.json")
    c_dim = dataset.label_dim if opts.cond else 0
    print(f"Dataset: {dataset.name}  {len(dataset)} items  {res}x{res}x{channels}  "
          f"labels={c_dim}  device={device}")

    torch.manual_seed(opts.seed)
    sg2 = c["cfg"] == "stylegan2"
    G = make_generator(c["cfg"], resolution=res, channels=channels, c_dim=c_dim,
                       cbase=c["G"]["channel_base"], cmax=c["G"]["channel_max"],
                       map_depth=c["G"]["map_depth"], num_fp16_res=c["G"]["num_fp16_res"],
                       z_dim=c["G"]["z_dim"], w_dim=c["G"]["w_dim"], conv_impl=conv_impl).to(device)
    D = Discriminator(c_dim=c_dim, img_resolution=res, img_channels=channels,
                      channel_base=c["D"]["channel_base"], channel_max=c["D"]["channel_max"],
                      num_fp16_res=c["D"]["num_fp16_res"],
                      epilogue_kwargs=dict(mbstd_group_size=c["D"]["mbstd_group"]),
                      conv_impl=conv_impl).to(device)
    g_reg_interval = 4 if sg2 else None  # StyleGAN3 has no path-length phase
    state = create_train_state(G, D, c["glr"], c["dlr"], g_reg_interval=g_reg_interval,
                               d_reg_interval=16)
    generator = torch.Generator(device=device).manual_seed(opts.seed)
    if opts.resume:
        from ..utils.checkpoint import load_checkpoint, resolve_checkpoint_path

        path = resolve_checkpoint_path(opts.resume)
        if path is None:
            raise SystemExit(f"--resume: no checkpoint found under {opts.resume}")
        print(f"Resuming from {path}")
        load_checkpoint(path, state, generator)

    augment_fn = None
    ada_target = None
    if opts.aug != "noaug":
        aug_cfg = AugmentConfig(**{
            **{k: 1.0 for k in opts.aug_opts},
            "xint_max": opts.xint_max, "rotate_max": opts.rotate_max / 360,
            "xfrac_std": opts.xfrac_std, "scale_std": opts.scale_std,
            "aniso_std": opts.aniso_std,
        })
        augment_fn = AugmentPipe(aug_cfg, res, res, channels, impl=augment_impl)
        if opts.aug == "ada":
            ada_target = opts.target
        elif not opts.resume:
            state.ada_p = torch.tensor(opts.aug_p, device=device)

    sg3r = c["cfg"] == "stylegan3-r"
    loss = StyleGAN2Loss(G, D, StyleGAN2LossConfig(
        r1_gamma=c["gamma"], style_mixing_prob=0.9 if sg2 else 0.0,
        pl_weight=2.0 if sg2 else 0.0, blur_init_sigma=10.0 if sg3r else 0.0,
        blur_fade_kimg=opts.batch * 200 / 32 if sg3r else 0.0), augment_fn=augment_fn)
    label_bank = None
    if c_dim > 0:
        label_bank = torch.from_numpy(np.stack(
            [dataset.get_label(i) for i in range(len(dataset))]).astype(np.float32)).to(device)
    step_cfg = TrainStepConfig(
        batch_size=opts.batch, z_dim=c["G"]["z_dim"], c_dim=c_dim, ema_kimg=c["ema_kimg"],
        ema_rampup=None if opts.resume else 0.05, g_reg_interval=g_reg_interval,
        d_reg_interval=16,
        ada_target=ada_target, ada_kimg=100 if opts.resume else opts.ada_kimg)
    stepper = TrainStepper(loss, step_cfg, generator, label_bank=label_bank)
    loader = InfiniteLoader(dataset, batch_size=opts.batch, seed=opts.seed,
                            num_workers=opts.workers)
    return dataset, loader, state, stepper


def train(c: dict, opts, run_dir: str):
    from ..training.loop import training_loop

    # The reference trains without TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(c["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device=cuda: no CUDA device is available "
                         "(--device=cpu trains on the CPU)")
    dataset, loader, state, stepper = build_training(c, opts, device)
    c_dim = stepper.cfg.c_dim

    metric_fn = None
    if c["metrics"]:
        from ..metrics import make_inception_detector
        from .calc_metrics import evaluate_metrics

        detector = make_inception_detector(opts.detector_weights, seed=0, device=device)
        cache_dir = os.path.join(run_dir, "metric-cache") if opts.metrics_cache else None

        def metric_fn(state, kimg=None):
            return evaluate_metrics(
                state.G_ema, c["metrics"], dataset, detector, device,
                batch_size=metric_batch(c["cfg"], dataset.resolution),
                modalities=opts.modalities.split(","), cache_dir=cache_dir, run_dir=run_dir,
                kimg=kimg)

    def sample_fn(state, grid_z, grid_c):
        outs = []
        with torch.no_grad():
            for i in range(0, len(grid_z), opts.batch):
                z = torch.from_numpy(grid_z[i:i + opts.batch]).to(device)
                cl = torch.from_numpy(grid_c[i:i + opts.batch]).to(device) if c_dim else None
                img = state.G_ema(z, cl, noise_mode="const")
                outs.append(img.permute(0, 2, 3, 1).float().cpu().numpy())
        return np.concatenate(outs)

    try:
        return training_loop(
            run_dir=run_dir, stepper=stepper, state=state, loader=loader, device=device,
            total_kimg=c["total_kimg"], kimg_per_tick=c["kimg_per_tick"],
            snapshot_ticks=c["snapshot_ticks"], image_snapshot_ticks=c["snapshot_ticks"],
            sample_fn=sample_fn, metrics=c["metrics"], metric_fn=metric_fn,
            metric_snapshot_every=opts.metric_snap, metric_async=opts.metric_async)
    finally:
        loader.close()


if __name__ == "__main__":
    main(sys.argv[1:])
