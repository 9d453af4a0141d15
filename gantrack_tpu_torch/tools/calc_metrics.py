"""Quality metrics of a trained generator (FID, KID, precision/recall, IS).

    python -m gantrack_tpu_torch.tools.calc_metrics --network=<run dir, state-*.pt or *.pkl> \\
        --metrics=fid10k,kid10k --data=<dataset dir> --cbase=16384 --cmax=512 --map-depth=2

Same flag names as ``gantrack_tpu/tools/calc_metrics.py`` (``argparse``
here), without its ``--resolution`` and ``--channels``, which nothing
reads: the dataset gives both.  Loads G_ema (the generator of ``--cfg``:
stylegan2, stylegan3-t or stylegan3-r) from a checkpoint of the port (a
``state-*.pt`` file, or the latest one of a run directory) or from a
NVIDIA ``network-snapshot-*.pkl``, whose architecture comes from the
pickle (the flags given are checked against it), evaluates every metric
for every modality of 2-channel data, and appends
``metric-<mode>-<metric>.jsonl`` rows to the run directory (beside a
pickle: its directory).  Runs on the CUDA device; ``--device=cpu``
runs on the CPU instead.  Without ``--detector-weights`` (a converted
InceptionV3 ``.npz``, a URL or ``file://`` path) the detector is the
random projection, whose FID is only comparable with itself.
``ppl2_wend`` is refused here, as the JAX CLI fails on it (it hands the
metrics no mapping); ``tools.train`` evaluates it.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from .train import _bool, make_generator, metric_batch


def evaluate_metrics(G_ema, metrics: Sequence[str], dataset, detector, device: torch.device,
                     batch_size: int, modalities: Optional[Sequence[str]] = None,
                     cache_dir: Optional[str] = None, run_dir: Optional[str] = None,
                     kimg: Optional[int] = None, snapshot_path: Optional[str] = None,
                     mesh=None) -> dict:
    """Run and report ``metrics`` of ``G_ema`` for each modality (one pass
    for 1- or 3-channel data, one per channel of 2-channel data); returns
    ``{name: value}``, names prefixed with the modality.  The metrics get
    G_ema's mapping and synthesis apart (w-space PPL), as the JAX training
    loop hands them.  ``mesh`` (``parallel.mesh``) splits the feature
    passes over its ranks; every rank must call, and only rank 0 writes
    the rows."""
    from ..metrics import MetricOptions, calc_metric, report_metric

    def generator(z, c):
        return G_ema(z, c, noise_mode="const")

    def mapping(z, c):
        return G_ema.mapping(z, c)

    def synthesis(ws):
        return G_ema.synthesis(ws, noise_mode="const")

    # The equivariance metrics synthesise with a user transform set on
    # StyleGAN3's input, and put the trained one back afterwards.
    generator_with_transform = None
    sg3_input = getattr(G_ema.synthesis, "input", None)
    if sg3_input is not None:
        def generator_with_transform(z, c, transform_3x3):
            saved = sg3_input.transform.clone()
            sg3_input.transform.copy_(torch.from_numpy(
                np.linalg.inv(transform_3x3).astype(np.float32)))
            try:
                return G_ema(z, c)
            finally:
                sg3_input.transform.copy_(saved)

    modes = ([(None, None)] if dataset.num_channels != 2
             else list((m, i) for i, m in enumerate(modalities or ["mode0", "mode1"])))
    results = {}
    for mode_name, mode_idx in modes:
        opts = MetricOptions(generator=generator,
                             generator_with_transform=generator_with_transform,
                             mapping=mapping, synthesis=synthesis,
                             z_dim=G_ema.z_dim, c_dim=G_ema.c_dim,
                             dataset=dataset, detector=detector, mode_idx=mode_idx,
                             batch_size=batch_size, cache_dir=cache_dir, device=device,
                             mesh=mesh)
        for m in metrics:
            rd = calc_metric(m, opts, mode_name=mode_name)
            if mesh is None or mesh.is_main:
                report_metric(rd, run_dir=run_dir, snapshot_path=snapshot_path, kimg=kimg)
            results.update({f"{mode_name or ''}{k}": v for k, v in rd["results"].items()})
    return results


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gantrack_tpu_torch.tools.calc_metrics",
                                description="Evaluate quality metrics of a trained checkpoint.")
    p.add_argument("--network", dest="checkpoint", required=True,
                   help="Checkpoint (state-*.pt), run dir or NVIDIA network-snapshot-*.pkl")
    p.add_argument("--metrics", default="fid10k", help="Comma-separated metric names")
    p.add_argument("--data", required=True, help="Dataset path (zip or shard dir)")
    p.add_argument("--split", default="train")
    p.add_argument("--modalities", default=None, help="Comma-separated (multimodal zips)")
    p.add_argument("--mirror", type=_bool, default=False)
    p.add_argument("--detector-weights", dest="detector_weights", default=None,
                   help="Converted InceptionV3 weights .npz (tools/convert_detector.py)")
    p.add_argument("--cache-dir", dest="cache_dir", default=None)
    p.add_argument("--cfg", choices=["stylegan2", "stylegan3-t", "stylegan3-r"], default=None,
                   help="Default stylegan2 (a pickle says it itself)")
    p.add_argument("--cbase", type=int, default=None, help="Default 32768")
    p.add_argument("--cmax", type=int, default=None, help="Default 512")
    p.add_argument("--map-depth", dest="map_depth", type=int, default=None)
    p.add_argument("--batch", type=int, default=None,
                   help="Extraction batch (default: resolution-scaled, 256 at <=256^2; "
                        "32 for StyleGAN3)")
    p.add_argument("--cond", type=_bool, default=False,
                   help="Conditional checkpoint: rebuild G with the dataset's label_dim")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Evaluate on the CUDA device (default) or on the CPU")
    return p


def _check_metrics(metric_list: Sequence[str], cfg: str) -> None:
    from ..metrics import check_metric

    for m in metric_list:
        try:
            check_metric(m)
        except ValueError as e:
            raise SystemExit(f"--metrics: {e}") from None
        if m.startswith("eq") and cfg == "stylegan2":
            raise SystemExit(f"--metrics: {m} needs a StyleGAN3 generator (--cfg=stylegan3-t|-r)")
        if m == "ppl2_wend":
            raise SystemExit("--metrics: ppl2_wend needs G's mapping and synthesis apart, which "
                             "calc_metrics does not hand over, as the JAX calc_metrics does not "
                             "(ROADMAP C9); the training loop evaluates it")


def main(argv: Optional[List[str]] = None) -> dict:
    """Parse ``argv`` and evaluate; returns ``{name: value}``."""
    from ..data import open_dataset
    from ..metrics import make_inception_detector
    from ..models.torch_compat import check_architecture, load_weights
    from ..precision import configure_device_numerics
    from ..utils.checkpoint import resolve_network

    opts = build_parser().parse_args(argv)
    device = configure_device_numerics(opts.device)
    metric_list = [m for m in opts.metrics.split(",") if m]
    pickled = opts.checkpoint.endswith((".pkl", ".pickle"))
    if not pickled:  # a pickle names its --cfg itself: checked once it is read
        _check_metrics(metric_list, opts.cfg or "stylegan2")
    modalities = opts.modalities.split(",") if opts.modalities else None
    kwargs = dict(split=opts.split, xflip=opts.mirror)
    if opts.data.endswith(".zip") and modalities:
        kwargs["modalities"] = modalities
    dataset = open_dataset(opts.data, **kwargs)
    c_dim = 0
    if opts.cond:
        if not dataset.has_labels:
            raise SystemExit("--cond requires a labelled dataset")
        c_dim = dataset.label_dim

    payload, path = resolve_network(opts.checkpoint)
    if payload is None:
        raise SystemExit(f"--network: no checkpoint found under {opts.checkpoint}")
    build = {}
    arch = payload.get("architecture")
    if arch is not None:  # a NVIDIA pickle: its architecture, checked against the flags
        try:
            check_architecture(arch, cfg=opts.cfg, cbase=opts.cbase, cmax=opts.cmax,
                               map_depth=opts.map_depth, resolution=dataset.resolution,
                               channels=dataset.num_channels, c_dim=c_dim if opts.cond else None)
        except ValueError as e:
            raise SystemExit(f"--network: {e}") from None
        opts.cfg, opts.cbase, opts.cmax, opts.map_depth = (
            arch["cfg"], arch["cbase"], arch["cmax"], arch["map_depth"])
        c_dim = arch["c_dim"]
        build = dict(z_dim=arch["z_dim"], w_dim=arch["w_dim"],
                     num_fp16_res=arch["num_fp16_res"], conv_clamp=arch["conv_clamp"],
                     num_layers=arch["num_layers"])
    opts.cfg = opts.cfg or "stylegan2"
    if pickled:
        _check_metrics(metric_list, opts.cfg)

    print(f"Loading {path}")
    G_ema = make_generator(
        opts.cfg, resolution=dataset.resolution, channels=dataset.num_channels, c_dim=c_dim,
        cbase=opts.cbase or 32768, cmax=opts.cmax or 512,
        map_depth=opts.map_depth or (8 if opts.cfg == "stylegan2" else 2), **build)
    load_weights(G_ema, payload["G_ema"], "G_ema")
    G_ema = G_ema.to(device).eval().requires_grad_(False)

    ckpt_dir = os.path.dirname(os.path.abspath(path))
    run_dir = os.path.dirname(ckpt_dir) if os.path.basename(ckpt_dir) == "checkpoints" else ckpt_dir
    detector = make_inception_detector(opts.detector_weights, device=device)
    return evaluate_metrics(
        G_ema, metric_list, dataset, detector, device,
        batch_size=opts.batch or metric_batch(opts.cfg, dataset.resolution),
        modalities=modalities,
        cache_dir=opts.cache_dir, run_dir=run_dir, snapshot_path=path)


if __name__ == "__main__":
    main(sys.argv[1:])
