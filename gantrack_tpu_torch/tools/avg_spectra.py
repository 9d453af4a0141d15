"""Average power spectra of real and generated images (alias detection).

    python -m gantrack_tpu_torch.tools.avg_spectra --network=<run dir> --data=<dataset> \\
        --num=256 --outdir=out --cbase=16384 --cmax=512 --map-depth=2

Port of ``gantrack_tpu/tools/avg_spectra.py``: the Kaiser-windowed mean
power spectrum of ``--num`` reals and ``--num`` fakes of G_ema and their
azimuthal averages, written to ``spectra.npz`` and then, where
matplotlib is installed, plotted to ``avg_spectra.png``.
:func:`compute_spectrum_batch` and :func:`azimuthal_average` are the
port's own copies of the JAX package's numpy functions
(``tests/test_torch_generation.py`` holds them equal).  The fakes' latents
come from a CPU ``torch.Generator`` seeded with the batch's first index
(JAX draws its own).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from .gen_images import add_network_args, load_generator, pick_device


def compute_spectrum_batch(images: np.ndarray, beta: float = 8.0) -> np.ndarray:
    """Mean 2D power spectrum of [N,H,W] images with a Kaiser window."""
    n, h, w = images.shape
    window = np.kaiser(h, beta)[:, None] * np.kaiser(w, beta)[None, :]
    window = window / np.sqrt(np.mean(np.square(window)))
    spec = np.zeros((h, w), np.float64)
    for img in images:
        f = np.fft.fftshift(np.fft.fft2(img * window))
        spec += np.square(np.abs(f)) / (h * w)
    return spec / n


def azimuthal_average(spectrum: np.ndarray, num_bins: Optional[int] = None):
    """Radially averaged 1-D spectrum."""
    h, w = spectrum.shape
    cy, cx = h // 2, w // 2
    y, x = np.indices((h, w))
    r = np.hypot(y - cy, x - cx)
    num_bins = num_bins or min(cy, cx)
    bins = np.clip((r / r[cy, 0] * num_bins).astype(int), 0, num_bins)
    sums = np.bincount(bins.ravel(), weights=spectrum.ravel(), minlength=num_bins + 1)
    counts = np.bincount(bins.ravel(), minlength=num_bins + 1)
    return sums[:num_bins] / np.maximum(counts[:num_bins], 1)


def generated_channel0(G, num: int, device, batch: int = 32) -> np.ndarray:
    """``[num, H, W]`` float64: the first channel of ``num`` G_ema images
    in [-1, 1]."""
    fakes = []
    with torch.no_grad():
        for i in range(0, num, batch):
            gen = torch.Generator().manual_seed(i)
            z = torch.randn((min(batch, num - i), G.z_dim), generator=gen).to(device)
            fakes.append(G(z, None, noise_mode="const")[:, 0].float().cpu().numpy())
    return np.concatenate(fakes).astype(np.float64)


def spectra(reals: np.ndarray, fakes: np.ndarray) -> dict:
    spec_real, spec_fake = compute_spectrum_batch(reals), compute_spectrum_batch(fakes)
    return dict(spec_real=spec_real, spec_fake=spec_fake, az_real=azimuthal_average(spec_real),
                az_fake=azimuthal_average(spec_fake))


def plot(result: dict, path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    axes[0].imshow(np.log10(result["spec_real"] + 1e-12), cmap="magma")
    axes[0].set_title("real")
    axes[1].imshow(np.log10(result["spec_fake"] + 1e-12), cmap="magma")
    axes[1].set_title("generated")
    axes[2].semilogy(result["az_real"], label="real")
    axes[2].semilogy(result["az_fake"], label="generated")
    axes[2].legend()
    axes[2].set_title("azimuthal average")
    fig.savefig(path, dpi=120, bbox_inches="tight")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gantrack_tpu_torch.tools.avg_spectra",
                                description="Compare real and generated average power spectra.")
    add_network_args(p)
    p.add_argument("--data", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--modalities", default=None)
    p.add_argument("--num", type=int, default=256, help="samples per side")
    p.add_argument("--outdir", required=True)
    return p


def main(argv: Optional[List[str]] = None) -> dict:
    from ..data import open_dataset

    opts = build_parser().parse_args(argv)
    device = pick_device(opts.device)
    os.makedirs(opts.outdir, exist_ok=True)
    kwargs = dict(split=opts.split)
    if opts.data.endswith(".zip") and opts.modalities:
        kwargs["modalities"] = opts.modalities.split(",")
    ds = open_dataset(opts.data, **kwargs)
    reals = np.stack([ds[i][0][..., 0] for i in range(min(opts.num, len(ds)))])
    reals = reals / 127.5 - 1
    opts.resolution, opts.channels = ds.resolution, ds.num_channels  # the dataset's, as in JAX
    G = load_generator(opts, device)
    result = spectra(reals, generated_channel0(G, opts.num, device))
    np.savez(os.path.join(opts.outdir, "spectra.npz"), **result)
    print(f"Wrote {opts.outdir}/spectra.npz")
    try:
        plot(result, os.path.join(opts.outdir, "avg_spectra.png"))
        print(f"Wrote {opts.outdir}/avg_spectra.png")
    except ImportError:
        print("matplotlib is not installed: no avg_spectra.png")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
