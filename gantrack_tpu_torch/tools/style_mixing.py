"""Style-mixing grids from a checkpoint of the port.

    python -m gantrack_tpu_torch.tools.style_mixing --network=<run dir> \\
        --rows=0-2 --cols=3-5 --outdir=out --cbase=16384 --cmax=512 --map-depth=2

Port of ``gantrack_tpu/tools/style_mixing.py``: rows take the coarse
styles of the row seeds, columns give the ``--col-styles`` layers of the
column seeds; the first row and column show the sources.  The latents
are ``np.random.RandomState(seed).randn(z_dim)``, as in the JAX tool, so
a seed's latent is the same in both packages.  One grayscale (or RGB)
PNG, or one a modality for 2-channel data.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .gen_images import (add_network_args, load_generator, parse_range, pick_device,
                         save_modalities, to_uint8)


def mixing_grid(G, row_seeds: Sequence[int], col_seeds: Sequence[int],
                col_styles: Sequence[int], truncation_psi: float = 1.0,
                device=torch.device("cpu")) -> np.ndarray:
    """The ``[(rows + 1)·H, (cols + 1)·W, C]`` uint8 grid."""
    all_seeds = list(dict.fromkeys(list(row_seeds) + list(col_seeds)))
    zs = np.stack([np.random.RandomState(s).randn(G.z_dim) for s in all_seeds])
    with torch.no_grad():
        ws = G.mapping(torch.from_numpy(zs.astype(np.float32)).to(device), None,
                       truncation_psi=truncation_psi)
        w_by_seed: Dict[int, torch.Tensor] = {seed: ws[i] for i, seed in enumerate(all_seeds)}

        def render(w):
            return to_uint8(G.synthesis(w[None], noise_mode="const"))[0]

        h = w_img = G.img_resolution
        canvas = np.zeros(((len(row_seeds) + 1) * h, (len(col_seeds) + 1) * w_img,
                           G.img_channels), np.uint8)
        for j, cs in enumerate(col_seeds):
            canvas[0:h, (j + 1) * w_img:(j + 2) * w_img] = render(w_by_seed[cs])
        for i, rs in enumerate(row_seeds):
            canvas[(i + 1) * h:(i + 2) * h, 0:w_img] = render(w_by_seed[rs])
            for j, cs in enumerate(col_seeds):
                w = w_by_seed[rs].clone()
                w[list(col_styles)] = w_by_seed[cs][list(col_styles)]
                canvas[(i + 1) * h:(i + 2) * h, (j + 1) * w_img:(j + 2) * w_img] = render(w)
    return canvas


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gantrack_tpu_torch.tools.style_mixing",
                                description="Generate a style-mixing grid from a checkpoint.")
    add_network_args(p)
    p.add_argument("--rows", dest="row_seeds", type=parse_range, required=True)
    p.add_argument("--cols", dest="col_seeds", type=parse_range, required=True)
    p.add_argument("--col-styles", dest="col_styles", type=parse_range, default="0-6",
                   help="w indices taken from column seeds")
    p.add_argument("--trunc", dest="truncation_psi", type=float, default=1.0)
    p.add_argument("--outdir", required=True)
    return p


def main(argv: Optional[List[str]] = None) -> List[str]:
    opts = build_parser().parse_args(argv)
    device = pick_device(opts.device)
    G = load_generator(opts, device)
    os.makedirs(opts.outdir, exist_ok=True)
    grid = mixing_grid(G, opts.row_seeds, opts.col_seeds, opts.col_styles, opts.truncation_psi,
                       device)
    paths = save_modalities(grid, os.path.join(opts.outdir, "style_mixing_grid"))
    print(f"Wrote {', '.join(paths)}")
    return paths


if __name__ == "__main__":
    main(sys.argv[1:])
