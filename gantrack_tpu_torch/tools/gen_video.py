"""Latent interpolation videos from a checkpoint of the port.

    python -m gantrack_tpu_torch.tools.gen_video --network=<run dir> --seeds=0-7 \\
        --grid=2x2 --w-frames=30 --output=frames/ --cbase=16384 --cmax=512 --map-depth=2

Port of ``gantrack_tpu/tools/gen_video.py``: a grid of seeds, each cell
looping through its keyframes' ws along a periodic cubic spline (linear
below four knots), latents ``np.random.RandomState(seed).randn(z_dim)``
as in the JAX tool.  Frames go to a directory of PNGs through the port's
writer (one a modality for 2-channel data); an ``--output`` ending in
``.gif`` imports ``imageio`` for it, only then.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from .gen_images import (add_network_args, load_generator, parse_range, pick_device,
                         save_modalities, to_uint8)


def render_frames(G, seeds: Sequence[int], grid_dims=(2, 2), num_keyframes: Optional[int] = None,
                  w_frames: int = 30, truncation_psi: float = 1.0,
                  device=torch.device("cpu")) -> List[np.ndarray]:
    """The frames, ``[gh·H, gw·W, C]`` uint8."""
    import scipy.interpolate

    gw, gh = grid_dims
    if num_keyframes is None:
        num_keyframes = len(seeds) // (gw * gh)
    assert num_keyframes >= 1, "need at least grid-size seeds"
    zs = np.stack([np.random.RandomState(seed).randn(G.z_dim)
                   for seed in seeds[:gw * gh * num_keyframes]])
    with torch.no_grad():
        ws = G.mapping(torch.from_numpy(zs.astype(np.float32)).to(device), None,
                       truncation_psi=truncation_psi).cpu().numpy()
    ws = ws.reshape(gh, gw, num_keyframes, *ws.shape[1:])

    interps = {}
    for yi in range(gh):
        for xi in range(gw):
            w = ws[yi, xi]
            loop = np.concatenate([w, w[:1]])
            x = np.arange(len(loop))
            kind = "cubic" if len(loop) >= 4 else "linear"  # cubic needs >= 4 knots
            interps[(yi, xi)] = scipy.interpolate.interp1d(x, loop, kind=kind, axis=0)

    frames = []
    with torch.no_grad():
        for fi in range(num_keyframes * w_frames):
            t = fi / w_frames
            rows = []
            for yi in range(gh):
                cells = [np.asarray(interps[(yi, xi)](t % num_keyframes), np.float32)
                         for xi in range(gw)]
                img = G.synthesis(torch.from_numpy(np.stack(cells)).to(device), noise_mode="const")
                rows.append(np.concatenate(list(to_uint8(img)), axis=1))
            frames.append(np.concatenate(rows, axis=0))
    return frames


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gantrack_tpu_torch.tools.gen_video",
                                description="Render a latent-interpolation video grid.")
    add_network_args(p)
    p.add_argument("--seeds", type=parse_range, required=True)
    p.add_argument("--grid", dest="grid_dims", default="2x2", help="WxH seed grid")
    p.add_argument("--num-keyframes", dest="num_keyframes", type=int, default=None)
    p.add_argument("--w-frames", dest="w_frames", type=int, default=30,
                   help="frames per keyframe transition")
    p.add_argument("--trunc", dest="truncation_psi", type=float, default=1.0)
    p.add_argument("--output", required=True, help="output dir (frames) or .gif path")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    opts = build_parser().parse_args(argv)
    device = pick_device(opts.device)
    G = load_generator(opts, device)
    gw, gh = (int(v) for v in opts.grid_dims.split("x"))
    frames = render_frames(G, opts.seeds, (gw, gh), opts.num_keyframes, opts.w_frames,
                           opts.truncation_psi, device)
    if opts.output.endswith(".gif"):
        import imageio

        imageio.mimsave(opts.output, [f[..., 0] if f.shape[2] == 1 else f for f in frames],
                        fps=30)
        print(f"wrote {opts.output} ({len(frames)} frames)")
    else:
        os.makedirs(opts.output, exist_ok=True)
        for i, fr in enumerate(frames):
            save_modalities(fr, os.path.join(opts.output, f"frame{i:05d}"))
        print(f"wrote {len(frames)} frames to {opts.output}")
    return len(frames)


if __name__ == "__main__":
    main(sys.argv[1:])
