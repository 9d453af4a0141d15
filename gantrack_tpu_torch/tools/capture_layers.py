"""Per-layer activations of a generator, headless.

    python -m gantrack_tpu_torch.tools.capture_layers --network=<run dir> --seeds=0 \\
        [--layer=REGEX --outdir=acts --save-pngs] --cbase=16384 --cmax=512 --map-depth=2

Port of ``gantrack_tpu/tools/capture_layers.py``: without ``--layer``,
the table of the synthesis layers (name, H×W, channels, dtype) for one
seed; with it, the matching layers' activations of each seed to
``<outdir>/seed####/<layer>.npy`` as ``[H, W, C]`` float32 and, with
``--save-pngs``, channel-grid PNGs.  Activations are caught by forward
hooks on every module and named as the JAX tool names them (its Flax
``capture_intermediates`` paths): module path with ``/``, a module that
returns a tuple gives ``<path>/0``, ``<path>/1``, the whole generator is
``""``; only 4-D outputs are kept.  Seeds' latents are the port's
(``gen_images.seed_latent``).
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from .gen_images import (add_network_args, load_generator, parse_range, pick_device,
                         seed_latent)


def channel_grid(x: np.ndarray, max_channels: int = 64) -> np.ndarray:
    """[H, W, C] activations → uint8 grid image, per-channel max-abs
    normalised (the renderer's inf-norm scaling)."""
    h, w, c = x.shape
    c = min(c, max_channels)
    cols = int(np.ceil(np.sqrt(c)))
    rows = int(np.ceil(c / cols))
    grid = np.zeros((rows * h, cols * w), np.uint8)
    for i in range(c):
        ch = x[:, :, i]
        scale = np.max(np.abs(ch)) + 1e-8
        img = np.clip((ch / scale) * 127.5 + 127.5, 0, 255).astype(np.uint8)
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = img
    return grid


def capture(module: torch.nn.Module, fn) -> Dict[str, torch.Tensor]:
    """Run ``fn()`` with a forward hook on every module of ``module`` and
    return the 4-D outputs as NHWC tensors, keyed by the JAX names, in the
    order the modules returned them."""
    out: Dict[str, torch.Tensor] = {}
    hooks = []

    def hook_for(name):
        def hook(_mod, _inputs, output):
            outs = output if isinstance(output, (tuple, list)) else (output,)
            for i, t in enumerate(outs):
                key = "/".join(p for p in (name, str(i) if len(outs) > 1 else "") if p)
                if isinstance(t, torch.Tensor) and t.ndim == 4 and key not in out:
                    out[key] = t.detach().permute(0, 2, 3, 1)
        return hook

    for name, mod in module.named_modules():
        hooks.append(mod.register_forward_hook(hook_for(name.replace(".", "/"))))
    try:
        with torch.no_grad():
            fn()
    finally:
        for h in hooks:
            h.remove()
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gantrack_tpu_torch.tools.capture_layers",
                                description="List or dump per-layer generator activations.")
    add_network_args(p)
    p.add_argument("--seeds", type=parse_range, default=[0], help="e.g. 0-3")
    p.add_argument("--trunc", dest="truncation_psi", type=float, default=1.0)
    p.add_argument("--layer", dest="layer_regex", default=None,
                   help="Regex over layer names; omit to just list layers")
    p.add_argument("--outdir", default=None, help="Required with --layer")
    p.add_argument("--save-pngs", dest="save_pngs", action="store_true",
                   help="Also write channel-grid PNGs")
    p.add_argument("--max-channels", dest="max_channels", type=int, default=64)
    return p


def main(argv: Optional[List[str]] = None) -> Dict[int, List[str]]:
    """Returns the layers written for each seed (none when listing)."""
    from ..utils.checkpoint import save_png

    opts = build_parser().parse_args(argv)
    pattern = re.compile(opts.layer_regex) if opts.layer_regex else None
    if pattern and not opts.outdir:
        raise SystemExit("--outdir is required with --layer")
    device = pick_device(opts.device)
    G = load_generator(opts, device)
    written: Dict[int, List[str]] = {}
    for si, seed in enumerate(opts.seeds):
        z = seed_latent(seed, G.z_dim).to(device)
        layers = capture(G, lambda: G(z, None, truncation_psi=opts.truncation_psi,
                                      noise_mode="const"))
        if pattern is None:
            if si == 0:
                print(f"{'layer':<48} {'HxW':>12} {'ch':>6} dtype")
                for name, arr in layers.items():
                    print(f"{name:<48} {arr.shape[1]}x{arr.shape[2]:<9} "
                          f"{arr.shape[3]:>6} {str(arr.dtype).replace('torch.', '')}")
            continue
        hits = [n for n in layers if pattern.search(n)]
        if not hits:
            raise SystemExit(f"--layer {opts.layer_regex!r} matched nothing; run without "
                             "--layer to list names")
        seed_dir = os.path.join(opts.outdir, f"seed{seed:04d}")
        os.makedirs(seed_dir, exist_ok=True)
        for name in hits:
            arr = layers[name][0].float().cpu().numpy()  # [H, W, C]; bf16 → f32
            fname = name.replace("/", "_")
            np.save(os.path.join(seed_dir, f"{fname}.npy"), arr)
            if opts.save_pngs:
                save_png(os.path.join(seed_dir, f"{fname}.png"),
                         channel_grid(arr, opts.max_channels))
        written[seed] = hits
        print(f"seed {seed}: wrote {len(hits)} layer dumps to {seed_dir}")
    return written


if __name__ == "__main__":
    main(sys.argv[1:])
