"""Generate images from a checkpoint of the port.

    python -m gantrack_tpu_torch.tools.gen_images --network=<run dir, state-*.pt or *.pkl> \\
        --seeds=0-31 --trunc=0.7 --outdir=out --cbase=16384 --cmax=512 --map-depth=2

Port of ``gantrack_tpu/tools/gen_images.py`` (``argparse`` here):
seed-driven sampling from G_ema with truncation ψ and cutoff, a class
label for a conditional generator, StyleGAN3's input translation and
rotation (``--translate``, ``--rotate``), one grayscale PNG a seed (one
a modality for 2-channel data, RGB for 3).  Runs on the CUDA device;
``--device=cpu`` runs on the CPU.

The latent of a seed is the port's own: ``torch.randn`` from a CPU
``torch.Generator`` seeded with the seed (:func:`seed_latent`), so a
seed gives the same image on the CPU and on the card; the JAX package
draws it with ``jax.random``, so the images of a seed differ between the
two packages.

This module also holds what the other generation tools share: the
``--network`` / architecture flags (:func:`add_network_args`), loading
G_ema (:func:`load_generator`) from a checkpoint of the port or from a
NVIDIA ``network-snapshot-*.pkl`` (whose architecture comes from the
pickle) and the uint8 conversion.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch


def parse_range(s) -> List[int]:
    """'1,2,5-10' → [1, 2, 5, ..., 10]."""
    if isinstance(s, list):
        return s
    ranges = []
    for p in s.split(","):
        if m := re.match(r"^(\d+)-(\d+)$", p):
            ranges.extend(range(int(m.group(1)), int(m.group(2)) + 1))
        else:
            ranges.append(int(p))
    return ranges


def parse_vec2(s):
    if isinstance(s, tuple):
        return s
    parts = s.split(",")
    return (float(parts[0]), float(parts[1]))


def make_transform(translate, angle):
    """The user transform of StyleGAN3's input for a translation and a
    rotation in degrees (its inverse goes into ``SynthesisInput.transform``)."""
    m = np.eye(3)
    s = np.sin(angle / 360 * np.pi * 2)
    c = np.cos(angle / 360 * np.pi * 2)
    m[0][0] = c
    m[0][1] = s
    m[0][2] = translate[0]
    m[1][0] = -s
    m[1][1] = c
    m[1][2] = translate[1]
    return m


def seed_latent(seed: int, z_dim: int) -> torch.Tensor:
    """``[1, z_dim]`` latent of ``seed`` (CPU float32)."""
    return torch.randn((1, z_dim), generator=torch.Generator().manual_seed(int(seed)))


def to_uint8(img: torch.Tensor) -> np.ndarray:
    """``[N, C, H, W]`` in [-1, 1] → ``[N, H, W, C]`` uint8, truncated as
    the JAX tools truncate."""
    img = img.detach().float().permute(0, 2, 3, 1).cpu().numpy()
    return np.clip((img + 1) * 127.5, 0, 255).astype(np.uint8)


def save_modalities(img: np.ndarray, stem: str) -> List[str]:
    """``[H, W, C]`` uint8 → ``<stem>.png`` (gray or RGB), or one
    ``<stem>_mode<i>.png`` a modality of 2-channel data; returns the paths."""
    from ..utils.checkpoint import save_png

    if img.shape[2] == 2:
        paths = [f"{stem}_mode{ci}.png" for ci in range(2)]
        for ci, path in enumerate(paths):
            save_png(path, img[:, :, ci])
        return paths
    save_png(f"{stem}.png", img[:, :, 0] if img.shape[2] == 1 else img)
    return [f"{stem}.png"]


# The architecture flags' values where neither the flags nor a pickle say.
NETWORK_DEFAULTS = dict(resolution=256, channels=1, cfg="stylegan2", cbase=32768, cmax=512,
                        z_dim=512, w_dim=512)


def add_network_args(p: argparse.ArgumentParser) -> None:
    """The flags that say which generator a checkpoint holds (a NVIDIA
    pickle says it itself: the flags given are checked against it)."""
    p.add_argument("--network", dest="checkpoint", required=True,
                   help="Checkpoint (state-*.pt), run dir or NVIDIA network-snapshot-*.pkl")
    p.add_argument("--resolution", type=int, default=None, help="Default 256")
    p.add_argument("--channels", type=int, default=None, help="Default 1")
    p.add_argument("--cfg", choices=["stylegan2", "stylegan3-t", "stylegan3-r"], default=None,
                   help="Default stylegan2")
    p.add_argument("--cbase", type=int, default=None, help="Default 32768")
    p.add_argument("--cmax", type=int, default=None, help="Default 512")
    p.add_argument("--map-depth", dest="map_depth", type=int, default=None,
                   help="Default 8 for stylegan2, 2 for StyleGAN3")
    p.add_argument("--z-dim", dest="z_dim", type=int, default=None, help="Default 512")
    p.add_argument("--w-dim", dest="w_dim", type=int, default=None, help="Default 512")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Run on the CUDA device (default) or on the CPU")


def pick_device(name: str) -> torch.device:
    """The device of ``--device``, with the port's numerics set on it."""
    from ..precision import configure_device_numerics

    return configure_device_numerics(name)


def resolve_architecture(opts, payload: dict) -> dict:
    """Fill ``opts``' architecture flags: from the pickle's architecture
    where ``payload`` holds one (the flags given must agree with it), else
    from the defaults; returns the generator's build arguments."""
    from ..models.torch_compat import check_architecture

    names = ("cfg", "cbase", "cmax", "map_depth", "resolution", "channels", "z_dim", "w_dim")
    arch = payload.get("architecture")
    if arch is not None:
        try:
            check_architecture(arch, **{k: getattr(opts, k) for k in names})
        except ValueError as e:
            raise SystemExit(f"--network: {e}") from None
        for k in names:
            setattr(opts, k, arch[k])
        return dict(c_dim=arch["c_dim"], num_fp16_res=arch["num_fp16_res"],
                    conv_clamp=arch["conv_clamp"], num_layers=arch["num_layers"])
    for k, v in NETWORK_DEFAULTS.items():
        if getattr(opts, k) is None:
            setattr(opts, k, v)
    if opts.map_depth is None:
        opts.map_depth = 8 if opts.cfg == "stylegan2" else 2
    sd = payload["G_ema"]
    return dict(c_dim=sd["mapping.embed.weight"].shape[1] if "mapping.embed.weight" in sd else 0)


def load_generator(opts, device: torch.device):
    """G_ema of the checkpoint or NVIDIA pickle ``opts.checkpoint`` names
    (``utils.checkpoint.resolve_network``), on ``device``, in eval mode
    without gradients.  A checkpoint's generator is built from the
    architecture flags (the label size read from the checkpoint), a
    pickle's from the pickle (:func:`resolve_architecture`)."""
    from ..models.torch_compat import load_weights
    from ..utils.checkpoint import resolve_network
    from .train import make_generator

    payload, path = resolve_network(opts.checkpoint)
    if payload is None:
        raise SystemExit(f"--network: no checkpoint found under {opts.checkpoint}")
    print(f"Loading {path}")
    build = resolve_architecture(opts, payload)
    G = make_generator(opts.cfg, resolution=opts.resolution, channels=opts.channels,
                       cbase=opts.cbase, cmax=opts.cmax, map_depth=opts.map_depth,
                       z_dim=opts.z_dim, w_dim=opts.w_dim, **build)
    load_weights(G, payload["G_ema"], "G_ema")
    return G.to(device).eval().requires_grad_(False)


def set_input_transform(G, translate=(0.0, 0.0), rotate: float = 0.0) -> bool:
    """Put the inverse of ``make_transform(translate, rotate)`` into
    StyleGAN3's input; False (nothing done) for a generator without one."""
    sg3_input = getattr(G.synthesis, "input", None)
    if sg3_input is None:
        return False
    m = np.linalg.inv(make_transform(translate, rotate)).astype(np.float32)
    sg3_input.transform.copy_(torch.from_numpy(m))
    return True


def class_label(G, class_idx: Optional[int], device) -> Optional[torch.Tensor]:
    if G.c_dim == 0:
        if class_idx is not None:
            print("warn: --class ignored when running an unconditional network")
        return None
    if class_idx is None:
        raise SystemExit("--class: the network is conditional; give a class label")
    c = torch.zeros((1, G.c_dim), device=device)
    c[:, class_idx] = 1
    return c


def generate(G, seeds: Sequence[int], outdir: str, truncation_psi: float = 1.0,
             truncation_cutoff: Optional[int] = None, c: Optional[torch.Tensor] = None,
             device=torch.device("cpu")) -> List[str]:
    """One image a seed into ``outdir``; returns the files written."""
    os.makedirs(outdir, exist_ok=True)
    paths = []
    with torch.no_grad():
        for seed in seeds:
            z = seed_latent(seed, G.z_dim).to(device)
            img = G(z, c, truncation_psi=truncation_psi, truncation_cutoff=truncation_cutoff,
                    noise_mode="const")
            paths += save_modalities(to_uint8(img)[0], os.path.join(outdir, f"seed{seed:04d}"))
    return paths


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gantrack_tpu_torch.tools.gen_images",
                                description="Render seed images from the EMA generator.")
    add_network_args(p)
    p.add_argument("--seeds", type=parse_range, required=True, help="e.g. 0-31")
    p.add_argument("--trunc", dest="truncation_psi", type=float, default=1.0)
    p.add_argument("--trunc-cutoff", dest="trunc_cutoff", type=int, default=None)
    p.add_argument("--class", dest="class_idx", type=int, default=None)
    p.add_argument("--translate", type=parse_vec2, default="0,0")
    p.add_argument("--rotate", type=float, default=0.0)
    p.add_argument("--outdir", required=True)
    return p


def main(argv: Optional[List[str]] = None) -> List[str]:
    opts = build_parser().parse_args(argv)
    device = pick_device(opts.device)
    G = load_generator(opts, device)
    if opts.rotate != 0 or opts.translate != (0, 0):
        if not set_input_transform(G, opts.translate, opts.rotate):
            print("warn: --translate/--rotate need a StyleGAN3 generator; ignored")
    c = class_label(G, opts.class_idx, device)
    paths = generate(G, opts.seeds, opts.outdir, opts.truncation_psi, opts.trunc_cutoff, c,
                     device)
    print(f"Wrote {len(opts.seeds)} images to {opts.outdir}")
    return paths


if __name__ == "__main__":
    main(sys.argv[1:])
