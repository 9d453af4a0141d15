"""Seeded synthetic slices, made on the card in bulk.

Single-channel 256² slices in 0..255: a smooth bright blob (position,
radius drawn per slice) over Gaussian noise, the same family of images
the program's chip checks train on.  Stand-ins for claro's CT slices,
which are not public.
"""

from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, k: int) -> int:
    """The seed of the ``k``-th stream drawn from the run's ``--seed``."""
    return int(np.random.SeedSequence([seed % (1 << 63), k]).generate_state(1, np.uint64)[0]) >> 1


def make_slices(seed: int, count: int, res: int, device, chunk: int = 128) -> np.ndarray:
    """``[count, res, res, 1]`` float32 slices on the host."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    yy, xx = torch.meshgrid(torch.arange(res, device=device, dtype=torch.float32),
                            torch.arange(res, device=device, dtype=torch.float32), indexing="ij")
    out = np.empty((count, res, res, 1), np.float32)
    for i in range(0, count, chunk):
        n = min(chunk, count - i)
        u = torch.rand((n, 3), generator=gen, device=device)
        cx, cy = (u[:, 0] * 0.5 + 0.25) * res, (u[:, 1] * 0.5 + 0.25) * res
        r = (u[:, 2] * 0.19 + 0.08) * res
        d2 = (xx - cx[:, None, None]) ** 2 + (yy - cy[:, None, None]) ** 2
        img = 200 * torch.exp(-d2 / (2 * r[:, None, None] ** 2))
        img = img + 8 * torch.randn((n, res, res), generator=gen, device=device)
        out[i:i + n, :, :, 0] = img.clamp(0, 255).cpu().numpy()
    return out
