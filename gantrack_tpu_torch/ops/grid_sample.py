"""Bilinear grid sampling (zeros padding, align_corners=False), gather form.

Port of ``gantrack_tpu/ops/grid_sample.py``.  The sampler is written
with ``torch.gather``, so autograd differentiates it to any order; it
does not depend on whether ``F.grid_sample`` is twice differentiable in
the installed PyTorch.  Coordinate math runs in float32.

Layout: input NCHW; grid ``[N, H_out, W_out, 2]`` with ``grid[..., 0]``
the normalised x and ``grid[..., 1]`` the normalised y coordinate.

:func:`warp_coefficients` and :func:`sample_positions` are the affine
case in pixel space: six coefficients a sample instead of a grid, the
form the warp kernels (:mod:`.warp`, :mod:`.upwarp`) take, rounded as
they round it.
"""

from __future__ import annotations

import torch

__all__ = ["grid_sample", "affine_grid", "bilinear_gather", "warp_coefficients",
           "sample_positions"]


def bilinear_gather(x: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Sample ``x [N, C, H, W]`` at pixel coordinates ``fx, fy [N, Ho, Wo]``
    (pixel centres at integers); out-of-bounds taps contribute zero."""
    n, c, h, w = x.shape
    dt = x.dtype
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx = (fx - x0).to(dt)[:, None]
    wy = (fy - y0).to(dt)[:, None]
    x0 = x0.long()
    y0 = y0.long()
    flat = x.reshape(n, c, h * w)

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)  # [N, Ho, Wo]
        vals = torch.gather(flat, 2, idx.reshape(n, 1, -1).expand(n, c, -1))
        return vals.reshape(n, c, *idx.shape[1:]) * valid[:, None].to(dt)

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample ``x [N, C, H, W]`` at normalised ``grid [N, Ho, Wo, 2]``."""
    assert x.ndim == 4 and grid.ndim == 4 and grid.shape[-1] == 2
    h, w = x.shape[2], x.shape[3]
    gx = grid[..., 0].float()
    gy = grid[..., 1].float()
    # align_corners=False: -1 maps to -0.5, +1 maps to size - 0.5.
    fx = ((gx + 1.0) * w - 1.0) * 0.5
    fy = ((gy + 1.0) * h - 1.0) * 0.5
    return bilinear_gather(x, fx, fy)


def affine_grid(theta: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``F.affine_grid(theta, [N, C, height, width], align_corners=False)``:
    normalised output coordinates mapped through ``theta [N, 2, 3]``."""
    assert theta.ndim == 3 and theta.shape[1:] == (2, 3)
    dev = theta.device
    ys = (torch.arange(height, dtype=torch.float32, device=dev) * 2 + 1) / height - 1
    xs = (torch.arange(width, dtype=torch.float32, device=dev) * 2 + 1) / width - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    coords = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # [H, W, 3]
    return torch.einsum("nij,hwj->nhwi", theta.float(), coords)


def warp_coefficients(theta: torch.Tensor, h2: int, w2: int, out_h: int, out_w: int) -> torch.Tensor:
    """``[N, 6]`` float32 pixel-space coefficients ``(ax, bx, cx, ay, by, cy)``
    of the normalised inverse transform ``theta [N, 2, 3]`` for an
    ``h2 × w2`` input and an ``out_h × out_w`` output (align_corners=False)."""
    t = theta.float()
    ax = t[:, 0, 0] * (w2 / out_w)
    bx = t[:, 0, 1] * (w2 / out_h)
    cx = (w2 / 2) * (t[:, 0, 0] * (1 / out_w - 1) + t[:, 0, 1] * (1 / out_h - 1)
                     + t[:, 0, 2] + 1) - 0.5
    ay = t[:, 1, 0] * (h2 / out_w)
    by = t[:, 1, 1] * (h2 / out_h)
    cy = (h2 / 2) * (t[:, 1, 0] * (1 / out_w - 1) + t[:, 1, 1] * (1 / out_h - 1)
                     + t[:, 1, 2] + 1) - 0.5
    return torch.stack([ax, bx, cx, ay, by, cy], dim=1).contiguous()


def sample_positions(coeffs: torch.Tensor, out_h: int, out_w: int):
    """Source positions ``fx, fy [N, out_h, out_w]``, rounded as the kernel
    rounds them: ``(a*ox + b*oy) + c``."""
    dev = coeffs.device
    ox = torch.arange(out_w, dtype=torch.float32, device=dev)[None, None, :]
    oy = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :, None]
    c = coeffs[:, :, None, None]
    fx = (c[:, 0] * ox + c[:, 1] * oy) + c[:, 2]
    fy = (c[:, 3] * ox + c[:, 4] * oy) + c[:, 5]
    return fx, fy
