"""Plain float32 ADA augmentation: the pixel-blitting and general
geometric sections (Karras et al. 2020, appendix B; NVIDIA's
``augment.py``).

Each sample draws its transforms from the caller's generator, gated by
``p``, in the order of the published pipeline (xflip, rotate90, integer
translation, isotropic scale, pre-rotation, anisotropic scale,
post-rotation with ``P(pre or post) = p``, fractional translation).  The
image is reflect-padded by a static margin, upsampled ×2 with the sym6
wavelet, sampled bilinearly through the inverse transform, and filtered
back down ×2.  The margin is the conservative Monte-Carlo bound of the
program's JAX origin (4096 transforms at p = 1 from a fixed seed, the
corners' largest excursion plus the wavelet's halo).  The colour,
filtering, noise and cutout sections are not written here; a
configuration that turns one on raises.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .numerics import Numerics
from .ops import downsample2d, upsample2d

SYM6 = [0.015404109327027373, 0.0034907120842174702, -0.11799011114819057, -0.048311742585633,
        0.4910559419267466, 0.787641141030194, 0.3379294217276218, -0.07263752278646252,
        -0.021060292512300564, 0.04472490177066578, 0.0017677118642428036,
        -0.007800708325034148]
GEOMETRIC = ("xflip", "rotate90", "xint", "scale", "rotate", "aniso", "xfrac")


def _m3(n, device, entries) -> torch.Tensor:
    m = torch.eye(3, device=device).expand(n, 3, 3).clone()
    for (i, j), v in entries.items():
        m[:, i, j] = v
    return m


def translate(tx, ty):
    return _m3(tx.shape[0], tx.device, {(0, 2): tx, (1, 2): ty})


def scale(sx, sy):
    return _m3(sx.shape[0], sx.device, {(0, 0): sx, (1, 1): sy})


def rotate(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    return _m3(theta.shape[0], theta.device, {(0, 0): c, (0, 1): -s, (1, 0): s, (1, 1): c})


def static_margin(opts: dict, height: int, width: int, samples: int = 4096,
                  seed: int = 0) -> Tuple[int, int, int, int]:
    """``(mx0, mx1, my0, my1)``: reflect padding that covers every
    transform of ``samples`` drawn at p = 1."""
    rng = np.random.default_rng(seed)
    n = samples

    def m(entries):
        out = np.broadcast_to(np.eye(3), (n, 3, 3)).copy()
        for (i, j), v in entries.items():
            out[:, i, j] = v
        return out

    def rot(t):
        return m({(0, 0): np.cos(t), (0, 1): -np.sin(t), (1, 0): np.sin(t), (1, 1): np.cos(t)})

    g = m({})
    if opts.get("xflip", 0) > 0:
        g = g @ m({(0, 0): 1 / (1 - 2 * rng.integers(0, 2, n))})
    if opts.get("rotate90", 0) > 0:
        g = g @ rot(np.pi / 2 * rng.integers(0, 4, n))
    if opts.get("xint", 0) > 0:
        t = (rng.random((n, 2)) * 2 - 1) * opts["xint_max"]
        g = g @ m({(0, 2): -np.round(t[:, 0] * width), (1, 2): -np.round(t[:, 1] * height)})
    if opts.get("scale", 0) > 0:
        s = np.exp2(np.clip(rng.standard_normal(n), -4.5, 4.5) * opts["scale_std"])
        s = np.concatenate([s, [2 ** (4.5 * opts["scale_std"]),
                                2 ** (-4.5 * opts["scale_std"])] * (n // 2)])[:n]
        g = g @ m({(0, 0): 1 / s, (1, 1): 1 / s})
    if opts.get("rotate", 0) > 0:
        g = g @ rot((rng.random(n) * 2 - 1) * np.pi * opts["rotate_max"])
    if opts.get("aniso", 0) > 0:
        s = np.exp2(np.clip(rng.standard_normal(n), -4.5, 4.5) * opts["aniso_std"])
        g = g @ m({(0, 0): 1 / s, (1, 1): s})
    if opts.get("rotate", 0) > 0:
        g = g @ rot((rng.random(n) * 2 - 1) * np.pi * opts["rotate_max"])
    if opts.get("xfrac", 0) > 0:
        t = np.clip(rng.standard_normal((n, 2)), -4.5, 4.5) * opts["xfrac_std"]
        g = g @ m({(0, 2): -t[:, 0] * width, (1, 2): -t[:, 1] * height})
    cx, cy = (width - 1) / 2, (height - 1) / 2
    corners = np.asarray([[-cx, -cy, 1], [cx, -cy, 1], [cx, cy, 1], [-cx, cy, 1]]).T
    xy = (g @ corners)[:, :2, :]
    pad = len(SYM6) // 4
    margin = np.stack([(-xy[:, 0]).max(), (-xy[:, 1]).max(), xy[:, 0].max(), xy[:, 1].max()])
    margin = np.clip(margin + np.asarray([pad * 2 - cx, pad * 2 - cy] * 2), 0,
                     [width - 1, height - 1, width - 1, height - 1])
    mx0, my0, mx1, my1 = np.ceil(margin).astype(int)
    return int(mx0), int(mx1), int(my0), int(my1)


def _reflect(x, t, b, l, r):
    parts = ([x[:, :, 1:t + 1].flip(2)] if t else []) + [x] + ([x[:, :, -b - 1:-1].flip(2)] if b else [])
    x = torch.cat(parts, dim=2)
    parts = ([x[:, :, :, 1:l + 1].flip(3)] if l else []) + [x] + ([x[:, :, :, -r - 1:-1].flip(3)] if r else [])
    return torch.cat(parts, dim=3)


def _bilinear(x, fx, fy):
    """Sample ``x`` at pixel coordinates (centres on integers), zeros outside."""
    n, c, h, w = x.shape
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = (fx - x0)[:, None], (fy - y0)[:, None]
    x0, y0 = x0.long(), y0.long()
    flat = x.reshape(n, c, h * w)

    def tap(yi, xi):
        valid = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h))[:, None].to(x.dtype)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, 1, -1).expand(n, c, -1)
        return torch.gather(flat, 2, idx).reshape(n, c, *yi.shape[1:]) * valid

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


class AugmentPipe:
    def __init__(self, opts: dict, height: int, width: int):
        unknown = {k for k, v in opts.items()
                   if not k.endswith(("_max", "_std")) and k not in GEOMETRIC and v}
        if unknown:
            raise NotImplementedError(f"augment sections without a reference: {sorted(unknown)}")
        self.opts, self.height, self.width = opts, height, width
        self.margin = static_margin(opts, height, width)
        self.filter = torch.tensor(SYM6, dtype=torch.float64)
        self.filter = (self.filter / self.filter.sum()).float()

    def sample(self, n: int, p, device, gen) -> torch.Tensor:
        """``G_inv [n, 3, 3]`` of the geometric section, gated by ``p``."""
        o, w, h = self.opts, self.width, self.height
        p = torch.as_tensor(p, dtype=torch.float32, device=device)
        u = lambda *tail: torch.rand((n,) + tail, generator=gen, device=device)  # noqa: E731
        nrm = lambda *tail: torch.randn((n,) + tail, generator=gen, device=device)  # noqa: E731

        def gate(mult, value, identity):
            return torch.where(u(*((1,) * (value.ndim - 1))) < mult * p, value, identity)

        ones, zeros = torch.ones(n, device=device), torch.zeros(n, device=device)
        g = torch.eye(3, device=device).expand(n, 3, 3).clone()
        if o.get("xflip", 0) > 0:
            i = gate(o["xflip"], torch.floor(u() * 2), zeros)
            g = g @ scale(1 / (1 - 2 * i), ones)
        if o.get("rotate90", 0) > 0:
            i = gate(o["rotate90"], torch.floor(u() * 4), zeros)
            g = g @ rotate(np.pi / 2 * i)
        if o.get("xint", 0) > 0:
            t = (u(2) * 2 - 1) * o["xint_max"]
            t = gate(o["xint"], t, torch.zeros_like(t))
            g = g @ translate(-torch.round(t[:, 0] * w), -torch.round(t[:, 1] * h))
        if o.get("scale", 0) > 0:
            s = gate(o["scale"], torch.exp2(nrm() * o["scale_std"]), ones)
            g = g @ scale(1 / s, 1 / s)
        p_rot = 1 - torch.sqrt(torch.clamp(1 - o.get("rotate", 0) * p, 0, 1))
        if o.get("rotate", 0) > 0:
            theta = (u() * 2 - 1) * np.pi * o["rotate_max"]
            theta = torch.where(u() < p_rot, theta, torch.zeros_like(theta))
            g = g @ rotate(theta)
        if o.get("aniso", 0) > 0:
            s = gate(o["aniso"], torch.exp2(nrm() * o["aniso_std"]), ones)
            g = g @ scale(1 / s, s)
        if o.get("rotate", 0) > 0:
            theta = (u() * 2 - 1) * np.pi * o["rotate_max"]
            theta = torch.where(u() < p_rot, theta, torch.zeros_like(theta))
            g = g @ rotate(theta)
        if o.get("xfrac", 0) > 0:
            t = nrm(2) * o["xfrac_std"]
            t = gate(o["xfrac"], t, torch.zeros_like(t))
            g = g @ translate(-t[:, 0] * w, -t[:, 1] * h)
        return g

    def __call__(self, images, p, gen, nm: Numerics) -> torch.Tensor:
        n, _, h, w = images.shape
        dev = images.device
        g = self.sample(n, p, dev, gen)
        mx0, mx1, my0, my1 = self.margin
        pad = len(SYM6) // 4
        x = nm.low(_reflect(nm.low(images), my0, my1, mx0, mx1))
        c = lambda v: torch.full((n,), float(v), device=dev)  # noqa: E731
        # The transform on the padded image, then on its 2x upsampled grid.
        g = translate(c((mx0 - mx1) / 2), c((my0 - my1) / 2)) @ g
        g = scale(c(2), c(2)) @ g @ scale(c(0.5), c(0.5))
        g = translate(c(-0.5), c(-0.5)) @ g @ translate(c(0.5), c(0.5))
        out_h, out_w = (h + pad * 2) * 2, (w + pad * 2) * 2
        x = nm.low(upsample2d(x, self.filter))
        # Output pixel (ox, oy) samples the source at G_inv applied to its
        # centre, both in the 2x grid's pixel units, measured from the
        # centre of each grid.
        ox = torch.arange(out_w, dtype=torch.float32, device=dev) - (out_w - 1) / 2
        oy = torch.arange(out_h, dtype=torch.float32, device=dev) - (out_h - 1) / 2
        gy, gx = torch.meshgrid(oy, ox, indexing="ij")
        a = g[:, :2, :2]
        t = g[:, :2, 2]
        fx = a[:, 0, 0, None, None] * gx + a[:, 0, 1, None, None] * gy + t[:, 0, None, None]
        fy = a[:, 1, 0, None, None] * gx + a[:, 1, 1, None, None] * gy + t[:, 1, None, None]
        in_h, in_w = x.shape[2], x.shape[3]
        x = nm.low(_bilinear(x, fx + (in_w - 1) / 2, fy + (in_h - 1) / 2))
        x = downsample2d(x, self.filter, padding=-pad * 2, flip_filter=True)
        return nm.low(x)
