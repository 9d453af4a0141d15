"""ADA augmentation pipeline: pixel blitting and general geometric sections.

Port of ``AugmentPipe`` in ``gantrack_tpu/training/augment.py`` on NCHW
tensors, with the same static reflect-pad margin, transform composition,
probability gating and ``debug_percentile`` path.  The geometric warp
(upsample ×2 → affine grid-sample) has the two forms of the JAX pipe's
``impl``: ``"fused"`` (the default; the JAX ``"pallas"``) is
:func:`ops.upwarp.up_affine_warp`, which never builds the 2x canvas and
launches the kernel pair K1/K2 on the card; ``"unfused"`` (the JAX
``"gather"``) is ``upsample2d`` → :func:`ops.warp.affine_warp` →
``downsample2d``, which launches the FIR kernels and the warp pair K3/K4.
Both sample at the same positions.

After the geometric section come the colour section (brightness,
contrast, luma flip, hue, saturation as one 4×4 transform a sample,
collapsed to a scalar gain and offset for 1 and 2 channels), image-space
filtering (per-sample gains of four sym2 wavelet bands, applied as a
separable per-sample filter: a grouped convolution with the batch folded
into the channels), additive noise and cutout, each gated by ``p`` and
each with its ``debug_percentile`` branch, as in the JAX pipe.

Random draws use an explicit ``torch.Generator`` on the images' device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import conv2d_gradfix
from ..ops.upfirdn2d import Filter, downsample2d, setup_filter, upsample2d
from ..ops.upwarp import up_affine_warp
from ..ops.warp import affine_warp

WAVELETS = {
    "haar": [0.7071067811865476, 0.7071067811865476],
    "sym2": [-0.12940952255092145, 0.22414386804185735, 0.836516303737469, 0.48296291314469025],
    "sym6": [
        0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
        -0.048311742585633, 0.4910559419267466, 0.787641141030194,
        0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
        0.04472490177066578, 0.0017677118642428036, -0.007800708325034148,
    ],
}


# ------------------------------------------------------- matrix helpers
# Batched 3x3 homogeneous transforms [N, 3, 3] in float32.

def _eye3(n, device):
    return torch.eye(3, device=device).expand(n, 3, 3).clone()


def translate2d(tx, ty):
    m = _eye3(tx.shape[0], tx.device)
    m[:, 0, 2] = tx
    m[:, 1, 2] = ty
    return m


def scale2d(sx, sy):
    m = _eye3(sx.shape[0], sx.device)
    m[:, 0, 0] = sx
    m[:, 1, 1] = sy
    return m


def rotate2d(theta):
    m = _eye3(theta.shape[0], theta.device)
    c, s = torch.cos(theta), torch.sin(theta)
    m[:, 0, 0] = c
    m[:, 0, 1] = -s
    m[:, 1, 0] = s
    m[:, 1, 1] = c
    return m


def translate2d_inv(tx, ty):
    return translate2d(-tx, -ty)


def scale2d_inv(sx, sy):
    return scale2d(1.0 / sx, 1.0 / sy)


def rotate2d_inv(theta):
    return rotate2d(-theta)


# Batched 4x4 homogeneous colour transforms [N, 4, 4] in float32.

def _eye4(n, device):
    return torch.eye(4, device=device).expand(n, 4, 4).clone()


def translate3d(tx, ty, tz):
    m = _eye4(tx.shape[0], tx.device)
    m[:, 0, 3] = tx
    m[:, 1, 3] = ty
    m[:, 2, 3] = tz
    return m


def scale3d(sx, sy, sz):
    m = _eye4(sx.shape[0], sx.device)
    m[:, 0, 0] = sx
    m[:, 1, 1] = sy
    m[:, 2, 2] = sz
    return m


def rotate3d(v, theta):
    """Rotation about the unit axis ``v`` (3 floats) by ``theta [N]``."""
    vx, vy, vz = float(v[0]), float(v[1]), float(v[2])
    s, c = torch.sin(theta), torch.cos(theta)
    cc = 1 - c
    m = _eye4(theta.shape[0], theta.device)
    m[:, 0, 0] = vx * vx * cc + c
    m[:, 0, 1] = vx * vy * cc - vz * s
    m[:, 0, 2] = vx * vz * cc + vy * s
    m[:, 1, 0] = vy * vx * cc + vz * s
    m[:, 1, 1] = vy * vy * cc + c
    m[:, 1, 2] = vy * vz * cc - vx * s
    m[:, 2, 0] = vz * vx * cc - vy * s
    m[:, 2, 1] = vz * vy * cc + vx * s
    m[:, 2, 2] = vz * vz * cc + c
    return m


def _const(n, value, device):
    return torch.full((n,), float(value), dtype=torch.float32, device=device)


# ---------------------------------------------------------------- config

@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Probability multipliers and magnitudes (same fields and defaults
    as the JAX ``AugmentConfig``)."""

    xflip: float = 0.0
    rotate90: float = 0.0
    xint: float = 0.0
    xint_max: float = 0.125
    scale: float = 0.0
    rotate: float = 0.0
    aniso: float = 0.0
    xfrac: float = 0.0
    scale_std: float = 0.2
    rotate_max: float = 1.0
    aniso_std: float = 0.2
    xfrac_std: float = 0.125
    brightness: float = 0.0
    contrast: float = 0.0
    lumaflip: float = 0.0
    hue: float = 0.0
    saturation: float = 0.0
    brightness_std: float = 0.2
    contrast_std: float = 0.5
    hue_max: float = 1.0
    saturation_std: float = 1.0
    imgfilter: float = 0.0
    imgfilter_bands: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    imgfilter_std: float = 1.0
    noise: float = 0.0
    cutout: float = 0.0
    noise_std: float = 0.1
    cutout_size: float = 0.5

    @property
    def has_geometric(self) -> bool:
        return any(v > 0 for v in (self.xflip, self.rotate90, self.xint,
                                   self.scale, self.rotate, self.aniso, self.xfrac))

    @property
    def has_color(self) -> bool:
        return any(v > 0 for v in (self.brightness, self.contrast, self.lumaflip, self.hue,
                                   self.saturation))


def filter_bank() -> np.ndarray:
    """The four-band sym2 filter bank ``[4, 13]`` of the image-space
    filtering section (same construction as the JAX package's)."""
    hz_lo = np.asarray(WAVELETS["sym2"])
    hz_hi = hz_lo * ((-1) ** np.arange(hz_lo.size))
    hz_lo2 = np.convolve(hz_lo, hz_lo[::-1]) / 2
    hz_hi2 = np.convolve(hz_hi, hz_hi[::-1]) / 2
    fbank = np.eye(4, 1)
    for i in range(1, fbank.shape[0]):
        fbank = np.dstack([fbank, np.zeros_like(fbank)]).reshape(fbank.shape[0], -1)[:, :-1]
        fbank = np.stack([np.convolve(row, hz_lo2) for row in fbank])
        lo = (fbank.shape[1] - hz_hi2.size) // 2
        fbank[i, lo:lo + hz_hi2.size] += hz_hi2
    return fbank.astype(np.float32)


def medical_augment_config(**overrides) -> AugmentConfig:
    """The medical ('bgc-mi') tuning: conservative blit + geometric
    magnitudes for CT/MR slices (same values as the JAX package)."""
    base = dict(
        xflip=1.0, xint=1.0, xint_max=0.05,
        scale=1.0, rotate=1.0, rotate_max=3.0 / 360.0,
        aniso=1.0, xfrac=1.0,
        scale_std=0.05, aniso_std=0.05, xfrac_std=0.05,
    )
    base.update(overrides)
    return AugmentConfig(**base)


# ------------------------------------------------- static margin (numpy)

def _np_translate2d(tx, ty):
    n = np.shape(tx)[0]
    m = np.broadcast_to(np.eye(3), (n, 3, 3)).copy()
    m[:, 0, 2] = tx
    m[:, 1, 2] = ty
    return m


def _np_scale2d_inv(sx, sy):
    n = np.shape(sx)[0]
    m = np.broadcast_to(np.eye(3), (n, 3, 3)).copy()
    m[:, 0, 0] = 1 / sx
    m[:, 1, 1] = 1 / sy
    return m


def _np_rotate2d(theta):
    n = np.shape(theta)[0]
    m = np.broadcast_to(np.eye(3), (n, 3, 3)).copy()
    c, s = np.cos(theta), np.sin(theta)
    m[:, 0, 0] = c
    m[:, 0, 1] = -s
    m[:, 1, 0] = s
    m[:, 1, 1] = c
    return m


def _sample_transforms(cfg: AugmentConfig, height: int, width: int,
                       samples: int, seed: int) -> np.ndarray:
    """Monte-Carlo G_inv draws at p=1 (the JAX draw sequence, in numpy)."""
    rng = np.random.default_rng(seed)
    n = samples
    g = np.broadcast_to(np.eye(3), (n, 3, 3)).copy()
    if cfg.xflip > 0:
        i = rng.integers(0, 2, n)
        g = g @ _np_scale2d_inv(1 - 2 * i, np.ones(n))
    if cfg.rotate90 > 0:
        i = rng.integers(0, 4, n)
        g = g @ _np_rotate2d(np.pi / 2 * i)
    if cfg.xint > 0:
        t = (rng.random((n, 2)) * 2 - 1) * cfg.xint_max
        g = g @ _np_translate2d(-np.round(t[:, 0] * width), -np.round(t[:, 1] * height))
    if cfg.scale > 0:
        s = np.exp2(np.clip(rng.standard_normal(n), -4.5, 4.5) * cfg.scale_std)
        s = np.concatenate([s, [2 ** (4.5 * cfg.scale_std), 2 ** (-4.5 * cfg.scale_std)] * (n // 2)])[:n]
        g = g @ _np_scale2d_inv(s, s)
    if cfg.rotate > 0:
        theta = (rng.random(n) * 2 - 1) * np.pi * cfg.rotate_max
        g = g @ _np_rotate2d(theta)
    if cfg.aniso > 0:
        s = np.exp2(np.clip(rng.standard_normal(n), -4.5, 4.5) * cfg.aniso_std)
        g = g @ _np_scale2d_inv(s, 1 / s)
    if cfg.rotate > 0:
        theta = (rng.random(n) * 2 - 1) * np.pi * cfg.rotate_max
        g = g @ _np_rotate2d(theta)
    if cfg.xfrac > 0:
        t = np.clip(rng.standard_normal((n, 2)), -4.5, 4.5) * cfg.xfrac_std
        g = g @ _np_translate2d(-t[:, 0] * width, -t[:, 1] * height)
    return g


def compute_static_margin(cfg: AugmentConfig, height: int, width: int,
                          samples: int = 4096, seed: int = 0) -> Tuple[int, int, int, int]:
    """Conservative static reflect-pad margins ``(mx0, mx1, my0, my1)``:
    Monte-Carlo max corner excursion + wavelet halo, clipped to
    ``[0, size-1]`` (same estimate as the JAX package)."""
    if not cfg.has_geometric:
        return (0, 0, 0, 0)
    g = _sample_transforms(cfg, height, width, samples, seed)
    cx = (width - 1) / 2
    cy = (height - 1) / 2
    corners = np.asarray([[-cx, -cy, 1], [cx, -cy, 1], [cx, cy, 1], [-cx, cy, 1]]).T
    xy = (g @ corners)[:, :2, :]
    hz_pad = len(WAVELETS["sym6"]) // 4
    margin = np.stack([(-xy[:, 0]).max(), (-xy[:, 1]).max(), xy[:, 0].max(), xy[:, 1].max()])
    margin = margin + np.asarray([hz_pad * 2 - cx, hz_pad * 2 - cy] * 2)
    margin = np.clip(margin, 0, [width - 1, height - 1, width - 1, height - 1])
    mx0, my0, mx1, my1 = np.ceil(margin).astype(int)
    return int(mx0), int(mx1), int(my0), int(my1)


def _reflect_pad(x: torch.Tensor, t: int, b: int, l: int, r: int) -> torch.Tensor:
    """NCHW reflect padding as flipped-slice concats (same as JAX's)."""
    parts = []
    if t > 0:
        parts.append(x[:, :, 1:t + 1].flip(2))
    parts.append(x)
    if b > 0:
        parts.append(x[:, :, -b - 1:-1].flip(2))
    x = torch.cat(parts, dim=2) if len(parts) > 1 else x
    parts = []
    if l > 0:
        parts.append(x[:, :, :, 1:l + 1].flip(3))
    parts.append(x)
    if r > 0:
        parts.append(x[:, :, :, -r - 1:-1].flip(3))
    return torch.cat(parts, dim=3) if len(parts) > 1 else x


# -------------------------------------------------------------- pipeline

class AugmentPipe:
    """Callable ``(images NCHW, p, generator) -> images``.

    ``compute_dtype`` is the image-path dtype (bf16 by default, as in the
    JAX pipe); transforms and sampling coordinates stay float32.
    ``impl`` is ``"fused"`` or ``"unfused"`` (see the module docstring).
    """

    def __init__(self, cfg: AugmentConfig, height: int, width: int, num_channels: int,
                 impl: str = "fused", compute_dtype: torch.dtype = torch.bfloat16):
        assert num_channels in (1, 2, 3)
        if impl not in ("fused", "unfused"):
            raise ValueError(f"impl must be 'fused' or 'unfused', got {impl!r}")
        self.impl = impl
        self.cfg = cfg
        self.height = height
        self.width = width
        self.num_channels = num_channels
        self.compute_dtype = compute_dtype
        self.hz_geom = Filter(setup_filter(WAVELETS["sym6"]))
        self.hz_fbank = torch.from_numpy(filter_bank())  # float32, CPU
        self.margin = compute_static_margin(cfg, height, width)
        self._filters = {}

    def _on(self, name: str, device) -> torch.Tensor:
        """The constant ``hz_fbank`` on ``device``."""
        key = (name, str(device))
        if key not in self._filters:
            self._filters[key] = getattr(self, name).to(device)
        return self._filters[key]

    def __call__(self, images: torch.Tensor, p, generator: Optional[torch.Generator] = None,
                 debug_percentile: Optional[float] = None) -> torch.Tensor:
        n, c, h, w = images.shape
        assert (h, w, c) == (self.height, self.width, self.num_channels)
        cfg = self.cfg
        draws = _Draws(n, p, images.device, generator, debug_percentile)
        x = images.to(self.compute_dtype)
        if cfg.has_geometric:
            x = self._geometric(x, self._sample_geometric(draws))
        if cfg.has_color:
            x = self._color(x, draws)
        if cfg.imgfilter > 0:
            x = self._imgfilter(x, draws)
        if cfg.noise > 0:
            x = self._noise(x, draws)
        if cfg.cutout > 0:
            x = self._cutout(x, draws)
        return x.to(images.dtype)

    def sample_geometric(self, n: int, p, device, generator: Optional[torch.Generator] = None,
                         debug_percentile: Optional[float] = None) -> torch.Tensor:
        """Draw the blit + geometric transforms: ``G_inv [n, 3, 3]``."""
        return self._sample_geometric(_Draws(n, p, device, generator, debug_percentile))

    def _sample_geometric(self, draws: "_Draws") -> torch.Tensor:
        cfg = self.cfg
        width, height = self.width, self.height
        n, p, dp, device = draws.n, draws.p, draws.dp, draws.device
        draw_u, draw_n, gate = draws.uniform, draws.normal, draws.gate

        g_inv = _eye3(n, device)
        if cfg.xflip > 0:
            i = gate(cfg.xflip, torch.floor(draw_u() * 2), torch.zeros(n, device=device))
            if dp is not None:
                i = torch.floor(dp * 2).expand(n)
            g_inv = g_inv @ scale2d_inv(1 - 2 * i, torch.ones_like(i))
        if cfg.rotate90 > 0:
            i = gate(cfg.rotate90, torch.floor(draw_u() * 4), torch.zeros(n, device=device))
            if dp is not None:
                i = torch.floor(dp * 4).expand(n)
            g_inv = g_inv @ rotate2d_inv(-np.pi / 2 * i)
        if cfg.xint > 0:
            t = (draw_u(2) * 2 - 1) * cfg.xint_max
            t = gate(cfg.xint, t, torch.zeros_like(t))
            if dp is not None:
                t = ((dp * 2 - 1) * cfg.xint_max).expand(n, 2)
            g_inv = g_inv @ translate2d_inv(torch.round(t[:, 0] * width),
                                            torch.round(t[:, 1] * height))
        if cfg.scale > 0:
            s = gate(cfg.scale, torch.exp2(draw_n() * cfg.scale_std), torch.ones(n, device=device))
            if dp is not None:
                s = torch.exp2(torch.special.erfinv(dp * 2 - 1) * cfg.scale_std).expand(n)
            g_inv = g_inv @ scale2d_inv(s, s)
        p_rot = 1 - torch.sqrt(torch.clamp(1 - cfg.rotate * p, 0, 1))  # P(pre OR post) = p
        if cfg.rotate > 0:
            theta = (draw_u() * 2 - 1) * np.pi * cfg.rotate_max
            theta = torch.where(draw_u() < p_rot, theta, torch.zeros_like(theta))
            if dp is not None:
                theta = ((dp * 2 - 1) * np.pi * cfg.rotate_max).expand(n)
            g_inv = g_inv @ rotate2d_inv(-theta)
        if cfg.aniso > 0:
            s = gate(cfg.aniso, torch.exp2(draw_n() * cfg.aniso_std), torch.ones(n, device=device))
            if dp is not None:
                s = torch.exp2(torch.special.erfinv(dp * 2 - 1) * cfg.aniso_std).expand(n)
            g_inv = g_inv @ scale2d_inv(s, 1 / s)
        if cfg.rotate > 0:
            theta = (draw_u() * 2 - 1) * np.pi * cfg.rotate_max
            theta = torch.where(draw_u() < p_rot, theta, torch.zeros_like(theta))
            if dp is not None:
                theta = torch.zeros_like(theta)
            g_inv = g_inv @ rotate2d_inv(-theta)
        if cfg.xfrac > 0:
            t = draw_n(2) * cfg.xfrac_std
            t = gate(cfg.xfrac, t, torch.zeros_like(t))
            if dp is not None:
                t = (torch.special.erfinv(dp * 2 - 1) * cfg.xfrac_std).expand(n, 2)
            g_inv = g_inv @ translate2d_inv(t[:, 0] * width, t[:, 1] * height)
        return g_inv

    def warp_geometry(self, g_inv: torch.Tensor):
        """Conjugate ``G_inv`` to the padded, upsampled grid.  Returns the
        normalised ``theta [n, 2, 3]`` of the warp and its output size."""
        n = g_inv.shape[0]
        dev = g_inv.device
        hz_pad = self.hz_geom.host.shape[0] // 4
        mx0, mx1, my0, my1 = self.margin
        h1, w1 = self.height + my0 + my1, self.width + mx0 + mx1
        g_inv = translate2d(_const(n, (mx0 - mx1) / 2, dev), _const(n, (my0 - my1) / 2, dev)) @ g_inv
        two = _const(n, 2.0, dev)
        half = _const(n, -0.5, dev)
        g_inv = scale2d(two, two) @ g_inv @ scale2d_inv(two, two)
        g_inv = translate2d(half, half) @ g_inv @ translate2d_inv(half, half)
        out_h = (self.height + hz_pad * 2) * 2
        out_w = (self.width + hz_pad * 2) * 2
        in_h, in_w = 2 * h1, 2 * w1
        g_inv = (scale2d(_const(n, 2 / in_w, dev), _const(n, 2 / in_h, dev)) @ g_inv
                 @ scale2d_inv(_const(n, 2 / out_w, dev), _const(n, 2 / out_h, dev)))
        return g_inv[:, :2, :], out_h, out_w

    def apply_geometric(self, images: torch.Tensor, g_inv: torch.Tensor) -> torch.Tensor:
        """The geometric section alone, in ``compute_dtype``, returned in
        the images' dtype."""
        return self._geometric(images.to(self.compute_dtype), g_inv).to(images.dtype)

    def _geometric(self, x: torch.Tensor, g_inv: torch.Tensor) -> torch.Tensor:
        """Reflect-pad, warp at 2x (upsample + affine bilinear, fused or
        not), and FIR-downsample back to the input size."""
        mx0, mx1, my0, my1 = self.margin
        hz_pad = self.hz_geom.host.shape[0] // 4
        x = _reflect_pad(x, my0, my1, mx0, mx1)
        theta, out_h, out_w = self.warp_geometry(g_inv)
        if self.impl == "fused":
            x = up_affine_warp(x, theta, self.hz_geom, out_h, out_w)
        else:
            x = upsample2d(x, self.hz_geom, up=2)
            x = affine_warp(x, theta, out_h, out_w)
        return downsample2d(x, self.hz_geom, down=2, padding=-hz_pad * 2, flip_filter=True)

    def _color(self, x: torch.Tensor, draws: "_Draws") -> torch.Tensor:
        """Brightness, contrast, luma flip, hue and saturation as one 4×4
        transform a sample; 1 and 2 channels take its collapsed scalar
        gain and offset (hue and saturation need 3 channels)."""
        cfg = self.cfg
        n, dp, device = draws.n, draws.dp, draws.device
        channels = self.num_channels
        erfinv = torch.special.erfinv
        eye4 = torch.eye(4, device=device)
        C = _eye4(n, device)
        v = np.asarray([1, 1, 1, 0]) / np.sqrt(3)
        vv = torch.from_numpy(np.outer(v, v).astype(np.float32)).to(device)
        if cfg.brightness > 0:
            b = draws.gate(cfg.brightness, draws.normal() * cfg.brightness_std,
                           torch.zeros(n, device=device))
            if dp is not None:
                b = (erfinv(dp * 2 - 1) * cfg.brightness_std).expand(n)
            C = translate3d(b, b, b) @ C
        if cfg.contrast > 0:
            c = draws.gate(cfg.contrast, torch.exp2(draws.normal() * cfg.contrast_std),
                           torch.ones(n, device=device))
            if dp is not None:
                c = torch.exp2(erfinv(dp * 2 - 1) * cfg.contrast_std).expand(n)
            C = scale3d(c, c, c) @ C
        if cfg.lumaflip > 0:
            i = draws.gate(cfg.lumaflip, torch.floor(draws.uniform(1, 1) * 2),
                           torch.zeros((n, 1, 1), device=device))
            if dp is not None:
                i = torch.floor(dp * 2).expand(n, 1, 1)
            C = (eye4 - 2 * vv * i) @ C  # Householder reflection
        if cfg.hue > 0 and channels > 1:
            theta = draws.gate(cfg.hue, (draws.uniform() * 2 - 1) * np.pi * cfg.hue_max,
                               torch.zeros(n, device=device))
            if dp is not None:
                theta = ((dp * 2 - 1) * np.pi * cfg.hue_max).expand(n)
            C = rotate3d(v, theta) @ C
        if cfg.saturation > 0 and channels > 1:
            s = draws.gate(cfg.saturation,
                           torch.exp2(draws.normal(1, 1) * cfg.saturation_std),
                           torch.ones((n, 1, 1), device=device))
            if dp is not None:
                s = torch.exp2(erfinv(dp * 2 - 1) * cfg.saturation_std).expand(n, 1, 1)
            C = (vv + (eye4 - vv) * s) @ C
        if channels == 3:
            return (torch.einsum("nij,njhw->nihw", C[:, :3, :3], x.float())
                    + C[:, :3, 3, None, None])
        # 1 channel, or 2 independent grayscale modes: the collapsed luma
        # transform, per channel.
        cm = C[:, :3, :].mean(dim=1)  # [N, 4]
        return x * cm[:, :3].sum(dim=1)[:, None, None, None] + cm[:, 3, None, None, None]

    def _imgfilter(self, x: torch.Tensor, draws: "_Draws") -> torch.Tensor:
        """Per-sample gains of the four wavelet bands, applied as a
        separable per-sample filter over the reflect-padded images."""
        cfg = self.cfg
        n, p, dp, device = draws.n, draws.p, draws.dp, draws.device
        fbank = self._on("hz_fbank", device)
        num_bands = fbank.shape[0]
        assert len(cfg.imgfilter_bands) == num_bands
        expected_power = torch.tensor([10 / 13, 1 / 13, 1 / 13, 1 / 13], device=device)
        g = torch.ones((n, num_bands), device=device)
        for i, band_strength in enumerate(cfg.imgfilter_bands):
            t_i = torch.exp2(draws.normal() * cfg.imgfilter_std)
            t_i = torch.where(draws.uniform() < cfg.imgfilter * p * band_strength, t_i,
                              torch.ones_like(t_i))
            if dp is not None:
                t_i = (torch.exp2(torch.special.erfinv(dp * 2 - 1) * cfg.imgfilter_std).expand(n)
                       if band_strength > 0 else torch.ones_like(t_i))
            t = torch.ones((n, num_bands), device=device)
            t[:, i] = t_i
            g = g * (t / torch.sqrt((expected_power * t.square()).sum(dim=-1, keepdim=True)))
        hz_prime = g @ fbank  # [N, taps]
        taps = hz_prime.shape[1]
        pad = taps // 2
        channels, height, width = x.shape[1:]
        # Fold the batch into the channels: one filter a sample, sample-major.
        w_band = hz_prime.repeat_interleave(channels, dim=0).to(x.dtype)  # [N*C, taps]
        y = torch.nn.functional.pad(x.reshape(1, n * channels, height, width),
                                    [pad, pad, pad, pad], mode="reflect")
        y = conv2d_gradfix.conv2d(y, w_band[:, None, :, None], groups=n * channels)
        y = conv2d_gradfix.conv2d(y, w_band[:, None, None, :], groups=n * channels)
        return y.reshape(n, channels, height, width)

    def _noise(self, x: torch.Tensor, draws: "_Draws") -> torch.Tensor:
        cfg = self.cfg
        n, dp, device = draws.n, draws.dp, draws.device
        sigma = draws.gate(cfg.noise, draws.normal(1, 1, 1).abs() * cfg.noise_std,
                           torch.zeros((n, 1, 1, 1), device=device))
        if dp is not None:
            sigma = (torch.special.erfinv(dp) * cfg.noise_std).expand(n, 1, 1, 1)
        return x + draws.normal(*x.shape[1:]) * sigma

    def _cutout(self, x: torch.Tensor, draws: "_Draws") -> torch.Tensor:
        cfg = self.cfg
        n, p, dp, device = draws.n, draws.p, draws.dp, draws.device
        height, width = x.shape[2:]
        size = torch.full((n, 2, 1, 1), cfg.cutout_size, device=device)
        size = torch.where(draws.uniform(1, 1, 1) < cfg.cutout * p, size, torch.zeros_like(size))
        center = draws.uniform(2, 1, 1)
        if dp is not None:
            size = torch.full_like(size, cfg.cutout_size)
            center = dp.expand(n, 2, 1, 1)
        coord_x = torch.arange(width, device=device).reshape(1, 1, -1)
        coord_y = torch.arange(height, device=device).reshape(1, -1, 1)
        mask_x = ((coord_x + 0.5) / width - center[:, 0]).abs() >= size[:, 0] / 2
        mask_y = ((coord_y + 0.5) / height - center[:, 1]).abs() >= size[:, 1] / 2
        return x * (mask_x | mask_y).to(x.dtype)[:, None]


class _Draws:
    """The random draws of one call: per-sample uniform and normal numbers
    from the caller's generator, and the gate ``value where u < mult * p
    else identity``.  ``dp`` is the ``debug_percentile`` as a tensor, or
    None."""

    def __init__(self, n: int, p, device, generator: Optional[torch.Generator],
                 debug_percentile: Optional[float]):
        self.n, self.device, self.generator = n, device, generator
        self.p = torch.as_tensor(p, dtype=torch.float32, device=device)
        self.dp = None if debug_percentile is None else torch.tensor(
            float(debug_percentile), dtype=torch.float32, device=device)

    def uniform(self, *tail) -> torch.Tensor:
        return torch.rand((self.n,) + tail, generator=self.generator, device=self.device)

    def normal(self, *tail) -> torch.Tensor:
        return torch.randn((self.n,) + tail, generator=self.generator, device=self.device)

    def gate(self, mult, value, identity):
        u = self.uniform(*((1,) * (value.ndim - 1)))
        return torch.where(u < mult * self.p, value, identity)
