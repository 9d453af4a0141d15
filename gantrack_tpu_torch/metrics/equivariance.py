"""Equivariance metrics EQ-T / EQ-T_frac / EQ-R (StyleGAN3 only).

Port of ``gantrack_tpu/metrics/equivariance.py`` on NCHW tensors: the
PSNR between (a) synthesising with a transformed input grid (the user
transform of StyleGAN3's ``SynthesisInput``) and (b) transforming the
synthesised image: integer and fractional translation, and rotation.

The image-space reference transforms are an integer roll (EQ-T) and the
bilinear affine warp (EQ-T_frac, EQ-R), which is
:func:`..ops.warp.affine_warp`: on the card the warp kernel K3.  The PSNR
is taken over the valid overlapping region.  The draws (z, translations,
angles) come from ``numpy.random.default_rng(opts.seed)`` in the JAX
metric's order, so both packages evaluate the same samples.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.warp import affine_warp
from .metric_utils import MetricOptions


def _psnr(a: torch.Tensor, b: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PSNR over [-1, 1]-range images (peak = 2).  The mask is
    ``[1, 1, H, W]``: the error sums over the batch, the count does not,
    as in the JAX metric."""
    if mask is None:
        mse = (a - b).square().mean()
    else:
        mse = ((a - b) * mask).square().sum() / mask.sum().clamp(min=1)
    return 20.0 * np.log10(2.0) - 10.0 * torch.log10(mse.clamp(min=1e-20))


def _mask(mask: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(mask).to(like.device)


def _theta(rows, like: torch.Tensor) -> torch.Tensor:
    theta = np.tile(np.array(rows, np.float32), (like.shape[0], 1, 1))
    return torch.from_numpy(theta).to(like.device)


def apply_integer_translation(x: torch.Tensor, tx: float, ty: float):
    """Integer pixel roll + validity mask."""
    h, w = x.shape[2], x.shape[3]
    ix, iy = int(np.rint(tx * w)), int(np.rint(ty * h))
    y = torch.roll(x, (iy, ix), dims=(2, 3))
    mask = np.ones((1, 1, h, w), np.float32)
    if iy > 0:
        mask[:, :, :iy] = 0
    elif iy < 0:
        mask[:, :, iy:] = 0
    if ix > 0:
        mask[:, :, :, :ix] = 0
    elif ix < 0:
        mask[:, :, :, ix:] = 0
    return y, _mask(mask, x)


def apply_fractional_translation(x: torch.Tensor, tx: float, ty: float):
    """Bilinear sub-pixel translation + interior mask."""
    h, w = x.shape[2], x.shape[3]
    y = affine_warp(x, _theta([[1, 0, -2 * tx], [0, 1, -2 * ty]], x), h, w)
    mask = np.ones((1, 1, h, w), np.float32)
    bx, by = int(np.ceil(abs(tx) * w)) + 1, int(np.ceil(abs(ty) * h)) + 1
    mask[:, :, :by] = 0
    mask[:, :, -by:] = 0
    mask[:, :, :, :bx] = 0
    mask[:, :, :, -bx:] = 0
    return y, _mask(mask, x)


def apply_rotation(x: torch.Tensor, angle: float):
    """Bilinear rotation about the centre + inscribed-disc mask."""
    h, w = x.shape[2], x.shape[3]
    c, s = np.cos(angle), np.sin(angle)
    y = affine_warp(x, _theta([[c, s, 0], [-s, c, 0]], x), h, w)
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    mask = ((xx ** 2 + yy ** 2) < (1 - 2 / min(h, w)) ** 2).astype(np.float32)[None, None]
    return y, _mask(mask, x)


def compute_equivariance_metrics(
    opts: MetricOptions,
    num_samples: int = 200,
    translate_max: float = 0.125,
    rotate_max: float = 1.0,
    compute_eqt_int: bool = True,
    compute_eqt_frac: bool = True,
    compute_eqr: bool = True,
) -> dict:
    """Mean PSNR (dB) per enabled metric: ``{"eqt_int", "eqt_frac", "eqr"}``.

    ``opts.generator_with_transform(z, c, transform_3x3)`` synthesises with
    the given user transform set on the StyleGAN3 input.
    """
    gen_t = opts.generator_with_transform
    if gen_t is None:
        raise ValueError("the equivariance metrics need a transform-capable generator "
                         "(opts.generator_with_transform: a StyleGAN3 G_ema)")
    device = torch.device(opts.device)
    rng = np.random.default_rng(opts.seed)
    sums: dict = {}
    counts: dict = {}
    bs = min(opts.batch_size, 8)
    done = 0

    def add(key, img_t, want, mask):
        # Kept on the device: the PSNRs are fetched once, at the end.
        sums[key] = sums.get(key, 0) + _psnr(img_t, want, mask).double()
        counts[key] = counts.get(key, 0) + 1

    with torch.inference_mode():
        while done < num_samples:
            z = torch.from_numpy(rng.standard_normal((bs, opts.z_dim)).astype(np.float32))
            z = z.to(device)
            ref = gen_t(z, None, np.eye(3, dtype=np.float32))

            if compute_eqt_int:
                t = (rng.random(2) * 2 - 1) * translate_max
                m = np.eye(3, dtype=np.float32)
                m[0, 2], m[1, 2] = -t[0] * 2, -t[1] * 2  # normalised input shift
                add("eqt_int", gen_t(z, None, m), *apply_integer_translation(ref, t[0], t[1]))
            if compute_eqt_frac:
                t = (rng.random(2) * 2 - 1) * translate_max
                m = np.eye(3, dtype=np.float32)
                m[0, 2], m[1, 2] = -t[0] * 2, -t[1] * 2
                add("eqt_frac", gen_t(z, None, m), *apply_fractional_translation(ref, t[0], t[1]))
            if compute_eqr:
                angle = (rng.random() * 2 - 1) * np.pi * rotate_max
                c, s = np.cos(angle), np.sin(angle)
                m = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
                add("eqr", gen_t(z, None, m), *apply_rotation(ref, angle))
            done += bs

    return {k: float(sums[k]) / counts[k] for k in sums}
