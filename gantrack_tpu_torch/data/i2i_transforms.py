"""CycleGAN/pix2pix train-time preprocessing, on uint8 numpy arrays.

The port's copy of ``gantrack_tpu/data/i2i_transforms.py``:
``get_params`` and ``output_size`` are the original's, line for line
(``tests/test_torch_i2i.py`` holds them equal).  The original applies
the chain to a PIL image; PIL is not taken here, so
:func:`apply_transform` runs it on ``[H, W]`` or ``[H, W, C]`` uint8
arrays, with :func:`resize_bicubic` in place of
``PIL.Image.resize(..., BICUBIC)``.  That resize is Pillow's: separable
(horizontal pass, rounded to uint8, then vertical), Keys' cubic with
a = -0.5 over a support of 2 scaled by the shrink factor (antialiased
when shrinking), each output's taps normalised to sum 1 and turned into
22-bit fixed point, integer sums rounded, shifted and clipped to uint8.
The transform modes:

* ``resize_and_crop`` (the reference default): resize to
  ``load_size``² → random ``crop_size``² crop,
* ``crop``: random crop straight from the source,
* ``scale_width`` / ``scale_width_and_crop``: width-pinned aspect
  resize (height floored at ``crop_size``), optional crop,
* ``resize``: plain bicubic square resize,
* ``none``: round each side to a multiple of 4,

plus the 50% horizontal flip.  Random parameters are drawn once per
sample (``get_params``, reference ``:62-78``) so aligned A/B pairs share
the identical crop/flip while unaligned sides draw independently
(reference ``aligned_dataset.py:49-54`` vs ``unaligned_dataset.py:36-37``).
"""

from __future__ import annotations

import math
import random
from typing import Dict, Optional, Tuple

import numpy as np

PREPROCESS_CHOICES = (
    "resize_and_crop", "crop", "scale_width", "scale_width_and_crop",
    "resize", "none",
)

_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit images


def get_params(
    preprocess: str,
    load_size: int,
    crop_size: int,
    src_size: Tuple[int, int],
    rng: random.Random,
    no_flip: bool = False,
) -> Dict[str, object]:
    """Draw the per-sample crop position and flip bit (reference
    ``base_dataset.get_params``).  ``src_size`` is the PIL ``(w, h)``."""
    w, h = src_size
    new_w, new_h = w, h
    if preprocess == "resize_and_crop":
        new_w = new_h = load_size
    elif preprocess == "scale_width_and_crop":
        new_w = load_size
        new_h = load_size * h // w
    x = rng.randint(0, max(0, new_w - crop_size))
    y = rng.randint(0, max(0, new_h - crop_size))
    flip = (not no_flip) and rng.random() > 0.5
    return {"crop_pos": (x, y), "flip": flip}


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _coefficients(in_size: int, out_size: int):
    """Each output's first input index and its fixed-point taps
    (Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``)."""
    scale = filterscale = in_size / out_size
    filterscale = max(filterscale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    taps = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = sum(w)
        w = np.asarray([v / total if total != 0.0 else v for v in w], np.float64)
        fixed = w * (1 << _PRECISION_BITS)
        taps[xx, :xmax] = np.where(fixed < 0, np.trunc(-0.5 + fixed), np.trunc(0.5 + fixed))
        first[xx] = xmin
    return first, taps


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along ``axis`` (0: rows, 1: columns) of ``[H, W, C]`` uint8."""
    first, taps = _coefficients(img.shape[axis], out_size)
    x = np.moveaxis(img, axis, 0).astype(np.int64)
    n = x.shape[0]
    acc = np.full((out_size,) + x.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for k in range(taps.shape[1]):
        idx = np.minimum(first + k, n - 1)  # taps past the window are 0
        acc += x[idx] * taps[:, k].reshape((-1,) + (1,) * (x.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``PIL.Image.resize(size, BICUBIC)`` of an ``[H, W]`` or ``[H, W, C]``
    uint8 array; ``size`` is PIL's ``(w, h)``."""
    w, h = size
    x = img[:, :, None] if img.ndim == 2 else img
    if w != x.shape[1]:
        x = _resample_axis(x, w, 1)
    if h != x.shape[0]:
        x = _resample_axis(x, h, 0)
    return x[:, :, 0] if img.ndim == 2 else x


def apply_transform(
    img: np.ndarray,
    preprocess: str,
    load_size: int,
    crop_size: int,
    params: Optional[Dict[str, object]] = None,
) -> np.ndarray:
    """Apply the reference transform chain to an ``[H, W]`` or ``[H, W, C]``
    uint8 array and return one (the reference's ToTensor+Normalize((0.5,),
    (0.5,)) is exactly ``arr/127.5 - 1``, the caller's job)."""
    if "resize" in preprocess:
        img = resize_bicubic(img, (load_size, load_size))
    elif "scale_width" in preprocess:
        oh, ow = img.shape[:2]
        if not (ow == load_size and oh >= crop_size):
            img = resize_bicubic(img, (load_size, max(load_size * oh // ow, crop_size)))
    if "crop" in preprocess:
        oh, ow = img.shape[:2]
        if ow > crop_size or oh > crop_size:
            x, y = params["crop_pos"]
            img = _crop(img, x, y, crop_size)
    if preprocess == "none":
        oh, ow = img.shape[:2]
        w4, h4 = int(round(ow / 4) * 4), int(round(oh / 4) * 4)
        if (w4, h4) != (ow, oh):
            img = resize_bicubic(img, (w4, h4))
    if params is not None and params.get("flip"):
        img = img[:, ::-1]
    return np.ascontiguousarray(img)


def _crop(img: np.ndarray, x: int, y: int, size: int) -> np.ndarray:
    """``PIL.Image.crop((x, y, x + size, y + size))``: zeros outside."""
    out = np.zeros((size, size) + img.shape[2:], img.dtype)
    part = img[y:y + size, x:x + size]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def output_size(preprocess: str, load_size: int, crop_size: int) -> int:
    """The square side the network sees for a given preprocess mode."""
    return crop_size if "crop" in preprocess else load_size
