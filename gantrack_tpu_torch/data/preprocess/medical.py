"""Per-slice medical image preprocessing (claro CT path).

The port's own copy of ``gantrack_tpu/data/preprocess/medical.py`` (framework-free;
``tests/test_torch_preprocess.py`` holds the two bit-equal).

Capability parity with the reference
``genlib/utils/util_medical_data.py:23-134`` and
``src/data/dataset_tool_mi.py:882-1001``: square bounding-box extraction
with zero-padding, bilinear resize, HU clipping, and min-max
normalisation — the stages BASELINE config 1 requires bit-exactly.

All functions are NumPy/SciPy host code.  The JAX module resizes with
OpenCV (``cv2.resize``); the port needs no OpenCV, and resizes with
:func:`resize_bilinear`, OpenCV's float64 bilinear path to the bit
(``tests/test_torch_preprocess.py`` holds it to ``cv2.resize``), so a
slice is resized alike wherever the port runs.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


def get_box(img: np.ndarray, box: Sequence[int], perc_border: float = 0.0) -> np.ndarray:
    """Extract a square region around ``box = [r0, c0, r1, c1]``.

    The shorter box side is symmetrically expanded (ceil/floor halves) to
    match the longer one, plus ``perc_border * ceil(Δ/2)`` border; any
    out-of-image extent is zero-padded first.  Matches the reference
    ``get_box`` (``util_medical_data.py:23-94``) including its
    asymmetric ceil/floor convention.
    """
    box = list(int(v) for v in box)
    l_h = box[2] - box[0]
    l_w = box[3] - box[1]
    diff1 = math.ceil(abs(l_h - l_w) / 2)
    diff2 = math.floor(abs(l_h - l_w) / 2)
    border = int(perc_border * diff1)

    if l_h > l_w:
        r_lo, r_hi = box[0] - border, box[2] + border
        c_lo, c_hi = box[1] - diff1 - border, box[3] + diff2 + border
    elif l_w > l_h:
        r_lo, r_hi = box[0] - diff1 - border, box[2] + diff2 + border
        c_lo, c_hi = box[1] - border, box[3] + border
    else:
        r_lo, r_hi = box[0] - border, box[2] + border
        c_lo, c_hi = box[1] - border, box[3] + border

    pad_top = max(0, -r_lo)
    pad_bot = max(0, r_hi - img.shape[0])
    pad_lef = max(0, -c_lo)
    pad_rig = max(0, c_hi - img.shape[1])
    if pad_top or pad_bot or pad_lef or pad_rig:
        img = np.pad(img, ((pad_top, pad_bot), (pad_lef, pad_rig)), mode="constant")
        r_lo += pad_top
        r_hi += pad_top
        c_lo += pad_lef
        c_hi += pad_lef
    return img[r_lo:r_hi, c_lo:c_hi]


def normalize(
    img: np.ndarray,
    convert_to_uint8: bool = False,
    scale_by_255: bool = True,
    min_val: Optional[float] = None,
    max_val: Optional[float] = None,
) -> np.ndarray:
    """Min-max normalise to [0,1] (optionally ×255, optionally uint8).

    Falsy min/max fall back to the image extrema — including explicit 0,
    matching the reference's ``if not min_val`` check
    (``util_medical_data.py:97-109``).
    """
    if not min_val:
        min_val = img.min()
    if not max_val:
        max_val = img.max()
    img = (img.astype(np.float64) - min_val) / (max_val - min_val)
    if scale_by_255:
        img = 255.0 * img
    if convert_to_uint8:
        img = img.astype(np.uint8)
    return img


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """``a * b + c`` rounded once (a fused multiply-add) in float64, from
    error-free transformations: the exact product (Dekker), the exact sum
    with ``c`` (Knuth), their tails added with rounding to odd, then one
    rounding to nearest (Boldo and Melquiond, "Emulation of FMA and
    correctly rounded sums", IEEE TC 2008).  Exact for the magnitudes of
    image samples (no overflow, no subnormal products)."""
    a, b, c = np.broadcast_arrays(*(np.asarray(v, np.float64) for v in (a, b, c)))
    split = 134217729.0  # 2**27 + 1

    def halves(x):
        t = split * x
        hi = t - (t - x)
        return hi, x - hi

    p = a * b
    (ah, al), (bh, bl) = halves(a), halves(b)
    p_err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = c + p
    bv = s - c
    s_err = (c - (s - bv)) + (p - bv)
    # Round to odd: the nearest sum of the tails, moved one unit toward
    # the exact sum where it is inexact and its last bit even.
    v = s_err + p_err
    vb = v - s_err
    v_err = (s_err - (v - vb)) + (p_err - vb)
    even = (v.view(np.int64) & 1) == 0
    v = np.where((v_err != 0) & even, np.nextafter(v, np.where(v_err > 0, np.inf, -np.inf)), v)
    return s + v


def _bilinear_axis(n: int, m: int):
    """Source rows (or columns) and weights of an ``n`` → ``m`` axis:
    the centre of output ``d`` maps to ``(d + 0.5) * n / m - 0.5``, which
    is clamped at the borders."""
    f = _fma(np.arange(m) + 0.5, np.float64(n / m), np.float64(-0.5))
    s = np.floor(f).astype(np.int64)
    t = np.where((s < 0) | (s >= n - 1), 0.0, f - s)
    return np.clip(s, 0, n - 1), np.clip(s + 1, 0, n - 1), t


def resize_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """``cv2.resize(img, (size, size))`` (``INTER_LINEAR``) of a float64
    ``[H, W]`` image with both sides resized, to the bit: each row
    interpolated as ``fma(x1 - x0, t, x0)``, then each column of the
    result so, in OpenCV's order."""
    if img.dtype != np.float64 or img.ndim != 2:
        raise ValueError(f"resize_bilinear takes a float64 [H, W] image, not {img.dtype} "
                         f"{img.shape}")
    x0, x1, tx = _bilinear_axis(img.shape[1], size)
    y0, y1, ty = _bilinear_axis(img.shape[0], size)
    rows = _fma(img[:, x1] - img[:, x0], tx, img[:, x0])
    return _fma(rows[y1] - rows[y0], ty[:, None], rows[y0])


def load_slice(
    img: np.ndarray,
    img_dim: int,
    box: Optional[Sequence[int]] = None,
    clip: Optional[dict] = None,
    scale: Optional[dict] = None,
    convert_to_uint8: bool = False,
    scale_by_255: bool = True,
    perc_border: float = 0.5,
) -> np.ndarray:
    """The claro per-slice pipeline (``util_medical_data.py:111-134``):
    box-crop (border 0.5) → bilinear resize to ``img_dim``² → clip HU →
    normalise.  Takes the decoded HxW float64 array; returns HxW float64
    (or uint8)."""
    if box is not None:
        img = get_box(img, box, perc_border=perc_border)
    if img_dim != img.shape[0]:
        img = resize_bilinear(img, img_dim)
    if clip is not None:
        img = np.clip(img, clip["min"], clip["max"])
    if scale is not None:
        img = normalize(img, convert_to_uint8, scale_by_255,
                        min_val=scale["min"], max_val=scale["max"])
    else:
        img = normalize(img, convert_to_uint8, scale_by_255)
    return img


def clip_and_rescale_volume(
    vol: np.ndarray,
    lower: Optional[float] = None,
    upper: Optional[float] = None,
    percentiles: Optional[Sequence[float]] = None,
    to_255: bool = True,
) -> np.ndarray:
    """Pelvis-style per-mode intensity normalisation
    (``dataset_tool_mi.py:305-336``): clip to ``[lower, upper]`` (or the
    given percentiles of the volume), map to [0,1], optionally ×255."""
    v = vol.astype(np.float64)
    if percentiles is not None:
        lower, upper = np.percentile(v, percentiles)
    assert lower is not None and upper is not None
    v = np.clip(v, lower, upper)
    v = (v - lower) / (upper - lower)
    return v * 255.0 if to_255 else v


def body_mask_slice(
    sl: np.ndarray,
    threshold: Optional[float] = None,
    closing_iters: int = 3,
) -> np.ndarray:
    """Threshold + largest-connected-component + closing + fill-holes
    body mask for one slice (the reference's generic recipe for
    spleen/heart/kits19, ``dataset_tool_mi.py:431-464``).  The Pelvis_2.1
    path uses the exact nilearn algorithm — see :func:`compute_epi_mask` /
    :func:`epi_body_mask_volume`."""
    from scipy import ndimage

    if threshold is None:
        # Otsu.
        hist, bin_edges = np.histogram(sl.ravel(), bins=256)
        centers = (bin_edges[:-1] + bin_edges[1:]) / 2
        w1 = np.cumsum(hist)
        w2 = np.cumsum(hist[::-1])[::-1]
        m1 = np.cumsum(hist * centers) / np.maximum(w1, 1)
        m2 = (np.cumsum((hist * centers)[::-1]) / np.maximum(w2[::-1], 1))[::-1]
        between = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
        threshold = centers[:-1][np.argmax(between)]
    mask = sl > threshold
    lab, n = ndimage.label(mask)
    if n > 1:
        sizes = ndimage.sum(mask, lab, range(1, n + 1))
        mask = lab == (int(np.argmax(sizes)) + 1)
    if closing_iters:
        mask = ndimage.binary_closing(mask, iterations=closing_iters)
    mask = ndimage.binary_fill_holes(mask)
    return mask.astype(np.uint8)


def body_mask_volume(vol: np.ndarray, **kwargs) -> np.ndarray:
    """Per-slice mask over a [H, W, D] volume (reference
    ``find_mask_folder`` applies per-slice fill-holes,
    ``dataset_tool_mi.py:488-510``)."""
    return np.stack([body_mask_slice(vol[:, :, d], **kwargs) for d in range(vol.shape[2])], axis=2)


def _largest_connected_component(volume: np.ndarray) -> np.ndarray:
    """nilearn ``_utils.ndimage.largest_connected_component``: 6-connected
    3D labeling (scipy default cross structure), biggest non-background
    label."""
    from scipy import ndimage

    labels, label_nb = ndimage.label(volume)
    if not label_nb:
        raise ValueError("No non-zero values: no connected components")
    if label_nb == 1:
        return volume.astype(bool)
    label_count = np.bincount(labels.ravel().astype(int))
    label_count[0] = 0
    return labels == label_count.argmax()


def compute_epi_mask(
    vol: np.ndarray,
    lower_cutoff: float = 0.2,
    upper_cutoff: float = 0.85,
    connected: bool = True,
    opening: int = 2,
    exclude_zeros: bool = False,
    ensure_finite: bool = True,
) -> np.ndarray:
    """Exact reimplementation of ``nilearn.masking.compute_epi_mask`` (the
    reference's Pelvis_2.1 body-mask extractor, ``dataset_tool_mi.py:486``)
    for a 3D volume, using the same numpy/scipy primitives nilearn calls:

    1. FWHM-1mm gaussian pre-smooth when ``opening`` (nilearn
       ``_compute_mean(..., smooth=(1 if opening else False))`` with
       ``affine=np.eye(4)`` — sigma is in *voxels*, spacing-independent);
    2. histogram-gap threshold: sort all voxels, find the largest jump
       between the ``lower_cutoff``/``upper_cutoff`` quantile positions,
       threshold at the midpoint of that jump;
    3. ``mask = smoothed >= threshold``;
    4. post-process (nilearn ``_post_process_mask``): binary erosion
       ×opening → largest 6-connected component → dilation ×2·opening →
       erosion ×opening (scipy default cross structures).
    """
    from scipy import ndimage

    if vol.ndim == 4:
        mean_epi = vol.astype(np.float64).mean(axis=-1)
    else:
        mean_epi = np.array(vol, dtype=np.float64, copy=True)
    if ensure_finite:
        mean_epi[np.logical_not(np.isfinite(mean_epi))] = 0
    if opening:
        # nilearn _smooth_array(fwhm=1, affine=eye(4)): per-axis
        # gaussian_filter1d with sigma = 1 / sqrt(8·ln 2) voxels.
        sigma = 1.0 / np.sqrt(8 * np.log(2))
        for axis in range(3):
            ndimage.gaussian_filter1d(mean_epi, sigma, output=mean_epi, axis=axis)

    sorted_input = np.sort(np.ravel(mean_epi))
    if exclude_zeros:
        sorted_input = sorted_input[sorted_input != 0]
    lo = int(np.floor(lower_cutoff * len(sorted_input)))
    hi = min(int(np.floor(upper_cutoff * len(sorted_input))),
             len(sorted_input) - 1)
    delta = sorted_input[lo + 1 : hi + 1] - sorted_input[lo:hi]
    ia = int(delta.argmax())
    threshold = 0.5 * (sorted_input[ia + lo] + sorted_input[ia + lo + 1])
    mask = mean_epi >= threshold

    if opening:
        opening = int(opening)
        mask = ndimage.binary_erosion(mask, iterations=opening)
    mask_any = mask.any()
    if connected and mask_any:
        mask = _largest_connected_component(mask)
    if opening:
        mask = ndimage.binary_dilation(mask, iterations=2 * opening)
        mask = ndimage.binary_erosion(mask, iterations=opening)
    return mask.astype(np.uint8)


def epi_body_mask_volume(vol: np.ndarray) -> np.ndarray:
    """The full Pelvis_2.1 mask recipe (``dataset_tool_mi.py:486-510``):
    ``compute_epi_mask`` on the reference CT volume, then per-slice
    ``binary_fill_holes``."""
    from scipy import ndimage

    m = compute_epi_mask(vol)
    for j in range(m.shape[-1]):
        m[:, :, j] = ndimage.binary_fill_holes(m[:, :, j]).astype(np.uint8)
    return m


def resample_volume(
    vol: np.ndarray,
    zooms: Sequence[float],
    zoom_level: float = 2.0,
    order: int = 1,
) -> tuple[np.ndarray, tuple]:
    """Respace a [H, W, D] volume by ``zoom_level`` in-plane.

    Reference behaviour (``src/engine/utils/utils.py:56-93``): new
    spacing = old spacing × zoom_level in-plane (512² → 256² at double
    the pixel size), linear interpolation, depth unchanged.  Implemented
    with ``scipy.ndimage.zoom`` (SimpleITK is optional in this
    environment); returns (volume, new_zooms).
    """
    from scipy import ndimage

    factors = (1.0 / zoom_level, 1.0 / zoom_level, 1.0)
    out = ndimage.zoom(vol.astype(np.float32), factors, order=order)
    new_zooms = (zooms[0] * zoom_level, zooms[1] * zoom_level, zooms[2])
    return out, new_zooms
