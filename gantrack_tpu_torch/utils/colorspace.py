"""sRGB <-> CIELAB conversion (D65), numpy.

The port's copy of ``gantrack_tpu/utils/colorspace.py``, kept equal to
it (``tests/test_torch_i2i.py``).

Capability parity with the ``skimage.color.rgb2lab`` / ``lab2rgb`` calls
the reference colorization pipeline depends on
(``pytorch-CycleGAN-and-pix2pix/data/colorization_dataset.py:35-40``,
``models/colorization_model.py:48-63``) — scikit-image is not a dependency,
and the conversion is ~30 lines of closed-form
numpy, so it is implemented directly.  Constants are the standard
sRGB/D65 ones (identical to skimage's ``xyz_from_rgb`` matrix and
D65 illuminant), so outputs match skimage to float precision.
"""

from __future__ import annotations

import numpy as np

# sRGB (linear) -> XYZ, D65 observer (ITU-R BT.709 primaries).
_XYZ_FROM_RGB = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float64,
)
_RGB_FROM_XYZ = np.linalg.inv(_XYZ_FROM_RGB)
# D65 reference white in XYZ (normalised Y=1).
_D65 = np.array([0.95047, 1.0, 1.08883], dtype=np.float64)
_EPS = (6.0 / 29.0) ** 3
_KAPPA = (29.0 / 6.0) ** 2 / 3.0  # == 1/(3*(6/29)^2)


def _srgb_decode(c: np.ndarray) -> np.ndarray:
    return np.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)


def _srgb_encode(c: np.ndarray) -> np.ndarray:
    c = np.clip(c, 0.0, 1.0)
    return np.where(c > 0.0031308, 1.055 * c ** (1 / 2.4) - 0.055, 12.92 * c)


def rgb2lab(rgb: np.ndarray) -> np.ndarray:
    """``[..., 3]`` sRGB in [0, 1] (or uint8 0..255) -> CIELAB ``[..., 3]``
    with L in [0, 100], a/b roughly [-110, 110]."""
    rgb = np.asarray(rgb)
    if rgb.dtype == np.uint8:
        rgb = rgb.astype(np.float64) / 255.0
    rgb = rgb.astype(np.float64)
    xyz = _srgb_decode(rgb) @ _XYZ_FROM_RGB.T
    t = xyz / _D65
    f = np.where(t > _EPS, np.cbrt(t), _KAPPA * t + 4.0 / 29.0)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return np.stack([L, a, b], axis=-1)


def lab2rgb(lab: np.ndarray) -> np.ndarray:
    """CIELAB ``[..., 3]`` -> sRGB ``[..., 3]`` in [0, 1] (gamut-clipped)."""
    lab = np.asarray(lab, dtype=np.float64)
    fy = (lab[..., 0] + 16.0) / 116.0
    fx = fy + lab[..., 1] / 500.0
    fz = fy - lab[..., 2] / 200.0
    f = np.stack([fx, fy, fz], axis=-1)
    t = np.where(f > 6.0 / 29.0, f**3, (f - 4.0 / 29.0) / _KAPPA)
    xyz = t * _D65
    rgb = xyz @ _RGB_FROM_XYZ.T
    return _srgb_encode(rgb)
