"""Filtered leaky ReLU, the StyleGAN3 anti-aliased nonlinearity.

Port of ``gantrack_tpu/ops/filtered_lrelu.py``: bias → ×up zero-insert
upsample → pad → FIR ``fu`` (gain ``up**2``) → gain·leaky-ReLU → clamp →
FIR ``fd`` → keep every ``down``-th sample, on NCHW tensors.

It is composed from the port's ops, as the JAX function is composed from
XLA ops (it is no Pallas kernel there): the two FIR passes go through
:func:`.upfirdn2d.upfirdn2d`, so a pass with a separable filter of at
most 32 taps and a factor of 1, 2 or 4, or a radial (2-D) one of at most
12 x 12 taps at ↓2, launches the FIR kernels on the card; any other takes
the plain version (counted as ``upfirdn2d.plain_route/<why>``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .bias_act import bias_act
from .upfirdn2d import Filter, _get_filter_size, _parse_padding, upfirdn2d

__all__ = ["filtered_lrelu"]


def filtered_lrelu(
    x: torch.Tensor,
    fu: Optional[Filter] = None,
    fd: Optional[Filter] = None,
    b: Optional[torch.Tensor] = None,
    up: int = 1,
    down: int = 1,
    padding=0,
    gain: float = float(np.sqrt(2)),
    slope: float = 0.2,
    clamp: Optional[float] = None,
) -> torch.Tensor:
    """Apply the filtered leaky ReLU to ``x [N, C, H, W]``.

    ``fu`` / ``fd`` are the upsampling / downsampling FIR filters
    (:class:`.upfirdn2d.Filter`; None for identity); ``b`` an optional
    ``[C]`` bias; ``padding`` is relative to the upsampled image, negative
    crops.
    """
    assert x.ndim == 4
    fu_w, fu_h = _get_filter_size(fu)
    fd_w, fd_h = _get_filter_size(fd)
    px0, px1, py0, py1 = _parse_padding(padding)
    assert up >= 1 and down >= 1
    assert slope >= 0

    in_h, in_w = x.shape[2], x.shape[3]
    out_w = (in_w * up + (px0 + px1) - (fu_w - 1) - (fd_w - 1) + (down - 1)) // down
    out_h = (in_h * up + (py0 + py1) - (fu_h - 1) - (fd_h - 1) + (down - 1)) // down

    x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=[px0, px1, py0, py1], gain=up ** 2)
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    x = upfirdn2d(x, fd, down=down)

    assert x.shape[2] == out_h and x.shape[3] == out_w, (tuple(x.shape), out_h, out_w)
    return x
