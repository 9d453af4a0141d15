"""Style-modulated convolution (NCHW / OIHW).

Port of ``gantrack_tpu/ops/modulated_conv2d.py``: modulation,
demodulation ``rsqrt(sum(w^2) + 1e-8)`` with float32 statistics (float64
when the styles are float64, as in JAX), the
unfused default ("scale activations, one shared-weight conv") and the
fused grouped path.  The reduced-precision blocks run in bfloat16, so
NVIDIA's fp16 overflow pre-normalisation is not needed.
"""

from __future__ import annotations

from typing import Optional

import torch

from .conv2d_resample import conv2d_resample
from .upfirdn2d import Filter

__all__ = ["modulated_conv2d"]


def modulated_conv2d(
    x: torch.Tensor,                     # [N, I, H, W]
    weight: torch.Tensor,                # [O, I, kh, kw]
    styles: torch.Tensor,                # [N, I]
    noise: Optional[torch.Tensor] = None,  # broadcastable to [N, O, H', W']
    up: int = 1,
    down: int = 1,
    padding: int = 0,
    resample_filter: Optional[Filter] = None,
    demodulate: bool = True,
    flip_weight: bool = True,
    fused_modconv: bool = False,
    conv_impl: str = "library",        # conv2d_resample's: "library" or "kernel"
) -> torch.Tensor:
    batch = x.shape[0]
    out_ch, in_ch, kh, kw = weight.shape
    assert styles.shape == (batch, in_ch), (tuple(styles.shape), (batch, in_ch))

    dcoefs = None
    if demodulate or fused_modconv:
        hi = torch.float64 if styles.dtype == torch.float64 else torch.float32
        w = weight[None].to(hi) * styles[:, None, :, None, None].to(hi)  # [N,O,I,kh,kw]
    if demodulate:
        dcoefs = torch.rsqrt(w.square().sum(dim=[2, 3, 4]) + 1e-8)  # [N, O]

    if not fused_modconv:
        x = x * styles[:, :, None, None].to(x.dtype)
        x = conv2d_resample(x, weight.to(x.dtype), f=resample_filter, up=up, down=down,
                            padding=padding, flip_weight=flip_weight, conv_impl=conv_impl)
        if demodulate:
            x = x * dcoefs[:, :, None, None].to(x.dtype)
        if noise is not None:
            x = x + noise.to(x.dtype)
        return x

    if demodulate:
        w = w * dcoefs[:, :, None, None, None]
    w = w.to(x.dtype).reshape(batch * out_ch, in_ch, kh, kw)
    xg = x.reshape(1, batch * in_ch, *x.shape[2:])
    xg = conv2d_resample(xg, w, f=resample_filter, up=up, down=down, padding=padding,
                         groups=batch, flip_weight=flip_weight, conv_impl=conv_impl)
    x = xg.reshape(batch, out_ch, *xg.shape[2:])
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x
