"""Least time of one call of the program's FIR kernels (K5–K7).

A pure function of the call's spec (its form, taps and pads), planes
shape and dtype, with the arithmetic of the kernels' bound in the
program's chip checks: the input planes read once and the output planes
written once over the memory rate, or a separable pass of ``ky`` then
``kx`` taps an output (half of them for the polyphase ×2 up-filter), 2
operations a tap, over float32's rate, whichever is larger.
"""

from __future__ import annotations

from typing import Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def out_size(form: str, n: int, k: int, p0: int, p1: int) -> int:
    if form == "down2":
        return (n + p0 + p1 - k) // 2 + 1
    if form == "up2":
        return 2 * n + p0 + p1 - k + 1
    return n + p0 + p1 - k + 1


def least_seconds(form: str, taps: Tuple[int, int], pads: Sequence[int],
                  shape: Sequence[int], dtype: str) -> float:
    """``taps``: (taps in y, taps in x); ``pads``: (py0, py1, px0, px1);
    ``shape``: the input planes ``[P, H, W]``."""
    p, h, w = shape
    ky, kx = taps
    oh = out_size(form, h, ky, pads[0], pads[1])
    ow = out_size(form, w, kx, pads[2], pads[3])
    nbytes = (p * h * w + p * oh * ow) * ITEMSIZE[dtype]
    flops = p * oh * ow * 2 * (ky + kx) / (2 if form == "up2" else 1)
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
