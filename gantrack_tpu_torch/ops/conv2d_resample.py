"""2D convolution with optional FIR up/downsampling (NCHW / OIHW).

Port of ``gantrack_tpu/ops/conv2d_resample.py``.  Same padding rules
("performed once at the beginning, w.r.t. the upsampled image") and the
same order of operations; the JAX module's ``lhs_dilation`` conv over
the zero-inserted input is computed here as a stride-``up``
``conv_transpose2d`` (identical numbers, without multiplying zeros).

``conv_impl`` chooses who runs the dense 3×3 stride-1 convolution of the
plain branch: ``"library"`` (the default: cuDNN through
``conv2d_gradfix``) or ``"kernel"`` (:func:`.conv3x3.conv3x3`, the
hand-written implicit-GEMM kernels, differentiable to every order through
themselves).  Every other convolution (1×1, strided, transposed, grouped,
asymmetric padding) is another function and stays on the library, counted
by reason as ``conv3x3.library_route/<why>`` (:mod:`..utils.profiling`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import conv2d_gradfix, conv3x3
from .upfirdn2d import Filter, _get_filter_size, _parse_padding, upfirdn2d

__all__ = ["conv2d_resample"]


CONV_IMPLS = ("library", "kernel")


def _conv2d(x, w, stride: int = 1, padding=(0, 0, 0, 0), groups: int = 1,
            flip_weight: bool = True, conv_impl: str = "library"):
    """Dense NCHW/OIHW conv; ``padding`` is ``[px0, px1, py0, py1]``.
    ``flip_weight=True`` = cross-correlation, ``False`` = convolution."""
    if not flip_weight and w.shape[2] * w.shape[3] > 1:
        w = w.flip([2, 3])
    if conv_impl == "kernel":
        why = conv3x3.library_reason(x.shape, w.shape, x.dtype, 1, stride, padding, groups)
        if why is None:
            return conv3x3.conv3x3(x, w)
        conv3x3.count_library_route(why)
    px0, px1, py0, py1 = padding
    if px0 == px1 and py0 == py1:
        return conv2d_gradfix.conv2d(x, w.to(x.dtype), stride=stride, padding=(py0, px0),
                                     groups=groups)
    x = F.pad(x, [px0, px1, py0, py1])
    return conv2d_gradfix.conv2d(x, w.to(x.dtype), stride=stride, groups=groups)


def _conv2d_up(x, w, up: int, padding, groups: int, flip_weight: bool):
    """Conv over the ``up``-times zero-inserted input, padded by
    ``[px0, px1, py0, py1]`` (the JAX ``lhs_dilation`` conv)."""
    kh, kw = int(w.shape[2]), int(w.shape[3])
    # conv_transpose applies its weight as a true convolution: hand it the
    # flipped correlation weight, in [in, out/groups, kh, kw] layout.
    if flip_weight:
        w = w.flip([2, 3])
    o, i = int(w.shape[0]), int(w.shape[1])
    w = w.reshape(groups, o // groups, i, kh, kw).transpose(1, 2)
    w = w.reshape(groups * i, o // groups, kh, kw)
    full = conv2d_gradfix.conv_transpose2d(x, w.to(x.dtype), stride=up, groups=groups)
    px0, px1, py0, py1 = padding
    # ``full`` starts k-1 samples before the zero-inserted grid's origin.
    return F.pad(full, [px0 - (kw - 1), up + px1 - kw, py0 - (kh - 1), up + py1 - kh])


def conv2d_resample(
    x: torch.Tensor,
    w: torch.Tensor,
    f: Optional[Filter] = None,
    up: int = 1,
    down: int = 1,
    padding=0,
    groups: int = 1,
    flip_weight: bool = True,
    flip_filter: bool = False,
    conv_impl: str = "library",
) -> torch.Tensor:
    """Convolve ``[N, I, H, W]`` by ``[O, I//groups, kh, kw]`` with optional
    FIR-filtered up/downsampling (see the JAX module for the contract).
    ``f`` is an :class:`.upfirdn2d.Filter` (or what :func:`.upfirdn2d.upfirdn2d`
    takes); ``conv_impl`` is ``"library"`` or ``"kernel"`` (see the module)."""
    assert x.ndim == 4 and w.ndim == 4
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, got {conv_impl!r}")
    kh, kw = int(w.shape[2]), int(w.shape[3])
    fw, fh = _get_filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)

    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2
    pad = [px0, px1, py0, py1]

    if kw == 1 and kh == 1 and down > 1 and up == 1:
        x = upfirdn2d(x, f, down=down, padding=pad, flip_filter=flip_filter)
        return _conv2d(x, w, groups=groups, flip_weight=flip_weight, conv_impl=conv_impl)

    if kw == 1 and kh == 1 and up > 1 and down == 1:
        x = _conv2d(x, w, groups=groups, flip_weight=flip_weight, conv_impl=conv_impl)
        return upfirdn2d(x, f, up=up, padding=pad, gain=up**2, flip_filter=flip_filter)

    if down > 1 and up == 1:
        x = upfirdn2d(x, f, padding=pad, flip_filter=flip_filter)
        return _conv2d(x, w, stride=down, groups=groups, flip_weight=flip_weight,
                       conv_impl=conv_impl)

    if up > 1:
        if conv_impl == "kernel":
            conv3x3.count_library_route(f"up={up}, down={down}")
        x = _conv2d_up(x, w, up, pad, groups, flip_weight)
        x = upfirdn2d(x, f, gain=up**2, flip_filter=flip_filter)
        if down > 1:
            x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
        return x

    return _conv2d(x, w, padding=pad, groups=groups, flip_weight=flip_weight,
                   conv_impl=conv_impl)
