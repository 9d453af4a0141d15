"""Fused ×2 FIR upsample + affine bilinear warp, and its adjoint.

Port of ``gantrack_tpu/ops/pallas/upwarp.py``.  ``up_affine_warp``
computes ``grid_sample(upsample2d(img, fir, up=2), affine_grid(theta))``
(bilinear, zeros padding, align_corners=False) for the ADA geometric
augmentation.

* On a CUDA tensor it launches the hand-written kernels of
  ``csrc/upwarp.cu``: K1 (:class:`UpWarp`) never builds the 2x canvas; K2
  (:class:`UpSplat`) is its exact adjoint, written as a deterministic
  gather.  Each is the other's backward, so autograd closes to any order.
* On a CPU tensor it runs the plain version: the plain ``upsample2d``
  followed by the gather sampler of :mod:`.grid_sample`, which autograd
  differentiates to any order.

Both sample at the same positions: the 2x-canvas position of output
pixel (ox, oy) is ``(ax*ox + bx*oy) + cx`` (y likewise) from six float32
coefficients built on the device from ``theta``, with the algebra of the
JAX wrapper.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ._nvcc import check_coeffs as _check_coeffs
from ._nvcc import check_planes as _check_planes
from ._nvcc import check_rc as _check_rc
from ._nvcc import load_library
from .grid_sample import bilinear_gather, sample_positions, warp_coefficients
from .upfirdn2d import upfirdn2d_plain, upsample2d_args

__all__ = ["up_affine_warp", "up_affine_warp_plain", "warp_coefficients",
           "UpWarp", "UpSplat", "LAUNCHES"]

NUM_TAPS = 12
# Kernel launches per wrapper; bumped only where a kernel is launched.
LAUNCHES = {"upwarp": 0, "upsplat": 0}


def _lib() -> ctypes.CDLL:
    lib = load_library("upwarp.cu")
    if not getattr(lib, "_gantrack_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gantrack_upwarp.argtypes = [p, p, p, i, i, i, i, i, i, p, p]
        lib.gantrack_upwarp.restype = i
        lib.gantrack_upsplat.argtypes = [p, p, p, p, i, i, i, i, i, i, p, p]
        lib.gantrack_upsplat.restype = i
        lib._gantrack_typed = True
    return lib


def _fir_array(taps: Tuple[float, ...]):
    if len(taps) != NUM_TAPS:
        raise ValueError(f"the upwarp kernels take a {NUM_TAPS}-tap FIR, got {len(taps)}")
    return (ctypes.c_float * NUM_TAPS)(*taps)


def upwarp_planes(planes: torch.Tensor, coeffs: torch.Tensor, taps: Tuple[float, ...],
                  out_h: int, out_w: int) -> torch.Tensor:
    """K1: ``[P, H1, W1]`` → ``[P, out_h, out_w]`` in the input's dtype."""
    _check_planes(planes, "planes")
    _check_coeffs(coeffs, planes)
    p, h1, w1 = planes.shape
    out = torch.empty((p, out_h, out_w), dtype=planes.dtype, device=planes.device)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().gantrack_upwarp(
            planes.data_ptr(), coeffs.data_ptr(), out.data_ptr(), p, h1, w1, out_h, out_w,
            int(planes.dtype == torch.bfloat16), _fir_array(taps), stream)
    _check_rc(rc, "upwarp kernel")
    LAUNCHES["upwarp"] += 1
    return out


def upsplat_planes(g: torch.Tensor, coeffs: torch.Tensor, taps: Tuple[float, ...],
                   h1: int, w1: int) -> torch.Tensor:
    """K2, the adjoint of K1: ``[P, out_h, out_w]`` → ``[P, h1, w1]`` in
    g's dtype, summed in float32 through a ``[P, 2h1, 2w1]`` f32 scratch."""
    _check_planes(g, "g")
    _check_coeffs(coeffs, g)
    p, out_h, out_w = g.shape
    canvas = torch.empty((p, 2 * h1, 2 * w1), dtype=torch.float32, device=g.device)
    out = torch.empty((p, h1, w1), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().gantrack_upsplat(
            g.data_ptr(), coeffs.data_ptr(), canvas.data_ptr(), out.data_ptr(), p, h1, w1,
            out_h, out_w, int(g.dtype == torch.bfloat16), _fir_array(taps), stream)
    _check_rc(rc, "upsplat kernel")
    LAUNCHES["upsplat"] += 1
    return out


class UpWarp(torch.autograd.Function):
    """K1 with K2 as its backward (zero gradient for the coefficients,
    as the JAX custom VJP returns)."""

    @staticmethod
    def forward(ctx, planes, coeffs, taps, out_h, out_w):
        ctx.save_for_backward(coeffs)
        ctx.taps = taps
        ctx.in_hw = (planes.shape[1], planes.shape[2])
        return upwarp_planes(planes, coeffs, taps, out_h, out_w)

    @staticmethod
    def backward(ctx, g):
        (coeffs,) = ctx.saved_tensors
        h1, w1 = ctx.in_hw
        return UpSplat.apply(g.contiguous(), coeffs, ctx.taps, h1, w1), None, None, None, None


class UpSplat(torch.autograd.Function):
    """K2 with K1 as its backward."""

    @staticmethod
    def forward(ctx, g, coeffs, taps, h1, w1):
        ctx.save_for_backward(coeffs)
        ctx.taps = taps
        ctx.out_hw = (g.shape[1], g.shape[2])
        return upsplat_planes(g, coeffs, taps, h1, w1)

    @staticmethod
    def backward(ctx, gg):
        (coeffs,) = ctx.saved_tensors
        out_h, out_w = ctx.out_hw
        return UpWarp.apply(gg.contiguous(), coeffs, ctx.taps, out_h, out_w), None, None, None, None


def up_affine_warp_plain(img: torch.Tensor, coeffs: torch.Tensor, fir: torch.Tensor,
                         out_h: int, out_w: int) -> torch.Tensor:
    """Plain PyTorch version: the plain ``upsample2d`` (never the FIR
    kernel), then the gather sampler."""
    up = upfirdn2d_plain(img, fir, **upsample2d_args(fir, 2))
    fx, fy = sample_positions(coeffs, out_h, out_w)
    return bilinear_gather(up, fx, fy)


def up_affine_warp(img: torch.Tensor, theta: torch.Tensor, fir: Sequence[float],
                   out_h: int, out_w: int) -> torch.Tensor:
    """Warp ``img [N, C, H1, W1]`` (1x, already reflect-padded) by
    ``theta [N, 2, 3]``, the normalised inverse transform of the virtual
    2x image, with the ``fir`` taps as the upsampling filter.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernels (or raises).
    """
    n, ch, h1, w1 = img.shape
    taps = tuple(float(v) for v in fir)
    coeffs = warp_coefficients(theta.to(img.device), 2 * h1, 2 * w1, out_h, out_w)
    if img.device.type == "cpu":
        fir_t = torch.tensor(taps, dtype=torch.float32)
        return up_affine_warp_plain(img, coeffs, fir_t, out_h, out_w)
    dt = img.dtype if img.dtype in (torch.bfloat16, torch.float32) else torch.float32
    planes = img.reshape(n * ch, h1, w1).to(dt).contiguous()
    coeffs_planes = coeffs.repeat_interleave(ch, dim=0).contiguous()
    out = UpWarp.apply(planes, coeffs_planes, taps, out_h, out_w)
    return out.reshape(n, ch, out_h, out_w).to(img.dtype)
