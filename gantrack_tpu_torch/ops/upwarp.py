"""Fused ×2 FIR upsample + affine bilinear warp, and its adjoint.

Port of ``gantrack_tpu/ops/pallas/upwarp.py``.  ``up_affine_warp``
computes ``grid_sample(upsample2d(img, fir, up=2), affine_grid(theta))``
(bilinear, zeros padding, align_corners=False) for the ADA geometric
augmentation.

* On a CUDA tensor it launches the hand-written kernels of
  ``csrc/upwarp.cu``: K1 (:class:`UpWarp`) never builds the 2x canvas (a
  block stages the box of the input its output tile weighs in shared
  memory); K2 (:class:`UpSplat`) is its exact adjoint, one deterministic
  gather kernel that builds each tile's part of the 2x canvas in shared
  memory.  Each is the other's backward, so autograd closes to any order.
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
import functools
from typing import Optional, Sequence, Tuple

import torch

from ._nvcc import check_coeffs as _check_coeffs
from ._nvcc import check_planes as _check_planes
from ._nvcc import check_rc as _check_rc
from ._nvcc import load_library
from .grid_sample import bilinear_gather, sample_positions, warp_coefficients
from .upfirdn2d import upfirdn2d_plain, upsample2d_args

__all__ = ["up_affine_warp", "up_affine_warp_plain", "warp_coefficients", "upwarp_planes",
           "upwarp_blocks", "upsplat_planes", "upsplat_blocks", "UpWarp", "UpSplat", "LAUNCHES"]

NUM_TAPS = 12
# Kernel launches per wrapper; bumped only where a kernel is launched.
LAUNCHES = {"upwarp": 0, "upsplat": 0}


def _lib() -> ctypes.CDLL:
    lib = load_library("upwarp.cu")
    if not getattr(lib, "_gantrack_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gantrack_upwarp.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p]
        lib.gantrack_upwarp.restype = i
        lib.gantrack_upwarp_blocks.argtypes = [i, i, i]
        lib.gantrack_upwarp_blocks.restype = ctypes.c_longlong
        lib.gantrack_upsplat.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p]
        lib.gantrack_upsplat.restype = i
        lib.gantrack_upsplat_blocks.argtypes = [i, i, i]
        lib.gantrack_upsplat_blocks.restype = ctypes.c_longlong
        lib._gantrack_typed = True
    return lib


@functools.lru_cache(maxsize=64)
def _fir_array(taps: Tuple[float, ...]):
    if len(taps) != NUM_TAPS:
        raise ValueError(f"the upwarp kernels take a {NUM_TAPS}-tap FIR, got {len(taps)}")
    return (ctypes.c_float * NUM_TAPS)(*taps)


def _counter_ptr(counter: Optional[torch.Tensor], like: torch.Tensor, name: str):
    """The device pointer of an optional one-element int32 block counter."""
    if counter is None:
        return None
    if counter.device != like.device or counter.dtype != torch.int32:
        raise ValueError(f"{name} must be an int32 tensor on the planes' device")
    return counter.data_ptr()


def upwarp_planes(planes: torch.Tensor, coeffs: torch.Tensor, taps: Tuple[float, ...],
                  out_h: int, out_w: int,
                  direct_blocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: ``[P, H1, W1]`` → ``[P, out_h, out_w]`` in the input's dtype.

    ``direct_blocks``, a one-element int32 tensor on the card, counts the
    blocks whose input box did not fit the shared buffer and took the
    direct gather (of :func:`upwarp_blocks` blocks)."""
    _check_planes(planes, "planes")
    _check_coeffs(coeffs, planes)
    counter = _counter_ptr(direct_blocks, planes, "direct_blocks")
    p, h1, w1 = planes.shape
    out = torch.empty((p, out_h, out_w), dtype=planes.dtype, device=planes.device)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().gantrack_upwarp(
            planes.data_ptr(), coeffs.data_ptr(), out.data_ptr(), p, h1, w1, out_h, out_w,
            int(planes.dtype == torch.bfloat16), _fir_array(taps), counter, stream)
    _check_rc(rc, "upwarp kernel")
    LAUNCHES["upwarp"] += 1
    return out


def upwarp_blocks(planes: int, out_h: int, out_w: int) -> int:
    """The number of blocks K1 launches for ``planes`` planes of
    ``out_h × out_w`` outputs."""
    return int(_lib().gantrack_upwarp_blocks(planes, out_h, out_w))


def upsplat_planes(g: torch.Tensor, coeffs: torch.Tensor, taps: Tuple[float, ...],
                   h1: int, w1: int, global_blocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2, the adjoint of K1: ``[P, out_h, out_w]`` → ``[P, h1, w1]`` in
    g's dtype, summed in float32, one launch.

    ``global_blocks``, a one-element int32 tensor on the card, counts the
    blocks whose cotangent box did not fit shared memory and were read
    from device memory (of :func:`upsplat_blocks` blocks)."""
    _check_planes(g, "g")
    _check_coeffs(coeffs, g)
    counter = _counter_ptr(global_blocks, g, "global_blocks")
    p, out_h, out_w = g.shape
    out = torch.empty((p, h1, w1), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().gantrack_upsplat(
            g.data_ptr(), coeffs.data_ptr(), out.data_ptr(), p, h1, w1, out_h, out_w,
            int(g.dtype == torch.bfloat16), _fir_array(taps), counter, stream)
    _check_rc(rc, "upsplat kernel")
    LAUNCHES["upsplat"] += 1
    return out


def upsplat_blocks(planes: int, h1: int, w1: int) -> int:
    """The number of blocks K2 launches for ``planes`` planes of
    ``h1 × w1`` outputs."""
    return int(_lib().gantrack_upsplat_blocks(planes, h1, w1))


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
