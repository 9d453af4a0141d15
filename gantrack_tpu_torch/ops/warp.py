"""Affine bilinear warp, and its adjoint splat.

Port of ``gantrack_tpu/ops/pallas/warp.py``.  ``affine_warp`` computes
``grid_sample(img, affine_grid(theta, out_h, out_w))`` (bilinear, zeros
padding, align_corners=False): the warp of the ADA augmentation's
unfused chain and of the equivariance metrics.

* On a CUDA tensor it launches the hand-written kernels of
  ``csrc/warp.cu``: K3 (:class:`Warp`) samples four taps an output
  pixel; K4 (:class:`Splat`) is its exact adjoint, written as a
  deterministic gather.  Each is the other's backward (zero gradient for
  the coefficients, as the JAX custom VJP returns), so autograd closes to
  any order.  There is no source window: no transform loses taps.
* On a CPU tensor it runs :func:`affine_warp_plain`, the gather sampler
  of :mod:`.grid_sample`, which autograd differentiates to any order.
* Each kernel launch counts ``warp.launch/warp`` or ``warp.launch/splat``
  in the installed recorder (:mod:`..utils.profiling`).

Both sample at the same positions: the source position of output pixel
(ox, oy) is ``(ax*ox + bx*oy) + cx`` (y likewise) from six float32
coefficients built on the device from ``theta``
(:func:`.grid_sample.warp_coefficients`, the algebra of the JAX wrapper).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils import profiling
from ._nvcc import check_coeffs, check_planes, check_rc, load_library
from .grid_sample import bilinear_gather, sample_positions, warp_coefficients

__all__ = ["affine_warp", "affine_warp_plain", "warp_planes", "splat_planes",
           "Warp", "Splat"]

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The built ``warp.cu``, its entry points typed; kept after the first
    call, so a launch looks nothing up."""
    global _LIB
    if _LIB is None:
        lib = load_library("warp.cu")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.gantrack_warp, lib.gantrack_splat):
            fn.argtypes = [p, p, p, i, i, i, i, i, i, p]
            fn.restype = i
        _LIB = lib
    return _LIB


def _launch(name: str, src: torch.Tensor, coeffs: torch.Tensor, h: int, w: int,
            out_h: int, out_w: int, out_hw) -> torch.Tensor:
    """Launch K3 (``warp``: src is the ``[P, h, w]`` image) or K4
    (``splat``: src is the ``[P, out_h, out_w]`` cotangent) on the current
    stream of src's device."""
    check_planes(src, name)
    check_coeffs(coeffs, src)
    p = src.shape[0]
    if p == 0 or min(h, w, out_h, out_w) < 1:
        raise ValueError(f"{name}: empty planes ({p} x {h} x {w} -> {out_h} x {out_w})")
    lib = _lib()
    fn = lib.gantrack_warp if name == "warp" else lib.gantrack_splat
    out = torch.empty((p, *out_hw), dtype=src.dtype, device=src.device)
    dev = src.device.index
    args = (src.data_ptr(), coeffs.data_ptr(), out.data_ptr(), p, h, w, out_h, out_w,
            int(src.dtype == torch.bfloat16), torch._C._cuda_getCurrentRawStream(dev))
    if dev == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args)
    check_rc(rc, f"{name} kernel")
    profiling.count(f"warp.launch/{name}")
    return out


def warp_planes(planes: torch.Tensor, coeffs: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """K3: ``[P, H, W]`` → ``[P, out_h, out_w]`` in the input's dtype."""
    _, h, w = planes.shape
    return _launch("warp", planes, coeffs, h, w, out_h, out_w, (out_h, out_w))


def splat_planes(g: torch.Tensor, coeffs: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """K4, the adjoint of K3: ``[P, out_h, out_w]`` → ``[P, h, w]`` in g's
    dtype; every pixel's sum runs in float32 and is rounded once."""
    _, out_h, out_w = g.shape
    return _launch("splat", g, coeffs, h, w, out_h, out_w, (h, w))


class Warp(torch.autograd.Function):
    """K3 with K4 as its backward."""

    @staticmethod
    def forward(ctx, planes, coeffs, out_h, out_w):
        ctx.save_for_backward(coeffs)
        ctx.in_hw = (planes.shape[1], planes.shape[2])
        return warp_planes(planes, coeffs, out_h, out_w)

    @staticmethod
    def backward(ctx, g):
        (coeffs,) = ctx.saved_tensors
        return Splat.apply(g.contiguous(), coeffs, *ctx.in_hw), None, None, None


class Splat(torch.autograd.Function):
    """K4 with K3 as its backward."""

    @staticmethod
    def forward(ctx, g, coeffs, h, w):
        ctx.save_for_backward(coeffs)
        ctx.out_hw = (g.shape[1], g.shape[2])
        return splat_planes(g, coeffs, h, w)

    @staticmethod
    def backward(ctx, gg):
        (coeffs,) = ctx.saved_tensors
        return Warp.apply(gg.contiguous(), coeffs, *ctx.out_hw), None, None, None


def affine_warp_plain(img: torch.Tensor, coeffs: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Plain PyTorch version: ``img [N, C, H, W]`` sampled by the gather
    sampler at the positions of ``coeffs [N, 6]``."""
    fx, fy = sample_positions(coeffs, out_h, out_w)
    return bilinear_gather(img, fx, fy)


def affine_warp(img: torch.Tensor, theta: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Warp ``img [N, C, H, W]`` by ``theta [N, 2, 3]``, the normalised
    inverse transform (the ``grid_sample`` convention), to
    ``[N, C, out_h, out_w]``.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernels (or raises).
    """
    n, ch, h, w = img.shape
    coeffs = warp_coefficients(theta.to(img.device), h, w, out_h, out_w)
    if img.device.type == "cpu":
        return affine_warp_plain(img, coeffs, out_h, out_w)
    dt = img.dtype if img.dtype in (torch.bfloat16, torch.float32) else torch.float32
    planes = img.reshape(n * ch, h, w).to(dt).contiguous()
    coeffs_planes = coeffs if ch == 1 else coeffs.repeat_interleave(ch, dim=0)
    out = Warp.apply(planes, coeffs_planes, out_h, out_w)
    return out.reshape(n, ch, out_h, out_w).to(img.dtype)
