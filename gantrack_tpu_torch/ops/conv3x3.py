"""3×3 stride-1 SAME convolution as an implicit GEMM, and its weight gradient.

Port of ``gantrack_tpu/ops/attic/conv3x3.py`` (kernels K8 and K9) in the
port's layout: ``x [N, Ci, H, W]``, ``w [Co, Ci, 3, 3]`` (NCHW / OIHW).

* ``conv3x3(x, w)`` is ``F.conv2d(x, w, padding=1)`` and ``wgrad3x3(x, g)``
  is its weight gradient ``dw[co,ci,dy,dx] = Σ xpad[n,ci,y+dy,x+dx] ·
  g[n,co,y,x]``.  ``w`` and ``g`` are cast to ``x.dtype``; sums run in
  float32 and are rounded once to ``x.dtype``.
* On a CUDA tensor they launch the hand-written kernels of
  ``csrc/conv3x3.cu``: bfloat16 through the tensor cores (``mma.sync``),
  float32 in full float32 on the CUDA cores (never TF32).  K9 is a split
  reduction without atomics, so it is bitwise deterministic.  On a CPU
  tensor they run :func:`conv3x3_plain` / :func:`wgrad3x3_plain`.
* Both are ``torch.autograd.Function``s that close on each other, as the
  JAX primitives' JVP and transpose rules do: the conv's backward is
  ``conv3x3(g, flip_t(w))`` and ``wgrad3x3(x, g)``; the weight gradient's
  backward is ``conv3x3(g, flip_t(ggw))`` and ``conv3x3(x, ggw)``.  So R1
  and the path-length penalty differentiate twice without leaving the
  kernels.

The contract (:func:`supported`) is wider than the JAX kernel's: any
``N, Ci, Co, H, W ≥ 1`` in bfloat16 or float32 (the width fold, the 128-lane
rows and the VMEM budget were the TPU's).  Outside it the wrappers raise.
``LAUNCHES`` counts kernel launches; ``LIBRARY_ROUTE`` counts, by reason, the
calls of ``conv2d_resample(conv_impl="kernel")`` that are another function
than a dense 3×3 stride-1 convolution and therefore stayed on the library
convolution.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from . import conv2d_gradfix
from ._nvcc import check_rc, load_library

__all__ = ["conv3x3", "wgrad3x3", "supported", "conv3x3_plain", "wgrad3x3_plain",
           "library_reason", "count_library_route", "LAUNCHES", "LIBRARY_ROUTE"]

# Kernel launches per wrapper; bumped only where a kernel is launched.
LAUNCHES = {"conv3x3": 0, "wgrad3x3": 0}
# ``conv2d_resample(conv_impl="kernel")`` calls outside the kernels'
# contract, which took the library convolution: {why: calls}.
LIBRARY_ROUTE: Dict[str, int] = {}

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_INT_MAX = 2**31 - 1
# K9 cuts its reduction over N*H*W into at most this many blocks in all;
# a constant, so the order of the sums does not depend on the device.
_WGRAD_TARGET_BLOCKS = 1024


def supported(x_shape: Sequence[int], w_shape: Sequence[int], dtype) -> bool:
    """Whether the kernels take ``x_shape [N, Ci, H, W]`` with ``w_shape
    [Co, Ci, 3, 3]`` in ``dtype``."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    n, ci, h, w = (int(v) for v in x_shape)
    co, wci, kh, kw = (int(v) for v in w_shape)
    if (kh, kw) != (3, 3) or wci != ci:
        return False
    if dtype not in _KERNEL_DTYPES:
        return False
    if min(n, ci, co, h, w) < 1:
        return False
    return h * w <= _INT_MAX and 9 * co * ci <= _INT_MAX and n * h * w <= _INT_MAX


def library_reason(x_shape, w_shape, dtype, up: int, down: int, padding, groups: int
                   ) -> Optional[str]:
    """Why a ``conv2d_resample`` call is not this module's function (it
    then stays on the library convolution), or None when it is.  Decided
    from the static spec alone; ``padding`` is ``[px0, px1, py0, py1]``."""
    kh, kw = int(w_shape[2]), int(w_shape[3])
    if up != 1 or down != 1:
        return f"up={up}, down={down}"
    if (kh, kw) != (3, 3):
        return f"{kh}x{kw} kernel"
    if groups != 1:
        return f"groups={groups}"
    if list(padding) != [1, 1, 1, 1]:
        return f"padding={list(padding)}"
    if not supported(x_shape, w_shape, dtype):
        return f"x {tuple(x_shape)}, w {tuple(w_shape)}, {dtype}: outside supported()"
    return None


def count_library_route(why: str) -> None:
    """Count one ``conv_impl="kernel"`` call that stayed on the library."""
    LIBRARY_ROUTE[why] = LIBRARY_ROUTE.get(why, 0) + 1


def _flip_t(w: torch.Tensor) -> torch.Tensor:
    """Spatial flip and ci↔co transpose: the weights of the input gradient."""
    return w.flip([2, 3]).transpose(0, 1)


def _sum_dtype(dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K8: the library convolution with float32
    sums and one rounding (through ``conv2d_gradfix``, whose numbers are
    ``F.conv2d``'s and whose second differentiation is affordable)."""
    dt = _sum_dtype(x.dtype)
    return conv2d_gradfix.conv2d(x.to(dt), w.to(dt), padding=1).to(x.dtype)


def wgrad3x3_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K9: nine shifted products over the padded
    image, float32 sums, one rounding."""
    dt = _sum_dtype(x.dtype)
    h, w = x.shape[2], x.shape[3]
    xp = F.pad(x.to(dt), [1, 1, 1, 1])
    g = g.to(dt)
    taps = [torch.einsum("nchw,nohw->oc", xp[:, :, dy:dy + h, dx:dx + w], g)
            for dy in range(3) for dx in range(3)]
    return torch.stack(taps, dim=-1).reshape(g.shape[1], x.shape[1], 3, 3).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = load_library("conv3x3.cu")
    if not getattr(lib, "_gantrack_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gantrack_conv3x3.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.gantrack_conv3x3.restype = i
        lib.gantrack_wgrad3x3.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        lib.gantrack_wgrad3x3.restype = i
        ll = ctypes.POINTER(ctypes.c_longlong)
        lib.gantrack_wgrad3x3_geometry.argtypes = [i, i, i, i, i, i, ll, ll]
        lib.gantrack_wgrad3x3_geometry.restype = None
        lib._gantrack_typed = True
    return lib


def _check(x: torch.Tensor, w_shape, name: str) -> None:
    """Raise unless ``x`` with weights of ``w_shape`` is inside the
    contract (a CPU tensor, which takes the plain version, may also be
    float64)."""
    on_cpu_f64 = x.device.type == "cpu" and x.dtype == torch.float64
    if not supported(x.shape, w_shape, torch.float32 if on_cpu_f64 else x.dtype):
        raise ValueError(f"{name}: x {tuple(x.shape)} {x.dtype} with weights {tuple(w_shape)} is "
                         f"outside the kernels' contract (3x3, matching Ci, bfloat16 or float32; "
                         f"see supported())")


def _conv_launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K8 on CUDA tensors of one dtype."""
    n, ci, h, wd = x.shape
    co = w.shape[0]
    is_bf16 = x.dtype == torch.bfloat16
    x = x.contiguous()
    # The kernel's weight layout: [tap][co][ci] (bf16: channel pairs feed
    # the mma fragments) or [tap][ci][co] (f32: a thread's 8 output channels).
    wp = (w.permute(2, 3, 0, 1) if is_bf16 else w.permute(2, 3, 1, 0)).contiguous()
    out = torch.empty((n, co, h, wd), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().gantrack_conv3x3(x.data_ptr(), wp.data_ptr(), out.data_ptr(), n, ci, co, h, wd,
                                     int(is_bf16), stream)
    check_rc(rc, "conv3x3 kernel")
    LAUNCHES["conv3x3"] += 1
    return out


def _wgrad_launch(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K9 on CUDA tensors of one dtype: the split sums into float32
    scratch, then the reduction over the splits in their order."""
    n, ci, h, wd = x.shape
    co = g.shape[1]
    is_bf16 = x.dtype == torch.bfloat16
    x, g = x.contiguous(), g.contiguous()
    lib = _lib()
    units, per_split = ctypes.c_longlong(), ctypes.c_longlong()
    lib.gantrack_wgrad3x3_geometry(n, ci, co, h, wd, int(is_bf16), ctypes.byref(units),
                                   ctypes.byref(per_split))
    splits = max(1, min(units.value, -(-_WGRAD_TARGET_BLOCKS // per_split.value)))
    partial = torch.empty((splits, 9, co, ci), dtype=torch.float32, device=x.device)
    dw = torch.empty((co, ci, 3, 3), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gantrack_wgrad3x3(x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                                   n, ci, co, h, wd, splits, int(is_bf16), stream)
    check_rc(rc, "wgrad3x3 kernel")
    LAUNCHES["wgrad3x3"] += 1
    return dw


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return conv3x3_plain(x, w) if x.device.type == "cpu" else _conv_launch(x, w)


def _wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return wgrad3x3_plain(x, g) if x.device.type == "cpu" else _wgrad_launch(x, g)


class _Conv3x3(torch.autograd.Function):
    """K8; bilinear in ``x`` and ``w``, so its gradients are K8 with the
    flipped, transposed weights and K9."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None,
                              w if ctx.needs_input_grad[0] else None)
        return _conv(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _Conv3x3.apply(g.to(w.dtype), _flip_t(w))
        if ctx.needs_input_grad[1]:
            gw = _Wgrad3x3.apply(x, g.to(x.dtype))
        return gx, gw


class _Wgrad3x3(torch.autograd.Function):
    """K9; bilinear in ``x`` and ``g``, so both its gradients are K8."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None,
                              g if ctx.needs_input_grad[0] else None)
        return _wgrad(x, g)

    @staticmethod
    def backward(ctx, ggw):
        x, g = ctx.saved_tensors
        dx = dg = None
        if ctx.needs_input_grad[0]:
            dx = _Conv3x3.apply(g, _flip_t(ggw.to(g.dtype)))
        if ctx.needs_input_grad[1]:
            dg = _Conv3x3.apply(x, ggw.to(x.dtype))
        return dx, dg


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Correlate ``x [N, Ci, H, W]`` with ``w [Co, Ci, 3, 3]``, stride 1,
    zero padding 1: ``F.conv2d(x, w, padding=1)`` in ``x.dtype`` with
    float32 sums.  Differentiable to every order through the kernels."""
    _check(x, w.shape, "conv3x3")
    if w.device != x.device:
        raise ValueError(f"conv3x3: x on {x.device}, w on {w.device}")
    return _Conv3x3.apply(x, w.to(x.dtype))


def wgrad3x3(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient of :func:`conv3x3`: ``x [N, Ci, H, W]``, ``g [N, Co,
    H, W]`` → ``[Co, Ci, 3, 3]`` in ``x.dtype`` with float32 sums."""
    if g.ndim != 4 or x.ndim != 4 or (g.shape[0], *g.shape[2:]) != (x.shape[0], *x.shape[2:]):
        raise ValueError(f"wgrad3x3: x {tuple(x.shape)} and g {tuple(g.shape)} do not match")
    _check(x, (g.shape[1], x.shape[1], 3, 3), "wgrad3x3")
    if g.device != x.device:
        raise ValueError(f"wgrad3x3: x on {x.device}, g on {g.device}")
    return _Wgrad3x3.apply(x, g.to(x.dtype))
