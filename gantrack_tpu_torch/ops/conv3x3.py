"""3×3 stride-1 SAME convolution as an implicit GEMM, and its weight gradient.

Port of ``gantrack_tpu/ops/attic/conv3x3.py`` (kernels K8 and K9) in the
port's layout: ``x [N, Ci, H, W]``, ``w [Co, Ci, 3, 3]`` (NCHW / OIHW).

* ``conv3x3(x, w)`` is ``F.conv2d(x, w, padding=1)`` and ``wgrad3x3(x, g)``
  is its weight gradient ``dw[co,ci,dy,dx] = Σ xpad[n,ci,y+dy,x+dx] ·
  g[n,co,y,x]``.  ``w`` and ``g`` are cast to ``x.dtype``; sums run in
  float32 and are rounded once to ``x.dtype``.
* On a CUDA tensor they launch the hand-written kernels of
  ``csrc/conv3x3.cu``, in the variant the static shape picks
  (:func:`conv_variant`, :func:`wgrad_variant`; counted in ``VARIANTS``):

  - ``wgmma`` (bfloat16, ``W % 8 == 0``): warpgroup ``wgmma`` from a ring of
    shared-memory stages that TMA fills as NCHW lies, zero fill beyond the
    image in place of padding and guards; a producer warpgroup writes the
    three column-shifted views of the window (a tap's ``dx`` is a 2-byte
    offset that neither TMA nor a ``wgmma`` descriptor can carry); K8 leaves
    by a TMA store, K9 sums into 132 blocks' partials at most (19.5 MB at the
    training shapes).  What bounds them is operations; what the design buys
    is tensor cores that are fed without the threads staging anything.
  - ``mma_sync`` (bfloat16, any other width: :func:`wgmma_reason` says why):
    warp-level ``mma.sync`` from synchronously staged, guarded tiles.
  - ``f32_tiled`` / ``f32_flat`` (K8) and ``f32`` (K9): full float32 FMA on
    the CUDA cores, never TF32; ``f32_flat`` packs whole images of at most
    64 pixels into one block, which then reads its weights once for them.

  K9 is a split reduction without atomics in every variant, its split a
  function of the shape alone (:func:`wgrad_plan`), so it is bitwise
  deterministic.  On a CPU tensor the wrappers run :func:`conv3x3_plain` /
  :func:`wgrad3x3_plain`; on a CUDA tensor they launch or raise.
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
           "library_reason", "count_library_route", "wgmma_reason", "conv_variant",
           "wgrad_variant", "wgrad_plan", "pack_weights", "LAUNCHES", "VARIANTS",
           "LIBRARY_ROUTE"]

# Kernel launches per wrapper; bumped only where a kernel is launched.
LAUNCHES = {"conv3x3": 0, "wgrad3x3": 0}
# The same launches by the kernel variant that ran ("wrapper:variant").
VARIANTS = {"conv3x3:wgmma": 0, "conv3x3:mma_sync": 0, "conv3x3:f32_tiled": 0,
            "conv3x3:f32_flat": 0, "wgrad3x3:wgmma": 0, "wgrad3x3:mma_sync": 0,
            "wgrad3x3:f32": 0}
# ``conv2d_resample(conv_impl="kernel")`` calls outside the kernels'
# contract, which took the library convolution: {why: calls}.
LIBRARY_ROUTE: Dict[str, int] = {}

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_INT_MAX = 2**31 - 1
# K9 cuts its reduction over N*H*W into about this many blocks in all:
# constants, so the order of the sums does not depend on the device.  A
# wgmma block fills an SM's shared memory, so its target is one block an SM
# of the H100 (132); two float32 blocks fit an SM, several mma.sync ones.
_WGRAD_TARGET_BLOCKS = {"wgmma": 132, "mma_sync": 1024, "f32": 264}
# ``variant`` argument of the C entry points (enum Variant of conv3x3.cu).
_VARIANT_CODE = {"mma_sync": 0, "wgmma": 1, "f32_tiled": 2, "f32": 2, "f32_flat": 3}
# Tiles of the kernels of conv3x3.cu, mirrored here so that the choice of a
# variant, K9's split and the packed weights are functions of the shape that
# run without the card.
_F32_FLAT_SLOTS = 64            # f32 K8, small images: pixel slots a block
_MMA_WGRAD_TILE = (8, 16, 64, 32)   # mma.sync K9: rows, columns, co, ci
_F32_WGRAD_TILE = (8, 8, 64, 32)    # f32 K9: rows, columns, co, ci
_F32_WGRAD_SLOTS = (64, 192)    # f32 K9, small images: pixel and window slots a tile
_WGMMA_CI_SLAB = 16             # wgmma K8: input channels a stage
_WGMMA_WGRAD_CI = 32            # wgmma K9: input channels a block


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


def wgmma_reason(x_shape: Sequence[int], dtype) -> Optional[str]:
    """Why the wgmma kernels (bf16, fed by TMA) do not take ``x_shape`` in
    ``dtype``, or None when they do.  From the static shape alone."""
    if dtype != torch.bfloat16:
        return f"{dtype}: wgmma multiplies bfloat16; float32 runs on the CUDA cores"
    w = int(x_shape[3])
    if w % 8 != 0:
        return f"W={w}: TMA needs row strides of 16 bytes (W a multiple of 8 in bfloat16)"
    return None


def conv_variant(x_shape: Sequence[int], dtype) -> str:
    """The K8 kernel that takes ``x_shape [N, Ci, H, W]`` in ``dtype``:
    ``wgmma`` or ``mma_sync`` (bfloat16), ``f32_tiled`` or, for images of at
    most 64 pixels (a block then holds whole images), ``f32_flat`` (float32)."""
    if dtype == torch.bfloat16:
        return "wgmma" if wgmma_reason(x_shape, dtype) is None else "mma_sync"
    h, w = int(x_shape[2]), int(x_shape[3])
    return "f32_flat" if h * w <= _F32_FLAT_SLOTS else "f32_tiled"


def wgrad_variant(x_shape: Sequence[int], dtype) -> str:
    """The K9 kernel that takes ``x_shape`` in ``dtype``: ``wgmma`` or
    ``mma_sync`` (bfloat16), ``f32`` (float32)."""
    if dtype == torch.bfloat16:
        return "wgmma" if wgmma_reason(x_shape, dtype) is None else "mma_sync"
    return "f32"


def wgrad_images_per_tile(h: int, w: int) -> int:
    """Whole images a pixel tile of the float32 K9 holds (with their padded
    windows), or 0 where an image is cut into 8 x 8 tiles instead."""
    pixels, window = _F32_WGRAD_SLOTS
    return min(pixels // (h * w), window // ((h + 2) * (w + 2)))


def _wgmma_tile(w: int, co: int):
    """(pixels of a box row, output channels of a block) of the wgmma
    kernels, as ``wgmma_bw`` and ``wgmma_cot`` of conv3x3.cu pick them."""
    return (64 if w > 32 else 32), (128 if co > 64 else 64)


def wgrad_plan(x_shape: Sequence[int], co: int, dtype, variant: Optional[str] = None) -> dict:
    """How K9 cuts its sum over ``N*H*W`` for ``x_shape`` and ``co`` output
    channels: ``units`` (pixel tiles or chunks), ``blocks_per_split``,
    ``splits``, ``slices`` of float32 scratch ``[slices, 9, co, ci]``, their
    ``scratch_bytes`` and, for the float32 kernel, the ``images_per_tile`` (0:
    tiles of one image).  From the shape alone: the same on any device."""
    n, ci, h, w = (int(v) for v in x_shape)
    variant = variant or wgrad_variant(x_shape, dtype)
    cdiv = lambda a, b: -(-a // b)
    slices_per_split = 1
    if variant == "wgmma":
        bw, cot = _wgmma_tile(w, co)
        units = n * cdiv(h, 128 // bw) * cdiv(w, bw)
        per_split = cdiv(co, cot) * cdiv(ci, _WGMMA_WGRAD_CI)
        # Whole blocks under the target (one wave); with co <= 64 the two
        # warpgroups of a block each sum half a tile's rows into a slice.
        splits = _WGRAD_TARGET_BLOCKS[variant] // per_split
        slices_per_split = 2 if cot == 64 else 1
    elif variant == "mma_sync":
        th, tw, cot, cit = _MMA_WGRAD_TILE
        units = n * cdiv(h, th) * cdiv(w, tw)
        per_split = cdiv(co, cot) * cdiv(ci, cit)
        splits = cdiv(_WGRAD_TARGET_BLOCKS[variant], per_split)
    elif variant == "f32":
        th, tw, cot, cit = _F32_WGRAD_TILE
        images = wgrad_images_per_tile(h, w)
        units = cdiv(n, images) if images else n * cdiv(h, th) * cdiv(w, tw)
        per_split = cdiv(co, cot) * cdiv(ci, cit)
        splits = _WGRAD_TARGET_BLOCKS[variant] // per_split
    else:
        raise ValueError(f"wgrad_plan: unknown variant {variant!r}")
    splits = max(1, min(units, splits))
    slices = splits * slices_per_split
    return {"variant": variant, "units": units, "blocks_per_split": per_split, "splits": splits,
            "slices": slices, "scratch_bytes": slices * 9 * co * ci * 4,
            "images_per_tile": wgrad_images_per_tile(h, w) if variant == "f32" else 0}


def pack_weights(w: torch.Tensor, variant: str) -> torch.Tensor:
    """``w [Co, Ci, 3, 3]`` in the layout K8's ``variant`` reads:

    * ``mma_sync``: ``[tap, co, ci]`` (channel pairs feed the mma fragments);
    * ``f32_tiled``, ``f32_flat``: ``[tap, ci, co]`` (a thread's 8 output channels);
    * ``wgmma``: ``[ci slab, co tile, tap, k half, co, 8 ci]``, zero-padded to
      whole slabs of 16 input channels and whole tiles of 128 (64 where
      ``Co <= 64``) output channels: the block of one (slab, tile) is one
      contiguous copy into shared memory, where 8 co x 8 ci (128 bytes) is a
      core matrix of wgmma's K-major operand.
    """
    if variant == "mma_sync":
        return w.permute(2, 3, 0, 1).contiguous()
    if variant in ("f32_tiled", "f32_flat"):
        return w.permute(2, 3, 1, 0).contiguous()
    if variant != "wgmma":
        raise ValueError(f"pack_weights: unknown variant {variant!r}")
    co, ci = int(w.shape[0]), int(w.shape[1])
    cot, slab = _wgmma_tile(8, co)[1], _WGMMA_CI_SLAB
    pad_co, pad_ci = -co % cot, -ci % slab
    if pad_co or pad_ci:
        w = F.pad(w, [0, 0, 0, 0, 0, pad_ci, 0, pad_co])
    w = w.reshape((co + pad_co) // cot, cot, (ci + pad_ci) // slab, 2, 8, 9)
    return w.permute(2, 0, 5, 3, 1, 4).contiguous()


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
        lib.gantrack_wgrad3x3.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        lib.gantrack_wgrad3x3.restype = i
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


def _pick(variant: Optional[str], chosen: str, x: torch.Tensor, name: str) -> str:
    """The variant to launch: ``chosen`` (from the shape) unless the caller
    forces the general bf16 kernels, which take every shape ``wgmma`` does."""
    if variant is None or variant == chosen:
        return chosen
    if variant == "mma_sync" and x.dtype == torch.bfloat16:
        return variant
    raise ValueError(f"{name}: variant {variant!r} does not take x {tuple(x.shape)} {x.dtype} "
                     f"(the shape picks {chosen!r}; {wgmma_reason(x.shape, x.dtype)})")


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as a tensor map's base must be."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _conv_launch(x: torch.Tensor, w: torch.Tensor, variant: Optional[str] = None) -> torch.Tensor:
    """K8 on CUDA tensors of one dtype.  ``variant`` (private: the card
    checks time the general kernels beside the wgmma ones) forces
    ``mma_sync`` on a shape that ``conv_variant`` gives to ``wgmma``."""
    n, ci, h, wd = x.shape
    co = w.shape[0]
    variant = _pick(variant, conv_variant(x.shape, x.dtype), x, "conv3x3")
    x = _tma_ready(x) if variant == "wgmma" else x.contiguous()
    wp = pack_weights(w, variant)
    out = torch.empty((n, co, h, wd), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().gantrack_conv3x3(x.data_ptr(), wp.data_ptr(), out.data_ptr(), n, ci, co, h, wd,
                                     _VARIANT_CODE[variant], stream)
    check_rc(rc, f"conv3x3 kernel ({variant})")
    LAUNCHES["conv3x3"] += 1
    VARIANTS[f"conv3x3:{variant}"] += 1
    return out


def _wgrad_launch(x: torch.Tensor, g: torch.Tensor, variant: Optional[str] = None) -> torch.Tensor:
    """K9 on CUDA tensors of one dtype: the split sums into float32
    scratch, then the reduction over the slices in their order.
    ``variant`` as in :func:`_conv_launch`."""
    n, ci, h, wd = x.shape
    co = g.shape[1]
    variant = _pick(variant, wgrad_variant(x.shape, x.dtype), x, "wgrad3x3")
    if variant == "wgmma":
        x, g = _tma_ready(x), _tma_ready(g)
    else:
        x, g = x.contiguous(), g.contiguous()
    plan = wgrad_plan(x.shape, co, x.dtype, variant)
    partial = torch.empty((plan["slices"], 9, co, ci), dtype=torch.float32, device=x.device)
    dw = torch.empty((co, ci, 3, 3), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().gantrack_wgrad3x3(x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                                      dw.data_ptr(), n, ci, co, h, wd, plan["splits"],
                                      plan["slices"], plan["images_per_tile"],
                                      _VARIANT_CODE[variant], stream)
    check_rc(rc, f"wgrad3x3 kernel ({variant})")
    LAUNCHES["wgrad3x3"] += 1
    VARIANTS[f"wgrad3x3:{variant}"] += 1
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
