"""Filtered leaky ReLU, the StyleGAN3 anti-aliased nonlinearity.

Port of ``gantrack_tpu/ops/filtered_lrelu.py``: bias → ×up zero-insert
upsample → pad → FIR ``fu`` (gain ``up**2``) → gain·leaky-ReLU → clamp →
FIR ``fd`` → keep every ``down``-th sample, on NCHW tensors.

Two routes, chosen from the call's static spec (device, dtype, factors,
the filters' taps and whether they are separable or 2-D), with no option:

* **fused** (:class:`FusedSpec`, :func:`fused_spec`): one pass a
  direction, ``csrc/filtered_lrelu.cu`` on the card.  It adds the bias,
  runs the up-FIR into shared memory, applies the activation there and
  keeps a 2-bit code a sample (0 positive, 1 negative or zero, 2 clamped),
  runs the down-FIR and rounds once to the layer's dtype: f32 inside, the
  upsampled intermediate never in device memory.  Autograd keeps only the
  codes.  The backward is the same pass with the roles swapped (the down
  pass' adjoint as its up pass, the up pass' adjoint as its down pass),
  scaling by ``gain``, ``gain·slope`` or 0 by the code (PyTorch's
  conventions: the slope at 0, the gradient passed at ±clamp), and linear
  in its input, so its own backward is the forward's layout in the same
  mode and every order of gradient stays on the kernel.  On a CPU tensor
  the same :class:`torch.autograd.Function` computes the plain form of
  the same semantics (f32, or the input's float64, inside; one rounding;
  the same codes and backward).
* **composed**: a spec outside the fused kernel's contract (up other than
  1, 2, 4; down other than 1, 2; up 4 without down 2; more than 6 taps a
  phase; a filter at factor 1; a 2-D up-filter; another dtype or device)
  runs the port's ops
  as the JAX function composes XLA ops: ``bias_act`` and the two
  :func:`.upfirdn2d.upfirdn2d` passes (the FIR kernels or their plain
  version).

Each call counts its route in the installed recorder
(:mod:`..utils.profiling`): ``filtered_lrelu.fused_route`` or
``filtered_lrelu.composed_route/<why>``; each fused launch on the card
``filtered_lrelu.launch/<kernel>`` (:attr:`FusedSpec.kernel`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import profiling
from ._nvcc import check_planes, check_rc, load_library
from .bias_act import bias_act
from .fir import FACTORS, FirSpec, fir_plain, fir_spec
from .upfirdn2d import _as_filter, _get_filter_size, _parse_padding, upfirdn2d

__all__ = ["filtered_lrelu", "FusedSpec", "fused_spec", "fused_planes", "pack_codes",
           "unpack_codes"]

PHASE_TAPS = 6  # taps a phase of the kernel's passes: 6·factor a filter, per axis
TAPS_2D = 12    # the largest 2-D filter (↓2 forward, ×2 backward)
_DTYPES = {"cuda": (torch.float32, torch.bfloat16),
           "cpu": (torch.float32, torch.bfloat16, torch.float64)}


@dataclasses.dataclass(frozen=True)
class FusedSpec:
    """One pass of the fused kernel: the up pass (``same``, ``up2`` or
    ``up4``; a 2-D filter at ``up2``) and the down pass (``same``,
    ``down2`` or ``down4``; a 2-D filter at ``down2``) as :class:`.fir.FirSpec`\\ s,
    the sizes of the input, mid and output grids, the activation, and
    ``s_off``, where the codes' words start along x: ``s_off`` samples
    before mid column 0, so that each block of the forward writes whole
    words."""

    up: FirSpec
    down: FirSpec
    in_hw: Tuple[int, int]
    mid_hw: Tuple[int, int]
    out_hw: Tuple[int, int]
    gain: float
    slope: float
    clamp: float  # < 0: none
    s_off: int

    @property
    def factors(self) -> Tuple[int, int]:
        return FACTORS[self.up.form][0], FACTORS[self.down.form][1]

    @property
    def words(self) -> int:
        """32-bit code words a mid row (16 codes a word)."""
        return (self.mid_hw[1] + self.s_off + 15) // 16

    @property
    def kernel(self) -> str:
        """The launch as ``filtered_lrelu.launch/<kernel>`` counts it."""
        u, d = self.factors
        tag = "_up2d" if self.up.taps_2d else "_down2d" if self.down.taps_2d else ""
        return f"up{u}_down{d}{tag}"

    def adjoint(self) -> "FusedSpec":
        """The backward pass: the down pass' adjoint up to the mid grid,
        then the up pass' adjoint down to the input grid; the same codes."""
        return dataclasses.replace(self, up=self.down.adjoint(*self.mid_hw),
                                   down=self.up.adjoint(*self.in_hw), in_hw=self.out_hw,
                                   out_hw=self.in_hw)


def _pass_why(spec: FirSpec, factor: int, what: str) -> str:
    """Why a FIR pass lies outside the fused kernel's contract ('' if not)."""
    if factor == 1 and (len(spec.taps_y), len(spec.taps_x)) != (1, 1):
        return f"{what}: a filter at factor 1"
    if len(spec.taps_y) > PHASE_TAPS * factor or len(spec.taps_x) > PHASE_TAPS * factor:
        return (f"{what}: {len(spec.taps_y)} x {len(spec.taps_x)} taps at factor {factor} "
                f"(at most {PHASE_TAPS * factor})")
    return ""


def fused_spec(x: torch.Tensor, fu, fd, b: Optional[torch.Tensor], up: int, down: int, padding,
               gain: float, slope: float, clamp: Optional[float]):
    """The :class:`FusedSpec` of a ``filtered_lrelu`` call, or ``(None,
    why)`` when the call lies outside the fused kernel's contract."""
    if x.dtype not in _DTYPES.get(x.device.type, ()):
        return None, f"{x.device.type} {x.dtype}"
    if b is not None and (b.ndim != 1 or b.shape[0] != x.shape[1]):
        return None, f"bias of shape {tuple(b.shape)}"
    fu, fd = _as_filter(fu), _as_filter(fd)
    px0, px1, py0, py1 = _parse_padding(padding)
    ups, why = fir_spec(fu, getattr(fu, "taps", None), up, 1, [px0, px1, py0, py1], False,
                        up ** 2)
    if ups is None:
        return None, f"up-filter: {why}"
    downs, why = fir_spec(fd, getattr(fd, "taps", None), 1, down, 0, False, 1)
    if downs is None:
        return None, f"down-filter: {why}"
    u, d = FACTORS[ups.form][0], FACTORS[downs.form][1]
    if d not in (1, 2):
        return None, f"down={d}"
    if (u, d) == (4, 1):  # not instantiated: no StyleGAN3 layer makes it
        return None, "up=4, down=1"
    if ups.taps_2d:
        return None, "2-D up-filter"
    why = _pass_why(ups, u, "up-filter") or _pass_why(downs, d, "down-filter")
    if why:
        return None, why
    mid = ups.out_size(x.shape[2], x.shape[3])
    out = downs.out_size(*mid)
    if min(*mid, *out) < 1:
        return None, "empty output"
    s_off = (-px0 - 1) % u  # the x offset of the forward's blocks (csrc/filtered_lrelu.cu)
    return FusedSpec(ups, downs, (int(x.shape[2]), int(x.shape[3])), mid, out, float(gain),
                     float(slope), -1.0 if clamp is None else float(clamp), s_off), ""


# ----------------------------------------------------------------- codes

_SHIFTS = 2 * torch.arange(16, dtype=torch.int64)


def pack_codes(codes: torch.Tensor, spec: FusedSpec) -> torch.Tensor:
    """``[P, MH, MW]`` codes (0, 1, 2) → the kernel's ``[P, MH, words]``
    int32 words: code of mid column n at bits 2·j of word w, where
    n + s_off = 16·w + j; the slots outside the mid grid hold 0."""
    p, mh, mw = codes.shape
    full = torch.zeros((p, mh, spec.words * 16), dtype=torch.int64, device=codes.device)
    full[:, :, spec.s_off:spec.s_off + mw] = codes
    words = (full.reshape(p, mh, spec.words, 16) << _SHIFTS.to(codes.device)).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def unpack_codes(sign: torch.Tensor, spec: FusedSpec) -> torch.Tensor:
    """The inverse of :func:`pack_codes`: ``[P, MH, MW]`` int64 codes."""
    p, mh, words = sign.shape
    w = sign.to(torch.int64) & 0xFFFFFFFF
    codes = (w[..., None] >> _SHIFTS.to(sign.device)) & 3
    return codes.reshape(p, mh, words * 16)[:, :, spec.s_off:spec.s_off + spec.mid_hw[1]]


# ------------------------------------------------------------ the passes

def _plain_planes(x, spec: FusedSpec, bias, sign, channels: int):
    """The plain form of :func:`fused_planes`, on any device."""
    ct = torch.promote_types(x.dtype, torch.float32)
    p, h, w = x.shape
    v = x.to(ct)
    if bias is not None:
        v = (v.reshape(-1, channels, h, w) + bias.to(ct).reshape(1, channels, 1, 1)).reshape(p, h, w)
    mid = fir_plain(v, spec.up)
    assert tuple(mid.shape[1:]) == spec.mid_hw, (tuple(mid.shape), spec.mid_hw)
    if sign is None:
        pos = mid > 0
        y = torch.where(pos, mid * spec.gain, (mid * spec.slope) * spec.gain)
        codes = torch.where(pos, 0, 1)
        if spec.clamp >= 0:
            over = y.abs() > spec.clamp
            y = y.clamp(-spec.clamp, spec.clamp)
            codes = torch.where(over, 2, codes)
        sign = pack_codes(codes, spec)
    else:
        codes = unpack_codes(sign, spec)
        g = mid * spec.gain
        y = torch.where(codes == 1, g * spec.slope, g)
        y = torch.where(codes == 2, torch.zeros_like(y), y)
    return fir_plain(y, spec.down).to(x.dtype), sign


def _lib() -> ctypes.CDLL:
    lib = load_library("filtered_lrelu.cu")
    if not getattr(lib, "_gantrack_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gantrack_filtered_lrelu.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i,
                                                i, p, p, p, i, f, f, f, i, p]
        lib.gantrack_filtered_lrelu.restype = i
        lib._gantrack_typed = True
    return lib


def _padded(rows, n: int):
    """A ``rows`` list of tap rows zero-padded to ``n`` x ``n``, flat."""
    out = np.zeros((n, n), dtype=np.float64)
    a = np.asarray(rows, dtype=np.float64)
    out[:a.shape[0], :a.shape[1]] = a
    return out.ravel().tolist()


@functools.lru_cache(maxsize=256)
def _c_arrays(spec: FusedSpec):
    """The kernel's tap arrays and pads: the up pass' correlation taps
    padded to 6·U (1 at U = 1) per axis, y then x, or 12 x 12 for a 2-D
    filter; the down pass' likewise at D; {pu0y, pu0x, pd0y, pd0x}."""
    u, d = spec.factors
    ku, kd = (1 if u == 1 else PHASE_TAPS * u), (1 if d == 1 else PHASE_TAPS * d)

    def per_axis(f: FirSpec, k: int):
        if f.taps_2d:
            return _padded(f.taps_2d, TAPS_2D)
        return [*f.taps_y, *[0.0] * (k - len(f.taps_y)), *f.taps_x, *[0.0] * (k - len(f.taps_x))]

    tu, td = per_axis(spec.up, ku), per_axis(spec.down, kd)
    pads = (spec.up.pads[0], spec.up.pads[2], spec.down.pads[0], spec.down.pads[2])
    return ((ctypes.c_float * len(tu))(*tu), (ctypes.c_float * len(td))(*td),
            (ctypes.c_int * 4)(*pads))


def _card_planes(x, spec: FusedSpec, bias, sign, channels: int):
    check_planes(x, "x")
    p, h, w = x.shape
    assert (h, w) == spec.in_hw, ((h, w), spec.in_hw)
    mh, mw = spec.mid_hw
    oh, ow = spec.out_hw
    read = sign is not None
    if read:
        if sign.dtype != torch.int32 or tuple(sign.shape) != (p, mh, spec.words) or \
                not sign.is_contiguous() or sign.device != x.device:
            raise ValueError(f"codes must be a contiguous int32 {(p, mh, spec.words)} tensor on "
                             f"{x.device}, got {sign.dtype} {tuple(sign.shape)} on {sign.device}")
    else:
        sign = torch.empty((p, mh, spec.words), dtype=torch.int32, device=x.device)
    y = torch.empty((p, oh, ow), dtype=x.dtype, device=x.device)
    b = None if bias is None else bias.to(device=x.device, dtype=torch.float32).contiguous()
    u, d = spec.factors
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().gantrack_filtered_lrelu(
            x.data_ptr(), y.data_ptr(), None if b is None else b.data_ptr(), sign.data_ptr(),
            int(read), p, channels, h, w, mh, mw, oh, ow, u, d, int(bool(spec.up.taps_2d)),
            int(bool(spec.down.taps_2d)), *_c_arrays(spec), spec.s_off, spec.gain, spec.slope,
            spec.clamp, int(x.dtype == torch.bfloat16), stream)
    check_rc(rc, f"filtered_lrelu {spec.kernel} kernel")
    profiling.count(f"filtered_lrelu.launch/{spec.kernel}")
    return y, sign


def fused_planes(x: torch.Tensor, spec: FusedSpec, bias: Optional[torch.Tensor] = None,
                 sign: Optional[torch.Tensor] = None, channels: int = 1):
    """One pass over ``[P, H, W]`` planes (plane p of channel p %
    ``channels``) → ``(y [P, OH, OW], sign)`` in x's dtype.  Without
    ``sign`` (forward): adds ``bias`` [channels], applies the activation
    and returns the codes it wrote; with it (read mode): scales by the
    codes, adds no bias, and returns them as they were.  The kernel on a
    CUDA tensor, the plain form on a CPU one."""
    run = _plain_planes if x.device.type == "cpu" else _card_planes
    return run(x, spec, bias, sign, channels)


class _Linear(torch.autograd.Function):
    """The read mode, linear in ``g`` with the codes fixed: its backward is
    itself with the adjoint spec."""

    @staticmethod
    def forward(ctx, g, sign, spec: FusedSpec):
        ctx.save_for_backward(sign)
        ctx.spec = spec
        return fused_planes(g, spec, sign=sign)[0]

    @staticmethod
    def backward(ctx, d):
        (sign,) = ctx.saved_tensors
        return _Linear.apply(d.contiguous(), sign, ctx.spec.adjoint()), None, None


class _Fused(torch.autograd.Function):
    """The forward (``x``, ``b``) → ``y``; autograd keeps only the codes.
    ``db`` is the f32 sum of ``dx`` over N, H and W."""

    @staticmethod
    def forward(ctx, x, b, spec: FusedSpec, channels: int):
        y, sign = fused_planes(x, spec, b, None, channels)
        ctx.save_for_backward(sign)
        ctx.spec, ctx.channels = spec, channels
        ctx.b_dtype = None if b is None else b.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        (sign,) = ctx.saved_tensors
        dx = db = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            dx = _Linear.apply(dy.contiguous(), sign, ctx.spec.adjoint())
        if ctx.needs_input_grad[1]:
            p, h, w = dx.shape
            acc = torch.promote_types(dx.dtype, torch.float32)
            db = dx.reshape(-1, ctx.channels, h * w).sum(dim=(0, 2), dtype=acc).to(ctx.b_dtype)
        return (dx if ctx.needs_input_grad[0] else None), db, None, None


def filtered_lrelu(
    x: torch.Tensor,
    fu=None,
    fd=None,
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

    n, c, in_h, in_w = x.shape
    out_w = (in_w * up + (px0 + px1) - (fu_w - 1) - (fd_w - 1) + (down - 1)) // down
    out_h = (in_h * up + (py0 + py1) - (fu_h - 1) - (fd_h - 1) + (down - 1)) // down

    spec, why = fused_spec(x, fu, fd, b, up, down, padding, gain, slope, clamp)
    if spec is not None:
        profiling.count("filtered_lrelu.fused_route")
        y = _Fused.apply(x.reshape(n * c, in_h, in_w).contiguous(), b, spec, c)
        x = y.reshape(n, c, *spec.out_hw)
    else:
        profiling.count(f"filtered_lrelu.composed_route/{why}")
        x = _composed(x, fu, fd, b, up, down, [px0, px1, py0, py1], gain, slope, clamp)
    assert x.shape[2] == out_h and x.shape[3] == out_w, (tuple(x.shape), out_h, out_w)
    return x


def _composed(x, fu, fd, b, up, down, padding, gain, slope, clamp) -> torch.Tensor:
    """The composed route: the port's ops, as the JAX function composes
    XLA ops."""
    x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=padding, gain=up ** 2)
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    return upfirdn2d(x, fd, down=down)
