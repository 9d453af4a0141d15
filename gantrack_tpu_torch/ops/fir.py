"""Separable resample FIR: same rate, ↓2, and ↑2 (polyphase).

Port of ``gantrack_tpu/ops/attic/fir.py`` (``fir2d``, kernels K5–K7) on
``[P, H, W]`` planes.  A :class:`FirSpec` names the form and holds the
correlation taps per axis (flipped unless ``flip_filter``, √gain per
axis, as ``fir2d`` prepares them) and the pads ``(py0, py1, px0, px1)``
of the up-rate grid, with the ``upfirdn2d`` contract: pad or crop, run
the taps, keep every ``down``-th sample.

* :class:`Fir` is the autograd Function.  On a CUDA tensor its forward
  launches the kernel of ``csrc/fir.cu`` (same and down2: ``fir_kernel``;
  up2: ``fir_up_kernel``, which takes the static polyphase split of
  :func:`up2_phases`); on a CPU tensor it computes the
  plain form with :func:`.upfirdn2d.upfirdn2d_plain`.  Its backward is
  :class:`Fir` again with the adjoint spec (``_fir_bwd`` of the JAX
  module): adjoint(same) is same with reversed taps and pads
  ``(k-1-p0, k-1-p1)``, adjoint(down2) is up2 and adjoint(up2) is down2,
  with the high pads solved so the output has the input's size.  So
  every order of gradient, as R1 and path length take, stays on the
  kernels.
* ``LAUNCHES`` counts kernel launches per form; it is bumped only where a
  kernel is launched.  ``PLAIN_ROUTE`` counts no kernel: it holds, by
  reason, the ``upfirdn2d`` calls whose static spec lies outside the
  kernels' contract and which therefore took the plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from ._nvcc import check_planes, check_rc, load_library
from .upfirdn2d import (NOT_SEPARABLE, Taps, _parse_padding, _parse_scaling, filter_taps,
                        upfirdn2d_plain)

__all__ = ["FirSpec", "Fir", "fir_spec", "fir_planes", "fir_plain", "up2_phases", "LAUNCHES",
           "PLAIN_ROUTE"]

FORMS = ("same", "down2", "up2")
MAX_TAPS = 32  # kMaxTaps of csrc/fir.cu
MAX_PHASE_TAPS = MAX_TAPS // 2  # kMaxPhaseTaps
# Kernel launches per form; bumped only where a kernel is launched.
LAUNCHES = {"fir_same": 0, "fir_down2": 0, "fir_up2": 0}
# ``upfirdn2d`` calls outside the kernels' contract, which took the plain
# version: {why the call was outside: calls}.
PLAIN_ROUTE: Dict[str, int] = {}


@dataclasses.dataclass(frozen=True)
class FirSpec:
    """One FIR call: ``form`` in :data:`FORMS`, correlation taps per
    axis, and the pads ``(py0, py1, px0, px1)`` of the up-rate grid."""

    form: str
    taps_y: Tuple[float, ...]
    taps_x: Tuple[float, ...]
    pads: Tuple[int, int, int, int]

    def _axis_out(self, n: int, k: int, p0: int, p1: int) -> int:
        if self.form == "down2":
            return (n + p0 + p1 - k) // 2 + 1
        if self.form == "up2":
            return 2 * n + p0 + p1 - k + 1
        return n + p0 + p1 - k + 1

    def out_size(self, h: int, w: int) -> Tuple[int, int]:
        py0, py1, px0, px1 = self.pads
        return (self._axis_out(h, len(self.taps_y), py0, py1),
                self._axis_out(w, len(self.taps_x), px0, px1))

    def _axis_adjoint(self, n: int, o: int, k: int, p0: int, p1: int) -> Tuple[int, int]:
        q0 = k - 1 - p0
        if self.form == "down2":  # adjoint is up2: 2o + q0 + q1 - k + 1 = n
            return q0, n + k - 1 - q0 - 2 * o
        if self.form == "up2":  # adjoint is down2: (o + q0 + q1 - k) // 2 + 1 = n
            return q0, 2 * n - 2 + k - q0 - o
        return q0, k - 1 - p1

    def adjoint(self, h: int, w: int) -> "FirSpec":
        """The transposed spec, for an input of ``h × w``."""
        oh, ow = self.out_size(h, w)
        py0, py1, px0, px1 = self.pads
        qy = self._axis_adjoint(h, oh, len(self.taps_y), py0, py1)
        qx = self._axis_adjoint(w, ow, len(self.taps_x), px0, px1)
        form = {"same": "same", "down2": "up2", "up2": "down2"}[self.form]
        return FirSpec(form, self.taps_y[::-1], self.taps_x[::-1], (*qy, *qx))


def fir_spec(f: Optional[torch.Tensor], taps: Optional[Taps], up, down, padding,
             flip_filter: bool, gain: float) -> Tuple[Optional[FirSpec], str]:
    """The :class:`FirSpec` of an ``upfirdn2d`` call, or ``(None, why)``
    when the call is outside the kernels' contract.  A filter on the
    device with no host taps beside it is the caller's fault and raises."""
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    if upx != upy or downx != downy:
        return None, f"up={up}, down={down} differ between the axes"
    if upx not in (1, 2) or downx not in (1, 2) or upx == downx == 2:
        return None, f"up={upx}, down={downx}"
    if not gain > 0:
        return None, f"gain={gain}"
    if taps is None:
        if f is None:
            taps = ((1.0,), (1.0,))
        elif f.device.type != "cpu":
            raise ValueError("upfirdn2d: the filter lies on the device and no host taps were "
                             "given (pass taps=filter_taps(f), computed when the filter is "
                             "set up, or NOT_SEPARABLE)")
        else:
            taps = filter_taps(f) or NOT_SEPARABLE
    if taps == NOT_SEPARABLE:
        return None, "2-D filter, not separable"
    ty, tx = taps
    if not (1 <= len(ty) <= MAX_TAPS and 1 <= len(tx) <= MAX_TAPS):
        return None, f"{len(ty)} x {len(tx)} taps (at most {MAX_TAPS} per axis)"
    if not flip_filter:
        ty, tx = ty[::-1], tx[::-1]
    ga = float(gain) ** 0.5
    px0, px1, py0, py1 = _parse_padding(padding)
    form = "up2" if upx == 2 else "down2" if downx == 2 else "same"
    return FirSpec(form, tuple(float(t) * ga for t in ty), tuple(float(t) * ga for t in tx),
                   (py0, py1, px0, px1)), ""


def up2_phases(taps: Tuple[float, ...], p0: int):
    """The static polyphase split of one axis of an up2 spec: correlation
    ``taps`` over the ×2 zero-stuffed grid with low pad ``p0``.  Returns
    ``(taps_r, d_r)`` for the output parities r = 0, 1, such that

        out[2b + r] = sum_t taps_r[t] * x[b + d_r + t]

    (the taps j ≡ p0 + r (mod 2), ascending, land on input samples; the
    others on stuffed zeros).  ``d_1 - d_0`` is 0 (p0 odd) or 1 (p0 even):
    the kernel's two output rows 2a + e, 2a + e + 1 with e = d_1 - d_0
    read the same input rows."""
    phases = []
    for r in (0, 1):
        j0 = (p0 + r) % 2
        phases.append((tuple(taps[j0::2]), (r + j0 - p0) // 2))
    return tuple(phases)


def _lib() -> ctypes.CDLL:
    lib = load_library("fir.cu")
    if not getattr(lib, "_gantrack_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gantrack_fir.argtypes = [p, p, i, i, i, i, i, i, i, i, i, i, p, p, i, i, p]
        lib.gantrack_fir.restype = i
        lib.gantrack_fir_up2.argtypes = [p, p, i, i, i, i, i, p, p, i, i, p]
        lib.gantrack_fir_up2.restype = i
        lib._gantrack_typed = True
    return lib


@functools.lru_cache(maxsize=256)
def _c_phases(taps_y: Tuple[float, ...], taps_x: Tuple[float, ...], py0: int, px0: int):
    """``gantrack_fir_up2``'s arrays: taps [axis][parity][MAX_PHASE_TAPS]
    and geometry [axis][n0, n1, d0, d1], y then x."""
    taps, geom = [], []
    for t, p0 in ((taps_y, py0), (taps_x, px0)):
        (t0, d0), (t1, d1) = up2_phases(t, p0)
        for tr in (t0, t1):
            taps += list(tr) + [0.0] * (MAX_PHASE_TAPS - len(tr))
        geom += [len(t0), len(t1), d0, d1]
    return (ctypes.c_float * len(taps))(*taps), (ctypes.c_int * len(geom))(*geom)


@functools.lru_cache(maxsize=256)
def _c_taps(taps: Tuple[float, ...]):
    return (ctypes.c_float * len(taps))(*taps)


def fir_planes(x: torch.Tensor, spec: FirSpec, *, blocks_per_sm: int = 0) -> torch.Tensor:
    """Launch the kernel of ``spec.form``: ``[P, H, W]`` → ``[P, OH, OW]``
    in x's dtype, summed in float32.  ``blocks_per_sm`` sizes the
    kernel's grid (0: the kernel's own choice); only the timing of that
    choice in ``chip_smoke.py`` sets it."""
    check_planes(x, "x")
    p, h, w = x.shape
    oh, ow = spec.out_size(h, w)
    if p == 0 or oh < 1 or ow < 1:
        raise ValueError(f"FIR {spec.form} of {tuple(x.shape)} with pads {spec.pads} and "
                         f"{len(spec.taps_y)} x {len(spec.taps_x)} taps has output {oh} x {ow}")
    out = torch.empty((p, oh, ow), dtype=x.dtype, device=x.device)
    py0, _, px0, _ = spec.pads
    is_bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if spec.form == "up2":
            rc = _lib().gantrack_fir_up2(x.data_ptr(), out.data_ptr(), p, h, w, oh, ow,
                                         *_c_phases(spec.taps_y, spec.taps_x, py0, px0), is_bf16,
                                         blocks_per_sm, stream)
        else:
            rc = _lib().gantrack_fir(
                x.data_ptr(), out.data_ptr(), p, h, w, oh, ow, FORMS.index(spec.form), py0, px0,
                len(spec.taps_y), len(spec.taps_x), _c_taps(spec.taps_y), _c_taps(spec.taps_x),
                is_bf16, blocks_per_sm, stream)
    check_rc(rc, f"FIR {spec.form} kernel")
    LAUNCHES[f"fir_{spec.form}"] += 1
    return out


def fir_plain(x: torch.Tensor, spec: FirSpec) -> torch.Tensor:
    """The plain PyTorch version of :func:`fir_planes`, on any device."""
    ty = torch.tensor(spec.taps_y, dtype=torch.float32, device=x.device)
    tx = torch.tensor(spec.taps_x, dtype=torch.float32, device=x.device)
    f = ty if spec.taps_y == spec.taps_x else torch.outer(ty, tx)
    py0, py1, px0, px1 = spec.pads
    return upfirdn2d_plain(x[:, None], f, up=2 if spec.form == "up2" else 1,
                           down=2 if spec.form == "down2" else 1,
                           padding=[px0, px1, py0, py1], flip_filter=True)[:, 0]


class Fir(torch.autograd.Function):
    """``spec`` applied to ``[P, H, W]`` planes; the backward is
    :class:`Fir` with the adjoint spec."""

    @staticmethod
    def forward(ctx, x, spec: FirSpec):
        ctx.spec = spec
        ctx.in_hw = (x.shape[1], x.shape[2])
        return fir_plain(x, spec) if x.device.type == "cpu" else fir_planes(x, spec)

    @staticmethod
    def backward(ctx, g):
        return Fir.apply(g.contiguous(), ctx.spec.adjoint(*ctx.in_hw)), None
