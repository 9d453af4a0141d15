"""Resample FIR: same rate, ↓2, ↑2, ↑4 (polyphase) and ↓4, separable; ↓2
and ↑2 with a 2-D filter.

Port of ``gantrack_tpu/ops/attic/fir.py`` (``fir2d``, kernels K5–K7) on
``[P, H, W]`` planes, widened to StyleGAN3's factor 4 (the ×4 up-filters
of its layers and their ↓4 adjoints) and to StyleGAN3-R's radial 2-D
down-filters at ↓2 and their ×2 adjoints, which the JAX kernels never
covered.  A :class:`FirSpec` names the form and holds the correlation
taps per axis (flipped unless ``flip_filter``, √gain per axis, as
``fir2d`` prepares them), or one 2-D array of them (``taps_2d``: flipped
on both axes unless ``flip_filter``, gain folded in), and the pads
``(py0, py1, px0, px1)`` of the up-rate grid, with the ``upfirdn2d``
contract: pad or crop, run the taps, keep every ``down``-th sample.

* :class:`Fir` is the autograd Function.  On a CUDA tensor its forward
  launches the kernel of ``csrc/fir.cu`` (same and down2: ``fir_kernel``;
  up2 and up4: ``fir_up_kernel``, which takes the static polyphase split
  of :func:`up_phases`; down4: ``fir_down4_kernel``; the 2-D forms:
  ``fir_kernel`` and ``fir_up_kernel`` with the filter's two sizes); on a
  CPU tensor it computes the plain form with
  :func:`.upfirdn2d.upfirdn2d_plain`.  Its backward is :class:`Fir` again
  with the adjoint spec (``_fir_bwd`` of the JAX module): adjoint(same) is
  same with reversed taps and pads ``(k-1-p0, k-1-p1)``, adjoint(down2) is
  up2 and adjoint(up2) is down2, and likewise down4 and up4 and the 2-D
  forms (taps reversed on both axes), with the high pads solved so the
  output has the input's size.  So every order of gradient, as R1 and
  path length take, stays on the kernels.
* Each kernel launch counts ``fir.launch/<form>`` (``<form>_2d`` for a
  2-D filter) in the installed recorder (:mod:`..utils.profiling`).  :func:`.upfirdn2d.upfirdn2d`
  counts its routing: ``upfirdn2d.kernel_route`` for a call that takes
  :class:`Fir`, ``upfirdn2d.plain_route/<why>`` for one whose static spec
  lies outside the kernels' contract and which took the plain version.
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
from .upfirdn2d import Filter, HostTaps, Taps2D, _parse_padding, _parse_scaling, upfirdn2d_plain

__all__ = ["FirSpec", "Fir", "fir_spec", "fir_planes", "fir_plain", "up_phases"]

# (up, down) of each form; a form's adjoint swaps them.
FACTORS = {"same": (1, 1), "down2": (1, 2), "up2": (2, 1), "up4": (4, 1), "down4": (1, 4)}
FORMS = tuple(FACTORS)
_FORM_OF = {factors: form for form, factors in FACTORS.items()}
MAX_TAPS = 32  # kMaxTaps of csrc/fir.cu
MAX_TAPS_2D = 12  # k2dMaxTaps of csrc/fir.cu: the largest square 2-D filter


@dataclasses.dataclass(frozen=True)
class FirSpec:
    """One FIR call: ``form`` in :data:`FORMS`, correlation taps per
    axis, and the pads ``(py0, py1, px0, px1)`` of the up-rate grid.  A
    2-D filter (down2 or up2) holds its correlation taps in ``taps_2d``
    (rows) and only its sizes in ``taps_y``, ``taps_x`` (zeros), so that
    what sizes a call by its form and tap counts reads it as any other."""

    form: str
    taps_y: Tuple[float, ...]
    taps_x: Tuple[float, ...]
    pads: Tuple[int, int, int, int]
    taps_2d: Tuple[Tuple[float, ...], ...] = ()

    @property
    def kernel(self) -> str:
        """The kernel's form as ``fir.launch/<kernel>`` counts it."""
        return f"{self.form}_2d" if self.taps_2d else self.form

    def _axis_out(self, n: int, k: int, p0: int, p1: int) -> int:
        up, down = FACTORS[self.form]
        return (up * n + p0 + p1 - k) // down + 1

    def out_size(self, h: int, w: int) -> Tuple[int, int]:
        py0, py1, px0, px1 = self.pads
        return (self._axis_out(h, len(self.taps_y), py0, py1),
                self._axis_out(w, len(self.taps_x), px0, px1))

    def _axis_adjoint(self, n: int, o: int, k: int, p0: int, p1: int) -> Tuple[int, int]:
        q0 = k - 1 - p0
        up, down = FACTORS[self.form]
        if down > 1:  # adjoint is up by ``down``: down·o + q0 + q1 - k + 1 = n
            return q0, n + k - 1 - q0 - down * o
        if up > 1:  # adjoint is down by ``up``: (o + q0 + q1 - k) // up + 1 = n
            return q0, up * n - up + k - q0 - o
        return q0, k - 1 - p1

    def adjoint(self, h: int, w: int) -> "FirSpec":
        """The transposed spec, for an input of ``h × w``."""
        oh, ow = self.out_size(h, w)
        py0, py1, px0, px1 = self.pads
        qy = self._axis_adjoint(h, oh, len(self.taps_y), py0, py1)
        qx = self._axis_adjoint(w, ow, len(self.taps_x), px0, px1)
        return FirSpec(_FORM_OF[FACTORS[self.form][::-1]], self.taps_y[::-1], self.taps_x[::-1],
                       (*qy, *qx), tuple(row[::-1] for row in self.taps_2d[::-1]))


def fir_spec(f, taps: Optional[HostTaps], up, down, padding, flip_filter: bool,
             gain: float) -> Tuple[Optional[FirSpec], str]:
    """The :class:`FirSpec` of an ``upfirdn2d`` call, or ``(None, why)``
    when the call is outside the kernels' contract.  ``taps`` are the
    filter's host taps (:attr:`.upfirdn2d.Filter.taps`); without them they
    are computed from a host filter, and a filter on the device is the
    caller's fault and raises."""
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    if upx != upy or downx != downy:
        return None, f"up={up}, down={down} differ between the axes"
    if upx not in (1, 2, 4) or downx not in (1, 2, 4) or min(upx, downx) > 1:
        return None, f"up={upx}, down={downx}"
    if not gain > 0:
        return None, f"gain={gain}"
    if taps is None:
        if f is None:
            taps = ((1.0,), (1.0,))
        elif f.device.type != "cpu":
            raise ValueError("upfirdn2d: the filter lies on the device without its host taps "
                             "(pass an upfirdn2d.Filter, made before the filter moves)")
        else:
            taps = Filter(f).taps
    if isinstance(taps, Taps2D):
        return _spec_2d(taps, upx, downx, padding, flip_filter, gain)
    ty, tx = taps
    if not (1 <= len(ty) <= MAX_TAPS and 1 <= len(tx) <= MAX_TAPS):
        return None, f"{len(ty)} x {len(tx)} taps (at most {MAX_TAPS} per axis)"
    if not flip_filter:
        ty, tx = ty[::-1], tx[::-1]
    ga = float(gain) ** 0.5
    px0, px1, py0, py1 = _parse_padding(padding)
    return FirSpec(_FORM_OF[(upx, downx)], tuple(float(t) * ga for t in ty),
                   tuple(float(t) * ga for t in tx), (py0, py1, px0, px1)), ""


def _spec_2d(taps: Taps2D, up: int, down: int, padding, flip_filter: bool,
             gain: float) -> Tuple[Optional[FirSpec], str]:
    """``fir_spec`` of a 2-D filter: down2 or up2 with at most
    ``MAX_TAPS_2D`` taps each way, else outside the contract."""
    ky, kx = len(taps.rows), len(taps.rows[0])
    if (up, down) not in ((1, 2), (2, 1)) or not (ky <= MAX_TAPS_2D and kx <= MAX_TAPS_2D):
        return None, "2-D filter, not separable"
    a = np.asarray(taps.rows, dtype=np.float64) * float(gain)
    if not flip_filter:
        a = a[::-1, ::-1]
    px0, px1, py0, py1 = _parse_padding(padding)
    return FirSpec(_FORM_OF[(up, down)], (0.0,) * ky, (0.0,) * kx, (py0, py1, px0, px1),
                   tuple(tuple(row) for row in a.tolist())), ""


def up_phases(taps: Tuple[float, ...], p0: int, u: int):
    """The static polyphase split of one axis of an up2 or up4 spec:
    correlation ``taps`` over the ×``u`` zero-stuffed grid with low pad
    ``p0``.  Returns ``(taps_r, d_r)`` for the output residues
    r = 0 .. u - 1, such that

        out[u·b + r] = sum_t taps_r[t] * x[b + d_r + t]

    (the taps j ≡ p0 - r (mod u), ascending, land on input samples; the
    others on stuffed zeros).  ``d_r`` is d_0 for r ≤ p0 mod u and d_0 + 1
    above, so the u outputs u·a + e .. u·a + e + u - 1, with e the count
    of residues at d_0 (mod u), read the same input samples: at u = 2,
    the kernel's two output rows 2a + e, 2a + e + 1 with e = d_1 - d_0."""
    phases = []
    for r in range(u):
        j0 = (p0 - r) % u
        phases.append((tuple(taps[j0::u]), (r + j0 - p0) // u))
    return tuple(phases)


def _lib() -> ctypes.CDLL:
    lib = load_library("fir.cu")
    if not getattr(lib, "_gantrack_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gantrack_fir.argtypes = [p, p, i, i, i, i, i, i, i, i, i, i, p, p, i, i, p]
        lib.gantrack_fir.restype = i
        for up in (lib.gantrack_fir_up2, lib.gantrack_fir_up4):
            up.argtypes = [p, p, i, i, i, i, i, p, p, i, i, p]
            up.restype = i
        lib.gantrack_fir_down4.argtypes = [p, p, i, i, i, i, i, i, i, i, i, p, p, i, i, p]
        lib.gantrack_fir_down4.restype = i
        lib.gantrack_fir_2d.argtypes = [p, p, i, i, i, i, i, i, p, p, i, i, p]
        lib.gantrack_fir_2d.restype = i
        lib._gantrack_typed = True
    return lib


@functools.lru_cache(maxsize=256)
def _c_phases(taps_y: Tuple[float, ...], taps_x: Tuple[float, ...], py0: int, px0: int, u: int):
    """``gantrack_fir_up2``'s / ``gantrack_fir_up4``'s arrays: taps
    [axis][residue][MAX_TAPS // u] and geometry [axis][n_0 .. n_{u-1},
    d_0 .. d_{u-1}], y then x."""
    taps, geom = [], []
    for t, p0 in ((taps_y, py0), (taps_x, px0)):
        phases = up_phases(t, p0, u)
        for tr, _ in phases:
            taps += list(tr) + [0.0] * (MAX_TAPS // u - len(tr))
        geom += [len(tr) for tr, _ in phases] + [d for _, d in phases]
    return (ctypes.c_float * len(taps))(*taps), (ctypes.c_int * len(geom))(*geom)


@functools.lru_cache(maxsize=256)
def _c_2d(spec: FirSpec):
    """``gantrack_fir_2d``'s arrays: down2, the ky x kx taps and {ky, kx,
    py0, px0}; up2, the taps [slot y][slot x][6][6] and {ny0, ny1, nx0,
    nx1, ey, dy, ex, dx} of the static polyphase split, per axis in the
    kernel's slot order: slot s holds the filter indices of output residue
    (e + s) mod 2 (:func:`up_phases`), and the output pair (2a + e, 2a + e
    + 1) reads the input samples a + d + t, t < the slot's count."""
    ky, kx = len(spec.taps_y), len(spec.taps_x)
    if spec.form == "down2":
        taps = [t for row in spec.taps_2d for t in row]
        geom = [ky, kx, spec.pads[0], spec.pads[2]]
    else:
        n = MAX_TAPS_2D // 2
        axes = []
        for k, p0 in ((ky, spec.pads[0]), (kx, spec.pads[2])):
            (i0, d0), (i1, d1) = up_phases(tuple(range(k)), p0, 2)
            e = d1 - d0
            axes.append(((i0, i1) if e == 0 else (i1, i0), e, (d0, d1)[e]))
        (sy, ey, dy), (sx, ex, dx) = axes
        taps = [0.0] * (4 * n * n)
        for a in range(2):
            for b in range(2):
                for t, i in enumerate(sy[a]):
                    for u, j in enumerate(sx[b]):
                        taps[((a * 2 + b) * n + t) * n + u] = spec.taps_2d[i][j]
        geom = [len(sy[0]), len(sy[1]), len(sx[0]), len(sx[1]), ey, dy, ex, dx]
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
        if spec.taps_2d:
            rc = _lib().gantrack_fir_2d(x.data_ptr(), out.data_ptr(), p, h, w, oh, ow,
                                        FACTORS[spec.form][0], *_c_2d(spec), is_bf16,
                                        blocks_per_sm, stream)
        elif spec.form in ("up2", "up4"):
            up = FACTORS[spec.form][0]
            launch = _lib().gantrack_fir_up2 if up == 2 else _lib().gantrack_fir_up4
            rc = launch(x.data_ptr(), out.data_ptr(), p, h, w, oh, ow,
                        *_c_phases(spec.taps_y, spec.taps_x, py0, px0, up), is_bf16, blocks_per_sm,
                        stream)
        elif spec.form == "down4":
            rc = _lib().gantrack_fir_down4(
                x.data_ptr(), out.data_ptr(), p, h, w, oh, ow, py0, px0, len(spec.taps_y),
                len(spec.taps_x), _c_taps(spec.taps_y), _c_taps(spec.taps_x), is_bf16,
                blocks_per_sm, stream)
        else:
            rc = _lib().gantrack_fir(
                x.data_ptr(), out.data_ptr(), p, h, w, oh, ow, FORMS.index(spec.form), py0, px0,
                len(spec.taps_y), len(spec.taps_x), _c_taps(spec.taps_y), _c_taps(spec.taps_x),
                is_bf16, blocks_per_sm, stream)
    check_rc(rc, f"FIR {spec.kernel} kernel")
    profiling.count(f"fir.launch/{spec.kernel}")
    return out


def fir_plain(x: torch.Tensor, spec: FirSpec) -> torch.Tensor:
    """The plain PyTorch version of :func:`fir_planes`, on any device."""
    ty = torch.tensor(spec.taps_y, dtype=torch.float32, device=x.device)
    tx = torch.tensor(spec.taps_x, dtype=torch.float32, device=x.device)
    f = (torch.tensor(spec.taps_2d, dtype=torch.float32, device=x.device) if spec.taps_2d
         else ty if spec.taps_y == spec.taps_x else torch.outer(ty, tx))
    py0, py1, px0, px1 = spec.pads
    up, down = FACTORS[spec.form]
    return upfirdn2d_plain(x[:, None], f, up=up, down=down, padding=[px0, px1, py0, py1],
                           flip_filter=True)[:, 0]


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
