"""2D resampling: pad → zero-insert upsample → FIR filter → downsample.

Port of ``gantrack_tpu/ops/upfirdn2d.py`` (``setup_filter``,
``upfirdn2d``, ``filter2d``, ``upsample2d``, ``downsample2d``) on NCHW
tensors.

* :func:`upfirdn2d` runs every call that fits the FIR kernels' contract
  (a separable filter of at most 32 taps an axis; ``up`` or ``down`` in
  {1, 2, 4}, the same on both axes, not both above 1; any padding; or a
  2-D filter of at most 12 x 12 taps at ``up`` or ``down`` 2, StyleGAN3-R's
  radial down-filters and their adjoints) through :class:`.fir.Fir`: on a
  CUDA tensor that launches the hand-written kernels of ``csrc/fir.cu``
  (K5–K7, K7 at ×4, the ↓4 kernel and the 2-D forms), on a CPU tensor it
  computes the plain form.  A call outside the contract (a 2-D filter at
  another factor or larger, more than 32 taps an axis, other factors)
  takes :func:`upfirdn2d_plain` on any device.  That is decided
  from the call's static spec before anything is launched, and counted in the
  installed recorder (:mod:`..utils.profiling`): ``upfirdn2d.kernel_route``,
  or ``upfirdn2d.plain_route/<why>`` by reason; a kernel that fails to
  build or launch still raises.
* :func:`upfirdn2d_plain` is the plain PyTorch version: a depthwise
  convolution (separable filters as a vertical then a horizontal pass)
  over a zero-inserted, padded copy.  The conv is
  :mod:`.conv2d_gradfix`'s, so its double backward never forms a weight
  gradient for the constant filter.

A filter is a :class:`Filter`: made once on the host from what
:func:`setup_filter` returns, it holds the tensor, its host taps (the
separable factors of :func:`filter_taps`, or, for a 2-D filter that has
none, its rows as :class:`Taps2D`), computed once, which the kernels take
so that no call reads a device filter back (which would synchronise the
stream), and a copy per device, made on first use, for the plain route.
The JAX module's banded-matrix lowerings are a TPU layout device and are
not carried.

Numerics contract (as the JAX module): 1. zero-insert upsample by
``up``; 2. zero-pad/crop by ``padding`` (relative to the upsampled
grid); 3. *convolve* (flipped cross-correlation unless ``flip_filter``)
with ``f * gain**(f.ndim/2)``; 4. keep every ``down``-th pixel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import profiling
from .conv2d_gradfix import conv2d

IntOrPair = Union[int, Sequence[int]]
Taps = Tuple[Tuple[float, ...], Tuple[float, ...]]


@dataclasses.dataclass(frozen=True)
class Taps2D:
    """The host taps of a 2-D filter that :func:`filter_taps` could not
    factor: its rows, as :func:`setup_filter` made it (before flip and
    gain), in host floats."""

    rows: Tuple[Tuple[float, ...], ...]


HostTaps = Union[Taps, Taps2D]


def _parse_scaling(scaling: IntOrPair) -> Tuple[int, int]:
    if isinstance(scaling, (int, np.integer)):
        scaling = [int(scaling)] * 2
    sx, sy = (int(v) for v in scaling)
    assert sx >= 1 and sy >= 1, f"invalid scaling {scaling}"
    return sx, sy


def _parse_padding(padding: IntOrPair) -> Tuple[int, int, int, int]:
    if isinstance(padding, (int, np.integer)):
        padding = [int(padding)] * 2
    padding = [int(v) for v in padding]
    if len(padding) == 2:
        px, py = padding
        padding = [px, px, py, py]
    px0, px1, py0, py1 = padding
    return px0, px1, py0, py1


def _get_filter_size(f) -> Tuple[int, int]:
    if f is None:
        return 1, 1
    if isinstance(f, Filter):
        f = f.host
    assert f.ndim in (1, 2)
    return int(f.shape[-1]), int(f.shape[0])


def setup_filter(
    f,
    normalize: bool = True,
    flip_filter: bool = False,
    gain: float = 1,
    separable: Optional[bool] = None,
    device=None,
) -> torch.Tensor:
    """Prepare a FIR filter for :func:`upfirdn2d` (float32 tensor).

    ``None`` → identity impulse; 1-D inputs become separable iff >= 8
    taps (else outer product to 2-D); DC-normalise; optional flip; scale
    by ``gain ** (ndim / 2)``.  Computed in float64 numpy, as the JAX
    module does, then cast.
    """
    if f is None:
        f = 1
    f = np.asarray(f.cpu() if isinstance(f, torch.Tensor) else f, dtype=np.float64)
    assert f.ndim in (0, 1, 2) and f.size > 0
    if f.ndim == 0:
        f = f[np.newaxis]
    if separable is None:
        separable = f.ndim == 1 and f.size >= 8
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    assert f.ndim == (1 if separable else 2)
    if normalize:
        f = f / np.sum(f)
    if flip_filter:
        f = np.flip(f, axis=tuple(range(f.ndim)))
    f = f * (gain ** (f.ndim / 2))
    return torch.tensor(np.ascontiguousarray(f), dtype=torch.float32, device=device)


def filter_taps(f) -> Optional[Taps]:
    """The separable factors ``(taps_y, taps_x)`` of a host filter as
    :func:`setup_filter` made it (before flip and gain), or None when a
    2-D filter is not of rank 1.  A 1-D filter is its own factor on both
    axes; a rank-1 2-D filter is split with equal magnitude on each axis,
    so ``setup_filter([1, 3, 3, 1])`` gives ``[1, 3, 3, 1] / 8`` twice."""
    if isinstance(f, torch.Tensor):
        if f.device.type != "cpu":
            raise ValueError("filter_taps reads a host filter; compute the taps when the "
                             "filter is set up, before it moves to the device")
        f = f.detach().numpy()
    a = np.asarray(f, dtype=np.float64)
    if a.ndim == 1:
        t = tuple(a.tolist())
        return t, t
    assert a.ndim == 2
    i, j = np.unravel_index(int(np.abs(a).argmax()), a.shape)
    p = a[i, j]
    if p == 0:
        return None
    s = np.sqrt(abs(p))
    ty, tx = a[:, j] / s, a[i, :] * (s / p)
    if not np.allclose(np.outer(ty, tx), a, rtol=1e-5, atol=1e-6 * abs(p)):
        return None
    return tuple(ty.tolist()), tuple(tx.tolist())


class Filter:
    """A FIR filter, made once on the host: ``host``, the tensor as
    :func:`setup_filter` made it; ``taps``, its host taps (the separable
    factors of :func:`filter_taps`, else its rows as :class:`Taps2D`),
    computed here once; :meth:`on`, its copy on a device, made on first
    use.  Immutable, so a copied module shares it."""

    def __init__(self, f):
        host = torch.as_tensor(f)
        taps = filter_taps(host)  # raises for a filter on the device
        self.host = host
        self.taps: HostTaps = taps if taps is not None else Taps2D(
            tuple(tuple(row) for row in host.double().tolist()))
        self._copies = {}

    def on(self, device) -> torch.Tensor:
        """The filter on ``device`` (the host tensor itself on the CPU)."""
        device = torch.device(device)
        if device.type == "cpu":
            return self.host
        copy = self._copies.get(device)
        if copy is None:  # two threads may each make one: either serves
            copy = self._copies[device] = self.host.to(device)
        return copy

    def __deepcopy__(self, memo) -> "Filter":
        return self


def _as_filter(f):
    """``f`` as :func:`upfirdn2d` takes it: a :class:`Filter` or None as
    it is, a host tensor or array wrapped (its taps computed for this call),
    a tensor on a device as it is (the kernels raise for want of its taps)."""
    if f is None or isinstance(f, Filter) or (isinstance(f, torch.Tensor)
                                              and f.device.type != "cpu"):
        return f
    return Filter(f)


def _depthwise(x: torch.Tensor, f2d: torch.Tensor, stride=(1, 1)) -> torch.Tensor:
    """VALID strided cross-correlation of every channel with one [fh, fw] filter."""
    c = x.shape[1]
    w = f2d.to(x.dtype)[None, None].expand(c, 1, *f2d.shape)
    return conv2d(x, w, stride=stride, groups=c)


def upfirdn2d(
    x: torch.Tensor,
    f,
    up: IntOrPair = 1,
    down: IntOrPair = 1,
    padding: IntOrPair = 0,
    flip_filter: bool = False,
    gain: float = 1,
) -> torch.Tensor:
    """Pad, upsample, FIR-filter and downsample a batch of NCHW images.

    Returns ``[N, C, out_h, out_w]`` with
    ``out_h = (H*upy + pady0 + pady1 - fh) // downy + 1`` (same for w).
    ``f`` is a :class:`Filter`, a host filter or None (see :func:`_as_filter`).
    """
    from . import fir  # here: fir.py imports this module

    f = _as_filter(f)
    spec, why = fir.fir_spec(f, getattr(f, "taps", None), up, down, padding, flip_filter, gain)
    if spec is None:  # outside the kernels' contract: the plain version, counted
        profiling.count(f"upfirdn2d.plain_route/{why}")
        if isinstance(f, Filter):
            f = f.on(x.device)
        return upfirdn2d_plain(x, f, up, down, padding, flip_filter, gain)
    profiling.count("upfirdn2d.kernel_route")
    n, c, h, w = x.shape
    out = fir.Fir.apply(x.reshape(n * c, h, w).contiguous(), spec)
    return out.reshape(n, c, *out.shape[1:])


def upfirdn2d_plain(
    x: torch.Tensor,
    f: Optional[torch.Tensor],
    up: IntOrPair = 1,
    down: IntOrPair = 1,
    padding: IntOrPair = 0,
    flip_filter: bool = False,
    gain: float = 1,
) -> torch.Tensor:
    """The plain PyTorch version of :func:`upfirdn2d` (any filter and
    factors, any device): depthwise convolution over a zero-inserted,
    padded copy."""
    assert x.ndim == 4, f"expected NCHW, got shape {tuple(x.shape)}"
    if f is None:
        f = torch.ones([1, 1], dtype=torch.float32, device=x.device)
    assert f.ndim in (1, 2)
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    n, c, h, w = x.shape

    # Zero-insert upsample: up-1 trailing zeros after every sample.
    if upx > 1 or upy > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(n, c, h * upy, w * upx)
    # Pad (positive) and crop (negative).
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0): x.shape[2] - max(-py1, 0),
          max(-px0, 0): x.shape[3] - max(-px1, 0)]
    assert x.shape[2] >= f.shape[0] and x.shape[3] >= f.shape[-1], (
        f"upsampled buffer {tuple(x.shape[2:])} smaller than filter {tuple(f.shape)}")

    f = f * (gain ** (f.ndim / 2))
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))
    if f.ndim == 2:
        return _depthwise(x, f, (downy, downx))
    x = _depthwise(x, f[:, None], (downy, 1))
    return _depthwise(x, f[None, :], (1, downx))


def filter2d(x, f, padding: IntOrPair = 0, flip_filter: bool = False, gain: float = 1):
    """FIR-filter NCHW images, output shape-matched to input."""
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [px0 + fw // 2, px1 + (fw - 1) // 2, py0 + fh // 2, py1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d_args(f, up: IntOrPair = 2, padding: IntOrPair = 0, gain: float = 1) -> dict:
    """The :func:`upfirdn2d` arguments of :func:`upsample2d`:
    output-centred padding and ``gain * up_x * up_y`` DC compensation."""
    upx, upy = _parse_scaling(up)
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [
        px0 + (fw + upx - 1) // 2,
        px1 + (fw - upx) // 2,
        py0 + (fh + upy - 1) // 2,
        py1 + (fh - upy) // 2,
    ]
    return dict(up=up, padding=p, gain=gain * upx * upy)


def upsample2d(x, f, up: IntOrPair = 2, padding: IntOrPair = 0,
               flip_filter: bool = False, gain: float = 1):
    """Upsample NCHW images with output-centred padding and
    ``gain * up_x * up_y`` DC compensation."""
    return upfirdn2d(x, f, flip_filter=flip_filter, **upsample2d_args(f, up, padding, gain))


def downsample2d(x, f, down: IntOrPair = 2, padding: IntOrPair = 0,
                 flip_filter: bool = False, gain: float = 1):
    """Downsample NCHW images with the given FIR filter."""
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [
        px0 + (fw - downx + 1) // 2,
        px1 + (fw - downx) // 2,
        py0 + (fh - downy + 1) // 2,
        py1 + (fh - downy) // 2,
    ]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter, gain=gain)
