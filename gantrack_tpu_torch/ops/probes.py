"""Capability probes P1–P6: what the card gives the 3×3 implicit-GEMM conv.

Port of ``scripts/probe_matmul.py`` (P1) and ``scripts/probe_mosaic.py``
(P2–P6), which compiled tiny Pallas kernels to learn what the TPU's Mosaic
compiler accepts.  Each probe here launches a small hand-written kernel
of ``csrc/probe.cu`` that asks the card the same question, and returns the
probe's array; beside it stands a plain PyTorch version.  A CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.

======  ==========================  =======================================
probe   JAX original                what it computes
======  ==========================  =======================================
P1      ``probe_matmul.mk``         ``a [m, k] @ b [k, n]`` (or ``b [n, k]``
                                    transposed) for an operand / result type
                                    pair, on the tensor cores
P2      ``probe_mosaic.probe_a``    a 16×32×64 tile of the 3×3 conv from an
                                    ``[18, 34, 64]`` halo window, as it lies
P3      ``probe_mosaic.probe_b``    the same from a ``[24, 40, 64]`` window
                                    staged with a padded stride
P4      ``probe_mosaic.probe_c``    ``x[:, :16, :32]`` through a two-slot
                                    asynchronous-copy ring, slot at run time
P5      ``probe_mosaic.probe_d``    nine ``[256, 64]`` pieces side by side
P6      ``probe_mosaic.probe_e``    rows 1..32 of a ``[40, 128]`` array
======  ==========================  =======================================

:func:`run_probes` runs them all on the scripts' inputs (ones) and prints
one line each, as the scripts' ``__main__`` do; ``python -m
gantrack_tpu_torch.ops.probes`` calls it.  Each kernel launch counts
``probes.launch/<probe>`` in the installed recorder
(:mod:`..utils.profiling`).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..utils import profiling
from ._nvcc import check_rc, load_library

__all__ = ["probe_matmul", "probe_halo_tile", "probe_padded_tile", "probe_ring", "probe_concat",
           "probe_row_slice", "probe_matmul_plain", "probe_tile_plain", "probe_ring_plain",
           "probe_concat_plain", "probe_row_slice_plain", "matmul_cases", "run_probes",
           "TH", "W", "C"]

TH, W, C = 16, 32, 64  # the tile of probe_mosaic.py

_BF16, _F32 = torch.bfloat16, torch.float32


def matmul_cases():
    """The cases of ``probe_matmul.py``: (label, m, k, n, dtype of a, of b,
    of the result, b transposed), with how the card computes each."""
    return [
        ("bf16xbf16->f32 48x128x128 (mma.m16n8k16)", 48, 128, 128, _BF16, _BF16, _F32, False),
        ("bf16xbf16->f32 128x128x128 (mma.m16n8k16)", 128, 128, 128, _BF16, _BF16, _F32, False),
        ("bf16xbf16->bf16 48x128x128 (f32 sum rounded in registers)", 48, 128, 128, _BF16, _BF16,
         _BF16, False),
        ("f32xbf16->f32 48x128x128 (f32 split into two tf32 terms in registers, 2 x "
         "mma.m16n8k8)", 48, 128, 128, _F32, _BF16, _F32, False),
        ("bf16xf32->f32 48x128x128 (f32 split into two tf32 terms in registers, 2 x "
         "mma.m16n8k8)", 48, 128, 128, _BF16, _F32, _F32, False),
        ("f32xf32->f32 48x128x128 (both split into two tf32 terms in registers, 3 x "
         "mma.m16n8k8)", 48, 128, 128, _F32, _F32, _F32, False),
        ("bf16xbf16->f32 rhsT 48x128 (mma.m16n8k16)", 48, 128, 128, _BF16, _BF16, _F32, True),
        ("bf16xbf16->f32 16x128x128 (mma.m16n8k16)", 16, 128, 128, _BF16, _BF16, _F32, False),
    ]


def _lib() -> ctypes.CDLL:
    lib = load_library("probe.cu")
    if not getattr(lib, "_gantrack_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gantrack_probe_matmul.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        lib.gantrack_probe_tile.argtypes = [p, p, p, i, i, i, i, p]
        lib.gantrack_probe_ring.argtypes = [p, p, i, p]
        lib.gantrack_probe_concat.argtypes = [p, p, i, p]
        lib.gantrack_probe_row_slice.argtypes = [p, p, p]
        for fn in (lib.gantrack_probe_matmul, lib.gantrack_probe_tile, lib.gantrack_probe_ring,
                   lib.gantrack_probe_concat, lib.gantrack_probe_row_slice):
            fn.restype = i
        lib._gantrack_typed = True
    return lib


def _require(t: torch.Tensor, shape: Tuple, dtypes, name: str) -> None:
    """Raise unless ``t`` is contiguous, of ``shape`` (None: any extent)
    and of one of ``dtypes``."""
    ok = (t.ndim == len(shape) and all(s is None or s == d for s, d in zip(shape, t.shape))
          and t.dtype in dtypes and t.is_contiguous())
    if not ok:
        raise ValueError(f"{name} must be a contiguous {shape} tensor of {dtypes}, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _launch(name: str, fn, out: torch.Tensor, *args) -> torch.Tensor:
    with torch.cuda.device(out.device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    check_rc(rc, f"{name} kernel")
    profiling.count(f"probes.launch/{name}")
    return out


# ---------------------------------------------------------------- P1

def probe_matmul_plain(a, b, out_dtype=_F32, b_transposed: bool = False) -> torch.Tensor:
    """Plain version of P1: the product in float32, rounded to ``out_dtype``."""
    b = b.float().t() if b_transposed else b.float()
    return (a.float() @ b).to(out_dtype)


def probe_matmul(a: torch.Tensor, b: torch.Tensor, out_dtype=_F32,
                 b_transposed: bool = False) -> torch.Tensor:
    """P1: ``a [m, k] @ b [k, n]`` (``b [n, k]`` when ``b_transposed``) on
    the tensor cores, float32 sums, result in ``out_dtype``.  bfloat16 ×
    bfloat16 is one native ``mma``; a pair with a float32 operand goes
    through tf32 in registers (the card has no other ``mma`` form for it):
    a bfloat16 operand is exact there, a float32 one is split into two tf32
    terms whose cross products are summed, so the result is the float32
    product to float32 rounding (1e-5 of the largest value), never a tf32
    one."""
    _require(a, (None, None), (_BF16, _F32), "a")
    _require(b, (None, None), (_BF16, _F32), "b")
    m, k = a.shape
    n = b.shape[0] if b_transposed else b.shape[1]
    if (b.shape[1] if b_transposed else b.shape[0]) != k or out_dtype not in (_BF16, _F32):
        raise ValueError(f"probe_matmul: a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"b_transposed={b_transposed}, out {out_dtype}")
    if m % 16 or n % 8 or k % 16:
        raise ValueError(f"probe_matmul: m, n, k = {m}, {n}, {k} must be multiples of 16, 8, 16")
    if a.device.type == "cpu":
        return probe_matmul_plain(a, b, out_dtype, b_transposed)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    return _launch("probe_matmul", _lib().gantrack_probe_matmul, out, a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), m, k, n, int(a.dtype == _BF16), int(b.dtype == _BF16),
                   int(out_dtype == _BF16), int(b_transposed))


# ------------------------------------------------------------ P2, P3

def probe_tile_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of P2 and P3: the 3×3 VALID conv of rows 0..17, columns
    0..33 of each ``[tiles, rows, cols, 64]`` window with ``w [576, 64]``
    (rows ``tap * 64 + ci``), float32 sums, to ``[tiles, 16, 32, 64]``."""
    win = x[:, :TH + 2, :W + 2].float().permute(0, 3, 1, 2)
    wk = w.float().reshape(3, 3, C, C).permute(3, 2, 0, 1)
    return F.conv2d(win, wk).permute(0, 2, 3, 1).contiguous().to(x.dtype)


def _probe_tile(name: str, x, w, rows: int, cols: int, padded: bool) -> torch.Tensor:
    _require(x, (None, rows, cols, C), (_BF16,), "x")
    _require(w, (9 * C, C), (_BF16,), "w")
    if x.device.type == "cpu":
        return probe_tile_plain(x, w)
    out = torch.empty((x.shape[0], TH, W, C), dtype=_BF16, device=x.device)
    return _launch(name, _lib().gantrack_probe_tile, out, x.data_ptr(), w.data_ptr(),
                   out.data_ptr(), x.shape[0], rows, cols, int(padded))


def probe_halo_tile(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """P2: one 16×32×64 conv tile a window from ``x [tiles, 18, 34, 64]``,
    copied into shared memory asynchronously as it lies."""
    return _probe_tile("probe_halo_tile", x, w, TH + 2, W + 2, False)


def probe_padded_tile(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """P3: the same tile from the wider ``x [tiles, 24, 40, 64]``, staged
    with a padded pixel stride so the shifted reads meet no bank conflict."""
    return _probe_tile("probe_padded_tile", x, w, TH + 8, W + 8, True)


# ---------------------------------------------------------------- P4

def probe_ring_plain(x: torch.Tensor) -> torch.Tensor:
    return x[:, :TH, :W].contiguous()


def probe_ring(x: torch.Tensor) -> torch.Tensor:
    """P4: ``x [tiles, 24, 40, 64]`` → ``x[:, :16, :32]`` through a
    two-slot asynchronous-copy ring whose slot is chosen at run time."""
    _require(x, (None, TH + 8, W + 8, C), (_BF16,), "x")
    if x.device.type == "cpu":
        return probe_ring_plain(x)
    out = torch.empty((x.shape[0], TH, W, C), dtype=_BF16, device=x.device)
    return _launch("probe_ring", _lib().gantrack_probe_ring, out, x.data_ptr(), out.data_ptr(),
                   x.shape[0])


# ---------------------------------------------------------------- P5

def probe_concat_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.cat(list(x), dim=-1)


def probe_concat(x: torch.Tensor) -> torch.Tensor:
    """P5: nine ``[rows, 64]`` pieces ``x [9, rows, 64]`` assembled into
    ``[rows, 576]`` rows in shared memory (``rows`` a multiple of 64)."""
    _require(x, (9, None, C), (_BF16,), "x")
    if x.shape[1] % 64:
        raise ValueError(f"probe_concat: {x.shape[1]} rows, not a multiple of 64")
    if x.device.type == "cpu":
        return probe_concat_plain(x)
    out = torch.empty((x.shape[1], 9 * C), dtype=_BF16, device=x.device)
    return _launch("probe_concat", _lib().gantrack_probe_concat, out, x.data_ptr(),
                   out.data_ptr(), x.shape[1])


# ---------------------------------------------------------------- P6

def probe_row_slice_plain(x: torch.Tensor) -> torch.Tensor:
    return x[1:33].contiguous()


def probe_row_slice(x: torch.Tensor) -> torch.Tensor:
    """P6: rows 1..32 of ``x [40, 128]`` staged in shared memory."""
    _require(x, (40, 128), (_BF16,), "x")
    if x.device.type == "cpu":
        return probe_row_slice_plain(x)
    out = torch.empty((32, 128), dtype=_BF16, device=x.device)
    return _launch("probe_row_slice", _lib().gantrack_probe_row_slice, out, x.data_ptr(),
                   out.data_ptr())


# ------------------------------------------------------------ the run

def run_probes(device="cuda", verbose: bool = True) -> Dict[str, float]:
    """Every probe on the inputs of the JAX scripts (ones), one line each
    as the scripts print them; returns {label: sum of the result}."""
    dev = torch.device(device)
    sums: Dict[str, float] = {}

    def run(label, fn):
        sums[label] = float(fn().float().sum())
        if verbose:
            print(f"{label}: OK sum={sums[label]:.3f}")

    for label, m, k, n, adt, bdt, odt, b_t in matmul_cases():
        a = torch.ones((m, k), dtype=adt, device=dev)
        b = torch.ones((n, k) if b_t else (k, n), dtype=bdt, device=dev)
        run(label, lambda: probe_matmul(a, b, odt, b_t))
    w = torch.ones((9 * C, C), dtype=_BF16, device=dev)
    run("A halo-window-as-it-lies", lambda: probe_halo_tile(
        torch.ones((4, TH + 2, W + 2, C), dtype=_BF16, device=dev), w))
    wide = torch.ones((4, TH + 8, W + 8, C), dtype=_BF16, device=dev)
    run("B padded-window-shifted-reads", lambda: probe_padded_tile(wide, w))
    run("C two-slot-ring-dynslot", lambda: probe_ring(wide))
    run("D concat-9x64", lambda: probe_concat(torch.ones((9, 256, C), dtype=_BF16, device=dev)))
    run("E row-offset-slice", lambda: probe_row_slice(
        torch.ones((40, 128), dtype=_BF16, device=dev)))
    return sums


if __name__ == "__main__":
    run_probes()
