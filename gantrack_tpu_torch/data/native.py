"""ctypes bindings for the native batch-assembly library.

``native/batch_loader.cpp`` gathers sample slices from memmapped shards
into a contiguous normalised NHWC batch on a persistent C++ thread pool
(the replacement for the reference's DataLoader worker processes).
The port's own copy of ``gantrack_tpu/data/native.py``; both build the
same ``native/batch_loader.cpp``.  Transparently built on first use; all callers fall back to
the NumPy path when the toolchain or build is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libgantrack_native.so")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_SO_PATH):
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR], check=True,
                capture_output=True, timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
        lib.gantrack_assemble_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),                  # shard_ptrs
            ctypes.POINTER(ctypes.c_int64),                   # shard_starts
            ctypes.c_int64,                                   # num_shards
            ctypes.POINTER(ctypes.c_int64),                   # indices
            ctypes.POINTER(ctypes.c_uint8),                   # flips (nullable)
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int,                                     # normalize
            ctypes.POINTER(ctypes.c_float),                   # out
            ctypes.c_int,                                     # threads
        ]
        lib.gantrack_assemble_batch.restype = None
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def native_available() -> bool:
    return _load() is not None


def assemble_batch(
    shards: List[np.ndarray],       # float32 [n_i, H, W, C] (memmap ok)
    indices: np.ndarray,            # int64 [B] global indices
    flips: Optional[np.ndarray] = None,  # uint8 [B]
    normalize: bool = True,
    threads: int = 0,
) -> np.ndarray:
    """Gather+normalise a batch; native if possible, NumPy otherwise."""
    h, w, c = shards[0].shape[1:]
    batch = len(indices)
    out = np.empty((batch, h, w, c), np.float32)
    starts = np.cumsum([0] + [s.shape[0] for s in shards[:-1]]).astype(np.int64)

    lib = _load()
    contiguous = all(
        isinstance(s, np.memmap) or s.flags["C_CONTIGUOUS"] for s in shards
    )
    if lib is not None and contiguous and all(s.dtype == np.float32 for s in shards):
        ptrs = (ctypes.c_void_p * len(shards))(
            *[s.ctypes.data_as(ctypes.c_void_p).value for s in shards]
        )
        idx = np.ascontiguousarray(indices, np.int64)
        flips_arr = (
            np.ascontiguousarray(flips, np.uint8) if flips is not None else None
        )
        lib.gantrack_assemble_batch(
            ptrs,
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(shards),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            flips_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) if flips_arr is not None else None,
            batch, h, w, c,
            1 if normalize else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            threads,
        )
        return out

    # NumPy fallback.
    for i, gidx in enumerate(indices):
        shard = int(np.searchsorted(starts, gidx, side="right") - 1)
        img = np.asarray(shards[shard][gidx - starts[shard]], np.float32)
        if flips is not None and flips[i]:
            img = img[:, ::-1, :]
        out[i] = img / 127.5 - 1.0 if normalize else img
    return out
