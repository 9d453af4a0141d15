"""Build a CUDA source of ``csrc/`` into a shared library and load it.

The library has a plain C interface and is loaded with ``ctypes``, so
the build needs no PyTorch headers (seconds, not minutes).  It is built
at first use into ``build/gantrack_tpu_torch/`` at the repository root,
under a name keyed by a hash of the source, the headers of ``csrc/`` and
the flags, so an edited source or header is rebuilt and concurrent builds
do not collide.  A missing ``nvcc`` raises: there is no fallback.
:func:`build_all` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "gantrack_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LOCK = threading.Lock()
_SOURCE_LOCKS: Dict[str, threading.Lock] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
# Per source: {"seconds": build time or 0.0 when cached, "log": nvcc output,
# "path": the shared library}.
BUILD_INFO: Dict[str, dict] = {}


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of gantrack_tpu_torch "
                           "need the CUDA toolkit (nvcc on PATH or /usr/local/cuda)")
    return path


def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``; cached per process."""
    with _LOCK:
        lock = _SOURCE_LOCKS.setdefault(source, threading.Lock())
    with lock:
        if source in _LIBS:
            return _LIBS[source]
        src_path = os.path.join(CSRC_DIR, source)
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        # The source and every header of csrc/ it may include.
        for name in [source] + sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")):
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                digest.update(name.encode() + f.read())
        digest = digest.hexdigest()[:16]
        stem = os.path.splitext(source)[0]
        so_path = os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")
        info = {"seconds": 0.0, "log": ""}
        if not os.path.exists(so_path):
            nvcc = find_nvcc()
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            t0 = time.perf_counter()
            try:
                proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, src_path],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, so_path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            info = {"seconds": time.perf_counter() - t0, "log": proc.stdout + proc.stderr}
        info["path"] = so_path
        BUILD_INFO[source] = info
        _LIBS[source] = ctypes.CDLL(so_path)
        return _LIBS[source]


def build_all() -> Dict[str, dict]:
    """Build and load every source of ``csrc/``, one ``nvcc`` each, all
    started together; returns ``BUILD_INFO`` of those sources."""
    sources = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        list(pool.map(load_library, sources))
    return {s: BUILD_INFO[s] for s in sources}


def kernel_resources(log: str) -> Dict[str, dict]:
    """What ``-Xptxas=-v`` printed for each kernel of a build log: {kernel:
    {"registers", "smem" (static bytes), "spill_stores", "spill_loads"}}.
    A kernel is named by the identifier of its mangled name that ends in
    ``_kernel``, with its integer template arguments."""
    out: Dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            # Itanium names are length-prefixed: the identifier that ends in _kernel.
            ids = [mangled[d.end():d.end() + int(d.group())] for d in re.finditer(r"\d+", mangled)]
            base = next((i for i in ids if i.endswith("_kernel")), mangled)
            ints = re.findall(r"Li(\d+)E", mangled)
            name = base + (f"<{', '.join(ints)}>" if ints else "")
            out[name] = {"registers": None, "smem": 0, "spill_stores": 0, "spill_loads": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"], out[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(smem.group(1)) if smem else 0
    return out


def check_planes(t: torch.Tensor, name: str) -> None:
    """Raise unless ``t`` is a contiguous CUDA ``[P, H, W]`` tensor of
    float32 or bfloat16, the layout the kernels of ``csrc/`` take."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.ndim != 3 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous [P, H, W] tensor, got "
                         f"shape {tuple(t.shape)} contiguous={t.is_contiguous()}")


def check_coeffs(coeffs: torch.Tensor, planes: torch.Tensor) -> None:
    """Raise unless ``coeffs`` is the ``[P, 6]`` float32 coefficient table
    of ``planes``' warp, on the same device."""
    if (coeffs.device != planes.device or coeffs.dtype != torch.float32
            or tuple(coeffs.shape) != (planes.shape[0], 6) or not coeffs.is_contiguous()):
        raise ValueError(f"coeffs must be a contiguous float32 [P, 6] tensor on "
                         f"{planes.device}, got {tuple(coeffs.shape)} {coeffs.dtype} "
                         f"on {coeffs.device}")


def check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
