"""Memory readings for the training loop's tick record.

Port of the part of ``gantrack_tpu/utils/profiling.py`` that the loop
calls: :func:`device_memory_stats` maps ``torch.cuda.memory_stats`` to
the JAX package's keys (``gb_in_use``, ``peak_gb_in_use``, ``gb_limit``),
and :func:`cpu_mem_gb` reads the process's current resident memory.
Traces come from ``torch.profiler`` directly (``step_profile.py``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch


def device_memory_stats(device=None) -> Dict[str, float]:
    """Current and peak allocated memory of a CUDA device and its size, in
    GiB, under the JAX package's keys; ``{}`` for the CPU."""
    device = torch.device(device) if device is not None else None
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "gb_in_use": stats.get("allocated_bytes.all.current", 0) / 2**30,
        "peak_gb_in_use": stats.get("allocated_bytes.all.peak", 0) / 2**30,
        "gb_limit": torch.cuda.mem_get_info(device)[1] / 2**30,
    }


def cpu_mem_gb() -> Optional[float]:
    """The process's current resident memory in GiB (``/proc/self/statm``;
    None where there is no ``/proc``)."""
    try:
        with open("/proc/self/statm") as f:
            resident_pages = int(f.read().split()[1])
    except OSError:
        return None
    return resident_pages * os.sysconf("SC_PAGE_SIZE") / 2**30
