"""Scalar training statistics (training_stats equivalent).

Port of ``gantrack_tpu/training/stats.py``: ``report`` accumulates
per-name moments ``[num, sum, sum_sq]`` as float32 tensors on the
values' device (no host sync in the step); the host-side
:class:`Collector` accumulates them between ticks and renders the
``stats.jsonl`` records.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch

Moments = Dict[str, torch.Tensor]  # name -> f32[3] = [n, sum, sum_sq]


def report(moments: Moments, name: str, value) -> Moments:
    """Record a tensor's moments under ``name``; repeats accumulate."""
    v = torch.as_tensor(value).detach().float().reshape(-1)
    m = torch.stack([torch.tensor(float(v.numel()), device=v.device), v.sum(), v.square().sum()])
    out = dict(moments)
    out[name] = moments[name] + m if name in moments else m
    return out


def merge(*moment_dicts: Moments) -> Moments:
    out: Moments = {}
    for d in moment_dicts:
        for k, v in d.items():
            out[k] = out[k] + v if k in out else v
    return out


class Collector:
    """Host-side accumulator over per-step moment dicts."""

    def __init__(self):
        self._moments: Dict[str, np.ndarray] = {}

    def update(self, moments: Mapping[str, torch.Tensor]) -> None:
        for k, v in moments.items():
            v = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v, np.float64)
            self._moments[k] = self._moments.get(k, np.zeros(3)) + v

    def num(self, name: str) -> float:
        return float(self._moments.get(name, np.zeros(3))[0])

    def mean(self, name: str, default: float = 0.0) -> float:
        m = self._moments.get(name)
        if m is None or m[0] == 0:
            return default
        return float(m[1] / m[0])

    def std(self, name: str) -> float:
        m = self._moments.get(name)
        if m is None or m[0] <= 1 or not np.isfinite(m[1] / m[0]):
            return 0.0
        mean = m[1] / m[0]
        return float(np.sqrt(max(m[2] / m[0] - mean ** 2, 0)))

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {name: {"num": self.num(name), "mean": self.mean(name), "std": self.std(name)}
                for name in self._moments}

    def clear(self) -> None:
        self._moments.clear()


class JsonlLogger:
    """Append-only jsonl writer for stats records."""

    def __init__(self, path: str):
        self._f = open(path, "at", buffering=1)

    def write(self, record: Mapping, timestamp: Optional[float] = None) -> None:
        rec = dict(record)
        rec["timestamp"] = timestamp if timestamp is not None else time.time()
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()
