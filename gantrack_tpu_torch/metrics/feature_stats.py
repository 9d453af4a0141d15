"""Feature statistics and the md5-keyed feature cache.

A copy of ``gantrack_tpu/metrics/feature_stats.py``, which is free of
any framework but cannot be imported without JAX: importing it runs
``gantrack_tpu/metrics/__init__.py``, which imports ``metric_utils``,
which imports jax.  float64 raw mean and covariance, optional capture of
all features, ``max_items`` clamping, pickle save and load.

Two changes: :func:`cache_path` takes ``shim``, a token naming the
dataset pass's uint8 shim, into the key, so a changed shim gives a new
cache file instead of reusing features computed under the old one; and
``FeatureStats.append`` is the span ``metric.sums``
(:mod:`..utils.profiling`).
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
from typing import Optional

import numpy as np

from ..utils.profiling import span


class FeatureStats:
    def __init__(self, capture_all: bool = False, capture_mean_cov: bool = False,
                 max_items: Optional[int] = None):
        self.capture_all = capture_all
        self.capture_mean_cov = capture_mean_cov
        self.max_items = max_items
        self.num_items = 0
        self.num_features: Optional[int] = None
        self.all_features = None
        self.raw_mean = None
        self.raw_cov = None

    def set_num_features(self, num_features: int):
        if self.num_features is not None:
            assert num_features == self.num_features
        else:
            self.num_features = num_features
            self.all_features = []
            self.raw_mean = np.zeros([num_features], dtype=np.float64)
            self.raw_cov = np.zeros([num_features, num_features], dtype=np.float64)

    def is_full(self) -> bool:
        return self.max_items is not None and self.num_items >= self.max_items

    def append(self, x: np.ndarray):
        """Counts the rows of ``x`` and keeps or sums them (the span
        ``metric.sums``)."""
        with span("metric.sums"):
            x = np.asarray(x, dtype=np.float32)
            assert x.ndim == 2
            if self.max_items is not None and self.num_items + x.shape[0] > self.max_items:
                if self.num_items >= self.max_items:
                    return
                x = x[: self.max_items - self.num_items]
            self.set_num_features(x.shape[1])
            self.num_items += x.shape[0]
            if self.capture_all:
                self.all_features.append(x)
            if self.capture_mean_cov:
                x64 = x.astype(np.float64)
                self.raw_mean += x64.sum(axis=0)
                self.raw_cov += x64.T @ x64

    def get_all(self) -> np.ndarray:
        assert self.capture_all
        return np.concatenate(self.all_features, axis=0)

    def get_mean_cov(self):
        assert self.capture_mean_cov
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items
        cov = cov - np.outer(mean, mean)
        return mean, cov

    def save(self, pkl_file: str):
        os.makedirs(os.path.dirname(pkl_file), exist_ok=True)
        tmp = pkl_file + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(self.__dict__, f)
        os.replace(tmp, pkl_file)

    @staticmethod
    def load(pkl_file: str) -> "FeatureStats":
        with open(pkl_file, "rb") as f:
            s = pickle.load(f)
        obj = FeatureStats(capture_all=s["capture_all"], max_items=s["max_items"])
        obj.__dict__.update(s)
        return obj


def cache_path(cache_dir: str, tag: str, shim: str, **key_kwargs) -> str:
    """md5-keyed cache file; ``shim`` names the dataset pass's uint8 shim."""
    args = json.dumps(dict(key_kwargs, shim=shim), sort_keys=True, default=repr)
    md5 = hashlib.md5(args.encode("utf-8")).hexdigest()
    return os.path.join(cache_dir, f"{tag}-{md5}.pkl")
