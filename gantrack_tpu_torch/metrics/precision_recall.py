"""Improved precision & recall (reference
``metrics/precision_recall.py:36-63``): VGG16 features, k-NN manifold
radius per feature set, fraction of the other set inside the manifold.

The host math of ``gantrack_tpu/metrics/precision_recall.py``,
unchanged; the feature passes are the port's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .metric_utils import (
    MetricOptions,
    compute_feature_stats_for_dataset,
    compute_feature_stats_for_generator,
)


def _kth_nn_distance(features: np.ndarray, k: int, batch: int = 2048) -> np.ndarray:
    """Distance to the k-th nearest neighbour within ``features``
    (includes self at distance 0, mirroring the reference's kthvalue over
    the full row)."""
    n = features.shape[0]
    out = np.empty(n, dtype=np.float64)
    x2 = np.square(features).sum(1)
    for i in range(0, n, batch):
        d2 = x2[i : i + batch, None] + x2[None, :] - 2 * features[i : i + batch] @ features.T
        d2 = np.maximum(d2, 0)
        out[i : i + batch] = np.sqrt(np.partition(d2, k, axis=1)[:, k])
    return out


def _fraction_in_manifold(
    query: np.ndarray, manifold: np.ndarray, radii: np.ndarray, batch: int = 2048
) -> float:
    hits = 0
    m2 = np.square(manifold).sum(1)
    for i in range(0, query.shape[0], batch):
        q = query[i : i + batch]
        d2 = np.square(q).sum(1)[:, None] + m2[None, :] - 2 * q @ manifold.T
        d2 = np.maximum(d2, 0)
        hits += int((np.sqrt(d2) <= radii[None, :]).any(axis=1).sum())
    return hits / query.shape[0]


def compute_pr(
    opts: MetricOptions,
    max_real: int,
    num_gen: int,
    nhood_size: int = 3,
) -> Tuple[float, float]:
    real = compute_feature_stats_for_dataset(
        opts, capture_all=True, max_items=max_real
    ).get_all().astype(np.float64)
    gen = compute_feature_stats_for_generator(
        opts, capture_all=True, max_items=num_gen
    ).get_all().astype(np.float64)

    real_radii = _kth_nn_distance(real, nhood_size)
    gen_radii = _kth_nn_distance(gen, nhood_size)
    precision = _fraction_in_manifold(gen, real, real_radii)
    recall = _fraction_in_manifold(real, gen, gen_radii)
    return float(precision), float(recall)
