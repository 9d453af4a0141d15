"""Kernel Inception Distance (reference
``metrics/kernel_inception_distance.py:18-44``): polynomial-kernel MMD
averaged over ``num_subsets`` subsets of ≤ ``max_subset_size``.

The host math of ``gantrack_tpu/metrics/kid.py``, unchanged; the feature
passes are the port's.
"""

from __future__ import annotations

import numpy as np

from .metric_utils import (
    MetricOptions,
    compute_feature_stats_for_dataset,
    compute_feature_stats_for_generator,
)


def compute_kid(
    opts: MetricOptions,
    max_real: int,
    num_gen: int,
    num_subsets: int = 100,
    max_subset_size: int = 1000,
) -> float:
    real_features = compute_feature_stats_for_dataset(
        opts, capture_all=True, max_items=max_real
    ).get_all()
    gen_features = compute_feature_stats_for_generator(
        opts, capture_all=True, max_items=num_gen
    ).get_all()

    n = real_features.shape[1]
    m = min(min(real_features.shape[0], gen_features.shape[0]), max_subset_size)
    t = 0.0
    rng = np.random.default_rng(opts.seed)
    for _subset_idx in range(num_subsets):
        x = gen_features[rng.choice(gen_features.shape[0], m, replace=False)]
        y = real_features[rng.choice(real_features.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.trace(a)) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)
