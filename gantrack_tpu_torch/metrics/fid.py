"""Fréchet Inception Distance (reference
``metrics/frechet_inception_distance.py:20-40``).

The host math of ``gantrack_tpu/metrics/fid.py``, unchanged; the feature
passes are the port's.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg

from .metric_utils import (
    MetricOptions,
    compute_feature_stats_for_dataset,
    compute_feature_stats_for_generator,
)


def compute_fid(opts: MetricOptions, max_real: int, num_gen: int) -> float:
    stats_real = compute_feature_stats_for_dataset(
        opts, capture_mean_cov=True, max_items=max_real
    )
    mu_real, sigma_real = stats_real.get_mean_cov()

    stats_gen = compute_feature_stats_for_generator(
        opts, capture_mean_cov=True, max_items=num_gen
    )
    mu_gen, sigma_gen = stats_gen.get_mean_cov()

    m = np.square(mu_gen - mu_real).sum()
    # ``disp=False`` of the JAX module is deprecated in scipy; the default
    # returns the same matrix.
    s = scipy.linalg.sqrtm(np.dot(sigma_gen, sigma_real))
    fid = np.real(m + np.trace(sigma_gen + sigma_real - s * 2))
    return float(fid)
