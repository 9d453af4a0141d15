"""Inception Score (reference ``metrics/inception_score.py:18-36``):
exp(E[KL(p(y|x) || p(y))]) over ``num_splits`` splits of softmaxed
detector logits.

The host math of ``gantrack_tpu/metrics/inception_score.py``, unchanged; the feature
passes are the port's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .metric_utils import MetricOptions, compute_feature_stats_for_generator


def compute_is(opts: MetricOptions, num_gen: int, num_splits: int = 10) -> Tuple[float, float]:
    # The detector for IS must output class probabilities/logits; with the
    # feature detector we softmax the 2048-d embedding as a proxy when no
    # logits head is available (documented limitation without pretrained
    # weights).
    gen_probs = compute_feature_stats_for_generator(
        opts, capture_all=True, max_items=num_gen
    ).get_all()
    # softmax if rows aren't already distributions
    if not np.allclose(gen_probs.sum(1), 1, atol=1e-3):
        e = np.exp(gen_probs - gen_probs.max(1, keepdims=True))
        gen_probs = e / e.sum(1, keepdims=True)

    scores = []
    for i in range(num_splits):
        part = gen_probs[i * num_gen // num_splits : (i + 1) * num_gen // num_splits]
        kl = part * (np.log(part + 1e-12) - np.log(np.mean(part, axis=0, keepdims=True) + 1e-12))
        kl = np.mean(np.sum(kl, axis=1))
        scores.append(np.exp(kl))
    return float(np.mean(scores)), float(np.std(scores))
