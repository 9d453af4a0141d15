"""Statistical comparison utilities for experiment analysis.

The port's own copy of ``gantrack_tpu/utils/stats_tests.py`` (numpy and
scipy only; ``tests/test_torch_tools.py`` holds the two equal).

Capability parity with the reference ``src/engine/utils/nemanyi_utils.py``
(rank computation, Nemenyi post-hoc test, and the classification/agreement
scores its ``__all__`` exports).  Re-designed: critical values come from
the studentized-range distribution (``q_{α,k,∞}/√2``) instead of a
hard-coded table — matching the table to 3 decimals for k ∈ [2, 50].
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.stats


def r2_score(y_true, y_pred) -> float:
    """Coefficient of determination (reference ``nemanyi_utils.py:10-51``)."""
    y_true = np.asarray(y_true, np.float64).ravel()
    y_pred = np.asarray(y_pred, np.float64).ravel()
    num = np.sum((y_true - y_pred) ** 2)
    den = np.sum((y_true - np.mean(y_true)) ** 2)
    if den == 0.0:
        return 1.0 if num == 0.0 else 0.0
    return float(1 - num / den)


def _confusion(y_true, y_pred) -> Tuple[float, float, float, float]:
    y_true = np.asarray(y_true).ravel().astype(bool)
    y_pred = np.asarray(y_pred).ravel().astype(bool)
    tp = float(np.sum(y_true & y_pred))
    tn = float(np.sum(~y_true & ~y_pred))
    fp = float(np.sum(~y_true & y_pred))
    fn = float(np.sum(y_true & ~y_pred))
    return tp, tn, fp, fn


def sensitivity(y_true, y_pred) -> float:
    tp, _tn, _fp, fn = _confusion(y_true, y_pred)
    return tp / (tp + fn) if tp + fn else 0.0


def specificity(y_true, y_pred) -> float:
    _tp, tn, fp, _fn = _confusion(y_true, y_pred)
    return tn / (tn + fp) if tn + fp else 0.0


def ppv(y_true, y_pred) -> float:
    tp, _tn, fp, _fn = _confusion(y_true, y_pred)
    return tp / (tp + fp) if tp + fp else 0.0


def npv(y_true, y_pred) -> float:
    _tp, tn, _fp, fn = _confusion(y_true, y_pred)
    return tn / (tn + fn) if tn + fn else 0.0


def F_score(y_true, y_pred, beta: float = 1.0) -> float:
    p = ppv(y_true, y_pred)
    r = sensitivity(y_true, y_pred)
    if p + r == 0:
        return 0.0
    b2 = beta * beta
    return (1 + b2) * p * r / (b2 * p + r)


def fleiss_kappa(ratings: np.ndarray) -> float:
    """Inter-rater agreement; ``ratings[i, j]`` = #raters assigning item i
    to category j."""
    ratings = np.asarray(ratings, np.float64)
    n_items, _ = ratings.shape
    n_raters = ratings[0].sum()
    p_j = ratings.sum(axis=0) / (n_items * n_raters)
    p_i = ((ratings**2).sum(axis=1) - n_raters) / (n_raters * (n_raters - 1))
    p_bar = p_i.mean()
    p_e = (p_j**2).sum()
    return float((p_bar - p_e) / (1 - p_e)) if p_e != 1 else 1.0


def compute_ranks(x: np.ndarray, method: str = "average") -> np.ndarray:
    """Row-wise ranks (reference ``:123-148``)."""
    if method not in ("average", "min", "max", "dense", "ordinal"):
        raise ValueError(method)
    x = np.asarray(x)
    return np.stack([scipy.stats.rankdata(row, method=method) for row in x])


def critical_nemenyi_value(p_value: float, num_models: int) -> float:
    """``q_{α,k,∞} / √2`` from the studentized-range distribution
    (replaces the reference's hard-coded table, ``:53-120``)."""
    if not 2 <= num_models <= 50:
        raise ValueError("num_models must be in [2, 50]")
    if p_value not in (0.01, 0.05, 0.10):
        raise ValueError("p_value must be in {0.01, 0.05, 0.10}")
    q = scipy.stats.studentized_range.ppf(1 - p_value, num_models, 1e7)
    return float(q / np.sqrt(2))


def nemenyi_test(x: np.ndarray, p_value: float = 0.05,
                 return_ranks: bool = False, return_critval: bool = False):
    """Pairwise significance of model rank differences
    (reference ``:151-198``): ``x`` is [num_datasets, num_models] scores.

    Returns ``sign`` (1 where |mean rank diff| > CD), ``sign_bool``
    (+1/−1 direction), optionally the rank matrix and critical distance.
    """
    x = np.asarray(x)
    n_datasets, n_models = x.shape
    ranks = compute_ranks(x)
    cd = critical_nemenyi_value(p_value, n_models) * np.sqrt(
        n_models * (n_models + 1) / (6.0 * n_datasets))
    diff = ranks.mean(axis=0)[:, None] - ranks.mean(axis=0)[None, :]
    sign = (np.abs(diff) > cd).astype(np.float64)
    sign_bool = np.where(diff > 0, 1.0, -1.0)
    if return_ranks and return_critval:
        return sign, ranks, cd, sign_bool
    if return_ranks:
        return sign, ranks, sign_bool
    if return_critval:
        return sign, cd, sign_bool
    return sign, sign_bool
