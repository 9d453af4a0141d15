"""Metric registry and reporting.

Port of ``gantrack_tpu/metrics/registry.py``: ``@register_metric``
functions, ``calc_metric`` (runs and times one metric) and
``report_metric`` (appends ``metric-<mode>-<metric>.jsonl`` rows, stamped
with ``kimg``), and the JAX registry's configurations, the StyleGAN3
equivariance metrics and ``ppl2_wend`` included.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

from .metric_utils import MetricOptions

_metric_dict: Dict[str, Callable] = {}


def register_metric(fn: Callable) -> Callable:
    assert callable(fn)
    _metric_dict[fn.__name__] = fn
    return fn


def is_valid_metric(metric: str) -> bool:
    return metric in _metric_dict


def list_valid_metrics():
    return list(_metric_dict)


def check_metric(metric: str) -> None:
    """Raise ``ValueError`` naming why ``metric`` cannot run."""
    if not is_valid_metric(metric):
        raise ValueError(f"unknown metric {metric}; valid: {list_valid_metrics()}")


def calc_metric(metric: str, opts: MetricOptions, mode_name: Optional[str] = None) -> dict:
    check_metric(metric)
    start = time.time()
    results = _metric_dict[metric](opts)
    total_time = time.time() - start
    return dict(results=results, metric=metric, mode=mode_name, total_time=total_time,
                total_time_str=f"{total_time:.1f}s")


def report_metric(result_dict: dict, run_dir: Optional[str] = None,
                  snapshot_path: Optional[str] = None, kimg: Optional[int] = None) -> None:
    """Print the row and append it to ``metric-<mode>-<metric>.jsonl``
    in ``run_dir``; ``kimg`` stamps it with the snapshot's progress."""
    metric = result_dict["metric"]
    mode = result_dict.get("mode")
    record = dict(result_dict, snapshot_path=snapshot_path, timestamp=time.time())
    if kimg is not None:
        record["kimg"] = int(kimg)
    print(json.dumps(record))
    if run_dir is not None and os.path.isdir(run_dir):
        name = f"metric-{mode}-{metric}.jsonl" if mode else f"metric-{metric}.jsonl"
        with open(os.path.join(run_dir, name), "at") as f:
            f.write(json.dumps(record) + "\n")


# ------------------------------------------------------------- metrics
# The configurations of the JAX registry.

@register_metric
def fid50k_full(opts: MetricOptions) -> dict:
    from .fid import compute_fid

    return {"fid50k_full": compute_fid(opts, max_real=None, num_gen=50000)}


@register_metric
def fid10k(opts: MetricOptions) -> dict:
    from .fid import compute_fid

    return {"fid10k": compute_fid(opts, max_real=10000, num_gen=10000)}


@register_metric
def fid1k(opts: MetricOptions) -> dict:
    from .fid import compute_fid

    return {"fid1k": compute_fid(opts, max_real=1000, num_gen=1000)}


@register_metric
def kid50k_full(opts: MetricOptions) -> dict:
    from .kid import compute_kid

    return {"kid50k_full": compute_kid(opts, max_real=1000000, num_gen=50000)}


@register_metric
def kid10k(opts: MetricOptions) -> dict:
    from .kid import compute_kid

    return {"kid10k": compute_kid(opts, max_real=10000, num_gen=10000)}


@register_metric
def pr50k3_full(opts: MetricOptions) -> dict:
    from .precision_recall import compute_pr

    precision, recall = compute_pr(opts, max_real=200000, num_gen=50000, nhood_size=3)
    return {"pr50k3_full_precision": precision, "pr50k3_full_recall": recall}


@register_metric
def pr10k3(opts: MetricOptions) -> dict:
    from .precision_recall import compute_pr

    precision, recall = compute_pr(opts, max_real=10000, num_gen=10000, nhood_size=3)
    return {"pr10k3_precision": precision, "pr10k3_recall": recall}


@register_metric
def is50k(opts: MetricOptions) -> dict:
    from .inception_score import compute_is

    mean, std = compute_is(opts, num_gen=50000, num_splits=10)
    return {"is50k_mean": mean, "is50k_std": std}


@register_metric
def ppl2_wend(opts: MetricOptions) -> dict:
    """Needs ``opts.mapping`` and ``opts.synthesis`` (w space)."""
    from .ppl import compute_ppl

    value = compute_ppl(opts, num_samples=50000, epsilon=1e-4, space="w", sampling="end")
    return {"ppl2_wend": value}


# StyleGAN3-only equivariance metrics; they need a transform-capable
# generator on opts (``opts.generator_with_transform``, which
# ``tools.calc_metrics.evaluate_metrics`` sets for a StyleGAN3 G_ema).

def _equivariance(opts: MetricOptions, name: str, key: str, num_samples: int) -> dict:
    from .equivariance import compute_equivariance_metrics

    r = compute_equivariance_metrics(
        opts, num_samples=num_samples, compute_eqt_int=(key == "eqt_int"),
        compute_eqt_frac=(key == "eqt_frac"), compute_eqr=(key == "eqr"))
    return {name: r[key]}


@register_metric
def eqt50k_int(opts: MetricOptions) -> dict:
    return _equivariance(opts, "eqt50k_int", "eqt_int", 50000)


@register_metric
def eqt50k_frac(opts: MetricOptions) -> dict:
    return _equivariance(opts, "eqt50k_frac", "eqt_frac", 50000)


@register_metric
def eqr50k(opts: MetricOptions) -> dict:
    return _equivariance(opts, "eqr50k", "eqr", 50000)


@register_metric
def eqt1k_int(opts: MetricOptions) -> dict:
    """Fast tier of eqt50k_int (validation runs; same estimator)."""
    return _equivariance(opts, "eqt1k_int", "eqt_int", 1000)


@register_metric
def eqr1k(opts: MetricOptions) -> dict:
    """Fast tier of eqr50k (validation runs; same estimator)."""
    return _equivariance(opts, "eqr1k", "eqr", 1000)
