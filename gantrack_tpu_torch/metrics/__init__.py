"""Quality metrics of G_ema: FID, KID, precision/recall, Inception Score,
equivariance and perceptual path length."""

from .feature_stats import FeatureStats, cache_path
from .metric_utils import (
    Detector,
    MetricOptions,
    compute_feature_stats_for_dataset,
    compute_feature_stats_for_generator,
    make_inception_detector,
    make_random_projection_detector,
    make_vgg_detector,
)
from .registry import (
    calc_metric,
    check_metric,
    is_valid_metric,
    list_valid_metrics,
    register_metric,
    report_metric,
)

__all__ = [
    "FeatureStats",
    "cache_path",
    "Detector",
    "MetricOptions",
    "compute_feature_stats_for_dataset",
    "compute_feature_stats_for_generator",
    "make_inception_detector",
    "make_random_projection_detector",
    "make_vgg_detector",
    "calc_metric",
    "check_metric",
    "is_valid_metric",
    "list_valid_metrics",
    "register_metric",
    "report_metric",
]
