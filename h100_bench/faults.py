"""Faults planted in the program, to show that a correctness check
catches them (the tests, and ``calibrate.py --fault`` on the card).
Each is a context manager that breaks the timed path underneath and
puts it back."""

from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def _patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def unchanged():
    """Every training phase computes its gradients and applies none: the
    step returns its state unchanged."""
    from gantrack_tpu_torch.training import step

    def no_update(opt, params, grads):
        for p in params:
            p.grad = None

    return _patched(step, "_apply", no_update)


@contextlib.contextmanager
def half_batch():
    """G-main and D-main leave out half of the batch and take the mean
    over the rest."""
    from gantrack_tpu_torch.training.loss import StyleGAN2Loss

    gmain, dmain = StyleGAN2Loss.gmain, StyleGAN2Loss.dmain

    def half_gmain(self, z, c, *args):
        return gmain(self, z[:len(z) // 2], c, *args)

    def half_dmain(self, z, c, real, real_c, *args):
        return dmain(self, z[:len(z) // 2], c, real[:len(real) // 2], real_c, *args)

    with _patched(StyleGAN2Loss, "gmain", half_gmain), _patched(StyleGAN2Loss, "dmain",
                                                                  half_dmain):
        yield


def altered_answer():
    """Every generated image's features come back 5 % larger."""
    from gantrack_tpu_torch.metrics import metric_utils

    stats = metric_utils.compute_feature_stats_for_generator

    def altered(*args, **kwargs):
        s = stats(*args, **kwargs)
        s.all_features = [f * np.float32(1.05) for f in s.all_features]
        return s

    return _patched(metric_utils, "compute_feature_stats_for_generator", altered)


def no_exchange():
    """A data-parallel step leaves out the gradients' exchange between
    ranks: each rank applies its own."""
    from gantrack_tpu_torch.training import step

    return _patched(step, "all_mean", lambda mesh, tensors: tensors)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered_answer": altered_answer,
          "no_exchange": no_exchange}
