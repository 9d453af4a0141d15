"""Fused bias + activation + gain + clamp (plain PyTorch).

Port of ``gantrack_tpu/ops/bias_act.py``: the same 9 activations and
default gains.  The bias is added along ``dim`` (1 for NCHW).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ActivationSpec:
    fn: Callable
    def_alpha: float
    def_gain: float


activation_funcs = {
    "linear": ActivationSpec(lambda x, alpha: x, 0.0, 1.0),
    "relu": ActivationSpec(lambda x, alpha: F.relu(x), 0.0, float(np.sqrt(2))),
    "lrelu": ActivationSpec(lambda x, alpha: F.leaky_relu(x, alpha), 0.2, float(np.sqrt(2))),
    "tanh": ActivationSpec(lambda x, alpha: torch.tanh(x), 0.0, 1.0),
    "sigmoid": ActivationSpec(lambda x, alpha: torch.sigmoid(x), 0.0, 1.0),
    "elu": ActivationSpec(lambda x, alpha: F.elu(x), 0.0, 1.0),
    "selu": ActivationSpec(lambda x, alpha: F.selu(x), 0.0, 1.0),
    "softplus": ActivationSpec(lambda x, alpha: F.softplus(x), 0.0, 1.0),
    "swish": ActivationSpec(lambda x, alpha: torch.sigmoid(x) * x, 0.0, float(np.sqrt(2))),
}


def bias_act(
    x: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    dim: int = 1,
    act: str = "linear",
    alpha: Optional[float] = None,
    gain: Optional[float] = None,
    clamp: Optional[float] = None,
) -> torch.Tensor:
    """``clamp(act(x + b) * gain, ±clamp)`` with per-activation defaults."""
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)
    if b is not None:
        assert b.ndim == 1, "bias must be 1-D"
        axis = dim % x.ndim
        assert b.shape[0] == x.shape[axis], (b.shape, x.shape, axis)
        shape = [1] * x.ndim
        shape[axis] = -1
        x = x + b.reshape(shape).to(x.dtype)
    x = spec.fn(x, alpha)
    if gain != 1:
        x = x * gain
    if clamp is not None:
        assert clamp >= 0
        x = x.clamp(-float(clamp), float(clamp))
    return x
