"""Weights the benchmark makes for the references and the program.

A reference module declares each parameter and persistent buffer with
:func:`param` and how it starts (standard normals times a scale, or a
constant); :func:`make_weights` fills all of them on the generator's
device from one draw, in a fixed order, and :func:`load` copies them into
a module with the same names, the reference's or the program's.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn


def param(module: nn.Module, name: str, shape, init: str, value: float = 1.0,
           buffer: bool = False) -> None:
    """An empty float32 tensor that :func:`make_weights` fills: ``init``
    ``"randn"`` (standard normal times ``value``) or ``"const"``."""
    t = torch.empty(shape, dtype=torch.float32)
    if buffer:
        module.register_buffer(name, t)
    else:
        module.register_parameter(name, nn.Parameter(t))
    module.__dict__.setdefault("inits", {})[name] = (init, float(value))


def make_weights(module: nn.Module, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Every parameter and persistent buffer of a reference ``module``,
    on the generator's device, from one draw of standard normals."""
    specs = {}
    for prefix, m in module.named_modules():
        for name, spec in m.__dict__.get("inits", {}).items():
            specs[f"{prefix}.{name}" if prefix else name] = (spec, getattr(m, name).shape)
    names = sorted(specs)
    total = sum(shape.numel() for (kind, _), shape in specs.values() if kind == "randn")
    flat = torch.randn(total, generator=generator, device=generator.device)
    out, i = {}, 0
    for k in names:
        (kind, value), shape = specs[k]
        if kind == "randn":
            out[k] = flat[i:i + shape.numel()].reshape(shape) * value
            i += shape.numel()
        else:
            out[k] = torch.full(shape, value, device=generator.device)
    return out


def load(module: nn.Module, weights: Dict[str, torch.Tensor]) -> nn.Module:
    """``weights`` (of :func:`make_weights`) copied into ``module``."""
    module.load_state_dict({k: v.clone() for k, v in weights.items()}, strict=True)
    return module
