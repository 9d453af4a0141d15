"""The networks of a configuration's ``model`` entry, with empty weights,
and the weights the benchmark makes for them from a generator."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import stylegan2, stylegan3, weights


def build(model: dict, device) -> Tuple[torch.nn.Module, torch.nn.Module]:
    family = model["family"]
    if family == "stylegan2":
        return stylegan2.build(model, device)
    mult = 2 if family == "stylegan3-r" else 1  # -R doubles the generator's channels
    G = stylegan3.Generator(512, 512, model["resolution"], model["channels"],
                            model["cbase"] * mult, model["cmax"] * mult, model["num_fp16_res"],
                            conv_kernel=1 if mult == 2 else 3, radial=mult == 2)
    D = stylegan2.Discriminator(model["resolution"], model["channels"], model["cbase"],
                                model["cmax"], model["num_fp16_res"], model.get("mbstd_group", 4))
    return G.to(device), D.to(device)


def make_weights(G, D, generator: torch.Generator) -> Tuple[Dict[str, torch.Tensor], ...]:
    """G's weights, then D's, from one generator."""
    make_g = stylegan3.make_weights if isinstance(G, stylegan3.Generator) else weights.make_weights
    return make_g(G, generator), weights.make_weights(D, generator)
