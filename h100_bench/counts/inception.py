"""Operations of InceptionV3's pool features: every convolution, 2 a
multiply-add, from the graph's shapes at 299² (float32 with TF32 off).

The shapes come from one pass of the reference graph on the ``meta``
device, which computes no values."""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def flops_per_image() -> float:
    from ..reference.inception import ConvBN, InceptionV3

    with torch.device("meta"):
        net = InceptionV3()
    total = [0]

    def hook(module, inputs, output):
        w = module.conv.weight
        total[0] += 2 * w.numel() * output.shape[2] * output.shape[3]

    for m in net.modules():
        if isinstance(m, ConvBN):
            m.register_forward_hook(hook)
    net(torch.empty(1, 3, 256, 256, device="meta"))
    return float(total[0])
