"""VGG16 feature extractor (NCHW, PyTorch): the precision/recall and PPL
embedding and the projector's LPIPS-style perceptual distance.

Port of ``gantrack_tpu/models/vgg.py``: the same layers and names
(``conv1_1`` .. ``conv5_3``, ``fc1``, ``fc2``), so
``bridge.flax_state_dict_from_jax`` carries Flax variables over and
:func:`load_npz` reads the flat ``a/b`` ``.npz`` the JAX ``load_npz``
reads.  Pretrained weights are not in the repository; without them a
seeded random VGG16 stands in (the JAX ``random_params``).

Input: images ``[N, 3, H, W]`` in 0..255.  The network resizes them to
``resize_to``² (bilinear, antialiased when it shrinks the image, as
``jax.image.resize`` is) and subtracts ``[123.68, 116.779, 103.939]`` in
the channel order it is given (no RGB → BGR swap), as the JAX module
does.  ``forward`` returns the 4096-d ``fc2`` embedding, flattened in
NHWC order before ``fc1`` as the JAX module flattens; ``return_taps``
returns the five conv blocks' activations before their max pool.  The
convolutions are cuDNN's: the JAX package runs them in XLA, not in a
Pallas kernel.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .inception import bilinear_resize

_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]
_MEAN = (123.68, 116.779, 103.939)


class VGG16(nn.Module):
    def __init__(self, resize_to: int = 224):
        super().__init__()
        self.resize_to = resize_to
        self.layers: List[str] = []
        in_ch, block, idx = 3, 1, 1
        for v in _CFG:
            if v == "M":
                self.layers.append("M")
                block, idx = block + 1, 1
            else:
                name = f"conv{block}_{idx}"
                setattr(self, name, nn.Conv2d(in_ch, v, 3, padding=1))
                self.layers.append(name)
                in_ch, idx = v, idx + 1
        side = resize_to // 32
        self.fc1 = nn.Linear(512 * side * side, 4096)
        self.fc2 = nn.Linear(4096, 4096)
        self.register_buffer("mean", torch.tensor(_MEAN)[None, :, None, None], persistent=False)

    def forward(self, x: torch.Tensor, return_taps: bool = False):
        assert x.shape[1] == 3
        x = bilinear_resize(x.float(), self.resize_to, self.resize_to) - self.mean
        taps = []
        for name in self.layers:
            if name == "M":
                taps.append(x)
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, name)(x))
        if return_taps:
            return taps
        x = x.permute(0, 2, 3, 1).flatten(1)  # NHWC order, as the JAX module flattens
        x = F.relu(self.fc1(x))
        return F.relu(self.fc2(x))


def lpips_features(model: VGG16, img255: torch.Tensor) -> torch.Tensor:
    """LPIPS embedding: each conv block's activations unit-normalised over
    the channels at each pixel, scaled by ``1/sqrt(H·W)`` and flattened in
    NHWC order (the JAX ``lpips_features``); the squared L2 distance of
    two embeddings is the perceptual distance."""
    feats = []
    for t in model(img255, return_taps=True):
        t = t / torch.sqrt(t.square().sum(dim=1, keepdim=True) + 1e-10)
        n, _, h, w = t.shape
        feats.append((t / np.sqrt(h * w)).permute(0, 2, 3, 1).reshape(n, -1))
    return torch.cat(feats, dim=1)


def random_vgg(seed: int = 0, resize_to: int = 224,
               device: torch.device = torch.device("cpu")) -> VGG16:
    """A VGG16 of seeded random weights (the weights differ from the JAX
    ``random_params`` of the same seed)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = VGG16(resize_to)
    return model.to(device).eval().requires_grad_(False)


def load_npz(path: str, resize_to: int = 224,
             device: torch.device = torch.device("cpu")) -> VGG16:
    """A VGG16 from converted weights (flat ``conv1_1/kernel``-style HWIO
    convs and ``[in, out]`` dense layers); raises if one is missing."""
    from .bridge import flax_state_dict_from_flat

    model = VGG16(resize_to)
    model.load_state_dict(flax_state_dict_from_flat(dict(np.load(path))), strict=True)
    return model.to(device).eval().requires_grad_(False)
