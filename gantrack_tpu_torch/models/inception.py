"""InceptionV3 feature extractor of the FID protocol (NCHW, PyTorch).

Port of ``gantrack_tpu/models/inception.py``: the same graph, module
names and parameters (conv weights without bias, batch norm folded into
``bn_scale`` / ``bn_offset``), so ``bridge.flax_state_dict_from_jax``
carries JAX variables over and :func:`load_npz` reads the flat ``a/b/c``
``.npz`` files that ``gantrack_tpu/tools/convert_detector.py`` writes.

Input: images ``[N, 3, H, W]`` in 0..255 (float); output ``[N, 2048]``
pool features, or ``[N, 1008]`` logits with ``return_logits``.  Two graph
variants, as in the JAX module:

* ``"torchvision"``: bilinear resize (antialiased only when it shrinks
  the image, as ``jax.image.resize`` is), ``x / 127.5 - 1``, average
  pools that count the padding;
* ``"tfslim"``: the TF1 legacy bilinear resize (the JAX module's numpy
  interpolation matrices), ``(x - 128) / 128``, average pools that
  exclude the padding and a max pool in Mixed_7c.  The FID of this
  variant, with converted weights, is comparable to published numbers.

The network is plain PyTorch (cuDNN convolutions): the JAX package runs
it in XLA, not in a Pallas kernel.  Callers keep TF32 off, so the
features stay float32.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class ConvBN(nn.Module):
    """Conv (no bias) + folded inference batch norm + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int],
                 stride: int = 1, padding: Tuple[int, int] = (0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=False)
        self.bn_scale = nn.Parameter(torch.ones(out_ch))
        self.bn_offset = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x):
        return F.relu(self.conv(x) * self.bn_scale[:, None, None] + self.bn_offset[:, None, None])


def _avg_pool_3x3(x, tf_pool: bool):
    """3×3/1 SAME average pool; ``tf_pool`` excludes the padding from the
    divisor (TF semantics), else counts it (torchvision semantics)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=not tf_pool)


def _tf1_interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """TF1 ``ResizeBilinear`` (``align_corners=False``,
    ``half_pixel_centers=False``): source ``src = dst · n_in / n_out``,
    no antialiasing (the same matrix as the JAX module's)."""
    scale = n_in / n_out
    src = np.arange(n_out, dtype=np.float64) * scale
    x0 = np.floor(src).astype(np.int64)
    x1 = np.minimum(x0 + 1, n_in - 1)
    frac = (src - x0).astype(np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), x0] += 1.0 - frac
    m[np.arange(n_out), x1] += frac
    return m


def tf1_resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``[N, C, H, W]`` → ``[N, C, out_h, out_w]`` by two matrix products."""
    h, w = x.shape[2], x.shape[3]
    if (h, w) == (out_h, out_w):
        return x
    mh = torch.from_numpy(_tf1_interp_matrix(h, out_h)).to(x.device)
    mw = torch.from_numpy(_tf1_interp_matrix(w, out_w)).to(x.device)
    x = torch.einsum("oh,nchw->ncow", mh, x)
    return torch.einsum("pw,ncow->ncop", mw, x)


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Half-pixel bilinear resize with ``jax.image.resize`` semantics:
    antialiased when the image shrinks, plain bilinear when it grows."""
    h, w = x.shape[2], x.shape[3]
    if (h, w) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False,
                         antialias=out_h < h or out_w < w)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int, tf_pool: bool):
        super().__init__()
        self.tf_pool = tf_pool
        self.branch1x1 = ConvBN(in_ch, 64, (1, 1))
        self.branch5x5_1 = ConvBN(in_ch, 48, (1, 1))
        self.branch5x5_2 = ConvBN(48, 64, (5, 5), padding=(2, 2))
        self.branch3x3dbl_1 = ConvBN(in_ch, 64, (1, 1))
        self.branch3x3dbl_2 = ConvBN(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = ConvBN(96, 96, (3, 3), padding=(1, 1))
        self.branch_pool = ConvBN(in_ch, pool_features, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3(x, self.tf_pool))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = ConvBN(in_ch, 384, (3, 3), stride=2)
        self.branch3x3dbl_1 = ConvBN(in_ch, 64, (1, 1))
        self.branch3x3dbl_2 = ConvBN(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = ConvBN(96, 96, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int, tf_pool: bool):
        super().__init__()
        self.tf_pool = tf_pool
        self.branch1x1 = ConvBN(in_ch, 192, (1, 1))
        self.branch7x7_1 = ConvBN(in_ch, c7, (1, 1))
        self.branch7x7_2 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = ConvBN(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = ConvBN(in_ch, c7, (1, 1))
        self.branch7x7dbl_2 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = ConvBN(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = ConvBN(in_ch, 192, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for name in ("branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4", "branch7x7dbl_5"):
            bd = getattr(self, name)(bd)
        bp = self.branch_pool(_avg_pool_3x3(x, self.tf_pool))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = ConvBN(in_ch, 192, (1, 1))
        self.branch3x3_2 = ConvBN(192, 320, (3, 3), stride=2)
        self.branch7x7x3_1 = ConvBN(in_ch, 192, (1, 1))
        self.branch7x7x3_2 = ConvBN(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = ConvBN(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = ConvBN(192, 192, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for name in ("branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4"):
            b7 = getattr(self, name)(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    """``pool_kind="max"`` is the Mixed_7c quirk of the TF-slim graph."""

    def __init__(self, in_ch: int, tf_pool: bool, pool_kind: str = "avg"):
        super().__init__()
        self.tf_pool = tf_pool
        self.pool_kind = pool_kind
        self.branch1x1 = ConvBN(in_ch, 320, (1, 1))
        self.branch3x3_1 = ConvBN(in_ch, 384, (1, 1))
        self.branch3x3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = ConvBN(in_ch, 448, (1, 1))
        self.branch3x3dbl_2 = ConvBN(448, 384, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = ConvBN(in_ch, 192, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        if self.pool_kind == "max":
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg_pool_3x3(x, self.tf_pool)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], dim=1)


class InceptionV3Features(nn.Module):
    """Images (0..255, ``[N, 3, H, W]``) → ``[N, 2048]`` features, or
    ``[N, 1008]`` logits with ``return_logits``."""

    def __init__(self, resize_to: int = 299, variant: str = "torchvision",
                 return_logits: bool = False, logits_bias: bool = True):
        super().__init__()
        assert variant in ("torchvision", "tfslim"), variant
        self.resize_to = resize_to
        self.variant = variant
        self.return_logits = return_logits
        tf = variant == "tfslim"
        self.Conv2d_1a_3x3 = ConvBN(3, 32, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = ConvBN(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = ConvBN(32, 64, (3, 3), padding=(1, 1))
        self.Conv2d_3b_1x1 = ConvBN(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = ConvBN(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32, tf)
        self.Mixed_5c = InceptionA(256, 64, tf)
        self.Mixed_5d = InceptionA(288, 64, tf)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, tf)
        self.Mixed_6c = InceptionC(768, 160, tf)
        self.Mixed_6d = InceptionC(768, 160, tf)
        self.Mixed_6e = InceptionC(768, 192, tf)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, tf)
        self.Mixed_7c = InceptionE(2048, tf, pool_kind="max" if tf else "avg")
        if return_logits:
            self.output = nn.Linear(2048, 1008, bias=logits_bias)

    def forward(self, x):
        assert x.shape[1] == 3, "the detector takes 3-channel input"
        x = x.float()
        if self.variant == "tfslim":
            x = tf1_resize_bilinear(x, self.resize_to, self.resize_to)
            x = (x - 128.0) / 128.0
        else:
            x = bilinear_resize(x, self.resize_to, self.resize_to)
            x = x / 127.5 - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        return self.output(x) if self.return_logits else x


def load_npz(path: str, return_logits: bool = False,
             device: torch.device = torch.device("cpu")) -> InceptionV3Features:
    """A detector from converted weights (the flat ``.npz`` of
    ``tools/convert_detector.py``; files without ``__variant__`` are
    torchvision).  Raises if a parameter is missing."""
    from .bridge import flax_state_dict_from_flat

    data = dict(np.load(path))
    variant = str(data.pop("__variant__")) if "__variant__" in data else "torchvision"
    model = InceptionV3Features(variant=variant, return_logits=return_logits,
                                logits_bias="output/bias" in data)
    model.load_state_dict(flax_state_dict_from_flat(data), strict=True)
    return model.to(device).eval().requires_grad_(False)


def save_npz(path: str, model: InceptionV3Features) -> None:
    """Write ``model`` in the ``convert_detector.py`` format (HWIO convs,
    ``[in, out]`` dense), e.g. seeded random weights for a smoke run."""
    flat: Dict[str, np.ndarray] = {"__variant__": np.asarray(model.variant)}
    for name, t in model.state_dict().items():
        a = t.detach().cpu().numpy()
        parts: Sequence[str] = name.split(".")
        if parts[-1] == "weight" and a.ndim == 4:
            flat["/".join([*parts[:-1], "kernel"])] = np.transpose(a, (2, 3, 1, 0))
        elif parts[-1] == "weight":
            flat["/".join([*parts[:-1], "kernel"])] = a.T
        else:
            flat["/".join(parts)] = a
    np.savez(path, **flat)
