"""Plain float32 InceptionV3 pool features, the TF-slim graph of the FID
protocol (Szegedy et al. 2016; the graph of TTUR's ``pt_inception``).

Images ``[N, 3, H, W]`` in 0..255 are resized by TF1's bilinear rule
(``align_corners=False``, no half-pixel centres, no antialiasing) to
299², mapped by ``(x - 128) / 128`` and run through the network, whose
batch norms are folded into a scale and an offset per channel; average
pools exclude the padding, Mixed_7c pools by maximum.  Returns the
``[N, 2048]`` spatial mean of the last block.  Parameter names follow
the program's converted-weights format, so one set of weights loads into
both.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .weights import param


class ConvBN(nn.Module):
    def __init__(self, cin, cout, kernel, stride=1, padding=(0, 0)):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.conv = nn.Module()
        # He-normal weights: the benchmark's seeded stand-in for trained ones.
        param(self.conv, "weight", [cout, cin, *kernel], "randn",
              float(np.sqrt(2.0 / (cin * kernel[0] * kernel[1]))))
        param(self, "bn_scale", [cout], "const", 1.0)
        param(self, "bn_offset", [cout], "const", 0.0)

    def forward(self, x):
        x = F.conv2d(x, self.conv.weight, stride=self.stride, padding=self.padding)
        return F.relu(x * self.bn_scale[:, None, None] + self.bn_offset[:, None, None])


def _avg(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class _Block(nn.Module):
    def __init__(self, layers):
        super().__init__()
        for name, args in layers.items():
            setattr(self, name, ConvBN(*args))

    def chain(self, x, *names):
        for n in names:
            x = getattr(self, n)(x)
        return x


class InceptionA(_Block):
    def __init__(self, cin, pool):
        super().__init__({"branch1x1": (cin, 64, (1, 1)), "branch5x5_1": (cin, 48, (1, 1)),
                          "branch5x5_2": (48, 64, (5, 5), 1, (2, 2)),
                          "branch3x3dbl_1": (cin, 64, (1, 1)),
                          "branch3x3dbl_2": (64, 96, (3, 3), 1, (1, 1)),
                          "branch3x3dbl_3": (96, 96, (3, 3), 1, (1, 1)),
                          "branch_pool": (cin, pool, (1, 1))})

    def forward(self, x):
        return torch.cat([self.branch1x1(x), self.chain(x, "branch5x5_1", "branch5x5_2"),
                          self.chain(x, "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
                          self.branch_pool(_avg(x))], dim=1)


class InceptionB(_Block):
    def __init__(self, cin):
        super().__init__({"branch3x3": (cin, 384, (3, 3), 2),
                          "branch3x3dbl_1": (cin, 64, (1, 1)),
                          "branch3x3dbl_2": (64, 96, (3, 3), 1, (1, 1)),
                          "branch3x3dbl_3": (96, 96, (3, 3), 2)})

    def forward(self, x):
        return torch.cat([self.branch3x3(x),
                          self.chain(x, "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
                          F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(_Block):
    def __init__(self, cin, c7):
        super().__init__({"branch1x1": (cin, 192, (1, 1)), "branch7x7_1": (cin, c7, (1, 1)),
                          "branch7x7_2": (c7, c7, (1, 7), 1, (0, 3)),
                          "branch7x7_3": (c7, 192, (7, 1), 1, (3, 0)),
                          "branch7x7dbl_1": (cin, c7, (1, 1)),
                          "branch7x7dbl_2": (c7, c7, (7, 1), 1, (3, 0)),
                          "branch7x7dbl_3": (c7, c7, (1, 7), 1, (0, 3)),
                          "branch7x7dbl_4": (c7, c7, (7, 1), 1, (3, 0)),
                          "branch7x7dbl_5": (c7, 192, (1, 7), 1, (0, 3)),
                          "branch_pool": (cin, 192, (1, 1))})

    def forward(self, x):
        return torch.cat([self.branch1x1(x),
                          self.chain(x, "branch7x7_1", "branch7x7_2", "branch7x7_3"),
                          self.chain(x, *[f"branch7x7dbl_{i}" for i in range(1, 6)]),
                          self.branch_pool(_avg(x))], dim=1)


class InceptionD(_Block):
    def __init__(self, cin):
        super().__init__({"branch3x3_1": (cin, 192, (1, 1)),
                          "branch3x3_2": (192, 320, (3, 3), 2),
                          "branch7x7x3_1": (cin, 192, (1, 1)),
                          "branch7x7x3_2": (192, 192, (1, 7), 1, (0, 3)),
                          "branch7x7x3_3": (192, 192, (7, 1), 1, (3, 0)),
                          "branch7x7x3_4": (192, 192, (3, 3), 2)})

    def forward(self, x):
        return torch.cat([self.chain(x, "branch3x3_1", "branch3x3_2"),
                          self.chain(x, *[f"branch7x7x3_{i}" for i in range(1, 5)]),
                          F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(_Block):
    def __init__(self, cin, max_pool: bool):
        super().__init__({"branch1x1": (cin, 320, (1, 1)), "branch3x3_1": (cin, 384, (1, 1)),
                          "branch3x3_2a": (384, 384, (1, 3), 1, (0, 1)),
                          "branch3x3_2b": (384, 384, (3, 1), 1, (1, 0)),
                          "branch3x3dbl_1": (cin, 448, (1, 1)),
                          "branch3x3dbl_2": (448, 384, (3, 3), 1, (1, 1)),
                          "branch3x3dbl_3a": (384, 384, (1, 3), 1, (0, 1)),
                          "branch3x3dbl_3b": (384, 384, (3, 1), 1, (1, 0)),
                          "branch_pool": (cin, 192, (1, 1))})
        self.max_pool = max_pool

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        bd = self.chain(x, "branch3x3dbl_1", "branch3x3dbl_2")
        bp = F.max_pool2d(x, 3, stride=1, padding=1) if self.max_pool else _avg(x)
        return torch.cat([self.branch1x1(x),
                          torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1),
                          torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1),
                          self.branch_pool(bp)], dim=1)


def _tf1_matrix(n_in: int, n_out: int) -> np.ndarray:
    src = np.arange(n_out, dtype=np.float64) * (n_in / n_out)
    x0 = np.floor(src).astype(np.int64)
    x1 = np.minimum(x0 + 1, n_in - 1)
    frac = (src - x0).astype(np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), x0] += 1.0 - frac
    m[np.arange(n_out), x1] += frac
    return m


class InceptionV3(nn.Module):
    STEM = (("Conv2d_1a_3x3", (3, 32, (3, 3), 2)), ("Conv2d_2a_3x3", (32, 32, (3, 3))),
            ("Conv2d_2b_3x3", (32, 64, (3, 3), 1, (1, 1))), ("Conv2d_3b_1x1", (64, 80, (1, 1))),
            ("Conv2d_4a_3x3", (80, 192, (3, 3))))

    def __init__(self):
        super().__init__()
        for name, args in self.STEM:
            setattr(self, name, ConvBN(*args))
        self.Mixed_5b, self.Mixed_5c, self.Mixed_5d = (InceptionA(192, 32), InceptionA(256, 64),
                                                       InceptionA(288, 64))
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b, self.Mixed_6c = InceptionC(768, 128), InceptionC(768, 160)
        self.Mixed_6d, self.Mixed_6e = InceptionC(768, 160), InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b, self.Mixed_7c = InceptionE(1280, False), InceptionE(2048, True)

    def forward(self, x):
        mh = torch.from_numpy(_tf1_matrix(x.shape[2], 299)).to(x.device)
        mw = torch.from_numpy(_tf1_matrix(x.shape[3], 299)).to(x.device)
        x = torch.einsum("oh,nchw->ncow", mh, x.float())
        x = torch.einsum("pw,ncow->ncop", mw, x)
        x = (x - 128.0) / 128.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))
