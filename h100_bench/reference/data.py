"""The order in which training reads a dataset, and what it reads.

NVIDIA's ``InfiniteSampler`` (StyleGAN2-ADA ``torch_utils/misc.py``): a
seeded shuffle, then after each visit a swap with a random earlier item
in a window of half the dataset; with x-flips the dataset is doubled,
the second half mirrored left to right.  Images are scaled from 0..255 to
-1..1.
"""

from __future__ import annotations

import numpy as np


def sampler(n: int, seed: int, rank: int = 0, world: int = 1, window_size: float = 0.5):
    """Rank ``rank`` of ``world`` takes every ``world``-th visit."""
    order = np.arange(n)
    rnd = np.random.RandomState(seed)
    rnd.shuffle(order)
    window = int(np.rint(order.size * window_size))
    idx = 0
    while True:
        i = idx % order.size
        if idx % world == rank:
            yield int(order[i])
        if window >= 2:
            j = (i - rnd.randint(window)) % order.size
            order[i], order[j] = order[j], order[i]
        idx += 1


def batches(raw: np.ndarray, batch: int, seed: int, xflip: bool, count: int, rank: int = 0,
            world: int = 1):
    """The first ``count`` batches ``[batch, C, H, W]`` float32 in -1..1
    of rank ``rank`` of ``world`` from ``raw`` ``[N, H, W, C]`` in 0..255."""
    n = raw.shape[0]
    order = sampler(2 * n if xflip else n, seed, rank, world)
    out = []
    for _ in range(count):
        rows = []
        for _ in range(batch):
            i = next(order)
            img = raw[i % n]
            rows.append(img[:, ::-1] if i >= n else img)
        x = np.stack(rows).astype(np.float32) / np.float32(127.5) - np.float32(1.0)
        out.append(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    return out
