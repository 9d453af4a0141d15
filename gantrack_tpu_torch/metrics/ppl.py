"""Perceptual Path Length (the JAX ``metrics/ppl.py``).

Samples pairs of latents, moves ε = 1e-4 along their interpolation
(slerp in z, lerp in w), measures the detector distance of the two
rendered images over ε², and reports the mean of the distances inside
[p1, p99].  The pairs run on the device under ``inference_mode``; only
the distances come back to the host.  The latents come from a
``torch.Generator`` seeded by ``opts.seed`` (JAX draws its own), so the
value is the port's, comparable with itself.
"""

from __future__ import annotations

import numpy as np
import torch

from .metric_utils import MetricOptions, to_detector_input


def slerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation along the last axis (the JAX ``slerp``)."""
    a_norm = a.norm(dim=-1, keepdim=True)
    a_n = a / a_norm
    b_n = b / b.norm(dim=-1, keepdim=True)
    d = (a_n * b_n).sum(dim=-1, keepdim=True)
    p = t * torch.arccos(d.clamp(-1, 1))
    c = b_n - d * a_n
    c = c / c.norm(dim=-1, keepdim=True)
    return (a_n * torch.cos(p) + c * torch.sin(p)) * a_norm


def pair_distances(opts: MetricOptions, z0: torch.Tensor, z1: torch.Tensor, t: torch.Tensor,
                   epsilon: float = 1e-4, space: str = "w", crop: bool = False) -> torch.Tensor:
    """``sum((f0 − f1)²) / ε²`` of each pair: the images at ``t`` and
    ``t + ε`` along the pair's path, 0..255 (not truncated to integers),
    through the detector."""

    def prep(img):
        if crop:
            cc = img.shape[2] // 8
            img = img[:, :, cc * 3:cc * 7, cc * 2:cc * 6]
        return to_detector_input(torch.clamp(img.float() * 127.5 + 128, 0, 255), opts.mode_idx)

    if space == "z":
        img0 = opts.generator(slerp(z0, z1, t), None)
        img1 = opts.generator(slerp(z0, z1, t + epsilon), None)
    else:
        w0, w1 = opts.mapping(z0, None), opts.mapping(z1, None)
        tt = t[:, :, None] if w0.ndim == 3 else t
        img0 = opts.synthesis(w0 + (w1 - w0) * tt)
        img1 = opts.synthesis(w0 + (w1 - w0) * (tt + epsilon))
    f0, f1 = opts.detector(prep(img0)), opts.detector(prep(img1))
    return (f0 - f1).square().sum(dim=-1) / epsilon ** 2


def filtered_mean(dist: np.ndarray) -> float:
    """Mean of the distances inside [p1, p99] (``lower`` / ``higher``
    percentiles, as the JAX metric takes them)."""
    lo = np.percentile(dist, 1, method="lower")
    hi = np.percentile(dist, 99, method="higher")
    return float(np.extract(np.logical_and(dist >= lo, dist <= hi), dist).mean())


def compute_ppl(opts: MetricOptions, num_samples: int = 50000, epsilon: float = 1e-4,
                space: str = "w", sampling: str = "end", crop: bool = False,
                batch_size: int = 32) -> float:
    assert space in ("z", "w") and sampling in ("full", "end")
    assert opts.generator is not None and opts.detector is not None
    if space == "w" and (opts.mapping is None or opts.synthesis is None):
        raise ValueError("space='w' PPL requires MetricOptions.mapping and .synthesis "
                         "(ws-capable generator); refusing to fall back to z-space silently")
    device = torch.device(opts.device)
    gen = torch.Generator(device=device).manual_seed(opts.seed)
    dists = []
    done = 0
    with torch.inference_mode():
        while done < num_samples:
            b = min(batch_size, num_samples - done)
            z0 = torch.randn((b, opts.z_dim), generator=gen, device=device)
            z1 = torch.randn((b, opts.z_dim), generator=gen, device=device)
            t = (torch.rand((b, 1), generator=gen, device=device) if sampling == "full"
                 else torch.zeros((b, 1), device=device))
            dists.append(pair_distances(opts, z0, z1, t, epsilon, space, crop).cpu().numpy())
            done += b
    return filtered_mean(np.concatenate(dists))
