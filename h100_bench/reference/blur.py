"""StyleGAN3-R's discriminator blur (Karras et al. 2021, "Alias-Free
Generative Adversarial Networks", its training details; NVIDIA's
``training/loss.py``), added to the plain training steps.

Every image the discriminator sees, in G-main, D-main and R1, is first
low-passed by a separable Gaussian of ``σ = σ₀ · max(1 − cur_nimg /
(fade_kimg · 1000), 0)``: ``⌊3σ⌋`` taps a side, weights ``2^-(t/σ)²``
normalised to sum 1, zero padding of ``⌊3σ⌋`` on every side (the output
keeps the input's size); no blur once ``⌊3σ⌋`` is 0.  ``σ₀`` is 10 and
the fade ``batch · 200 / 32`` kimg for ``--cfg=stylegan3-r``, and there
is no blur for the other configurations (:func:`ramp`).  Then the
augment runs as the parent :class:`Trainer` runs it.

Departures from the published description:

* D-main blurs the fakes and the reals as one batch, since the parent
  augments them in one pass; a blur acts on each image alone, so the
  numbers are those of two calls;
* the blur runs in float32 at every precision of :class:`Numerics`
  (NVIDIA's runs at the images' float32 too: D's first bfloat16 layer
  comes after it);
* ``cur_nimg`` is the trainer's count of images before the step, for
  every phase of the step, as NVIDIA's loop hands each phase the count
  at the step's start.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .training import Trainer


def ramp(family: str, batch: int) -> Tuple[float, float]:
    """``(σ₀, fade_kimg)`` of a configuration's family and global batch,
    as NVIDIA's ``train.py`` derives them; ``(0, 0)``: no blur."""
    if family == "stylegan3-r":
        return 10.0, batch * 200 / 32
    return 0.0, 0.0


def sigma(cur_nimg: float, init_sigma: float, fade_kimg: float) -> float:
    if fade_kimg <= 0:
        return 0.0
    return max(1.0 - cur_nimg / (fade_kimg * 1e3), 0.0) * init_sigma


def blur(img: torch.Tensor, blur_sigma: float) -> torch.Tensor:
    """The Gaussian blur of NCHW ``img`` at ``blur_sigma``, in float32."""
    size = int(np.floor(blur_sigma * 3))
    if size <= 0:
        return img
    t = torch.arange(-size, size + 1, dtype=torch.float32, device=img.device)
    f = t.div(blur_sigma).square().neg().exp2()
    f = f / f.sum()
    c = img.shape[1]
    x = F.pad(img.float(), [size, size, size, size])
    x = F.conv2d(x, f.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return F.conv2d(x, f.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c).to(img.dtype)


class BlurTrainer(Trainer):
    """:class:`Trainer` whose discriminator inputs pass the blur ramp
    (``blur_init_sigma`` fading to 0 over ``blur_fade_kimg``) before the
    augment."""

    def __init__(self, *args, blur_init_sigma: float, blur_fade_kimg: float, **kwargs):
        super().__init__(*args, **kwargs)
        self.blur_init_sigma, self.blur_fade_kimg = blur_init_sigma, blur_fade_kimg

    def blur_sigma(self) -> float:
        return sigma(self.cur_nimg, self.blur_init_sigma, self.blur_fade_kimg)

    def _augment(self, img):
        return super()._augment(blur(img, self.blur_sigma()))
