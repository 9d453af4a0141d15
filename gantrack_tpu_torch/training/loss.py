"""StyleGAN2-ADA and StyleGAN3 loss phases.

Port of ``gantrack_tpu/training/loss.py`` with the JAX package's
semantics (which differ from NVIDIA's in two places):

* ``pl_mean`` stays in the path-length penalty's graph: the lerped mean
  is differentiated through, not detached;
* D-main augments the fake ‖ real batch in one pass, then splits it
  before D, so minibatch-std groups stay fake-only or real-only.

StyleGAN3 runs the same phases with style mixing and the path-length
weight at 0; ``stylegan3-r`` adds the discriminator blur ramp
(``blur_init_sigma`` fading to 0 over ``blur_fade_kimg``), one blur over
fake ‖ real in D-main.  The JAX loss convolves with a shape-static 61-tap
Gaussian whose taps beyond ``3σ`` are masked to zero; here the host
computes the ``2·⌊3σ⌋ + 1`` live taps from ``cur_nimg`` (a host integer,
so nothing is read back from the device), which is the same filter.

Each phase returns its loss and a moments dict (``stats.report``); the
stepper takes the gradients.  The inner ``create_graph`` passes are the
spans ``pl_grads`` and ``r1_grads``, D's input blur the span ``d_blur``
(:mod:`..utils.profiling`).  Random draws come from the explicit
``torch.Generator`` a phase is given; the path-length noise can be
handed in instead (``pl_noise``), which the parity tests do.

Data parallelism (``training.step``, ``rng_mode="global_sample"``):
``global_rows = (rank, world)`` makes every per-sample draw (the style
mixing's second z, the path-length noise) one draw of the global batch,
of which this rank takes its rows, so the draws do not depend on how the
batch is split; ``gpl``'s ``batch_mean`` is then the global mean.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.upfirdn2d import Filter, filter2d
from ..utils.profiling import count, span
from . import stats


@dataclasses.dataclass(frozen=True)
class StyleGAN2LossConfig:
    r1_gamma: float = 10.0
    style_mixing_prob: float = 0.9
    pl_weight: float = 2.0
    pl_batch_shrink: int = 2
    pl_decay: float = 0.01
    blur_init_sigma: float = 0.0
    blur_fade_kimg: float = 0.0
    noise_mode: str = "random"   # synthesis noise; "const" for parity tests


# augment_fn(images, p, generator) -> images
AugmentFn = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Generator]], torch.Tensor]


class StyleGAN2Loss:
    def __init__(self, G, D, cfg: StyleGAN2LossConfig = StyleGAN2LossConfig(),
                 augment_fn: Optional[AugmentFn] = None):
        self.G = G
        self.D = D
        self.cfg = cfg
        self.augment_fn = augment_fn
        self.global_rows: Optional[Tuple[int, int]] = None  # (rank, world)

    # ------------------------------------------------------------- helpers

    def _randn(self, shape, gen, device) -> torch.Tensor:
        """A standard normal per sample (rows of ``shape``): with
        ``global_rows``, this rank's rows of one draw for the global batch."""
        if self.global_rows is None:
            return torch.randn(shape, generator=gen, device=device)
        rank, world = self.global_rows
        n = shape[0]
        rows = torch.randn((n * world, *shape[1:]), generator=gen, device=device)
        return rows[rank * n:(rank + 1) * n]

    def _mix(self, ws, z, c, gen):
        """Style mixing: from a random cutoff on, the layers take the ws of
        a second latent (one cutoff per batch, drawn on the device)."""
        if self.cfg.style_mixing_prob <= 0:
            return ws
        num_ws = ws.shape[1]
        dev = ws.device
        cutoff = torch.randint(1, num_ws, (), generator=gen, device=dev)
        mix = torch.rand((), generator=gen, device=dev) < self.cfg.style_mixing_prob
        cutoff = torch.where(mix, cutoff, torch.full_like(cutoff, num_ws))
        z2 = self._randn(z.shape, gen, dev)
        ws2 = self.G.mapping(z2, c)
        mask = torch.arange(num_ws, device=dev)[None, :, None] >= cutoff
        return torch.where(mask, ws2, ws)

    def run_G(self, z, c, gen, update_emas: bool = False):
        """mapping → style mixing → synthesis.  ``update_emas`` (the D-main
        fake pass) updates ``w_avg`` and StyleGAN3's per-layer
        ``magnitude_ema`` in place."""
        ws = self.G.mapping(z, c, update_emas=update_emas)
        ws = self._mix(ws, z, c, gen)
        img = self.G.synthesis(ws, noise_mode=self.cfg.noise_mode, generator=gen,
                               update_emas=update_emas)
        return img, ws

    def _blur(self, img, blur_sigma: float):
        """D's input blur: the span ``d_blur`` (its forward launches; the
        backward's run in the phase's ``backward``) and the counter
        ``loss.blur/<taps of one axis>``."""
        blur_size = int(np.floor(blur_sigma * 3))
        if blur_size <= 0:
            return img
        count(f"loss.blur/{2 * blur_size + 1}")
        with span("d_blur", sigma=blur_sigma):
            # Built on the host, so the FIR kernel gets its taps without a sync.
            t = np.arange(-blur_size, blur_size + 1, dtype=np.float32)
            f = np.exp2(-np.square(t / np.float32(blur_sigma)))
            return filter2d(img, Filter(f / f.sum()))

    def blur_sigma(self, cur_nimg: float) -> float:
        if self.cfg.blur_fade_kimg <= 0:
            return 0.0
        return max(1.0 - cur_nimg / (self.cfg.blur_fade_kimg * 1e3), 0.0) * self.cfg.blur_init_sigma

    def _augment(self, img, ada_p, gen):
        if self.augment_fn is None:
            return img
        return self.augment_fn(img, ada_p, gen)

    def run_D(self, img, c, gen, ada_p, cur_nimg: float):
        """blur ramp → ADA augment → D."""
        img = self._blur(img, self.blur_sigma(cur_nimg))
        return self.D(self._augment(img, ada_p, gen), c)

    # -------------------------------------------------------------- phases

    def gmain(self, z, c, gen, ada_p, cur_nimg: float) -> Tuple[torch.Tensor, stats.Moments]:
        """Non-saturating generator loss."""
        img, _ = self.run_G(z, c, gen)
        logits = self.run_D(img, c, gen, ada_p, cur_nimg)
        loss = F.softplus(-logits)
        m: stats.Moments = {}
        m = stats.report(m, "Loss/scores/fake", logits)
        m = stats.report(m, "Loss/signs/fake", logits.sign())
        m = stats.report(m, "Loss/G/loss", loss)
        return loss.mean(), m

    def gpl(self, z, c, gen, pl_mean, pl_noise=None,
            batch_mean: Callable[[torch.Tensor], torch.Tensor] = torch.mean):
        """Path-length regularisation.  Returns
        ``(loss, new_pl_mean (detached), moments)``; the caller applies the
        lazy-reg gain.  ``pl_noise`` (NCHW standard normal) replaces the
        draw from ``gen``; ``batch_mean`` is the mean that ``pl_mean``
        moves toward (over all ranks in a data-parallel step, as JAX's
        ``batch_mean_fn``)."""
        bsz = z.shape[0] // self.cfg.pl_batch_shrink
        z = z[:bsz]
        c = c[:bsz] if c is not None else None
        ws = self.G.mapping(z, c)
        ws = self._mix(ws, z, c, gen)
        img = self.G.synthesis(ws, noise_mode=self.cfg.noise_mode, generator=gen)
        if pl_noise is None:
            pl_noise = self._randn(img.shape, gen, img.device)
        pl_noise = pl_noise / np.sqrt(img.shape[2] * img.shape[3])
        with span("pl_grads"):
            (pl_grads,) = torch.autograd.grad((img * pl_noise).sum(), ws, create_graph=True)
        pl_lengths = pl_grads.square().sum(dim=2).mean(dim=1).sqrt()
        # The lerped mean stays in the graph for the penalty.
        new_pl_mean = pl_mean + self.cfg.pl_decay * (batch_mean(pl_lengths) - pl_mean)
        pl_penalty = (pl_lengths - new_pl_mean).square()
        loss = pl_penalty * self.cfg.pl_weight
        m: stats.Moments = {}
        m = stats.report(m, "Loss/pl_penalty", pl_penalty)
        m = stats.report(m, "Loss/G/reg", loss)
        return loss.mean(), new_pl_mean.detach(), m

    def dmain(self, z, c, real_img, real_c, gen, ada_p, cur_nimg: float):
        """Discriminator main loss; the fake pass updates G's EMA buffers."""
        with torch.no_grad():
            gen_img, _ = self.run_G(z, c, gen, update_emas=True)
        both = torch.cat([gen_img, real_img.to(gen_img.dtype)], dim=0)
        both = self._augment(self._blur(both, self.blur_sigma(cur_nimg)), ada_p, gen)
        n = gen_img.shape[0]
        gen_logits = self.D(both[:n], c)
        real_logits = self.D(both[n:], real_c)
        loss_dgen = F.softplus(gen_logits)
        loss_dreal = F.softplus(-real_logits)
        m: stats.Moments = {}
        m = stats.report(m, "Loss/scores/fake", gen_logits)
        m = stats.report(m, "Loss/signs/fake", gen_logits.sign())
        m = stats.report(m, "Loss/scores/real", real_logits)
        m = stats.report(m, "Loss/signs/real", real_logits.sign())
        m = stats.report(m, "Loss/D/loss", loss_dgen + loss_dreal)
        return loss_dgen.mean() + loss_dreal.mean(), m

    def dr1(self, real_img, real_c, gen, ada_p, cur_nimg: float):
        """R1 gradient penalty (differentiates through the augment twice)."""
        real = real_img.detach().requires_grad_(True)
        logits = self.run_D(real, real_c, gen, ada_p, cur_nimg)
        with span("r1_grads"):
            (r1_grads,) = torch.autograd.grad(logits.sum(), real, create_graph=True)
        r1_penalty = r1_grads.square().sum(dim=[1, 2, 3])
        loss = r1_penalty * (self.cfg.r1_gamma / 2)
        m: stats.Moments = {}
        m = stats.report(m, "Loss/scores/real", logits)
        m = stats.report(m, "Loss/signs/real", logits.sign())
        m = stats.report(m, "Loss/r1_penalty", r1_penalty)
        m = stats.report(m, "Loss/D/reg", loss)
        return loss.mean(), m
