"""CycleGAN / pix2pix training engines in PyTorch.

Port of ``gantrack_tpu/training/image2image.py``: CycleGAN (two G, two D,
cycle-consistency L1 λ=10, identity loss λ_idt=0.5, LSGAN, an image pool
of past fakes), pix2pix (conditional GAN + L1 λ=100), its colorization
variant (L → ab in CIELAB) and the G-only L1 regression baseline, with
the linear / step / cosine learning-rate policies.

As in the JAX package:

* the learning rate is a function of the **iteration**: an optimizer's
  ``k``-th update (from 0) takes ``schedule(k)``, as ``optax.adam(sched)``
  evaluates its schedule at its count before the update;
* Adam with ``b1=beta1``, ``b2=0.999``, eps 1e-8; one Adam over both
  CycleGAN generators, one per discriminator;
* CycleGAN updates both G, then each D against the pooled fakes of that
  G step (the D step reads the discriminators before their update);
* pix2pix updates D against the detached fake, then G against the
  **updated** D; G's forward runs once, so its loss sees the fake (and the
  dropout mask) that D was trained against, as the JAX step's two
  forwards with one dropout key do.

The networks live in the trainer and are updated in place.  A trainer is
built on an explicit ``device`` from an explicit ``torch.Generator``:
the weights are drawn from it on the CPU (the same weights on any
device), and the dropout masks from a generator on ``device`` seeded
from it.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..models.image2image import define_D, define_G, gan_loss, set_dropout_generator


class ImagePool:
    """History buffer of generated images (reference ``util/image_pool.py``)."""

    def __init__(self, pool_size: int = 50, seed: int = 0):
        self.pool_size = pool_size
        self.images = []
        self._rng = random.Random(seed)

    def query(self, images: torch.Tensor) -> torch.Tensor:
        if self.pool_size == 0:
            return images
        out = []
        for img in images:
            if len(self.images) < self.pool_size:
                self.images.append(img.clone())
                out.append(img)
            elif self._rng.random() > 0.5:
                idx = self._rng.randint(0, self.pool_size - 1)
                out.append(self.images[idx].clone())
                self.images[idx] = img.clone()
            else:
                out.append(img)
        return torch.stack(out)


def make_lr_schedule(policy: str, lr: float, n_epochs: int, n_epochs_decay: int,
                     iters_per_epoch: int, step_size: int = 50) -> Callable[[int], float]:
    """reference ``get_scheduler`` (``networks.py:38-64``) as a schedule
    over iterations."""
    if policy == "linear":
        def sched(it):
            epoch = it // iters_per_epoch
            factor = 1.0 - max(0, epoch + 1 - n_epochs) / (n_epochs_decay + 1)
            return lr * min(max(factor, 0.0), 1.0)
        return sched
    if policy == "step":
        def sched(it):
            epoch = it // iters_per_epoch
            return lr * 0.1 ** (epoch // step_size)
        return sched
    if policy == "cosine":
        total = n_epochs + n_epochs_decay

        def sched(it):
            epoch = it // iters_per_epoch
            return lr * 0.5 * (1 + math.cos(math.pi * epoch / total))
        return sched
    raise ValueError(policy)


class ScheduledAdam:
    """Adam whose ``k``-th update (from 0) takes ``schedule(k)`` as its
    learning rate."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Callable[[int], float],
                 beta1: float):
        self.params: List[torch.nn.Parameter] = list(params)
        self.schedule = schedule
        self.opt = torch.optim.Adam(self.params, lr=schedule(0), betas=(beta1, 0.999), eps=1e-8)
        self.count = 0

    def step(self, loss: torch.Tensor) -> None:
        """One update of the parameters down the gradient of ``loss``."""
        grads = torch.autograd.grad(loss, self.params)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.count += 1

    def state_dict(self) -> dict:
        return {"opt": self.opt.state_dict(), "count": self.count}


class _Trainer:
    """Networks, optimizers and the iteration count of an i2i trainer."""

    nets: Dict[str, torch.nn.Module]
    opts: Dict[str, ScheduledAdam]

    def _setup(self, device, generator: torch.Generator):
        self.device = torch.device(device)
        for net in self.nets.values():
            net.to(self.device).train()
        seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
        self.dropout_generator = torch.Generator(self.device).manual_seed(seed)
        for net in self.nets.values():
            set_dropout_generator(net, self.dropout_generator)
        self.step = 0

    def state_dict(self) -> dict:
        return {"nets": {k: v.state_dict() for k, v in self.nets.items()},
                "opts": {k: v.state_dict() for k, v in self.opts.items()},
                "step": self.step, "dropout_generator": self.dropout_generator.get_state()}


@dataclasses.dataclass
class CycleGANConfig:
    input_nc: int = 3
    output_nc: int = 3
    ngf: int = 64
    ndf: int = 64
    netG: str = "resnet_9blocks"
    netD: str = "basic"
    gan_mode: str = "lsgan"
    lambda_a: float = 10.0
    lambda_b: float = 10.0
    lambda_identity: float = 0.5
    lr: float = 2e-4
    beta1: float = 0.5
    pool_size: int = 50
    lr_policy: str = "linear"
    n_epochs: int = 100
    n_epochs_decay: int = 100


class CycleGANTrainer(_Trainer):
    """Two-direction CycleGAN (reference ``cycle_gan_model.py``): ``g_a``
    maps A → B and ``d_a`` judges B; ``g_b`` maps B → A and ``d_b`` judges A."""

    def __init__(self, cfg: CycleGANConfig, *, device, generator: torch.Generator,
                 iters_per_epoch: int = 1000):
        self.cfg = cfg
        self.g_a = define_G(cfg.input_nc, cfg.output_nc, cfg.ngf, cfg.netG, generator=generator)
        self.g_b = define_G(cfg.output_nc, cfg.input_nc, cfg.ngf, cfg.netG, generator=generator)
        self.d_a = define_D(cfg.output_nc, cfg.ndf, cfg.netD, generator=generator)
        self.d_b = define_D(cfg.input_nc, cfg.ndf, cfg.netD, generator=generator)
        self.nets = dict(g_a=self.g_a, g_b=self.g_b, d_a=self.d_a, d_b=self.d_b)
        self._setup(device, generator)
        sched = make_lr_schedule(cfg.lr_policy, cfg.lr, cfg.n_epochs, cfg.n_epochs_decay,
                                 iters_per_epoch)
        self.opts = dict(
            g=ScheduledAdam([*self.g_a.parameters(), *self.g_b.parameters()], sched, cfg.beta1),
            d_a=ScheduledAdam(self.d_a.parameters(), sched, cfg.beta1),
            d_b=ScheduledAdam(self.d_b.parameters(), sched, cfg.beta1))
        self.pool_a = ImagePool(cfg.pool_size)
        self.pool_b = ImagePool(cfg.pool_size)

    def optimize_parameters(self, real_a: torch.Tensor, real_b: torch.Tensor
                            ) -> Dict[str, float]:
        cfg = self.cfg
        real_a, real_b = real_a.to(self.device), real_b.to(self.device)
        fake_b = self.g_a(real_a)
        rec_a = self.g_b(fake_b)
        fake_a = self.g_b(real_b)
        rec_b = self.g_a(fake_a)
        loss_g = 0.0
        if cfg.lambda_identity > 0:
            idt_a = self.g_a(real_b)
            idt_b = self.g_b(real_a)
            loss_g = loss_g + (idt_a - real_b).abs().mean() * cfg.lambda_b * cfg.lambda_identity
            loss_g = loss_g + (idt_b - real_a).abs().mean() * cfg.lambda_a * cfg.lambda_identity
        loss_g = loss_g + gan_loss(self.d_a(fake_b), True, cfg.gan_mode)
        loss_g = loss_g + gan_loss(self.d_b(fake_a), True, cfg.gan_mode)
        loss_g = loss_g + (rec_a - real_a).abs().mean() * cfg.lambda_a
        loss_g = loss_g + (rec_b - real_b).abs().mean() * cfg.lambda_b
        self.opts["g"].step(loss_g)

        fake_a = self.pool_a.query(fake_a.detach())
        fake_b = self.pool_b.query(fake_b.detach())

        def d_loss(d, real, fake):
            return (gan_loss(d(real), True, cfg.gan_mode)
                    + gan_loss(d(fake), False, cfg.gan_mode)) * 0.5

        loss_da = d_loss(self.d_a, real_b, fake_b)
        loss_db = d_loss(self.d_b, real_a, fake_a)
        self.opts["d_a"].step(loss_da)
        self.opts["d_b"].step(loss_db)
        self.step += 1
        return {"G": float(loss_g.detach()), "D_A": float(loss_da.detach()),
                "D_B": float(loss_db.detach())}


@dataclasses.dataclass
class Pix2PixConfig:
    input_nc: int = 3
    output_nc: int = 3
    ngf: int = 64
    ndf: int = 64
    netG: str = "unet_256"
    netD: str = "basic"
    gan_mode: str = "vanilla"
    lambda_l1: float = 100.0
    lr: float = 2e-4
    beta1: float = 0.5
    lr_policy: str = "linear"
    n_epochs: int = 100
    n_epochs_decay: int = 100
    no_dropout: bool = False   # reference --no_dropout (pix2pix trains with dropout)


class Pix2PixTrainer(_Trainer):
    """Conditional GAN + L1 (reference ``pix2pix_model.py``)."""

    def __init__(self, cfg: Pix2PixConfig, *, device, generator: torch.Generator,
                 iters_per_epoch: int = 1000):
        self.cfg = cfg
        self.g = define_G(cfg.input_nc, cfg.output_nc, cfg.ngf, cfg.netG,
                          use_dropout=not cfg.no_dropout, generator=generator)
        self.d = define_D(cfg.input_nc + cfg.output_nc, cfg.ndf, cfg.netD, generator=generator)
        self.nets = dict(g=self.g, d=self.d)
        self._setup(device, generator)
        sched = make_lr_schedule(cfg.lr_policy, cfg.lr, cfg.n_epochs, cfg.n_epochs_decay,
                                 iters_per_epoch)
        self.opts = dict(g=ScheduledAdam(self.g.parameters(), sched, cfg.beta1),
                         d=ScheduledAdam(self.d.parameters(), sched, cfg.beta1))

    def optimize_parameters(self, real_a: torch.Tensor, real_b: torch.Tensor
                            ) -> Dict[str, float]:
        cfg = self.cfg
        real_a, real_b = real_a.to(self.device), real_b.to(self.device)
        fake_b = self.g(real_a)
        fake_ab = torch.cat([real_a, fake_b.detach()], dim=1)
        real_ab = torch.cat([real_a, real_b], dim=1)
        loss_d = (gan_loss(self.d(fake_ab), False, cfg.gan_mode)
                  + gan_loss(self.d(real_ab), True, cfg.gan_mode)) * 0.5
        self.opts["d"].step(loss_d)

        pred = self.d(torch.cat([real_a, fake_b], dim=1))  # the updated D
        loss_g = gan_loss(pred, True, cfg.gan_mode) + (fake_b - real_b).abs().mean() * cfg.lambda_l1
        self.opts["g"].step(loss_g)
        self.step += 1
        return {"G": float(loss_g.detach()), "D": float(loss_d.detach())}


class ColorizationTrainer(Pix2PixTrainer):
    """pix2pix specialised to colorization: L channel -> ab channels in
    CIELAB (reference ``models/colorization_model.py``: the 1 -> 2 channel
    config and Lab -> RGB visuals)."""

    def __init__(self, cfg: Optional[Pix2PixConfig] = None, **kwargs):
        cfg = dataclasses.replace(cfg or Pix2PixConfig(), input_nc=1, output_nc=2)
        super().__init__(cfg, **kwargs)

    @staticmethod
    def lab2rgb(L: np.ndarray, AB: np.ndarray) -> np.ndarray:
        """NHWC [-1,1] L plane + [-1,1] ab planes -> [0,255] RGB float array
        (reference ``colorization_model.py:48-63``)."""
        from ..utils.colorspace import lab2rgb as _lab2rgb

        lab = np.concatenate([(np.asarray(L, np.float64) + 1.0) * 50.0,
                              np.asarray(AB, np.float64) * 110.0], axis=-1)
        return _lab2rgb(lab) * 255.0

    def compute_visuals(self, real_a: torch.Tensor, real_b: torch.Tensor,
                        fake_b: torch.Tensor) -> Dict[str, np.ndarray]:
        """Input L, ground-truth RGB and predicted RGB (NCHW tensors in,
        NHWC numpy out)."""
        a, b, f = (t.detach().permute(0, 2, 3, 1).cpu().numpy() for t in (real_a, real_b, fake_b))
        return {"real_A": a, "real_B_rgb": self.lab2rgb(a, b), "fake_B_rgb": self.lab2rgb(a, f)}


@dataclasses.dataclass
class RegressionConfig:
    input_nc: int = 3
    output_nc: int = 3
    ngf: int = 64
    netG: str = "unet_256"
    lambda_regression: float = 1.0
    lr: float = 2e-4
    beta1: float = 0.5
    lr_policy: str = "linear"
    n_epochs: int = 100
    n_epochs_decay: int = 100


class RegressionTrainer(_Trainer):
    """G-only L1 regression ``min_G ||G(A) - B||_1`` (reference
    ``models/template_model.py``)."""

    def __init__(self, cfg: RegressionConfig, *, device, generator: torch.Generator,
                 iters_per_epoch: int = 1000):
        self.cfg = cfg
        self.g = define_G(cfg.input_nc, cfg.output_nc, cfg.ngf, cfg.netG, generator=generator)
        self.nets = dict(g=self.g)
        self._setup(device, generator)
        sched = make_lr_schedule(cfg.lr_policy, cfg.lr, cfg.n_epochs, cfg.n_epochs_decay,
                                 iters_per_epoch)
        self.opts = dict(g=ScheduledAdam(self.g.parameters(), sched, cfg.beta1))

    def optimize_parameters(self, real_a: torch.Tensor, real_b: torch.Tensor
                            ) -> Dict[str, float]:
        real_a, real_b = real_a.to(self.device), real_b.to(self.device)
        loss = (self.g(real_a) - real_b).abs().mean() * self.cfg.lambda_regression
        self.opts["g"].step(loss)
        self.step += 1
        return {"loss_G": float(loss.detach())}
