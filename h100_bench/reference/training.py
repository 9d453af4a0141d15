"""Plain float32 StyleGAN2-ADA training steps (Karras et al. 2020).

One step runs the four phases of the published schedule on one batch:
G-main (non-saturating loss), G-reg (path-length penalty, every
``g_reg_interval`` steps, on half the batch), D-main (both halves of the
logistic loss; the fake pass moves G's ``w_avg``), D-reg (R1, every
``d_reg_interval`` steps); each phase's gradients are NaN/Inf-scrubbed
and applied by Adam with lazy-regularisation scaling; then G_ema with
its ramp-up and the ADA controller.  With ``micro_batches = M`` a phase
sums the gradients of its ``M`` chunks' mean losses before its update.

The draws come from one generator in the order the program under test
draws them (z, the style mixing's cutoff, gate and second z, each
layer's noise, the augment's transforms, the path-length noise), so the
same seed gives both the same latents and transforms.  As in the
program's JAX origin, the path-length mean stays in the penalty's graph
and D-main augments the fakes and reals in one pass.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .augment import AugmentPipe
from .numerics import Numerics


@dataclasses.dataclass
class StepConfig:
    batch: int
    glr: float
    dlr: float
    gamma: float
    ema_kimg: float
    micro_batches: int = 1
    g_reg_interval: Optional[int] = 4
    d_reg_interval: int = 16
    style_mixing: float = 0.9
    pl_weight: float = 2.0
    ada_target: Optional[float] = 0.6
    ada_kimg: float = 500.0
    z_dim: int = 512


class Adam:
    """Adam with bias correction, eps outside the root, and the
    lazy-regularisation scaling ``r / (r + 1)`` of lr and both betas."""

    def __init__(self, params: Dict[str, torch.nn.Parameter], lr: float, reg_interval):
        ratio = reg_interval / (reg_interval + 1) if reg_interval else 1.0
        self.params, self.lr = params, lr * ratio
        self.b1, self.b2, self.eps, self.t = 0.0 ** ratio, 0.99 ** ratio, 1e-8, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = torch.nan_to_num(grads[k], nan=0.0, posinf=1e5, neginf=-1e5)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr / c1 * self.m[k] / ((self.v[k] / c2).sqrt() + self.eps))


class Trainer:
    """G, D, G_ema, their optimisers and the step counters.  With several
    ``generators``, the step is data-parallel over that many ranks: rank
    ``r`` draws from ``generators[r]`` and takes ``reals[r]``; a phase's
    loss is the mean over ranks of each rank's, the path-length mean is
    the global batch's, G's ``w_avg`` moves toward the global mean, and
    ADA counts every rank's signs."""

    def __init__(self, G, D, cfg: StepConfig, augment: Optional[AugmentPipe], nm: Numerics,
                 generators: List[torch.Generator], ada_p: float):
        self.G, self.D, self.cfg, self.augment, self.nm = G, D, cfg, augment, nm
        self.gens = list(generators)
        self.gen = self.gens[0]
        self.G_ema = copy.deepcopy(G).requires_grad_(False)
        self.g_params = dict(G.named_parameters())
        self.d_params = dict(D.named_parameters())
        self.opt_g = Adam(self.g_params, cfg.glr, cfg.g_reg_interval)
        self.opt_d = Adam(self.d_params, cfg.dlr, cfg.d_reg_interval)
        dev = self.gen.device
        self.pl_mean = torch.zeros([], device=dev)
        self.ada_p = torch.tensor(float(ada_p), device=dev)
        self.ada_signs = torch.zeros([2], device=dev)
        self.step_idx = 0
        self.cur_nimg = 0

    # ------------------------------------------------------------ passes

    def _mix(self, ws, z):
        if self.cfg.style_mixing <= 0:
            return ws
        num_ws, dev = ws.shape[1], ws.device
        cutoff = torch.randint(1, num_ws, (), generator=self.gen, device=dev)
        mix = torch.rand((), generator=self.gen, device=dev) < self.cfg.style_mixing
        cutoff = torch.where(mix, cutoff, torch.full_like(cutoff, num_ws))
        z2 = torch.randn(z.shape, generator=self.gen, device=dev)
        ws2 = self.G.mapping(z2)
        return torch.where(torch.arange(num_ws, device=dev)[None, :, None] >= cutoff, ws2, ws)

    def _run_G(self, z, update_emas: bool = False):
        ws = self.G.mapping(z)
        if update_emas:  # moved once every rank's chunk has run (``_move_w_avg``)
            self._w_means.append(ws[:, 0].detach().mean(dim=0))
        ws = self._mix(ws, z)
        return self.G.synthesis_forward(ws, self.nm, "random", self.gen,
                                        update_emas=update_emas), ws

    def _move_w_avg(self) -> None:
        w_avg = self.G.mapping.w_avg
        with torch.no_grad():
            w_avg.copy_(torch.stack(self._w_means).mean(dim=0).lerp(w_avg, 0.998))

    def _augment(self, img):
        return img if self.augment is None else self.augment(img, self.ada_p, self.gen, self.nm)

    def _ranks(self, args, fn):
        """``fn(*rank_args)`` for each rank with its generator; their
        losses' mean and their reports joined."""
        losses, parts = [], {}
        for gen, a in zip(self.gens, args):
            self.gen = gen
            loss, p = fn(*a)
            losses.append(loss)
            for k, v in p.items():
                parts.setdefault(k, []).append(v)
        return torch.stack(losses).mean(), {k: torch.cat(v) for k, v in parts.items()}

    def _gmain(self, args):
        def one(z):
            img, _ = self._run_G(z)
            logits = self.D(self._augment(img), self.nm)
            return F.softplus(-logits).mean(), {"Loss/G/loss": F.softplus(-logits).reshape(-1)}
        return self._ranks(args, one)

    def _gpl(self, args):
        lengths = []
        for gen, (z,) in zip(self.gens, args):
            self.gen = gen
            z = z[:z.shape[0] // 2]
            ws = self._mix(self.G.mapping(z), z)
            img = self.G.synthesis_forward(ws, self.nm, "random", self.gen)
            noise = torch.randn(img.shape, generator=self.gen, device=img.device)
            noise = noise / np.sqrt(img.shape[2] * img.shape[3])
            (g,) = torch.autograd.grad((img * noise).sum(), ws, create_graph=True)
            lengths.append(g.square().sum(dim=2).mean(dim=1).sqrt())
        # The path-length mean moves toward the global batch's mean.
        new_mean = self.pl_mean + 0.01 * (torch.stack([x.mean() for x in lengths]).mean()
                                          - self.pl_mean)
        penalties = [(x - new_mean).square() * self.cfg.pl_weight for x in lengths]
        self.pl_mean = new_mean.detach()
        loss = torch.stack([p.mean() for p in penalties]).mean() * self.cfg.g_reg_interval
        return loss, {"Loss/G/reg": torch.cat(penalties)}

    def _dmain(self, args):
        self._w_means = []

        def one(z, real):
            with torch.no_grad():
                fake, _ = self._run_G(z, update_emas=True)
            both = self._augment(torch.cat([fake, real], dim=0))
            n = fake.shape[0]
            gen_logits, real_logits = self.D(both[:n], self.nm), self.D(both[n:], self.nm)
            loss = F.softplus(gen_logits) + F.softplus(-real_logits)
            return (F.softplus(gen_logits).mean() + F.softplus(-real_logits).mean(),
                    {"Loss/D/loss": loss.reshape(-1), "signs": real_logits.sign().reshape(-1)})

        out = self._ranks(args, one)
        self._move_w_avg()
        return out

    def _dr1(self, args):
        def one(real):
            real = real.detach().requires_grad_(True)
            logits = self.D(self._augment(real), self.nm)
            (g,) = torch.autograd.grad(logits.sum(), real, create_graph=True)
            penalty = g.square().sum(dim=[1, 2, 3]) * (self.cfg.gamma / 2)
            return penalty.mean() * self.cfg.d_reg_interval, {"Loss/D/reg": penalty,
                                                             "signs": logits.sign().reshape(-1)}
        return self._ranks(args, one)

    # -------------------------------------------------------------- step

    def _phase(self, params: Dict[str, torch.nn.Parameter], opt: Adam, loss_fn, chunks,
               out: Dict[str, List[torch.Tensor]]) -> None:
        """``chunks[j]``: every rank's arguments of chunk ``j``."""
        total = {k: torch.zeros_like(p) for k, p in params.items()}
        for args in chunks:
            loss, parts = loss_fn(args)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            for (k, t), g in zip(total.items(), grads):
                if g is not None:
                    t.add_(g)
            for name, v in parts.items():
                out.setdefault(name, []).append(v.detach().float())
        opt.step(total)

    def step(self, reals: List[torch.Tensor]) -> Dict[str, float]:
        """One batch (``reals[r]``: rank ``r``'s share); returns each
        reported quantity's mean over the global batch."""
        cfg, dev = self.cfg, reals[0].device
        M = cfg.micro_batches
        n = reals[0].shape[0] // M
        split = lambda x: [x[j * n:(j + 1) * n] for j in range(M)]  # noqa: E731

        def zs():  # each rank's latents of one phase, split into its chunks
            per_rank = [split(torch.randn((r.shape[0], cfg.z_dim), generator=g, device=dev))
                        for g, r in zip(self.gens, reals)]
            return [[(z[j],) for z in per_rank] for j in range(M)]

        do_gpl = cfg.g_reg_interval is not None and cfg.pl_weight != 0 and \
            self.step_idx % cfg.g_reg_interval == 0
        do_dr1 = cfg.gamma != 0 and self.step_idx % cfg.d_reg_interval == 0
        out: Dict[str, List[torch.Tensor]] = {}
        with self.nm.matmul_precision():
            self._phase(self.g_params, self.opt_g, self._gmain, zs(), out)
            if do_gpl:
                self._phase(self.g_params, self.opt_g, self._gpl, zs(), out)
            z = zs()
            r = [split(x) for x in reals]
            self._phase(self.d_params, self.opt_d, self._dmain,
                        [[(z[j][k][0], r[k][j]) for k in range(len(reals))] for j in range(M)],
                        out)
            if do_dr1:
                self._phase(self.d_params, self.opt_d, self._dr1,
                            [[(r[k][j],) for k in range(len(reals))] for j in range(M)], out)
        ema_nimg = min(cfg.ema_kimg * 1000.0, self.cur_nimg * 0.05)
        beta = 0.5 ** (cfg.batch / max(ema_nimg, 1e-8))  # ``batch``: the global batch
        with torch.no_grad():
            for p_ema, p in zip(self.G_ema.parameters(), self.G.parameters()):
                p_ema.copy_(p.lerp(p_ema, beta))
            for b_ema, b in zip(self.G_ema.buffers(), self.G.buffers()):
                b_ema.copy_(b)
        if cfg.ada_target is not None:
            signs = torch.cat(out["signs"])
            self.ada_signs = self.ada_signs + torch.stack([torch.tensor(float(signs.numel()),
                                                                        device=dev), signs.sum()])
            if (self.step_idx + 1) % 4 == 0:
                mean_sign = self.ada_signs[1] / self.ada_signs[0].clamp(min=1.0)
                adjust = torch.sign(mean_sign - cfg.ada_target) * (cfg.batch * 4) / (cfg.ada_kimg * 1000)
                self.ada_p = (self.ada_p + adjust).clamp(min=0.0)
                self.ada_signs = torch.zeros_like(self.ada_signs)
        self.step_idx += 1
        self.cur_nimg += cfg.batch
        return {k: float(torch.cat(v).mean()) for k, v in out.items() if k != "signs"}
