"""The training step: all phases of one batch, in plain PyTorch.

Port of ``TrainStepper._device_step`` (``gantrack_tpu/training/step.py``):
G-main, then G-reg (path length) every ``g_reg_interval`` steps, D-main,
then D-reg (R1) every ``d_reg_interval`` steps; each phase's gradients
are NaN/Inf-scrubbed before its Adam update; then the G-EMA with rampup
and the ADA controller.  The JAX package's jit fast path and host syncs
are not carried.

Data parallelism (``parallel.mesh``): one process per device, each with
its share of the batch (``cfg.batch_size`` is the global batch).  The
collectives sit where the JAX step has them: each phase's accumulated
gradients are averaged over ranks before the scrub, in one
``all_reduce`` per phase (flattened; the port differentiates with
``torch.autograd.grad``, so no DDP hook would fire); ``pl_mean`` moves
toward the global batch mean; G's EMA buffers (``w_avg``,
``magnitude_ema``) are averaged after D-main; the moments are summed, so
the ADA signs and ``p`` are the same on every rank.  Without a process
group no collective runs and the step's bits are those of one device.

RNG modes: ``"device"`` gives each rank its own stream (the caller seeds
its generator ``seed * world + rank``, the reference's
``seed*num_gpus+rank``).  ``"global_sample"`` takes one stream, seeded
alike on every rank, and draws every per-sample value (z, labels, the
style mixing's second z, the path-length noise) for the global batch, of
which each rank keeps its rows: one rank and N ranks of the same global
batch then give the same update.  As in JAX it needs const synthesis
noise, no augment and ``pl_batch_shrink=1``, and the runs compared must
take equal ``micro_batches`` (a chunk's style-mixing cutoff and
``pl_mean`` carry depend on which samples the chunk holds).

Gradient accumulation (``micro_batches = M > 1``, the CLI's
``--batch-gpu``): every phase splits its batch into ``M`` chunks in
order and takes one ``torch.autograd.grad`` a chunk, which frees that
chunk's graph before the next; the per-chunk mean gradients are
**summed**, not averaged (the JAX ``_accum``, the reference's
accumulate-then-step), then scrubbed once and applied in one optimizer
step.  ``pl_mean`` and G's EMA buffers go from chunk to chunk; moments
sum over the chunks.  The parameters a phase updates are those its
optimizer holds, so a discriminator built with frozen layers
(``--freezed``) still passes gradients through them.

Spans (:mod:`..utils.profiling`): ``Gmain``, ``Greg``, ``Dmain`` and
``Dreg`` (the reference's phase names) a phase, with the step number as
``step``; ``forward`` and ``backward`` a chunk, with its index as
``chunk``; ``opt`` (all-reduce, scrub, Adam) a phase's update; ``ema``
and ``ada`` the step's tail.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..parallel.mesh import Mesh, all_mean, all_sum, batch_mean, create_mesh
from ..utils.profiling import span
from . import stats
from .loss import StyleGAN2Loss
from .train_state import TrainState


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    batch_size: int
    z_dim: int
    c_dim: int = 0
    ema_kimg: float = 10.0
    ema_rampup: Optional[float] = 0.05
    g_reg_interval: Optional[int] = 4
    d_reg_interval: Optional[int] = 16
    ada_target: Optional[float] = None      # None = ADA controller off
    ada_interval: int = 4
    ada_kimg: float = 500.0
    micro_batches: int = 1
    rng_mode: str = "device"


# G's buffers that the D-main fake pass moves (the JAX state's ``emas_g``).
EMA_BUFFERS = ("w_avg", "magnitude_ema")


def _scrub(grads):
    """nan → 0, ±inf → ±1e5 (reference ``misc.nan_to_num``)."""
    return [torch.nan_to_num(g, nan=0.0, posinf=1e5, neginf=-1e5) for g in grads]


def _opt_params(opt: torch.optim.Optimizer) -> List[torch.nn.Parameter]:
    """The parameters ``opt`` updates: a phase differentiates only these."""
    return [p for group in opt.param_groups for p in group["params"]]


def _accumulate(params, num_chunks: int,
                chunk_loss: Callable[[int], Tuple[torch.Tensor, stats.Moments]]):
    """Sum of the gradients of ``chunk_loss(j)`` w.r.t. ``params`` over
    the chunks ``j`` in order, and the chunks' moments summed; each
    chunk's graph is freed before the next is built.  Spans ``forward``
    and ``backward`` a chunk."""
    total: Optional[List[torch.Tensor]] = None
    moments: stats.Moments = {}
    for j in range(num_chunks):
        with span("forward", chunk=j):
            loss, m = chunk_loss(j)
        with span("backward", chunk=j):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            total = grads if total is None else [a + g for a, g in zip(total, grads)]
        moments = stats.merge(moments, m)
    return total, moments


def _apply(opt: torch.optim.Optimizer, params, grads) -> None:
    """Scrubbed gradients, then one optimizer step."""
    for p, g in zip(params, _scrub(grads)):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def update_ema(G_ema, G, batch_size: int, cur_nimg: int, ema_kimg: float,
               ema_rampup: Optional[float]) -> None:
    """``G_ema ← G + (G_ema − G)·β`` with ``β = 0.5^(batch / ema_nimg)``;
    buffers (``w_avg``, noise constants; StyleGAN3's ``magnitude_ema`` and
    Fourier constants) are copied from G, as the JAX state shares
    ``emas_g`` and ``consts_g`` between G and G_ema."""
    ema_nimg = ema_kimg * 1000.0
    if ema_rampup is not None:
        ema_nimg = min(ema_nimg, cur_nimg * ema_rampup)
    beta = 0.5 ** (batch_size / max(ema_nimg, 1e-8))
    with torch.no_grad():
        for p_ema, p in zip(G_ema.parameters(), G.parameters()):
            p_ema.copy_(p.lerp(p_ema, beta))
        for b_ema, b in zip(G_ema.buffers(), G.buffers()):
            b_ema.copy_(b)


class TrainStepper:
    """Runs one batch on ``state`` in place and returns its moments.
    ``mesh`` is the process group's (:func:`parallel.mesh.create_mesh`
    when not given); the step runs on this rank's share of the batch."""

    def __init__(self, loss: StyleGAN2Loss, cfg: TrainStepConfig,
                 generator: torch.Generator, label_bank: Optional[torch.Tensor] = None,
                 mesh: Optional[Mesh] = None):
        if cfg.micro_batches < 1:
            raise ValueError(f"micro_batches must be at least 1, not {cfg.micro_batches}")
        if mesh is None:
            mesh = create_mesh() if torch.distributed.is_initialized() else Mesh()
        if mesh.world > 1 and not mesh.distributed:
            raise ValueError(f"a mesh of {mesh.world} ranks needs a process group")
        if cfg.batch_size % mesh.world:
            raise ValueError(f"batch {cfg.batch_size} is not divisible by {mesh.world} ranks")
        if cfg.rng_mode == "global_sample":
            lc = loss.cfg
            if lc.noise_mode != "const" or loss.augment_fn is not None or lc.pl_batch_shrink != 1:
                raise ValueError("rng_mode='global_sample' needs noise_mode='const', no augment "
                                 "and pl_batch_shrink=1")
            loss.global_rows = (mesh.rank, mesh.world)
        elif cfg.rng_mode != "device":
            raise ValueError(f"unknown rng_mode {cfg.rng_mode!r}")
        self.loss = loss
        self.cfg = cfg
        self.generator = generator
        self.label_bank = label_bank
        self.mesh = mesh

    def phase_flags(self, step: int) -> Tuple[bool, bool]:
        """Lazy-regularisation cadence for batch index ``step``."""
        do_gpl = (self.cfg.g_reg_interval is not None and self.loss.cfg.pl_weight != 0
                  and step % self.cfg.g_reg_interval == 0)
        do_dr1 = (self.cfg.d_reg_interval is not None and self.loss.cfg.r1_gamma != 0
                  and step % self.cfg.d_reg_interval == 0)
        return do_gpl, do_dr1

    def _sample_zc(self, n: int, device):
        """z and labels of ``n`` samples; in ``global_sample`` mode this
        rank's rows of a draw for the global batch."""
        world = self.mesh.world if self.cfg.rng_mode == "global_sample" else 1
        rows = slice(self.mesh.rank * n, (self.mesh.rank + 1) * n) if world > 1 else slice(None)
        z = torch.randn((n * world, self.cfg.z_dim), generator=self.generator,
                        device=device)[rows]
        c = None
        if self.cfg.c_dim > 0:
            high = self.label_bank.shape[0] if self.label_bank is not None else self.cfg.c_dim
            idx = torch.randint(0, high, (n * world,), generator=self.generator,
                                device=device)[rows]
            if self.label_bank is not None:
                c = self.label_bank[idx]
            else:
                c = torch.nn.functional.one_hot(idx, self.cfg.c_dim).float()
        return z, c

    def _apply(self, opt: torch.optim.Optimizer, params, grads) -> None:
        """Gradients averaged over ranks, then scrubbed and applied."""
        with span("opt"):
            _apply(opt, params, all_mean(self.mesh, grads))

    def __call__(self, state: TrainState, real_img, real_c=None) -> stats.Moments:
        return self.run(state, real_img, real_c, *self.phase_flags(state.step))

    def run(self, state: TrainState, real_img: torch.Tensor, real_c: Optional[torch.Tensor],
            do_gpl: bool, do_dr1: bool,
            draws: Optional[Dict[str, object]] = None) -> stats.Moments:
        """One batch with the given regularisation phases; ``real_img`` is
        this rank's share.  ``draws`` may hand in what the step would
        otherwise draw: ``z_gmain``, ``z_gpl``, ``z_dmain`` (and ``c_*``),
        each for this rank's share (split into the chunks in order), and
        ``pl_noise``: the NCHW standard normal of the path-length pass, or
        with ``micro_batches > 1`` a sequence of one per chunk."""
        cfg, loss, gen = self.cfg, self.loss, self.generator
        draws = draws or {}
        b = real_img.shape[0]
        M = cfg.micro_batches
        if b % M:
            raise ValueError(f"batch {b} is not divisible by micro_batches {M}")
        n = b // M
        dev = real_img.device
        if cfg.c_dim == 0:
            real_c = None
        cur_nimg = float(state.cur_nimg)
        g_params = _opt_params(state.opt_g)
        d_params = _opt_params(state.opt_d)

        def zc(phase):
            if f"z_{phase}" in draws:
                return draws[f"z_{phase}"], draws.get(f"c_{phase}")
            return self._sample_zc(b, dev)

        def chunk(x: Optional[torch.Tensor], j: int) -> Optional[torch.Tensor]:
            return None if x is None else x[j * n:(j + 1) * n]

        step = state.step
        with span("Gmain", step=step):
            z, c = zc("gmain")
            grads, moments = _accumulate(g_params, M, lambda j: loss.gmain(
                chunk(z, j), chunk(c, j), gen, state.ada_p, cur_nimg))
            self._apply(state.opt_g, g_params, grads)

        # G-reg (path length); pl_mean goes from chunk to chunk.
        if do_gpl:
            with span("Greg", step=step):
                z, c = zc("gpl")
                pl_noise = draws.get("pl_noise")
                gain = float(cfg.g_reg_interval)

                def gpl_chunk(j):
                    noise = pl_noise if M == 1 or pl_noise is None else pl_noise[j]
                    loss_pl, state.pl_mean, m = loss.gpl(
                        chunk(z, j), chunk(c, j), gen, state.pl_mean, noise,
                        batch_mean=lambda x: batch_mean(self.mesh, x))
                    return loss_pl * gain, m

                grads, m = _accumulate(g_params, M, gpl_chunk)
                self._apply(state.opt_g, g_params, grads)
                moments = stats.merge(moments, m)

        # D-main (updates w_avg and StyleGAN3's magnitude_ema from each
        # chunk's fake pass, in chunk order).
        with span("Dmain", step=step):
            z, c = zc("dmain")
            grads, m = _accumulate(d_params, M, lambda j: loss.dmain(
                chunk(z, j), chunk(c, j), chunk(real_img, j), chunk(real_c, j), gen,
                state.ada_p, cur_nimg))
            self._apply(state.opt_d, d_params, grads)
            moments = stats.merge(moments, m)
            if self.mesh.distributed:
                emas = [b for name, b in state.G.named_buffers()
                        if name.rsplit(".", 1)[-1] in EMA_BUFFERS]
                with torch.no_grad():
                    for b, mean in zip(emas, all_mean(self.mesh, emas)):
                        b.copy_(mean)

        # D-reg (R1).
        if do_dr1:
            with span("Dreg", step=step):
                gain = float(cfg.d_reg_interval)

                def dr1_chunk(j):
                    loss_r1, m = loss.dr1(chunk(real_img, j), chunk(real_c, j), gen,
                                          state.ada_p, cur_nimg)
                    return loss_r1 * gain, m

                grads, m = _accumulate(d_params, M, dr1_chunk)
                self._apply(state.opt_d, d_params, grads)
                moments = stats.merge(moments, m)

        with span("ema", step=step):
            update_ema(state.G_ema, state.G, cfg.batch_size, state.cur_nimg, cfg.ema_kimg,
                       cfg.ema_rampup)

        # ADA controller: sign feedback every ada_interval batches, from
        # the moments of the global batch.
        with span("ada", step=step):
            names = list(moments)
            moments = dict(zip(names, all_sum(self.mesh, [moments[k] for k in names])))
            if cfg.ada_target is not None:
                sr = moments["Loss/signs/real"]
                state.ada_signs = state.ada_signs + sr[:2]
                if (state.step + 1) % cfg.ada_interval == 0:
                    mean_sign = state.ada_signs[1] / state.ada_signs[0].clamp(min=1.0)
                    adjust = (torch.sign(mean_sign - cfg.ada_target)
                              * (cfg.batch_size * cfg.ada_interval) / (cfg.ada_kimg * 1000.0))
                    state.ada_p = (state.ada_p + adjust).clamp(min=0.0)
                    state.ada_signs = torch.zeros_like(state.ada_signs)
            moments = stats.report(moments, "Progress/augment", state.ada_p)

        state.step += 1
        state.cur_nimg += cfg.batch_size
        return moments
