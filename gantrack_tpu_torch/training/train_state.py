"""Training state: everything a step mutates, in one container.

Port of ``gantrack_tpu/training/train_state.py``.  The networks and
optimizers are updated in place; the step counters are host integers
(the phase schedule needs no device sync), G's running statistics
(``w_avg``; StyleGAN3's ``magnitude_ema``, the JAX state's ``emas_g``) are
buffers of G that the D-main fake pass updates and G_ema copies, so the
checkpoint's state dicts hold them, and the scalars that the step
computes (``pl_mean``, ADA ``p`` and its sign accumulator) are device
tensors.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Collection, Iterable, Optional

import torch
import torch.nn as nn


def lazy_reg_adam(params: Iterable[torch.nn.Parameter], lr: float, betas=(0.0, 0.99),
                  eps: float = 1e-8, reg_interval: Optional[int] = None) -> torch.optim.Adam:
    """Adam with lazy-regularisation scaling: ``mb_ratio = r / (r + 1)``,
    ``lr *= mb_ratio``, ``beta_i **= mb_ratio`` (same update as optax's
    ``adam``: eps outside the square root, bias-corrected moments)."""
    if reg_interval is not None:
        mb_ratio = reg_interval / (reg_interval + 1)
        lr = lr * mb_ratio
        betas = tuple(b ** mb_ratio for b in betas)
    return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps)


@dataclasses.dataclass
class TrainState:
    G: nn.Module
    D: nn.Module
    G_ema: nn.Module
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    pl_mean: torch.Tensor          # path-length EMA baseline (scalar)
    ada_p: torch.Tensor            # ADA augmentation probability (scalar)
    ada_signs: torch.Tensor        # [n, sum(sign(D(real)))] since the last ADA update
    step: int = 0                  # batches done
    cur_nimg: int = 0              # images seen


def create_train_state(G: nn.Module, D: nn.Module, glr: float, dlr: float,
                       g_reg_interval: Optional[int] = 4,
                       d_reg_interval: Optional[int] = 16,
                       d_trainable: Optional[Collection[str]] = None) -> TrainState:
    """Wrap networks (already on their device) with optimizers and a
    G_ema copy of G.  ``d_trainable`` names the D parameters its optimizer
    updates (freeze-D: ``models.stylegan2.discriminator_freeze_mask``);
    the others keep no Adam state and are never updated, but stay in
    autograd, so gradients still flow through them to D's input."""
    device = next(G.parameters()).device
    G_ema = copy.deepcopy(G).eval().requires_grad_(False)
    d_params = [p for name, p in D.named_parameters()
                if d_trainable is None or name in d_trainable]
    return TrainState(
        G=G, D=D, G_ema=G_ema,
        opt_g=lazy_reg_adam(G.parameters(), glr, reg_interval=g_reg_interval),
        opt_d=lazy_reg_adam(d_params, dlr, reg_interval=d_reg_interval),
        pl_mean=torch.zeros([], device=device),
        ada_p=torch.zeros([], device=device),
        ada_signs=torch.zeros([2], device=device),
    )
