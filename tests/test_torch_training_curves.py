"""The port's training dynamics against the JAX package's, over 1000 steps.

The statistical tier of ``tests/test_sg2_training_curves.py`` (its
``test_sg2_training_dynamics_statistical_with_ada``), with the JAX
package's ``TrainStepper`` in the place of the NVIDIA reference (the
augment pipe on ``impl="gather"`` and in float32; ROADMAP C1, C2).  Both
sides start from one initialisation, carried to the port by
``models.bridge``, and each draws from its own RNG: 1000 steps of the
production recipe (16², cbase 128, cmax 32, batch 8, minibatch-std group
2, the medical ADA pipe and controller with target 0.6, style mixing
0.9, random synthesis noise, lazy R1 and path length) on one fixed set
of smooth blobs.

The bands and floors are the JAX test's: over the second half of the run,
5 tail blocks a side, |Δmean| ≤ 3·SE(Δ) + floor, with floors of 0.06
(sign of D(real), the ADA signal), 0.25 (D's fake scores), 0.35 (the
log-medians of the R1 and path-length penalties) and 0.08 (ADA p).
About four minutes on four CPU threads (the JAX side compiles four step
variants; the port runs op by op).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.long  # over 250 s of the tier-1 run: started first

ZDIM = 16
LR = 0.0025
BETAS = (0.0, 0.99)
G_INT, D_INT = 4, 16
RES, CBASE, CMAX, BATCH, STEPS = 16, 128, 32, 8, 1000
ADA_TARGET, ADA_INTERVAL, ADA_KIMG = 0.6, 4, 2.0
K = 5  # tail blocks per side (approx independent at 100 steps)


def _blobs():
    """A tiny fixed "dataset" of smooth blobs, so D has real structure to
    separate (pure-noise reals make sign(D_real) a coin flip)."""
    rng = np.random.default_rng(11)
    xs, ys = np.meshgrid(np.arange(RES), np.arange(RES))
    data = np.stack([
        np.exp(-(((xs - a) ** 2 + (ys - b) ** 2) / (2.0 * s ** 2)))
        for a, b, s in rng.uniform(4, RES - 4, (64, 3)) * [1, 1, 0.25]
    ]).astype(np.float32)[..., None] * 2 - 1
    return data, rng


def _record(curves, moments, ada_p):
    m = {k: float(v[1] / v[0]) for k, v in moments.items()}
    curves["signs_real"].append(m["Loss/signs/real"])
    curves["scores_fake"].append(m["Loss/scores/fake"])
    if "Loss/r1_penalty" in m:
        curves["r1"].append(m["Loss/r1_penalty"])
    if "Loss/pl_penalty" in m:
        curves["pl"].append(m["Loss/pl_penalty"])
    curves["p"].append(float(ada_p))


def _blocks(xs):
    tail = np.asarray(xs, np.float64)[-(STEPS // 2):]
    return tail.reshape(K, -1).mean(axis=1)


def _band(ob, rb, floor):
    se = float(np.sqrt(ob.var(ddof=1) / K + rb.var(ddof=1) / K))
    return abs(float(ob.mean() - rb.mean())), 3 * se + floor


def test_port_training_dynamics_match_jax_statistically():
    from gantrack_tpu.models.stylegan2 import Discriminator, Generator
    from gantrack_tpu.parallel.mesh import create_mesh, shard_batch
    from gantrack_tpu.training import (
        StyleGAN2Loss, StyleGAN2LossConfig, TrainStepConfig, TrainStepper, create_train_state,
        lazy_reg_adam,
    )
    from gantrack_tpu.training.augment import AugmentPipe, medical_augment_config
    from gantrack_tpu_torch.models import bridge
    from gantrack_tpu_torch.models import stylegan2 as tsg2
    from gantrack_tpu_torch.training import augment as taug
    from gantrack_tpu_torch.training import loss as tloss
    from gantrack_tpu_torch.training import step as tstep
    from gantrack_tpu_torch.training.train_state import create_train_state as t_create_state

    torch.set_num_threads(4)
    g_kw = dict(z_dim=ZDIM, c_dim=0, w_dim=ZDIM, img_resolution=RES, img_channels=1,
                mapping_kwargs=dict(num_layers=2),
                synthesis_kwargs=dict(channel_base=CBASE, channel_max=CMAX, num_fp16_res=0))
    d_kw = dict(c_dim=0, img_resolution=RES, img_channels=1, channel_base=CBASE,
                channel_max=CMAX, num_fp16_res=0, epilogue_kwargs=dict(mbstd_group_size=2))
    loss_kw = dict(r1_gamma=1.0, style_mixing_prob=0.9, pl_weight=2.0, pl_batch_shrink=2,
                   noise_mode="random")
    step_kw = dict(batch_size=BATCH, z_dim=ZDIM, c_dim=0, g_reg_interval=G_INT,
                   d_reg_interval=D_INT, ada_target=ADA_TARGET, ada_interval=ADA_INTERVAL,
                   ada_kimg=ADA_KIMG)

    # The JAX side.
    g, d = Generator(**g_kw), Discriminator(**d_kw)
    opt_g = lazy_reg_adam(LR, betas=BETAS, reg_interval=G_INT)
    opt_d = lazy_reg_adam(LR, betas=BETAS, reg_interval=D_INT)
    state = create_train_state(g, d, jax.random.PRNGKey(0), opt_g, opt_d, z_dim=ZDIM, c_dim=0,
                               img_resolution=RES, img_channels=1)
    pipe = AugmentPipe(medical_augment_config(), RES, RES, 1, impl="gather",
                       compute_dtype=jnp.float32)
    loss = StyleGAN2Loss(g, d, StyleGAN2LossConfig(**loss_kw), augment_fn=pipe)
    mesh = create_mesh(1)
    stepper = TrainStepper(loss, opt_g, opt_d, TrainStepConfig(**step_kw), mesh)

    # The port, from the same weights.
    init = jax.device_get(state)
    consts = init.consts_g
    G, D = tsg2.Generator(**g_kw), tsg2.Discriminator(**d_kw)
    G.load_state_dict(bridge.generator_state_dict_from_jax(
        {"params": init.params_g, "emas": init.emas_g, **consts}))
    D.load_state_dict(bridge.discriminator_state_dict_from_jax({"params": init.params_d}))
    t_state = t_create_state(G, D, LR, LR, g_reg_interval=G_INT, d_reg_interval=D_INT)
    t_state.G_ema.load_state_dict(bridge.generator_state_dict_from_jax(
        {"params": init.params_g_ema, "emas": init.emas_g, **consts}))
    t_pipe = taug.AugmentPipe(taug.medical_augment_config(), RES, RES, 1,
                              compute_dtype=torch.float32)
    t_loss = tloss.StyleGAN2Loss(G, D, tloss.StyleGAN2LossConfig(**loss_kw), augment_fn=t_pipe)
    t_stepper = tstep.TrainStepper(t_loss, tstep.TrainStepConfig(**step_kw),
                                   torch.Generator().manual_seed(123))

    data, rng = _blobs()
    keys = ("signs_real", "scores_fake", "r1", "pl", "p")
    jax_curves, port_curves = {k: [] for k in keys}, {k: [] for k in keys}
    for _ in range(STEPS):
        batch = data[rng.integers(0, len(data), BATCH)]
        state, moments = stepper(state, shard_batch(mesh, jnp.asarray(batch)))
        _record(jax_curves, moments, state.ada_p)
        moments = t_stepper(t_state, torch.from_numpy(np.ascontiguousarray(
            batch.transpose(0, 3, 1, 2))))
        _record(port_curves, moments, t_state.ada_p)

    margins = {}
    for key, floor in (("signs_real", 0.06), ("scores_fake", 0.25), ("p", 0.08)):
        margins[key] = _band(_blocks(port_curves[key]), _blocks(jax_curves[key]), floor)
    # Penalty magnitudes: equivalence on log-medians (scale parity).
    for key in ("r1", "pl"):
        o = np.log(np.asarray(port_curves[key], np.float64)[-len(port_curves[key]) // 2:] + 1e-8)
        r = np.log(np.asarray(jax_curves[key], np.float64)[-len(jax_curves[key]) // 2:] + 1e-8)
        ob = o[: len(o) - len(o) % K].reshape(K, -1).mean(axis=1)
        rb = r[: len(r) - len(r) % K].reshape(K, -1).mean(axis=1)
        margins[key] = _band(ob, rb, 0.35)
    print("training curves, |delta| against band:",
          {k: (round(d, 4), round(b, 4)) for k, (d, b) in margins.items()})
    assert max(port_curves["p"]) > 0  # the controller ran on the port's side
    for key, (delta, band) in margins.items():
        assert delta <= band, (key, delta, band)
