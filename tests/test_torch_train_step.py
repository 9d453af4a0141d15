"""The port's training slice against the JAX package, at a tiny width.

* Each loss phase (G-main, G-reg, D-main, D-reg): loss and parameter
  gradients against ``jax.value_and_grad`` of the JAX phase.
* One whole step with both regularisers (two lazy-reg Adam updates of G,
  two of D, the G-EMA and one ADA update) against the JAX
  ``TrainStepper._device_step``.

Same weights (carried by ``models.bridge``), const noise, style mixing 0,
and the augment pipe fixed by ``debug_percentile`` on both sides.  What
JAX draws inside the step (the latents and the path-length noise) is
drawn here with JAX's own keys and handed to the port.  Tolerances: 1e-4
on losses and gradients (two nested differentiations through G or D and
the augment chain); 1e-5 on parameters after an Adam step, whose
updates are ±lr-sized.

The same whole step for StyleGAN3 (-t, and -r with its blur inside the
fade): G and G_ema state dicts (``magnitude_ema`` included) and D after
G-main, D-main and R1, to 1e-5 but for the rare sign flip of a noise-level
gradient in G's first Adam step (stated at the check).

Then four steps of the full port stepper (random noise, style mixing,
random augment draws) on the CPU must stay finite.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gantrack_tpu.models import stylegan2 as jsg2
from gantrack_tpu.parallel.mesh import create_mesh
from gantrack_tpu.training import augment as jaug
from gantrack_tpu.training import loss as jloss
from gantrack_tpu.training import step as jstep
from gantrack_tpu.training.train_state import create_train_state as j_create_state
from gantrack_tpu.training.train_state import lazy_reg_adam as j_adam
from gantrack_tpu_torch.models import bridge
from gantrack_tpu_torch.models import stylegan2 as tsg2
from gantrack_tpu_torch.training import augment as taug
from gantrack_tpu_torch.training import loss as tloss
from gantrack_tpu_torch.training import step as tstep
from gantrack_tpu_torch.training.train_state import create_train_state
from gantrack_tpu_torch.utils import profiling

torch.set_num_threads(1)

RES, ZDIM, BATCH = 16, 8, 4
PCT = 0.3
GLR = DLR = 0.002
TOL = dict(rtol=1e-4, atol=1e-4)
G_KW = dict(z_dim=ZDIM, c_dim=0, w_dim=ZDIM, img_resolution=RES, img_channels=1,
            mapping_kwargs=dict(num_layers=2),
            synthesis_kwargs=dict(channel_base=128, channel_max=32, num_fp16_res=0))
D_KW = dict(c_dim=0, img_resolution=RES, img_channels=1, channel_base=128, channel_max=32,
            num_fp16_res=0, epilogue_kwargs=dict(mbstd_group_size=2))
LOSS_KW = dict(r1_gamma=1.0, style_mixing_prob=0.0, pl_weight=2.0, noise_mode="const")
STEP_KW = dict(batch_size=BATCH, z_dim=ZDIM, ada_target=0.6, ada_interval=4)


def _perturb(tree, rng, scale=0.1):
    return jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(np.shape(a)).astype(np.float32),
        tree)


@functools.lru_cache(maxsize=None)
def _jax_setup():
    g, d = jsg2.Generator(**G_KW), jsg2.Discriminator(**D_KW)
    pipe = jaug.AugmentPipe(jaug.medical_augment_config(), RES, RES, 1, impl="gather",
                            compute_dtype=jnp.float32)
    loss = jloss.StyleGAN2Loss(g, d, jloss.StyleGAN2LossConfig(**LOSS_KW),
                               augment_fn=functools.partial(pipe, debug_percentile=PCT))
    opt_g = j_adam(GLR, reg_interval=4)
    opt_d = j_adam(DLR, reg_interval=16)
    state = jax.jit(lambda key: j_create_state(
        g, d, key, opt_g, opt_d, z_dim=ZDIM, c_dim=0, img_resolution=RES,
        img_channels=1))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params_g = _perturb(jax.device_get(state.params_g), rng)
    state = state.replace(
        params_g=params_g,
        params_g_ema=_perturb(params_g, rng, 0.01),
        params_d=_perturb(jax.device_get(state.params_d), rng),
        emas_g=_perturb(jax.device_get(state.emas_g), rng),
        step=jnp.asarray(3, jnp.int32),            # (step + 1) % ada_interval == 0
        cur_nimg=jnp.asarray(1000, jnp.int32),     # G-EMA beta strictly inside (0, 1)
        ada_p=jnp.asarray(0.2, jnp.float32),
        opt_g=opt_g.init(params_g),
    )
    stepper = jstep.TrainStepper(loss, opt_g, opt_d, jstep.TrainStepConfig(**STEP_KW),
                                 create_mesh(1))
    return loss, state, stepper


def _port_setup(jstate, conv_impl="library"):
    g, d, g_ema = (tsg2.Generator(**G_KW, conv_impl=conv_impl),
                   tsg2.Discriminator(**D_KW, conv_impl=conv_impl),
                   tsg2.Generator(**G_KW, conv_impl=conv_impl))
    consts = jax.device_get(jstate.consts_g)
    emas = jax.device_get(jstate.emas_g)
    g.load_state_dict(bridge.generator_state_dict_from_jax(
        {"params": jax.device_get(jstate.params_g), "emas": emas, **consts}))
    g_ema.load_state_dict(bridge.generator_state_dict_from_jax(
        {"params": jax.device_get(jstate.params_g_ema), "emas": emas, **consts}))
    d.load_state_dict(bridge.discriminator_state_dict_from_jax(
        {"params": jax.device_get(jstate.params_d)}))
    state = create_train_state(g, d, GLR, DLR)
    state.G_ema.load_state_dict(g_ema.state_dict())
    state.step = int(jstate.step)
    state.cur_nimg = int(jstate.cur_nimg)
    state.ada_p = torch.tensor(float(jstate.ada_p))
    pipe = taug.AugmentPipe(taug.medical_augment_config(), RES, RES, 1,
                            compute_dtype=torch.float32)
    loss = tloss.StyleGAN2Loss(state.G, state.D, tloss.StyleGAN2LossConfig(**LOSS_KW),
                               augment_fn=functools.partial(pipe, debug_percentile=PCT))
    return state, loss


def _nchw(x):
    return torch.tensor(np.transpose(np.asarray(x), (0, 3, 1, 2)))


def _reals(seed=5):
    return np.random.default_rng(seed).standard_normal((BATCH, RES, RES, 1)).astype(np.float32)


def _step_draws(jstate):
    """The latents and path-length noise ``_device_step`` draws."""
    rng_dev = jax.random.fold_in(jax.random.fold_in(jstate.rng, jstate.step), 0)
    k = jax.random.split(rng_dev, 8)
    z = {name: np.array(jax.random.normal(k[i], (BATCH, ZDIM), jnp.float32))
         for name, i in (("gmain", 0), ("gpl", 2), ("dmain", 4))}
    k_noise = jax.random.split(k[3], 3)[1]
    pl_noise = jax.random.normal(k_noise, (BATCH // 2, RES, RES, 1))
    return k, z, pl_noise


def _assert_grads(port_module, port_grads, jax_grads, kind):
    names = [n for n, _ in port_module.named_parameters()]
    if kind == "G":
        want = bridge.generator_state_dict_from_jax({"params": jax.device_get(jax_grads)})
    else:
        want = bridge.discriminator_state_dict_from_jax({"params": jax.device_get(jax_grads)})
    assert set(names) == set(want)
    for name, g in zip(names, port_grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("phase", ["gmain", "gpl", "dmain", "dr1"])
def test_phase_loss_and_grads_match_jax(phase):
    jl, jstate, _ = _jax_setup()
    state, tl = _port_setup(jstate)
    k, z, pl_noise = _step_draws(jstate)
    extras_g = {"emas": jstate.emas_g, **jstate.consts_g}
    vars_g = {"params": jstate.params_g, **extras_g}
    reals = _reals()
    gen = torch.Generator().manual_seed(0)
    ada_p, nimg = jstate.ada_p, jnp.float32(1000.0)
    if phase == "gmain":
        fn = lambda p: jl.gmain(p, extras_g, {"params": jstate.params_d}, jnp.asarray(z["gmain"]),
                                None, k[1], ada_p, nimg)
        (jl_val, _), jgrads = jax.jit(jax.value_and_grad(fn, has_aux=True))(jstate.params_g)
        t_val, _ = tl.gmain(torch.from_numpy(z["gmain"]), None, gen, state.ada_p, 1000.0)
    elif phase == "gpl":
        fn = lambda p: jl.gpl(p, extras_g, jnp.asarray(z["gpl"]), None, k[3], jstate.pl_mean)
        (jl_val, (j_pl, _)), jgrads = jax.jit(jax.value_and_grad(fn, has_aux=True))(
            jstate.params_g)
        t_val, t_pl, _ = tl.gpl(torch.from_numpy(z["gpl"]), None, gen, state.pl_mean,
                                _nchw(pl_noise))
        np.testing.assert_allclose(float(t_pl), float(j_pl), **TOL)
    elif phase == "dmain":
        fn = lambda p: jl.dmain(p, vars_g, jnp.asarray(z["dmain"]), None, jnp.asarray(reals),
                                jnp.zeros((BATCH, 0)), k[5], ada_p, nimg)
        (jl_val, (new_emas, _)), jgrads = jax.jit(jax.value_and_grad(fn, has_aux=True))(
            jstate.params_d)
        t_val, _ = tl.dmain(torch.from_numpy(z["dmain"]), None, _nchw(reals), None, gen,
                            state.ada_p, 1000.0)
        np.testing.assert_allclose(state.G.mapping.w_avg.numpy(),
                                   np.asarray(new_emas["mapping"]["w_avg"]), **TOL)
    else:
        fn = lambda p: jl.dr1(p, jnp.asarray(reals), jnp.zeros((BATCH, 0)), k[6], ada_p, nimg)
        (jl_val, _), jgrads = jax.jit(jax.value_and_grad(fn, has_aux=True))(jstate.params_d)
        t_val, _ = tl.dr1(_nchw(reals), None, gen, state.ada_p, 1000.0)
    module = state.G if phase.startswith("g") else state.D
    params = list(module.parameters())
    t_grads = torch.autograd.grad(t_val, params, allow_unused=True)
    t_grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, t_grads)]
    np.testing.assert_allclose(float(t_val.detach()), float(jl_val), **TOL)
    _assert_grads(module, t_grads, jgrads, "G" if phase.startswith("g") else "D")


@functools.lru_cache(maxsize=None)
def _jax_full_step():
    _, jstate, jstepper = _jax_setup()
    new_j, _ = jax.jit(functools.partial(jstepper._device_step, True, True))(
        jstate, jnp.asarray(_reals()), jnp.zeros((BATCH, 0), jnp.float32))
    return jax.device_get(new_j)


def _run_full_step(conv_impl="library"):
    """One +Greg+Dreg step of both sides from the same state and draws."""
    _, jstate, _ = _jax_setup()
    state, tl = _port_setup(jstate, conv_impl)
    _, z, pl_noise = _step_draws(jstate)
    reals = _reals()
    new_j = _jax_full_step()
    stepper = tstep.TrainStepper(tl, tstep.TrainStepConfig(**STEP_KW), torch.Generator())
    draws = {f"z_{k}": torch.from_numpy(v) for k, v in z.items()}
    draws["pl_noise"] = _nchw(pl_noise)
    moments = stepper.run(state, _nchw(reals), None, True, True, draws=draws)
    return state, new_j, moments


def _assert_step_matches_jax(state, new_j, moments):
    assert state.step == 4 and state.cur_nimg == 1000 + BATCH
    for module, params, emas in ((state.G, new_j.params_g, new_j.emas_g),
                                 (state.G_ema, new_j.params_g_ema, new_j.emas_g)):
        want = bridge.generator_state_dict_from_jax(
            {"params": params, "emas": emas, **new_j.consts_g})
        for name, value in module.state_dict().items():
            np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
    want_d = bridge.discriminator_state_dict_from_jax({"params": new_j.params_d})
    for name, value in state.D.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want_d[name].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(float(state.pl_mean), float(new_j.pl_mean), **TOL)
    np.testing.assert_allclose(float(state.ada_p), float(new_j.ada_p), **TOL)
    assert float(state.ada_p) != 0.2  # the controller moved p
    np.testing.assert_allclose(state.ada_signs.numpy(), np.asarray(new_j.ada_signs), **TOL)
    assert "Loss/pl_penalty" in moments and "Loss/r1_penalty" in moments


def test_full_step_matches_jax():
    """Adam updates of all four phases, the G-EMA, pl_mean and one ADA update."""
    _assert_step_matches_jax(*_run_full_step())


def test_full_step_on_the_kernel_route_matches_library_and_jax():
    """The same step with ``conv_impl="kernel"``: every dense 3×3 stride-1
    conv of G and D, and both differentiations of it, go through
    ``ops.conv3x3`` (its plain version here).  Parameters equal the library
    route's to 1e-5 (an Adam step is ±lr-sized; the convs' sums run in
    another order) and the JAX step's at the existing tolerance."""
    from gantrack_tpu_torch.ops import conv3x3 as c3

    lib_state, _, _ = _run_full_step("library")
    calls = []
    conv, wgrad = c3._conv, c3._wgrad
    try:
        c3._conv = lambda x, w: calls.append("conv") or conv(x, w)
        c3._wgrad = lambda x, g: calls.append("wgrad") or wgrad(x, g)
        with profiling.recording() as rec:
            state, new_j, moments = _run_full_step("kernel")
    finally:
        c3._conv, c3._wgrad = conv, wgrad
    # G 4^2..16^2 conv1 and D 16^2, 8^2 conv0 and the epilogue conv, in four
    # phases, differentiated once or twice.
    assert calls.count("conv") > 40 and calls.count("wgrad") > 10, (len(calls),)
    # Only the 3×3 layers take ``conv_impl``: the strided ones stay on the library.
    routed = rec.under("conv3x3.library_route")
    assert set(routed) == {"up=2, down=1", "up=1, down=2"}, routed
    _assert_step_matches_jax(state, new_j, moments)
    for name in ("G", "D", "G_ema"):
        lib, ker = getattr(lib_state, name).state_dict(), getattr(state, name).state_dict()
        for key, value in ker.items():
            np.testing.assert_allclose(value.numpy(), lib[key].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name}.{key}")


# ------------------------------------------------------------------ StyleGAN3
# One whole step of each StyleGAN3 config (G-main, D-main with the
# magnitude-EMA update, R1; no path length) against the JAX stepper.

SG3_RES = 32
SG3_D_KW = dict(D_KW, img_resolution=SG3_RES)


def _sg3_g_kw(cfg):
    mult = 2 if cfg == "stylegan3-r" else 1
    return dict(z_dim=ZDIM, c_dim=0, w_dim=ZDIM, img_resolution=SG3_RES, img_channels=1,
                channel_base=256 * mult, channel_max=16 * mult, num_fp16_res=0,
                conv_kernel=1 if mult == 2 else 3, use_radial_filters=(mult == 2),
                synthesis_kwargs=dict(num_layers=6, num_critical=2))


def _sg3_loss_kw(cfg):
    # -r: sigma = (1 - 1000 / 2000) * 1 = 0.5 at cur_nimg 1000, inside the fade:
    # 3 live taps of JAX's 7-tap worst-case filter.  (A wider blur of the
    # white-noise reals leaves D gradients at the level of rounding noise.)
    blur = dict(blur_init_sigma=1.0, blur_fade_kimg=2.0) if cfg == "stylegan3-r" else {}
    return dict(r1_gamma=1.0, style_mixing_prob=0.0, pl_weight=0.0, noise_mode="const", **blur)


@pytest.mark.parametrize("cfg", ["stylegan3-t", "stylegan3-r"])
def test_full_step_matches_jax_stylegan3(cfg):
    from gantrack_tpu.models import stylegan3 as jsg3
    from gantrack_tpu_torch.models import stylegan3 as tsg3

    g, d = jsg3.Generator(**_sg3_g_kw(cfg)), jsg2.Discriminator(**SG3_D_KW)
    jpipe = jaug.AugmentPipe(jaug.medical_augment_config(), SG3_RES, SG3_RES, 1, impl="gather",
                             compute_dtype=jnp.float32)
    jl = jloss.StyleGAN2Loss(g, d, jloss.StyleGAN2LossConfig(**_sg3_loss_kw(cfg)),
                             augment_fn=functools.partial(jpipe, debug_percentile=PCT))
    opt_g, opt_d = j_adam(GLR), j_adam(DLR, reg_interval=16)
    jstate = jax.jit(lambda key: j_create_state(
        g, d, key, opt_g, opt_d, z_dim=ZDIM, c_dim=0, img_resolution=SG3_RES,
        img_channels=1))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params_g = _perturb(jax.device_get(jstate.params_g), rng)
    jstate = jstate.replace(
        params_g=params_g, params_g_ema=_perturb(params_g, rng, 0.01),
        params_d=_perturb(jax.device_get(jstate.params_d), rng),
        emas_g=_perturb(jax.device_get(jstate.emas_g), rng),  # magnitude_ema stays > 0
        step=jnp.asarray(3, jnp.int32), cur_nimg=jnp.asarray(1000, jnp.int32),
        ada_p=jnp.asarray(0.2, jnp.float32), opt_g=opt_g.init(params_g))
    step_kw = dict(STEP_KW, g_reg_interval=None)
    jstepper = jstep.TrainStepper(jl, opt_g, opt_d, jstep.TrainStepConfig(**step_kw),
                                  create_mesh(1))

    def port_g(params):
        m = tsg3.Generator(**_sg3_g_kw(cfg))
        m.load_state_dict(bridge.sg3_generator_state_dict_from_jax(
            {"params": jax.device_get(params), "emas": jax.device_get(jstate.emas_g),
             **jax.device_get(jstate.consts_g)}))
        return m

    state = create_train_state(port_g(jstate.params_g), tsg2.Discriminator(**SG3_D_KW), GLR, DLR,
                               g_reg_interval=None)
    state.D.load_state_dict(bridge.discriminator_state_dict_from_jax(
        {"params": jax.device_get(jstate.params_d)}))
    state.G_ema.load_state_dict(port_g(jstate.params_g_ema).state_dict())
    state.step, state.cur_nimg, state.ada_p = 3, 1000, torch.tensor(0.2)
    tpipe = taug.AugmentPipe(taug.medical_augment_config(), SG3_RES, SG3_RES, 1,
                             compute_dtype=torch.float32)
    tl = tloss.StyleGAN2Loss(state.G, state.D, tloss.StyleGAN2LossConfig(**_sg3_loss_kw(cfg)),
                             augment_fn=functools.partial(tpipe, debug_percentile=PCT))
    assert (tl.blur_sigma(1000.0) == 0.5) == (cfg == "stylegan3-r")

    rng_dev = jax.random.fold_in(jax.random.fold_in(jstate.rng, jstate.step), 0)
    k = jax.random.split(rng_dev, 8)
    draws = {f"z_{name}": torch.from_numpy(np.array(
        jax.random.normal(k[i], (BATCH, ZDIM), jnp.float32))) for name, i in
        (("gmain", 0), ("dmain", 4))}
    reals = np.random.default_rng(5).standard_normal((BATCH, SG3_RES, SG3_RES, 1)).astype(
        np.float32)
    new_j, _ = jax.jit(functools.partial(jstepper._device_step, False, True))(
        jstate, jnp.asarray(reals), jnp.zeros((BATCH, 0), jnp.float32))
    stepper = tstep.TrainStepper(tl, tstep.TrainStepConfig(**step_kw), torch.Generator())
    assert stepper.phase_flags(0) == (False, True)  # no path-length phase at all
    emas_before = {n: float(getattr(state.G.synthesis, n).magnitude_ema)
                   for n in state.G.synthesis.layer_names}
    moments = stepper.run(state, _nchw(reals), None, False, True, draws=draws)

    new_j = jax.device_get(new_j)
    for module, params in ((state.G, new_j.params_g), (state.G_ema, new_j.params_g_ema)):
        want = bridge.sg3_generator_state_dict_from_jax(
            {"params": params, "emas": new_j.emas_g, **new_j.consts_g})
        sd = module.state_dict()
        assert set(sd) == set(want)
        for name, value in sd.items():
            got, ref = value.numpy(), want[name].numpy()
            # G takes one Adam step from a fresh optimizer: ±lr·g / (|g| + 1e-8),
            # in effect lr·sign(g).  Where a gradient is at the level of the
            # rounding noise between the two frameworks its sign is arbitrary,
            # so one element of a tensor, or up to 0.5 % of its elements, may
            # be off by one such flip (2·lr); every other element holds to 1e-5.
            off = ~np.isclose(got, ref, rtol=1e-5, atol=1e-5)
            assert off.sum() <= max(1, 0.005 * off.size), (name, int(off.sum()), off.size)
            assert np.abs(got - ref)[off].max(initial=0) <= 2.02 * GLR, name
    for name, old in emas_before.items():  # the D-main fake pass moved every layer's EMA
        assert float(getattr(state.G.synthesis, name).magnitude_ema) != old, name
    d_tol = 1e-5
    want_d = bridge.discriminator_state_dict_from_jax({"params": new_j.params_d})
    for name, value in state.D.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want_d[name].numpy(), rtol=d_tol, atol=d_tol,
                                   err_msg=name)
    np.testing.assert_allclose(float(state.ada_p), float(new_j.ada_p), **TOL)
    assert "Loss/r1_penalty" in moments and "Loss/pl_penalty" not in moments


def test_four_port_steps_stay_finite():
    torch.manual_seed(0)
    g, d = tsg2.Generator(**G_KW), tsg2.Discriminator(**D_KW)
    state = create_train_state(g, d, GLR, DLR)
    pipe = taug.AugmentPipe(taug.medical_augment_config(), RES, RES, 1)
    loss = tloss.StyleGAN2Loss(g, d, tloss.StyleGAN2LossConfig(r1_gamma=1.0), augment_fn=pipe)
    state.ada_p = torch.tensor(0.5)
    stepper = tstep.TrainStepper(loss, tstep.TrainStepConfig(**STEP_KW),
                                 torch.Generator().manual_seed(0))
    p0 = [p.detach().clone() for p in g.parameters()]
    reals = _nchw(_reals())
    seen = set()
    for _ in range(4):
        moments = stepper(state, reals)
        seen |= set(moments)
        for name, m in moments.items():
            assert torch.isfinite(m).all(), name
    assert {"Loss/pl_penalty", "Loss/r1_penalty", "Loss/G/loss", "Loss/D/loss"} <= seen
    assert state.step == 4
    assert any(not torch.equal(a, b) for a, b in zip(p0, g.parameters()))
    for p in list(g.parameters()) + list(d.parameters()) + list(state.G_ema.parameters()):
        assert torch.isfinite(p).all()
