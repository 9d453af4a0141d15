"""Gradient accumulation and freeze-D of the port's step against the JAX
package, at a tiny width.

* One ``micro_batches=2`` +Greg+Dreg step against the JAX stepper's
  ``micro_batches=2`` step, jitted as the JAX package runs it, from the
  same state (carried by ``models.bridge``) with JAX's per-chunk draws:
  the accumulated gradient of each of the four phases (G-main, G-pl,
  D-main, R1: the sum of the chunks' mean gradients, as the stepper's
  ``_accum`` hands it to the optimizer) at 1e-4, then every parameter,
  ``pl_mean``, the ADA state and the moments at 1e-5; ``Loss/G/loss``
  counts the whole batch.
* Summed, not averaged: with a minibatch-std group of 1 each sample's
  loss is its own, so the ``M=2`` G-main, D-main and R1 gradients are
  twice the ``M=1`` ones.
* Freeze-D: the trainable names equal JAX's ``discriminator_freeze_mask``,
  frozen parameters stay bit-equal (no Adam state is kept for them), and
  G and the trainable D parameters match the JAX step with an
  ``optax.masked`` optimizer at 1e-5.  (``optax.masked`` passes the
  frozen leaves' raw gradients through as their update, so JAX's frozen
  parameters move; the port follows the reference's frozen layers,
  which do not.  ROADMAP Queue C records the JAX fault.)
* The CLI's ``--batch-gpu`` and ``--freezed`` reach the step.

Same set-up as ``test_torch_train_step.py``: const noise, style mixing 0,
the augment pipe fixed by ``debug_percentile``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from gantrack_tpu.models import stylegan2 as jsg2
from gantrack_tpu.parallel.mesh import create_mesh
from gantrack_tpu.training import augment as jaug
from gantrack_tpu.training import loss as jloss
from gantrack_tpu.training import step as jstep
from gantrack_tpu.training.train_state import create_train_state as j_create_state
from gantrack_tpu.training.train_state import lazy_reg_adam as j_adam
from gantrack_tpu_torch.models import bridge
from gantrack_tpu_torch.models import stylegan2 as tsg2
from gantrack_tpu_torch.tools import train as cli
from gantrack_tpu_torch.training import augment as taug
from gantrack_tpu_torch.training import loss as tloss
from gantrack_tpu_torch.training import step as tstep
from gantrack_tpu_torch.training.train_state import create_train_state

torch.set_num_threads(1)

RES, ZDIM, BATCH, M = 16, 8, 4, 2
PCT = 0.3
GLR = DLR = 0.002
FREEZE = 5  # b16 fromrgb, conv0, conv1, skip and b8 conv0
TOL = dict(rtol=1e-4, atol=1e-4)
P_TOL = dict(rtol=1e-5, atol=1e-5)
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


def _jax_mask(params_d):
    return jsg2.discriminator_freeze_mask(params_d, FREEZE, [16, 8], architecture="resnet")


@functools.lru_cache(maxsize=None)
def _jax_setup(micro_batches, freeze):
    g, d = jsg2.Generator(**G_KW), jsg2.Discriminator(**D_KW)
    pipe = jaug.AugmentPipe(jaug.medical_augment_config(), RES, RES, 1, impl="gather",
                            compute_dtype=jnp.float32)
    loss = jloss.StyleGAN2Loss(g, d, jloss.StyleGAN2LossConfig(**LOSS_KW),
                               augment_fn=functools.partial(pipe, debug_percentile=PCT))
    opt_g = j_adam(GLR, reg_interval=4)
    opt_d = j_adam(DLR, reg_interval=16)
    if freeze:
        opt_d = optax.masked(opt_d, _jax_mask)
    state = jax.jit(lambda key: j_create_state(
        g, d, key, opt_g, opt_d, z_dim=ZDIM, c_dim=0, img_resolution=RES,
        img_channels=1))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params_g = _perturb(jax.device_get(state.params_g), rng)
    params_d = _perturb(jax.device_get(state.params_d), rng)
    state = state.replace(
        params_g=params_g,
        params_g_ema=_perturb(params_g, rng, 0.01),
        params_d=params_d,
        emas_g=_perturb(jax.device_get(state.emas_g), rng),
        step=jnp.asarray(3, jnp.int32),
        cur_nimg=jnp.asarray(1000, jnp.int32),
        ada_p=jnp.asarray(0.2, jnp.float32),
        opt_g=opt_g.init(params_g),
        opt_d=opt_d.init(params_d),
    )
    stepper = jstep.TrainStepper(
        loss, opt_g, opt_d, jstep.TrainStepConfig(**STEP_KW, micro_batches=micro_batches),
        create_mesh(1))
    return loss, state, stepper


def _reals():
    return np.random.default_rng(5).standard_normal((BATCH, RES, RES, 1)).astype(np.float32)


def _nchw(x):
    return torch.tensor(np.transpose(np.asarray(x), (0, 3, 1, 2)))


def _draws(jstate, micro_batches):
    """What the JAX ``_device_step`` draws: the phases' latents for the
    whole batch, and one path-length noise a chunk from the chunk's key."""
    rng_dev = jax.random.fold_in(jax.random.fold_in(jstate.rng, jstate.step), 0)
    k = jax.random.split(rng_dev, 8)
    draws = {f"z_{name}": torch.from_numpy(np.array(jax.random.normal(
        k[i], (BATCH, ZDIM), jnp.float32))) for name, i in (("gmain", 0), ("gpl", 2), ("dmain", 4))}
    n = BATCH // micro_batches // 2
    keys = jax.random.split(k[3], micro_batches) if micro_batches > 1 else k[3:4]
    noise = [_nchw(jax.random.normal(jax.random.split(key, 3)[1], (n, RES, RES, 1)))
             for key in keys]
    draws["pl_noise"] = noise if micro_batches > 1 else noise[0]
    return k, draws


def _port_state(jstate, d_trainable=None):
    consts, emas = jax.device_get(jstate.consts_g), jax.device_get(jstate.emas_g)
    g, d, g_ema = tsg2.Generator(**G_KW), tsg2.Discriminator(**D_KW), tsg2.Generator(**G_KW)
    g.load_state_dict(bridge.generator_state_dict_from_jax(
        {"params": jax.device_get(jstate.params_g), "emas": emas, **consts}))
    g_ema.load_state_dict(bridge.generator_state_dict_from_jax(
        {"params": jax.device_get(jstate.params_g_ema), "emas": emas, **consts}))
    d.load_state_dict(bridge.discriminator_state_dict_from_jax(
        {"params": jax.device_get(jstate.params_d)}))
    state = create_train_state(g, d, GLR, DLR, d_trainable=d_trainable)
    state.G_ema.load_state_dict(g_ema.state_dict())
    state.step, state.cur_nimg = int(jstate.step), int(jstate.cur_nimg)
    state.ada_p = torch.tensor(float(jstate.ada_p))
    pipe = taug.AugmentPipe(taug.medical_augment_config(), RES, RES, 1,
                            compute_dtype=torch.float32)
    loss = tloss.StyleGAN2Loss(state.G, state.D, tloss.StyleGAN2LossConfig(**LOSS_KW),
                               augment_fn=functools.partial(pipe, debug_percentile=PCT))
    return state, loss


def _assert_state(state, new_j, d_names=None):
    for module, params in ((state.G, new_j.params_g), (state.G_ema, new_j.params_g_ema)):
        want = bridge.generator_state_dict_from_jax(
            {"params": params, "emas": new_j.emas_g, **new_j.consts_g})
        for name, value in module.state_dict().items():
            np.testing.assert_allclose(value.numpy(), want[name].numpy(), err_msg=name, **P_TOL)
    want_d = bridge.discriminator_state_dict_from_jax({"params": new_j.params_d})
    for name, value in state.D.state_dict().items():
        if d_names is None or name in d_names:
            np.testing.assert_allclose(value.numpy(), want_d[name].numpy(), err_msg=name,
                                       **P_TOL)
    np.testing.assert_allclose(float(state.ada_p), float(new_j.ada_p), **P_TOL)
    np.testing.assert_allclose(state.ada_signs.numpy(), np.asarray(new_j.ada_signs), **P_TOL)


def _record_grads(monkeypatch):
    """Each phase's summed gradients as ``_apply`` receives them."""
    seen = []
    apply = tstep._apply

    def recording(opt, params, grads):
        seen.append([g.detach().clone() for g in grads])
        return apply(opt, params, grads)

    monkeypatch.setattr(tstep, "_apply", recording)
    return seen


def _recording(opt, seen):
    """``opt`` that also keeps the gradients each update is handed."""
    def update(grads, opt_state, params=None):
        seen.append(grads)
        return opt.update(grads, opt_state, params)

    return optax.GradientTransformation(opt.init, update)


@functools.lru_cache(maxsize=None)
def _jax_step(micro_batches, freeze, do_gpl, do_dr1):
    """The JAX stepper's jitted step, with the gradients each phase hands
    its optimizer (after ``_accum`` and the scrub), in phase order."""
    jl, jstate, jst = _jax_setup(micro_batches, freeze)
    seen = []
    stepper = jstep.TrainStepper(jl, _recording(jst.opt_g, seen), _recording(jst.opt_d, seen),
                                 jst.cfg, create_mesh(1))

    def step(state, reals, c):
        seen.clear()
        new, moments = stepper._device_step(do_gpl, do_dr1, state, reals, c)
        return new, moments, list(seen)

    new_j, moments, grads = jax.jit(step)(
        jstate, jnp.asarray(_reals()), jnp.zeros((BATCH, 0), jnp.float32))
    return jax.device_get(new_j), jax.device_get(moments), jax.device_get(grads)


def test_accumulated_step_matches_jax(monkeypatch):
    _, jstate, _ = _jax_setup(M, False)
    state, tl = _port_state(jstate)
    _, draws = _draws(jstate, M)
    seen = _record_grads(monkeypatch)
    stepper = tstep.TrainStepper(tl, tstep.TrainStepConfig(**STEP_KW, micro_batches=M),
                                 torch.Generator())
    moments = stepper.run(state, _nchw(_reals()), None, True, True, draws=draws)
    assert len(seen) == 4  # one optimizer step a phase, whatever M

    # Each phase's accumulated gradient: the sum of the chunks' mean
    # gradients, as the JAX stepper's _accum hands it to the optimizer.
    new_j, j_moments, j_grads = _jax_step(M, False, True, True)
    assert len(j_grads) == 4
    for module, to_port, ours, theirs in (
            (state.G, bridge.generator_state_dict_from_jax, seen[0], j_grads[0]),
            (state.G, bridge.generator_state_dict_from_jax, seen[1], j_grads[1]),
            (state.D, bridge.discriminator_state_dict_from_jax, seen[2], j_grads[2]),
            (state.D, bridge.discriminator_state_dict_from_jax, seen[3], j_grads[3])):
        want = to_port({"params": theirs})
        names = [name for name, _ in module.named_parameters()]
        assert set(names) == set(want)
        for name, g in zip(names, ours):
            np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **TOL)

    assert state.step == 4 and state.cur_nimg == 1000 + BATCH
    _assert_state(state, new_j)
    np.testing.assert_allclose(float(state.pl_mean), float(new_j.pl_mean), **P_TOL)
    assert set(moments) == set(j_moments)
    for name, m in moments.items():
        np.testing.assert_allclose(m.numpy(), np.asarray(j_moments[name]), err_msg=name,
                                   **P_TOL)
    assert float(moments["Loss/G/loss"][0]) == BATCH
    assert float(moments["Loss/pl_penalty"][0]) == BATCH // 2  # B/(2M) a chunk


@pytest.mark.parametrize("group", [1, 2])
def test_chunk_gradients_are_summed_not_averaged(group, monkeypatch):
    """Group 1: every sample's loss is its own, so two chunks' mean
    gradients sum to twice the whole batch's mean gradient, in G-main,
    D-main and R1 alike.  Group 2: the chunks' minibatch-std statistics
    differ from the whole batch's, so the relation does not hold (the
    chunking is real)."""
    d_kw = dict(D_KW, epilogue_kwargs=dict(mbstd_group_size=group))
    torch.manual_seed(0)
    g0, d0 = tsg2.Generator(**G_KW), tsg2.Discriminator(**d_kw)
    z = torch.randn((BATCH, ZDIM), generator=torch.Generator().manual_seed(1))
    reals = _nchw(_reals())
    grads = {}
    for micro in (1, 2):
        g, d = tsg2.Generator(**G_KW), tsg2.Discriminator(**d_kw)
        g.load_state_dict(g0.state_dict())
        d.load_state_dict(d0.state_dict())
        # Learning rates 0: every phase of both runs sees the same
        # parameters, so only the chunking differs.
        state = create_train_state(g, d, 0.0, 0.0)
        loss = tloss.StyleGAN2Loss(g, d, tloss.StyleGAN2LossConfig(**LOSS_KW))
        stepper = tstep.TrainStepper(loss, tstep.TrainStepConfig(**STEP_KW, micro_batches=micro),
                                     torch.Generator())
        seen = _record_grads(monkeypatch)
        stepper.run(state, reals, None, False, True, draws={"z_gmain": z, "z_dmain": z})
        assert len(seen) == 3  # G-main, D-main, R1
        grads[micro] = seen
    for phase in range(3):
        close = [torch.allclose(a * 2, b, rtol=1e-5, atol=1e-7)
                 for a, b in zip(grads[1][phase], grads[2][phase])]
        assert all(close) if group == 1 else not all(close), phase


def test_freeze_d_matches_jax_mask_and_masked_step():
    _, jstate, _ = _jax_setup(1, True)
    mask = _jax_mask(jax.device_get(jstate.params_d))
    as_float = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32), mask,
                            jax.device_get(jstate.params_d))
    jax_trainable = {name for name, v in bridge.discriminator_state_dict_from_jax(
        {"params": as_float}).items() if bool((v == 1).all())}
    d = tsg2.Discriminator(**D_KW)
    trainable = tsg2.discriminator_freeze_mask(d, FREEZE)
    assert trainable == jax_trainable
    frozen = {n for n, _ in d.named_parameters()} - trainable
    assert {n.rsplit(".", 1)[0] for n in frozen} == {
        "b16.fromrgb", "b16.conv0", "b16.conv1", "b16.skip", "b8.conv0"}

    # The plain step against JAX: G-main differentiates through D's frozen
    # layers and D-main updates only the trainable ones.  (After D-main the
    # JAX state's frozen layers have moved, so its later phases differ.)
    state, tl = _port_state(jstate, d_trainable=trainable)
    _, draws = _draws(jstate, 1)
    stepper = tstep.TrainStepper(tl, tstep.TrainStepConfig(**STEP_KW), torch.Generator())
    stepper.run(state, _nchw(_reals()), None, False, False, draws=draws)
    new_j, _, _ = _jax_step(1, True, False, False)
    _assert_state(state, new_j, d_names=trainable)

    # With R1, which differentiates through the frozen layers to D's input.
    state, tl = _port_state(jstate, d_trainable=trainable)
    before = {n: p.detach().clone() for n, p in state.D.named_parameters()}
    stepper = tstep.TrainStepper(tl, tstep.TrainStepConfig(**STEP_KW), torch.Generator())
    moments = stepper.run(state, _nchw(_reals()), None, False, True, draws=draws)
    assert float(moments["Loss/r1_penalty"][1]) > 0
    for name, p in state.D.named_parameters():
        if name in frozen:
            assert torch.equal(p, before[name]), name
            assert p not in state.opt_d.state  # no Adam state
        else:
            assert not torch.equal(p, before[name]), name


def test_cli_batch_gpu_and_freezed_reach_the_step(tmp_path):
    args = [f"--outdir={tmp_path}", "--data=unused", "--cfg=stylegan2", "--batch=8",
            "--gamma=1", "--mbstd-group=2", "--device=cpu"]
    opts = cli.build_parser().parse_args([*args, "--batch-gpu=4", "--freezed=3"])
    cli.check_slice(opts)
    assert cli.micro_batches(opts) == 2
    c = cli.resolve_config(opts)
    assert c["batch_gpu"] == 4 and c["freezed"] == 3
    for bad, match in (("--batch-gpu=3", "must divide"), ("--batch-gpu=16", "must divide"),
                       ("--mbstd-group=3", "not divisible")):
        with pytest.raises(SystemExit, match=match):
            cli.check_slice(cli.build_parser().parse_args([*args, bad]))
    # A chunk smaller than the group: JAX takes min(group, chunk) and runs.
    cli.check_slice(cli.build_parser().parse_args([*args, "--batch-gpu=1", "--mbstd-group=4"]))
