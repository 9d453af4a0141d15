"""Data parallelism of the port on the CPU: gloo ranks on localhost.

Each multi-rank case spawns its ranks with ``torch.multiprocessing``
(one thread each) and fails, rather than hanging the suite, if they do
not finish within ``SPAWN_TIMEOUT`` seconds.  At a tiny width (16²,
cbase 128, cmax 32):

* ``rng_mode="global_sample"``: one rank and two ranks of the same
  global batch of 8 give the same update in all four phase variants, in
  float64 (G, D, G_ema and its EMA buffers, ``pl_mean``, ADA ``p`` and
  signs; moments too), to ``PIN_F64`` absolute.  The step machinery
  (stepper, loss, Adam, the collectives) runs on small float64 stand-ins
  for G and D, as the JAX package's ``tiny`` f64 pin does: the port's
  StyleGAN2 layers compute in float32.  The JAX package pins its
  1-device against 4-device step at 4.7e-14 in float64; the port's pin
  is set at 1e-13: float64 rounding between one mean of 8 and the mean
  of two means of 4, carried through one Adam step (whose update divides
  by the gradient's own magnitude), stays near 1e-16 per element, and a
  collective that is missing or sums without dividing moves elements by
  ~lr = 2.5e-3.  The real StyleGAN2 G and D take the same check in
  float32 at the JAX package's float32 band (5e-3 relative, 2e-5
  absolute; ``tests/test_train_step.py``).  Each phase's gradient, as
  its optimizer takes it, is compared too (Adam's first step is the
  gradient's sign, so the parameters do not see its scale): to
  ``PIN_F64`` in float64, and to 1e-5 relative norm error in float32
  (float32 reassociation of 8 samples against 2 × 4: 3.3e-7 seen).
  Each comparison prints its largest differences (``-s``).
* Two ranks in ``rng_mode="device"`` with the draws injected against the
  JAX single-device step on the same global batch and draws, at
  ``tests/test_torch_train_step.py``'s tolerance (1e-5 on parameters
  after the Adam step, 1e-4 on ``pl_mean``, ``p`` and the signs); the
  two ranks' states bit-equal.
* ``micro_batches=2`` on two ranks (the stand-ins, float64): every
  phase variant runs, stays finite, the ranks hold the same bits and the
  moments count the global batch; without the path-length phase (whose
  ``pl_mean`` goes from chunk to chunk) the update equals one rank's at
  ``micro_batches=2`` to ``PIN_F64`` (style mixing off: its cutoff is
  drawn once a chunk).
* The metrics' feature passes over two ranks equal one rank's (the
  dataset pass and the generator pass, an odd batch that pads).
* ``--devices=2 --device=cpu`` through the CLI: only rank 0 writes
  ``stats.jsonl`` and the checkpoint; ``--resume`` of that run on two
  ranks (read on rank 0, broadcast) goes on from its step.
"""

import functools
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gantrack_tpu_torch.parallel import mesh as pm

pytestmark = pytest.mark.long  # over 250 s of the tier-1 run: started first

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 240
RES, ZDIM, BATCH = 16, 8, 8
PIN_F64 = 1e-13
LR = 0.0025
G_KW = dict(z_dim=ZDIM, c_dim=0, w_dim=ZDIM, img_resolution=RES, img_channels=1,
            mapping_kwargs=dict(num_layers=2),
            synthesis_kwargs=dict(channel_base=128, channel_max=32, num_fp16_res=0))
# Minibatch-std groups are a rank's own samples (the reference's groups
# never cross GPUs either), so a split-invariant D has the feature off.
D_KW = dict(c_dim=0, img_resolution=RES, img_channels=1, channel_base=128, channel_max=32,
            num_fp16_res=0, epilogue_kwargs=dict(mbstd_group_size=2, mbstd_num_channels=0))
VARIANTS = [(False, False), (True, False), (False, True), (True, True)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank, world, port, out_dir, fn, args):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    pm.initialize_distributed("cpu")
    try:
        result = fn(pm.create_mesh(world, "cpu"), *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world, out_dir, *args):
    """``fn(mesh, *args)`` on ``world`` gloo ranks; their results in rank order."""
    ctx = mp.start_processes(_rank_entry, args=(world, _free_port(), str(out_dir), fn, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish within {SPAWN_TIMEOUT} s")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(world)]


# ------------------------------------------------------------------ the step

def _reals(dtype=torch.float64):
    x = np.random.default_rng(5).standard_normal((BATCH, 1, RES, RES))
    return torch.from_numpy(x).to(dtype)


def _state_of(state, moments):
    out = {f"G.{k}": v.clone() for k, v in state.G.state_dict().items()}
    out.update({f"D.{k}": v.clone() for k, v in state.D.state_dict().items()})
    out.update({f"G_ema.{k}": v.clone() for k, v in state.G_ema.state_dict().items()})
    out.update(pl_mean=state.pl_mean.clone(), ada_p=state.ada_p.clone(),
               ada_signs=state.ada_signs.clone())
    out.update({f"moments.{k}": v.clone() for k, v in moments.items()})
    return out


class _Mapping(torch.nn.Module):
    num_ws = 3

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(ZDIM, ZDIM)
        self.register_buffer("w_avg", torch.zeros(ZDIM))

    def forward(self, z, c, update_emas=False):
        w = torch.nn.functional.leaky_relu(self.fc(z), 0.2)
        if update_emas:
            with torch.no_grad():
                self.w_avg.copy_(w.mean(dim=0).lerp(self.w_avg, 0.995))
        return w[:, None].repeat(1, self.num_ws, 1)


class _Synthesis(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(ZDIM * _Mapping.num_ws, RES * RES)

    def forward(self, ws, noise_mode="const", generator=None, update_emas=False):
        return torch.tanh(self.fc(ws.flatten(1))).reshape(-1, 1, RES, RES)


class _StandInG(torch.nn.Module):
    """What the loss and the step read of a generator, small and in the
    default dtype."""

    def __init__(self):
        super().__init__()
        self.mapping, self.synthesis = _Mapping(), _Synthesis()


class _StandInD(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(1, 4, 3, padding=1)
        self.fc = torch.nn.Linear(4 * RES * RES, 1)

    def forward(self, img, c):
        return self.fc(torch.nn.functional.leaky_relu(self.conv(img), 0.2).flatten(1))


def _step(mesh, flags, micro_batches, models="stand-in", style_mixing=0.9):
    """One step of the given phase variant, ``global_sample``, on this
    rank's share of the global batch: float64 stand-ins, the float32
    StyleGAN2 networks (``models="stylegan2"``) or the StyleGAN2 networks
    in float64 under ``precision.pinned_float64`` (``"stylegan2-f64"``)."""
    if models == "stylegan2-f64":
        from gantrack_tpu_torch.precision import pinned_float64

        with pinned_float64():
            return _step(mesh, flags, micro_batches, "stylegan2-in-f64", style_mixing)
    from gantrack_tpu_torch.models import stylegan2 as tsg2
    from gantrack_tpu_torch.training import step
    from gantrack_tpu_torch.training.loss import StyleGAN2Loss, StyleGAN2LossConfig
    from gantrack_tpu_torch.training.step import TrainStepConfig, TrainStepper
    from gantrack_tpu_torch.training.train_state import create_train_state

    default = torch.get_default_dtype()
    dtype = torch.float64 if models in ("stand-in", "stylegan2-in-f64") else torch.float32
    torch.set_default_dtype(dtype)
    try:
        torch.manual_seed(0)
        if models == "stand-in":
            G, D = _StandInG(), _StandInD()
        else:
            G, D = tsg2.Generator(**G_KW), tsg2.Discriminator(**D_KW)
        state = create_train_state(G, D, LR, LR)
        state.step, state.cur_nimg = 3, 1000  # an ADA update; G-EMA beta inside (0, 1)
        state.ada_p = torch.tensor(0.2)
        loss = StyleGAN2Loss(G, D, StyleGAN2LossConfig(
            r1_gamma=1.0, pl_weight=2.0, pl_batch_shrink=1, noise_mode="const",
            style_mixing_prob=style_mixing))
        cfg = TrainStepConfig(batch_size=BATCH, z_dim=ZDIM, ada_target=0.6,
                              rng_mode="global_sample", micro_batches=micro_batches)
        stepper = TrainStepper(loss, cfg, torch.Generator().manual_seed(1), mesh=mesh)
        grads = []
        apply = step._apply
        step._apply = lambda opt, p, g: grads.append(torch.cat([x.flatten() for x in g])) or \
            apply(opt, p, g)
        try:
            moments = stepper.run(state, pm.shard_batch(mesh, _reals(dtype)), None, *flags)
        finally:
            step._apply = apply
        out = _state_of(state, moments)
        # Each phase's gradient as its optimizer takes it (averaged over the
        # ranks): Adam's first step is the sign of the gradient, so the
        # parameters alone would not see its scale.
        out.update({f"grads.{i}": g for i, g in enumerate(grads)})
        return out
    finally:
        torch.set_default_dtype(default)


def _assert_same(a, b, atol, rtol=0.0, skip=(), grad_rel=None):
    """Every entry to ``atol`` (and ``rtol``); the float32 moments to 1e-6
    of their size; with ``grad_rel``, each phase's gradient to that
    relative norm error instead.  Prints the largest differences."""
    assert set(a) == set(b)
    state = [k for k in a if not k.startswith(("moments.", "grads.")) and not k.endswith(skip)]
    print("largest difference of the state:",
          max(float((a[k].double() - b[k].double()).abs().max()) for k in state),
          "; of a phase's gradient, relative norm:",
          max(float((a[k] - b[k]).norm() / a[k].norm()) for k in a if k.startswith("grads.")))
    for name in a:
        if any(name.endswith(s) for s in skip):
            continue
        if name.startswith("grads.") and grad_rel is not None:
            err = float((a[name] - b[name]).norm() / a[name].norm())
            assert err <= grad_rel, (name, err)
            continue
        if name.startswith("moments."):
            tol = dict(rtol=0, atol=1e-6 * max(float(a[name].abs().max()), 1.0))
        else:
            tol = dict(rtol=rtol, atol=atol)
        np.testing.assert_allclose(a[name].double().numpy(), b[name].double().numpy(),
                                   err_msg=name, **tol)


def _assert_ranks_equal(results):
    for r in results[1:]:
        assert set(r) == set(results[0])
        for name, v in r.items():
            assert torch.equal(v, results[0][name]), name


@pytest.mark.parametrize("flags", VARIANTS, ids=["plain", "Greg", "Dreg", "Greg+Dreg"])
def test_global_sample_one_rank_equals_two(flags, tmp_path):
    one = _step(pm.Mesh(), flags, 1)
    two = run_ranks(_step, 2, tmp_path, flags, 1)
    _assert_ranks_equal(two)
    _assert_same(one, two[0], PIN_F64)
    assert float(one["ada_p"]) != 0.2  # the controller moved p
    assert float(one["moments.Loss/G/loss"][0]) == BATCH  # the moments count the global batch
    assert ("moments.Loss/pl_penalty" in one) == flags[0]
    assert ("moments.Loss/r1_penalty" in one) == flags[1]


@pytest.mark.parametrize("flags", [(False, False), (True, True)], ids=["plain", "Greg+Dreg"])
def test_global_sample_one_rank_equals_two_stylegan2(flags, tmp_path):
    one = _step(pm.Mesh(), flags, 1, "stylegan2")
    two = run_ranks(_step, 2, tmp_path, flags, 1, "stylegan2")
    _assert_ranks_equal(two)
    _assert_same(one, two[0], atol=2e-5, rtol=5e-3, grad_rel=1e-5)


@pytest.mark.parametrize("flags", VARIANTS, ids=["plain", "Greg", "Dreg", "Greg+Dreg"])
def test_micro_batches_on_two_ranks(flags, tmp_path):
    two = run_ranks(_step, 2, tmp_path, flags, 2, "stand-in", 0.0)
    _assert_ranks_equal(two)
    for name, v in two[0].items():
        assert torch.isfinite(v).all(), name
    assert float(two[0]["moments.Loss/D/loss"][0]) == BATCH
    if not flags[0]:
        # A chunk holds other samples on one rank than on two, so what goes
        # from chunk to chunk differs: w_avg (it lerps toward each chunk's
        # mean in turn, left out here) and the style-mixing cutoff (one a
        # chunk; mixing is off here).
        one = _step(pm.Mesh(), flags, 2, "stand-in", 0.0)
        _assert_same(one, two[0], PIN_F64, skip=("w_avg",))


# ------------------------------------------------------- against the JAX step

def _port_device_step(mesh, sds, scalars, draws, reals):
    """Two ranks in ``rng_mode="device"`` from the JAX state, with the JAX
    draws for the rank's share."""
    import functools as ft

    from gantrack_tpu_torch.models import stylegan2 as tsg2
    from gantrack_tpu_torch.training import augment as taug
    from gantrack_tpu_torch.training.loss import StyleGAN2Loss, StyleGAN2LossConfig
    from gantrack_tpu_torch.training.step import TrainStepConfig, TrainStepper
    from gantrack_tpu_torch.training.train_state import create_train_state

    G, D = tsg2.Generator(**G_KW), tsg2.Discriminator(**D_KW)
    G.load_state_dict(sds["G"])
    D.load_state_dict(sds["D"])
    state = create_train_state(G, D, LR, LR)
    state.G_ema.load_state_dict(sds["G_ema"])
    state.step, state.cur_nimg = scalars["step"], scalars["cur_nimg"]
    state.ada_p = torch.tensor(scalars["ada_p"])
    pipe = taug.AugmentPipe(taug.medical_augment_config(), RES, RES, 1,
                            compute_dtype=torch.float32)
    loss = StyleGAN2Loss(G, D, StyleGAN2LossConfig(**_JAX_LOSS_KW),
                         augment_fn=ft.partial(pipe, debug_percentile=0.3))
    stepper = TrainStepper(loss, TrainStepConfig(batch_size=BATCH, z_dim=ZDIM, ada_target=0.6),
                           torch.Generator(), mesh=mesh)
    mine = {k: pm.shard_batch(mesh, v) for k, v in draws.items()}
    moments = stepper.run(state, pm.shard_batch(mesh, reals), None, True, True, draws=mine)
    return _state_of(state, moments)


# Style mixing off and const noise (the draws are handed in); the augment
# fixed by ``debug_percentile`` is the same transform for every sample;
# pl_batch_shrink 1, so both sides take the path length of all samples.
_JAX_LOSS_KW = dict(r1_gamma=1.0, style_mixing_prob=0.0, pl_weight=2.0, pl_batch_shrink=1,
                    noise_mode="const")


def test_two_ranks_match_the_jax_step_on_injected_draws(tmp_path):
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

    g, d = jsg2.Generator(**G_KW), jsg2.Discriminator(**D_KW)
    pipe = jaug.AugmentPipe(jaug.medical_augment_config(), RES, RES, 1, impl="gather",
                            compute_dtype=jnp.float32)
    jl = jloss.StyleGAN2Loss(g, d, jloss.StyleGAN2LossConfig(**_JAX_LOSS_KW),
                             augment_fn=functools.partial(pipe, debug_percentile=0.3))
    opt_g, opt_d = j_adam(LR, reg_interval=4), j_adam(LR, reg_interval=16)
    jstate = jax.jit(lambda key: j_create_state(
        g, d, key, opt_g, opt_d, z_dim=ZDIM, c_dim=0, img_resolution=RES,
        img_channels=1))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    perturb = lambda tree, s=0.1: jax.tree.map(  # noqa: E731
        lambda a: np.asarray(a) + s * rng.standard_normal(np.shape(a)).astype(np.float32), tree)
    params_g = perturb(jax.device_get(jstate.params_g))
    jstate = jstate.replace(
        params_g=params_g, params_g_ema=perturb(params_g, 0.01),
        params_d=perturb(jax.device_get(jstate.params_d)),
        emas_g=perturb(jax.device_get(jstate.emas_g)),
        step=jnp.asarray(3, jnp.int32), cur_nimg=jnp.asarray(1000, jnp.int32),
        ada_p=jnp.asarray(0.2, jnp.float32), opt_g=opt_g.init(params_g))
    stepper = jstep.TrainStepper(jl, opt_g, opt_d, jstep.TrainStepConfig(
        batch_size=BATCH, z_dim=ZDIM, ada_target=0.6), create_mesh(1))
    reals = _reals(torch.float32)
    new_j, _ = jax.jit(functools.partial(stepper._device_step, True, True))(
        jstate, jnp.asarray(reals.permute(0, 2, 3, 1).numpy()), jnp.zeros((BATCH, 0)))
    new_j = jax.device_get(new_j)

    # What _device_step draws: the latents, and the path-length noise of
    # the whole batch (pl_batch_shrink 1).
    k = jax.random.split(jax.random.fold_in(jax.random.fold_in(jstate.rng, jstate.step), 0), 8)
    draws = {f"z_{name}": torch.from_numpy(np.array(jax.random.normal(k[i], (BATCH, ZDIM))))
             for name, i in (("gmain", 0), ("gpl", 2), ("dmain", 4))}
    pl = jax.random.normal(jax.random.split(k[3], 3)[1], (BATCH, RES, RES, 1))
    draws["pl_noise"] = torch.from_numpy(np.array(pl)).permute(0, 3, 1, 2).contiguous()

    consts, emas = jax.device_get(jstate.consts_g), jax.device_get(jstate.emas_g)
    sds = dict(
        G=bridge.generator_state_dict_from_jax(
            {"params": params_g, "emas": emas, **consts}),
        G_ema=bridge.generator_state_dict_from_jax(
            {"params": jax.device_get(jstate.params_g_ema), "emas": emas, **consts}),
        D=bridge.discriminator_state_dict_from_jax({"params": jax.device_get(jstate.params_d)}))
    two = run_ranks(_port_device_step, 2, tmp_path, sds,
                    dict(step=3, cur_nimg=1000, ada_p=0.2), draws, reals)
    _assert_ranks_equal(two)
    got = two[0]
    for prefix, params in (("G.", new_j.params_g), ("G_ema.", new_j.params_g_ema)):
        want = bridge.generator_state_dict_from_jax(
            {"params": params, "emas": new_j.emas_g, **new_j.consts_g})
        for name, value in want.items():
            np.testing.assert_allclose(got[prefix + name].numpy(), value.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=prefix + name)
    want_d = bridge.discriminator_state_dict_from_jax({"params": new_j.params_d})
    for name, value in want_d.items():
        np.testing.assert_allclose(got["D." + name].numpy(), value.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg="D." + name)
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(got["pl_mean"]), float(new_j.pl_mean), **tol)
    np.testing.assert_allclose(float(got["ada_p"]), float(new_j.ada_p), **tol)
    np.testing.assert_allclose(got["ada_signs"].numpy(), np.asarray(new_j.ada_signs), **tol)


# ------------------------------------------------------------------ metrics

def _features(mesh, data_dir):
    from gantrack_tpu_torch.data import open_dataset
    from gantrack_tpu_torch.metrics import metric_utils as mu
    from gantrack_tpu_torch.models import stylegan2 as tsg2

    torch.manual_seed(0)
    G = tsg2.Generator(**G_KW).eval()
    opts = mu.MetricOptions(
        generator=lambda z, c: G(z, c, noise_mode="const"), z_dim=ZDIM,
        dataset=open_dataset(data_dir), detector=mu.make_random_projection_detector(seed=0),
        batch_size=7, mesh=mesh)
    real = mu.compute_feature_stats_for_dataset(opts, capture_all=True, max_items=23)
    fake = mu.compute_feature_stats_for_generator(opts, capture_all=True, max_items=23)
    return {"real": torch.from_numpy(real.get_all()), "fake": torch.from_numpy(fake.get_all())}


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    from gantrack_tpu_torch.data import pack_shards

    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (RES, RES, 1)).astype(np.float32) for _ in range(32)]
    root = str(tmp_path_factory.mktemp("data") / "data")
    pack_shards(root, "train", images, [f"s{i}" for i in range(len(images))])
    return root


def test_metric_features_over_two_ranks_equal_one(tiny_dataset, tmp_path):
    one = _features(pm.Mesh(), tiny_dataset)
    two = run_ranks(_features, 2, tmp_path, tiny_dataset)
    _assert_ranks_equal(two)
    # The detector's float32 products over 3072 pixels take another
    # blocking at another batch size: rounding of a few 1e-6.
    for name in ("real", "fake"):
        assert one[name].shape == (23, 510)
        np.testing.assert_allclose(two[0][name].numpy(), one[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------- CLI

def _cli(argv):
    # One thread a rank: the suite's other workers share the host.
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-m", "gantrack_tpu_torch.tools.train", *argv],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=SPAWN_TIMEOUT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return out


def test_cli_two_cpu_devices_write_from_rank_0_only(tiny_dataset, tmp_path):
    argv = [f"--data={tiny_dataset}", "--cfg=stylegan2", "--batch=32",
            "--batch-gpu=8", "--gamma=0.4096", "--cbase=256", "--cmax=16", "--map-depth=2",
            "--mbstd-group=2", "--tick=1", "--snap=1", "--metrics=none",
            "--device=cpu", "--devices=2"]
    out = _cli([f"--outdir={tmp_path / 'a'}", "--kimg=1", *argv])
    (run_dir,) = [os.path.join(tmp_path, "a", d) for d in os.listdir(tmp_path / "a")]
    with open(os.path.join(run_dir, "training_options.json")) as f:
        assert json.load(f)["num_devices"] == 2
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        ticks = [json.loads(line)["Progress/tick"] for line in f]
    assert ticks == [0, 1]  # one writer: no tick twice
    assert os.listdir(os.path.join(run_dir, "checkpoints")) == ["state-00000032.pt"]
    payload = torch.load(os.path.join(run_dir, "checkpoints", "state-00000032.pt"),
                         weights_only=True)
    assert payload["cur_nimg"] == 32 * 32
    assert out.stdout.count("tick 1 ") == 1  # only rank 0 reports

    out = _cli([f"--outdir={tmp_path / 'b'}", "--kimg=2", f"--resume={run_dir}", *argv])
    assert out.stdout.count("Resuming from") == 1
    (run_dir,) = [os.path.join(tmp_path, "b", d) for d in os.listdir(tmp_path / "b")]
    assert os.listdir(os.path.join(run_dir, "checkpoints")) == ["state-00000063.pt"]
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        assert [json.loads(line)["Progress/kimg"] for line in f] == [1.056, 2.016]


# ------------------------------------------------ the card's 2-rank check

def _smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def _gmain_grads(z, pins=None):
    import contextlib

    smoke = _smoke()
    G, _, state, loss, stepper = smoke.claro_float32(
        torch.device("cpu"), z.shape[0], mixing=0.0, res=RES, cbase=256, cmax=32)
    with pins.active() if pins is not None else contextlib.nullcontext():
        value = loss.gmain(z, None, stepper.generator, state.ada_p, 0.0)[0]
        return torch.cat([g.flatten() for g in torch.autograd.grad(value, list(G.parameters()))])


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_kink_pins_replay_the_recorded_branches():
    """``chip_smoke.KinkPins``: recording leaves the gradient's bits as
    they are; replaying it on the same batch flips nothing and changes no
    bit; on the batch's halves it holds their mean gradient within float32
    rounding (1e-6 relative norm); and where z moves by 1e-3 and every
    element within 0.2 of the rms of a kink or clamp is pinned, pinning
    flips branches and leaves less than a quarter of the unpinned change."""
    torch.set_num_threads(2)
    smoke = _smoke()
    z = torch.randn((8, 512), generator=torch.Generator().manual_seed(1))
    pins = smoke.KinkPins()
    whole = _gmain_grads(z, pins)
    assert torch.equal(whole, _gmain_grads(z))
    assert torch.equal(whole, _gmain_grads(z, pins.replay(0)))
    assert sum(f for _, f in pins.flips) == 0
    halves = [_gmain_grads(z[j:j + 4], pins.replay(j)) for j in (0, 4)]
    assert _rel((halves[0] + halves[1]) / 2, whole) <= 1e-6
    wide = smoke.KinkPins(band=0.2)
    _gmain_grads(z, wide)
    moved = z + 1e-3 * torch.randn((8, 512), generator=torch.Generator().manual_seed(5))
    unpinned = _rel(_gmain_grads(moved), whole)
    pinned = _rel(_gmain_grads(moved, wide.replay(0)), whole)
    print(f"z moved by 1e-3: {unpinned:.3e} unpinned, {pinned:.3e} pinned, "
          f"{sum(f for _, f in wide.flips)} flips")
    assert sum(f for _, f in wide.flips) > 0 and pinned < unpinned / 4


def test_card_global_sample_check_rehearsed_on_gloo(tmp_path, monkeypatch):
    """``chip_smoke.check_global_sample``, the card's 2-rank check, on two
    gloo ranks against one at 16²: its own bound (1e-4 on each phase's
    gradient, kinks pinned) holds."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    _smoke().check_global_sample(str(tmp_path), "cpu", small=True)
