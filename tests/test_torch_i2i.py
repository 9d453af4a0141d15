"""The port's image-to-image family against the JAX package, small.

* Transforms: ``get_params`` / ``output_size`` give the original's
  results; the numpy BICUBIC resize equals ``PIL.Image.resize(...,
  BICUBIC)`` exactly (bound: 0 LSB; up- and down-scaling, odd sizes, 1 and
  3 channels); every preprocess mode equals the JAX chain on PIL images;
  the PNG reader's RGB → L equals PIL's ``convert("L")``.
* ``utils.colorspace`` equals the original (same float64 operations).
* Networks: each generator (resnet, 2 blocks; U-Net, 5 downs) and
  discriminator (basic, n_layers, pixel) in both norms, with the JAX
  weights carried by ``models.bridge``: outputs to 1e-4 (float32 convs
  over up to 7×7×C taps, summed in another order).
* ``gan_loss`` in all three modes, and ``gradient_penalty`` (its value
  and its gradient with respect to D's parameters, a double backward):
  1e-5 relative.
* Three iterations of each trainer (CycleGAN with its pool and the
  identity loss, pix2pix without dropout, colorization, regression),
  each from equal states: before each, the port's networks and Adam
  moments are set to the JAX trainer's (whose update count, and torch
  Adam's step, must equal the port's).  Then: the losses to 1e-5 relative
  at the first iteration and 1e-4 after; each optimizer's gradient (the
  JAX one recorded from its optax transform), relative norm error over
  all its parameters, from a float64 twin of the port's trainer (same
  state and pools) at 1e-3, and from the port's float32 trainer at 1e-4
  unless that one lies farther than 1e-4 from its own float64 twin: a
  leaky-ReLU or ReLU input within a float32 rounding of 0 takes another
  branch in two float32 computations and moves a whole gradient (the
  CycleGAN generators' first one: 9.0e-3 from JAX and from the port's
  own float64, whose error against JAX is 2.7e-4).  The parameters after
  each update are equal but for Adam's sign flips: its first step moves
  every element by ±lr whatever the gradient's size, so an element whose
  gradient is at the level of the two frameworks' rounding may step the
  other way (measured: up to 0.5 % of a tensor).  Up to 1 % of a
  tensor's elements may so differ, by at most 2·lr; a conv bias that
  feeds a norm has no gradient in exact arithmetic (the norm removes it),
  so all of its elements may.  ``ScheduledAdam`` itself is held to
  ``optax.adam`` with a schedule on a well-conditioned problem, to
  float32 rounding (1e-5 relative).
* The learning-rate schedules over epoch boundaries, and a regression
  trainer whose rate changes every iteration.
* A generator's ``state_dict`` saved with ``torch.save`` loads with
  ``torch.load`` into a fresh generator, and is the reference's layout:
  the JAX package's reader of reference state dicts
  (``torch_compat.*_params_from_torch``) turns it into the JAX network
  that computes the same output.
* ``train_i2i`` → ``test_i2i`` on the CPU writes the HTML sheet and its
  PNGs, from the port's checkpoint and from reference-style ``.pth``
  files.
"""

import copy
import functools
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from gantrack_tpu.models import image2image as J
from gantrack_tpu.training import image2image as JT
from gantrack_tpu_torch.models import bridge
from gantrack_tpu_torch.models import image2image as T
from gantrack_tpu_torch.training import image2image as TT

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
# An i2i trainer's gradient against the JAX trainer's from the same state,
# relative norm error: the port's float32 one, and its float64 twin's.
GRAD_RTOL, GRAD64_RTOL = 1e-4, 1e-3


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(x), (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------- transforms

def test_get_params_and_output_size_equal_the_original():
    from gantrack_tpu.data import i2i_transforms as orig
    from gantrack_tpu_torch.data import i2i_transforms as port

    assert port.PREPROCESS_CHOICES == orig.PREPROCESS_CHOICES
    for mode in orig.PREPROCESS_CHOICES:
        r1, r2 = random.Random(3), random.Random(3)
        for w, h in ((70, 50), (40, 90), (256, 256), (30, 30)):
            for no_flip in (False, True):
                assert (port.get_params(mode, 64, 32, (w, h), r1, no_flip)
                        == orig.get_params(mode, 64, 32, (w, h), r2, no_flip))
        assert port.output_size(mode, 286, 256) == orig.output_size(mode, 286, 256)


@pytest.mark.parametrize("channels", [1, 3])
def test_bicubic_resize_equals_pil(channels):
    """Up, down, odd sizes, shrink factors beyond 2: 0 LSB apart."""
    Image = pytest.importorskip("PIL.Image")
    from gantrack_tpu_torch.data.i2i_transforms import resize_bicubic

    rng = np.random.default_rng(channels)
    cases = [((37, 53), (256, 256)), ((256, 256), (37, 53)), ((64, 64), (31, 17)),
             ((1, 5), (3, 2)), ((300, 11), (7, 40)), ((33, 33), (33, 64))]
    for (h, w), (ow, oh) in cases:
        shape = (h, w) if channels == 1 else (h, w, 3)
        img = rng.integers(0, 256, shape).astype(np.uint8)
        want = np.asarray(Image.fromarray(img, "L" if channels == 1 else "RGB").resize(
            (ow, oh), Image.BICUBIC))
        got = resize_bicubic(img, (ow, oh))
        assert got.shape == want.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() == 0, ((h, w), (ow, oh))


@pytest.mark.parametrize("mode", ["resize_and_crop", "crop", "scale_width",
                                  "scale_width_and_crop", "resize", "none"])
def test_every_preprocess_mode_equals_the_jax_chain(mode):
    Image = pytest.importorskip("PIL.Image")
    from gantrack_tpu.data.i2i_transforms import apply_transform as orig
    from gantrack_tpu.data.i2i_transforms import get_params
    from gantrack_tpu_torch.data.i2i_transforms import apply_transform as port

    rng = np.random.default_rng(7)
    for (h, w), channels in (((50, 70), 3), ((41, 30), 1), ((96, 64), 3)):
        img = rng.integers(0, 256, (h, w, 3) if channels == 3 else (h, w)).astype(np.uint8)
        pil = Image.fromarray(img, "RGB" if channels == 3 else "L")
        for seed in range(3):
            params = get_params(mode, 48, 32, (w, h), random.Random(seed))
            want = np.asarray(orig(pil, mode, 48, 32, params))
            np.testing.assert_array_equal(port(img, mode, 48, 32, params), want)


def test_png_reader_converts_rgb_to_l_as_pil(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    from gantrack_tpu_torch.tools.train_i2i import read_image
    from gantrack_tpu_torch.utils.checkpoint import save_png

    rgb = np.random.default_rng(0).integers(0, 256, (9, 13, 3)).astype(np.uint8)
    save_png(str(tmp_path / "x.png"), rgb)
    want = np.asarray(Image.fromarray(rgb, "RGB").convert("L"))
    np.testing.assert_array_equal(read_image(str(tmp_path / "x.png"), 1), want)
    np.testing.assert_array_equal(read_image(str(tmp_path / "x.png"), 3), rgb)


def test_colorspace_equals_the_original():
    from gantrack_tpu.utils import colorspace as orig
    from gantrack_tpu_torch.utils import colorspace as port

    rng = np.random.default_rng(1)
    rgb = rng.random((8, 8, 3))
    np.testing.assert_array_equal(port.rgb2lab(rgb), orig.rgb2lab(rgb))
    u8 = rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)
    np.testing.assert_array_equal(port.rgb2lab(u8), orig.rgb2lab(u8))
    lab = orig.rgb2lab(rgb)
    np.testing.assert_array_equal(port.lab2rgb(lab), orig.lab2rgb(lab))


# ------------------------------------------------------------------ networks

def _perturb(tree, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(np.shape(a)).astype(np.float32),
        tree)


def _jax_apply(module, variables, x, **kw):
    """A JAX i2i network's output; batch norm normalises with the batch's
    statistics (its running averages are a mutable collection)."""
    if "batch_stats" in variables:
        return module.apply(variables, x, mutable=["batch_stats"], **kw)[0]
    return module.apply(variables, x, **kw)


@pytest.mark.parametrize("norm", ["instance", "batch"])
@pytest.mark.parametrize("net", ["resnet", "unet"])
def test_generators_match_jax(net, norm):
    size = 32
    if net == "resnet":
        jg = J.ResnetGenerator(2, ngf=8, n_blocks=2, norm=norm)
        tg = T.ResnetGenerator(3, 2, ngf=8, n_blocks=2, norm=norm)
        to_sd = functools.partial(bridge.resnet_state_dict_from_jax, n_blocks=2)
    else:
        jg = J.UnetGenerator(2, num_downs=5, ngf=8, norm=norm)
        tg = T.UnetGenerator(3, 2, num_downs=5, ngf=8, norm=norm)
        to_sd = functools.partial(bridge.unet_state_dict_from_jax, num_downs=5)
    x = np.random.default_rng(1).standard_normal((2, size, size, 3)).astype(np.float32)
    variables = jg.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {**variables, "params": _perturb(variables["params"])}
    want = _jax_apply(jg, variables, jnp.asarray(x))
    tg.load_state_dict(to_sd(variables["params"]))
    np.testing.assert_allclose(_nhwc(tg(_nchw(x))), np.asarray(want), **TOL)


@pytest.mark.parametrize("norm", ["instance", "batch"])
@pytest.mark.parametrize("netD", ["basic", "n_layers", "pixel"])
def test_discriminators_match_jax(netD, norm):
    jd = J.define_D(8, netD, n_layers_D=2, norm=norm)
    td = T.define_D(3, 8, netD, n_layers_D=2, norm=norm)
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    variables = jd.init(jax.random.PRNGKey(1), jnp.asarray(x))
    variables = {**variables, "params": _perturb(variables["params"], 1)}
    td.load_state_dict(bridge.i2i_discriminator_state_dict_from_jax(variables["params"], netD, 2))
    want = _jax_apply(jd, variables, jnp.asarray(x))
    np.testing.assert_allclose(_nhwc(td(_nchw(x))), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["lsgan", "vanilla", "wgangp"])
@pytest.mark.parametrize("target", [True, False])
def test_gan_loss_matches_jax(mode, target):
    pred = np.random.default_rng(3).standard_normal((2, 6, 6, 1)).astype(np.float32) * 3
    want = float(J.gan_loss(jnp.asarray(pred), target, mode))
    got = float(T.gan_loss(_nchw(pred), target, mode))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["real", "fake", "mixed"])
def test_gradient_penalty_and_its_d_gradient_match_jax(kind):
    jd = J.define_D(8, "basic", norm="instance")
    td = T.define_D(3, 8, "basic", norm="instance")
    rng = np.random.default_rng(4)
    real = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    fake = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    params = _perturb(jd.init(jax.random.PRNGKey(2), jnp.asarray(real))["params"], 2)
    key = jax.random.PRNGKey(5)
    d_apply = lambda p, x: jd.apply({"params": p}, x)  # noqa: E731
    fn = lambda p: J.gradient_penalty(d_apply, p, jnp.asarray(real), jnp.asarray(fake),  # noqa
                                      key, type=kind)
    want, want_grads = jax.value_and_grad(fn)(params)
    alpha = torch.from_numpy(np.array(jax.random.uniform(key, (2, 1, 1, 1))))
    td.load_state_dict(bridge.i2i_discriminator_state_dict_from_jax(params, "basic"))
    got = T.gradient_penalty(td, _nchw(real), _nchw(fake), type=kind, alpha=alpha)
    grads = torch.autograd.grad(got, list(td.parameters()), allow_unused=True)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_sd = bridge.i2i_discriminator_state_dict_from_jax(jax.device_get(want_grads), "basic")
    for (name, p), g in zip(td.named_parameters(), grads):
        g = torch.zeros_like(p) if g is None else g  # the last bias leaves ∇_x D unchanged
        np.testing.assert_allclose(g.numpy(), want_sd[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


# ------------------------------------------------------------------ trainers

def _biases_before_norm(net: torch.nn.Module):
    names = set()
    for prefix, m in net.named_modules():
        if isinstance(m, torch.nn.Sequential):
            for i in range(len(m) - 1):
                if (isinstance(m[i], (torch.nn.Conv2d, torch.nn.ConvTranspose2d))
                        and isinstance(m[i + 1], (torch.nn.InstanceNorm2d, torch.nn.BatchNorm2d))):
                    names.add(f"{prefix}.{i}.bias".lstrip("."))
    return names


def _assert_params(got: torch.nn.Module, want_sd, lr):
    """After one update from equal states: equal but for Adam's sign flips
    (see the module's docstring)."""
    sd = got.state_dict()
    assert set(sd) == set(want_sd)
    free = _biases_before_norm(got)
    for name, value in sd.items():
        a, b = value.numpy(), want_sd[name].numpy()
        off = ~np.isclose(a, b, rtol=1e-4, atol=1e-5)
        if name not in free:
            assert off.sum() <= max(1, off.size // 100), (name, int(off.sum()), off.size)
        assert np.abs(a - b)[off].max(initial=0) <= 2.02 * lr, name


def _assert_losses(got, want, i):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5 if i == 0 else 1e-4,
                                   err_msg=f"iteration {i}: {k}")


def _batches(n, shape_a, shape_b, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-1, 1, shape_a).astype(np.float32),
             rng.uniform(-1, 1, shape_b).astype(np.float32)) for _ in range(n)]


def _gen(netG):
    return lambda tree: bridge.i2i_generator_state_dict_from_jax(tree, netG)


def _disc(tree):
    return bridge.i2i_discriminator_state_dict_from_jax(tree, "basic")


def _pick(tree, key):
    return tree if key is None else tree[key]


def _record_jax(jt, attr):
    """The gradients handed to the JAX trainer's optax transform ``attr``,
    one tree an update, in order."""
    sink, tx = [], getattr(jt, attr)

    def update(grads, state, params=None):
        jax.debug.callback(lambda g: sink.append(jax.device_get(g)), grads, ordered=True)
        return tx.update(grads, state, params)

    setattr(jt, attr, optax.GradientTransformation(tx.init, update))
    return sink


def _record_torch(opt):
    """The gradients of each update of the port's ``ScheduledAdam``."""
    sink, step = [], opt.opt.step

    def recorded(*args, **kwargs):
        sink.append(torch.cat([p.grad.flatten() for p in opt.params]))
        return step(*args, **kwargs)

    opt.opt.step = recorded
    return sink


def _flat(parts, tree):
    """A JAX tree of one optimizer's parameters (or gradients), flattened
    in the order of the port's; ``parts`` are its (net, convert, key)."""
    return torch.cat([convert(_pick(tree, key))[name].flatten()
                      for net, convert, key in parts for name, _ in net.named_parameters()])


def _sync(opt, parts, params, opt_state, twin=False):
    """The port's nets and Adam moments set to the JAX trainer's, which
    must have taken as many updates as the port; a ``twin`` (float64) also
    takes the JAX trainer's update count."""
    adam = jax.device_get(opt_state[0])
    count = int(adam.count)
    if twin:
        opt.count = count
    assert opt.count == count
    for net, convert, key in parts:
        net.load_state_dict(convert(_pick(jax.device_get(params), key)))
        mu, nu = convert(_pick(adam.mu, key)), convert(_pick(adam.nu, key))
        for name, p in net.named_parameters():
            state = opt.opt.state[p]
            if twin and count and not state:
                state.update(step=torch.tensor(float(count)), exp_avg=torch.zeros_like(p),
                             exp_avg_sq=torch.zeros_like(p))
            if state:
                assert int(state["step"]) == count, name
                state["exp_avg"].copy_(mu[name])
                state["exp_avg_sq"].copy_(nu[name])


def _iterate(jt, make, state, batches, sides, lr):
    """Each iteration from equal states: the port's nets and moments set
    to the JAX trainer's, then one iteration of each; the losses and the
    parameters after each update are held as the module's docstring says,
    and each optimizer's gradient twice: the port's (float32) against
    JAX's at ``GRAD_RTOL``, and, from the same state and pools, a float64
    twin of the port's trainer against JAX's at ``GRAD64_RTOL``.
    ``make()`` builds a port trainer; ``sides(state, trainer)`` lists, per
    port optimizer: (its ``ScheduledAdam``, parts, the JAX parameters and
    optimizer state, the JAX gradient sink, the index there of iteration
    ``i``'s gradient as a function of ``i``)."""
    tt = make()
    sinks = [_record_torch(opt) for opt, *_ in sides(state, tt)]
    for i, (a, b) in enumerate(batches):
        pools = {k: copy.deepcopy(v) for k, v in vars(tt).items()
                 if isinstance(v, TT.ImagePool)}
        twin = make()
        for net in twin.nets.values():
            net.double()
        for k, pool in pools.items():
            pool.images = [img.double() for img in pool.images]
            setattr(twin, k, pool)
        for trainer, is_twin in ((tt, False), (twin, True)):
            for opt, parts, params, opt_state, *_ in sides(state, trainer):
                _sync(opt, parts, params, opt_state, twin=is_twin)
        twin_sinks = [_record_torch(opt) for opt, *_ in sides(state, twin)]
        twin.optimize_parameters(_nchw(a).double(), _nchw(b).double())
        state, want = jt.optimize_parameters(state, a, b)
        _assert_losses(tt.optimize_parameters(_nchw(a), _nchw(b)), want, i)
        jax.effects_barrier()
        for got, got64, (opt, parts, params, _, jax_sink, index) in zip(
                sinks, twin_sinks, sides(state, tt)):
            want_g = _flat(parts, jax_sink[index(i)]).double()
            what = (i, [net.__class__.__name__ for net, *_ in parts])
            err = float((got[i].double() - want_g).norm() / want_g.norm())
            err64 = float((got64[0] - want_g).norm() / want_g.norm())
            split = float((got[i].double() - got64[0]).norm() / got64[0].norm())
            print(f"iteration {i} {what[1]}: gradient against JAX {err:.3e}, float64 twin "
                  f"against JAX {err64:.3e}, float32 against float64 {split:.3e}")
            assert err64 <= GRAD64_RTOL, (what, err64)
            assert err <= GRAD_RTOL or split > GRAD_RTOL, (what, err, split)
            for net, convert, key in parts:
                _assert_params(net, convert(_pick(jax.device_get(params), key)), lr)
    return tt


def test_cyclegan_trainer_matches_jax():
    cfg = dict(input_nc=1, output_nc=1, ngf=8, ndf=8, netG="resnet_6blocks", pool_size=3)
    jt = JT.CycleGANTrainer(JT.CycleGANConfig(**cfg), image_size=32, iters_per_epoch=10)
    state = jt.init_state(jax.random.PRNGKey(0))
    make = lambda: TT.CycleGANTrainer(  # noqa: E731
        TT.CycleGANConfig(**cfg), device="cpu", generator=torch.Generator().manual_seed(0),
        iters_per_epoch=10)
    jg, jd = _record_jax(jt, "opt_g"), _record_jax(jt, "opt_d")  # opt_d: d_a, then d_b
    gen = _gen("resnet_6blocks")

    def sides(s, tt):
        return [(tt.opts["g"], [(tt.g_a, gen, "a"), (tt.g_b, gen, "b")],
                 {"a": s.params_g_a, "b": s.params_g_b}, s.opt_g, jg, lambda i: i),
                (tt.opts["d_a"], [(tt.d_a, _disc, None)], s.params_d_a, s.opt_d_a, jd,
                 lambda i: 2 * i),
                (tt.opts["d_b"], [(tt.d_b, _disc, None)], s.params_d_b, s.opt_d_b, jd,
                 lambda i: 2 * i + 1)]

    tt = _iterate(jt, make, state, _batches(3, (2, 32, 32, 1), (2, 32, 32, 1)), sides, 2e-4)
    assert len(tt.pool_a.images) == 3 and tt.step == 3


@pytest.mark.parametrize("kind", ["pix2pix", "colorization"])
def test_pix2pix_trainers_match_jax(kind):
    if kind == "pix2pix":
        cfg, size, nc = dict(ngf=8, ndf=8, netG="unet_128", no_dropout=True), 128, (3, 3)
        jcls, tcls = JT.Pix2PixTrainer, TT.Pix2PixTrainer
    else:
        cfg, size, nc = dict(ngf=8, ndf=8, netG="resnet_6blocks", no_dropout=True), 32, (1, 2)
        jcls, tcls = JT.ColorizationTrainer, TT.ColorizationTrainer
    jt = jcls(JT.Pix2PixConfig(**cfg), image_size=size, iters_per_epoch=10)
    state = jt.init_state(jax.random.PRNGKey(0))
    make = lambda: tcls(TT.Pix2PixConfig(**cfg), device="cpu",  # noqa: E731
                        generator=torch.Generator().manual_seed(0), iters_per_epoch=10)
    jg, jd = _record_jax(jt, "opt_g"), _record_jax(jt, "opt_d")

    def sides(s, tt):
        return [(tt.opts["g"], [(tt.g, _gen(cfg["netG"]), None)], s.params_g, s.opt_g, jg,
                 lambda i: i),
                (tt.opts["d"], [(tt.d, _disc, None)], s.params_d, s.opt_d, jd, lambda i: i)]

    tt = _iterate(jt, make, state, _batches(3, (1, size, size, nc[0]), (1, size, size, nc[1]),
                                            seed=1), sides, 2e-4)
    assert (tt.cfg.input_nc, tt.cfg.output_nc) == nc
    if kind == "colorization":
        a, b = _batches(1, (1, size, size, 1), (1, size, size, 2))[0]
        vis = tt.compute_visuals(_nchw(a), _nchw(b), _nchw(b * 0.9))
        want = jt.compute_visuals(a, b, b * 0.9)
        for k in want:
            np.testing.assert_allclose(vis[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_regression_trainer_matches_jax_with_a_rate_that_moves_every_iteration():
    """``iters_per_epoch=1``, 1 + 3 epochs: the linear policy changes the
    rate at every iteration from the second on."""
    cfg = dict(input_nc=1, output_nc=1, ngf=8, netG="resnet_6blocks", lr=2e-3,
               n_epochs=1, n_epochs_decay=3)
    jt = JT.RegressionTrainer(JT.RegressionConfig(**cfg), image_size=16, iters_per_epoch=1)
    state = jt.init_state(jax.random.PRNGKey(0))
    make = lambda: TT.RegressionTrainer(  # noqa: E731
        TT.RegressionConfig(**cfg), device="cpu", generator=torch.Generator().manual_seed(0),
        iters_per_epoch=1)
    jg = _record_jax(jt, "opt_g")

    def sides(s, tt):
        return [(tt.opts["g"], [(tt.g, _gen("resnet_6blocks"), None)], s.params_g, s.opt_g, jg,
                 lambda i: i)]

    tt = _iterate(jt, make, state, _batches(3, (2, 16, 16, 1), (2, 16, 16, 1), seed=2), sides,
                  2e-3)
    assert tt.opts["g"].count == 3
    assert [tt.opts["g"].schedule(k) for k in range(4)] == pytest.approx(
        [2e-3, 2e-3 * 0.75, 2e-3 * 0.5, 2e-3 * 0.25])


def test_scheduled_adam_matches_optax_adam_with_a_schedule():
    """Update ``k`` takes ``schedule(k)``: five steps on a quadratic, whose
    gradients are far from rounding, against ``optax.adam(sched)``."""
    import optax

    sched = JT.make_lr_schedule("linear", 0.1, 1, 3, 1)
    target = np.linspace(-1, 1, 6).astype(np.float32)
    x0 = np.full(6, 0.5, np.float32)
    opt = optax.adam(sched, b1=0.5, b2=0.999)
    x, state = jnp.asarray(x0), opt.init(jnp.asarray(x0))
    p = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    adam = TT.ScheduledAdam([p], TT.make_lr_schedule("linear", 0.1, 1, 3, 1), beta1=0.5)
    for _ in range(5):
        g = jax.grad(lambda v: jnp.sum(jnp.square(v - target) * jnp.arange(1, 7)))(x)
        updates, state = opt.update(g, state, x)
        x = optax.apply_updates(x, updates)
        adam.step(((p - torch.from_numpy(target)).square() * torch.arange(1, 7)).sum())
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(x), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("policy", ["linear", "step", "cosine"])
def test_lr_schedules_match_jax_over_epoch_boundaries(policy):
    args = (policy, 2e-4, 3, 4, 5)
    want = JT.make_lr_schedule(*args, step_size=2)
    got = TT.make_lr_schedule(*args, step_size=2)
    for it in range(0, 40):  # 8 epochs of 5 iterations
        np.testing.assert_allclose(got(it), float(want(it)), rtol=1e-6, err_msg=str(it))


def test_image_pool_replays_as_the_jax_pool():
    jp, tp = JT.ImagePool(3, seed=0), TT.ImagePool(3, seed=0)
    rng = np.random.default_rng(5)
    for _ in range(6):
        x = rng.standard_normal((2, 1, 4, 4)).astype(np.float32)
        np.testing.assert_array_equal(tp.query(torch.from_numpy(x)).numpy(), jp.query(x))


# ------------------------------------------------------------- .pth and CLIs

@pytest.mark.parametrize("netG", ["resnet_6blocks", "unet_128"])
def test_pth_round_trip_is_the_reference_layout(netG, tmp_path):
    from gantrack_tpu.models import torch_compat

    size = 32 if netG.startswith("resnet") else 128
    g = T.define_G(3, 3, 8, netG, generator=torch.Generator().manual_seed(3))
    path = str(tmp_path / "latest_net_G.pth")
    torch.save(g.state_dict(), path)
    fresh = T.define_G(3, 3, 8, netG)
    fresh.load_state_dict(torch.load(path, weights_only=True))  # strict: same keys
    params = torch_compat.i2i_generator_params_from_pth(path, netG)
    x = np.random.default_rng(6).standard_normal((1, size, size, 3)).astype(np.float32)
    want = J.define_G(3, 8, netG).apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(_nhwc(fresh(_nchw(x))), np.asarray(want), **TOL)


def _png_dataset(root, aligned: bool):
    from gantrack_tpu_torch.utils.checkpoint import save_png

    rng = np.random.default_rng(0)
    for phase in ("train", "test"):
        dirs = [root / phase] if aligned else [root / f"{phase}A", root / f"{phase}B"]
        for d in dirs:
            d.mkdir(parents=True)
            for i in range(2):
                w = 64 if aligned else 32
                save_png(str(d / f"im{i}.png"),
                         rng.integers(0, 256, (32, w, 3)).astype(np.uint8))


@pytest.mark.parametrize("model", ["cycle_gan", "pix2pix"])
def test_train_i2i_then_test_i2i_write_the_html_sheet(model, tmp_path):
    from gantrack_tpu_torch.tools import test_i2i, train_i2i

    aligned = model == "pix2pix"
    _png_dataset(tmp_path / "data", aligned)
    netg = "resnet_6blocks"
    run_dir = train_i2i.main([
        f"--dataroot={tmp_path / 'data'}", "--name=t", f"--model={model}", "--ngf=8",
        "--ndf=8", f"--netG={netg}", "--load-size=32", "--batch-size=1",
        f"--checkpoints-dir={tmp_path / 'ckpt'}", "--max-iters=2", "--n-epochs=1",
        "--n-epochs-decay=0", "--device=cpu"])
    assert os.listdir(os.path.join(run_dir, "checkpoints")) == ["i2i-00000002.pt"]
    web = test_i2i.main([
        f"--dataroot={tmp_path / 'data'}", "--name=t", f"--model={model}", "--ngf=8",
        f"--netG={netg}", "--load-size=32", "--num-test=2",
        f"--checkpoints-dir={tmp_path / 'ckpt'}", f"--results-dir={tmp_path / 'results'}",
        "--device=cpu"])
    _assert_sheet(web, model)


def _assert_sheet(web, model):
    from gantrack_tpu_torch.utils.checkpoint import decode_png

    with open(os.path.join(web, "index.html")) as f:
        html = f.read()
    pngs = sorted(os.listdir(os.path.join(web, "images")))
    labels = {"real_A", "fake_B"} | ({"rec_A"} if model == "cycle_gan" else {"real_B"})
    assert {p.split("_", 1)[1][:-4] for p in pngs} == labels, pngs
    for p in pngs:
        assert f'src="images/{p}"' in html
        with open(os.path.join(web, "images", p), "rb") as f:
            assert decode_png(f.read()).shape == (32, 32, 3)


def test_test_i2i_reads_reference_pth_files(tmp_path):
    from gantrack_tpu_torch.tools import test_i2i

    _png_dataset(tmp_path / "data", aligned=False)
    run = tmp_path / "ckpt" / "ref"
    run.mkdir(parents=True)
    for side, seed in (("G_A", 1), ("G_B", 2)):
        g = T.define_G(3, 3, 8, "resnet_6blocks", generator=torch.Generator().manual_seed(seed))
        torch.save(g.state_dict(), str(run / f"latest_net_{side}.pth"))
    web = test_i2i.main([
        f"--dataroot={tmp_path / 'data'}", "--name=ref", "--model=cycle_gan", "--ngf=8",
        "--netG=resnet_6blocks", "--load-size=32", f"--checkpoints-dir={tmp_path / 'ckpt'}",
        f"--results-dir={tmp_path / 'results'}", "--device=cpu"])
    _assert_sheet(web, "cycle_gan")


def test_non_png_datasets_are_refused(tmp_path):
    from gantrack_tpu_torch.tools.train_i2i import AlignedDataset

    (tmp_path / "train").mkdir()
    (tmp_path / "train" / "a.jpg").write_bytes(b"\xff\xd8")
    with pytest.raises(SystemExit, match="only PNG"):
        AlignedDataset(str(tmp_path), "train", 3)
