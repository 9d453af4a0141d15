"""VGG16, LPIPS features and perceptual path length of the port against
the JAX package.

* ``VGG16`` features (fc2) and ``lpips_features`` with the JAX
  ``random_params`` carried over by ``bridge.flax_state_dict_from_jax``,
  for an input smaller than ``resize_to`` (up-resize) and larger
  (antialiased down-resize), rel 1e-4; and the same weights read from a
  flat ``.npz`` by ``load_npz``.
* ``slerp`` to 1e-6.
* ``compute_ppl`` of the JAX package (z and w space) against the port's
  ``pair_distances`` and ``filtered_mean`` on the latents JAX draws, with
  a small StyleGAN2 carried over and the VGG16 detector.  ε is 1e-2 here:
  at the metric's 1e-4 the distance divides float32 rounding of two
  frameworks by 1e-8.  Rel 1e-3.
* ``ppl2_wend`` is registered, refuses w space without a mapping (as
  JAX does), and runs through ``evaluate_metrics``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gantrack_tpu.metrics import metric_utils as jmu
from gantrack_tpu.metrics import ppl as jppl
from gantrack_tpu.models import stylegan2 as jsg2
from gantrack_tpu.models import vgg as jvgg
from gantrack_tpu_torch.metrics import metric_utils as tmu
from gantrack_tpu_torch.metrics import ppl as tppl
from gantrack_tpu_torch.metrics import registry
from gantrack_tpu_torch.models import bridge
from gantrack_tpu_torch.models import stylegan2 as tsg2
from gantrack_tpu_torch.models import vgg as tvgg

torch.set_num_threads(1)

RESIZE, ZDIM, RES = 32, 8, 16
G_KW = dict(z_dim=ZDIM, c_dim=0, w_dim=ZDIM, img_resolution=RES, img_channels=1,
            mapping_kwargs=dict(num_layers=2),
            synthesis_kwargs=dict(channel_base=128, channel_max=32, num_fp16_res=0))


@functools.lru_cache(maxsize=None)
def _vgg_pair():
    params = jax.device_get(jvgg.random_params(jax.random.PRNGKey(3), resize_to=RESIZE))
    model = tvgg.VGG16(RESIZE)
    model.load_state_dict(bridge.flax_state_dict_from_jax(params))
    return params, model.eval().requires_grad_(False)


def _images(size, n=2, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (n, size, size, 3)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


@pytest.mark.parametrize("size", [24, 48], ids=["up", "down"])
def test_vgg_features_and_lpips_match_jax(size):
    params, model = _vgg_pair()
    jmodel = jvgg.VGG16(resize_to=RESIZE)
    x = _images(size)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    got = model(_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    want = np.asarray(jax.jit(lambda v, im: jvgg.lpips_features(jmodel, v, im))(
        params, jnp.asarray(x)))
    got = tvgg.lpips_features(model, _nchw(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_vgg_load_npz_and_detector(tmp_path):
    params, model = _vgg_pair()
    flat = {"/".join(k): np.asarray(v) for k, v in _flat(params["params"]).items()}
    path = str(tmp_path / "vgg16.npz")
    np.savez(path, **flat)
    loaded = tvgg.load_npz(path, resize_to=RESIZE)
    x = _nchw(_images(40, seed=1))
    np.testing.assert_array_equal(loaded(x).numpy(), model(x).numpy())
    det = tmu.make_vgg_detector(path, resize_to=RESIZE)
    assert det.name == "vgg16:vgg16.npz"
    np.testing.assert_array_equal(det(x).numpy(), model(x).numpy())
    rand = tmu.make_vgg_detector(seed=1, resize_to=RESIZE)
    assert rand(x).shape == (2, 4096) and rand.name == "vgg16-torch:random-seed1"
    with pytest.raises(FileNotFoundError):
        tmu.make_vgg_detector(str(tmp_path / "missing.npz"))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def test_slerp_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 5, 16)).astype(np.float64)
    t = rng.uniform(0, 1, (5, 1))
    want = np.asarray(jppl.slerp(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32),
                                 jnp.asarray(t, jnp.float32)))
    got = tppl.slerp(torch.from_numpy(a).float(), torch.from_numpy(b).float(),
                     torch.from_numpy(t).float()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _generators():
    g = jsg2.Generator(**G_KW)
    v = g.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
               jnp.zeros((1, ZDIM)), None)
    v = jax.device_get(dict(v))
    tg = tsg2.Generator(**G_KW)
    tg.load_state_dict(bridge.generator_state_dict_from_jax(v))
    return g, v, tg.eval().requires_grad_(False)


@pytest.mark.parametrize("space", ["z", "w"])
def test_ppl_matches_jax_on_jax_latents(space):
    g, v, tg = _generators()
    params, model = _vgg_pair()
    jdet = jmu.Detector(jvgg.VGG16(resize_to=RESIZE).apply, params, "vgg")
    eps, n, bs = 1e-2, 8, 4
    jopts = jmu.MetricOptions(
        generator=lambda z, c: g.apply(v, z, c, noise_mode="const"),
        mapping=lambda z, c: g.apply(v, z, c, method=lambda m, z_, c_: m.mapping(z_, c_)),
        synthesis=lambda ws: g.apply(v, ws, noise_mode="const", method="map_then_synthesize"),
        z_dim=ZDIM, detector=jdet)
    want = jppl.compute_ppl(jopts, num_samples=n, epsilon=eps, space=space, batch_size=bs)

    topts = tmu.MetricOptions(
        generator=lambda z, c: tg(z, c, noise_mode="const"),
        mapping=lambda z, c: tg.mapping(z, c),
        synthesis=lambda ws: tg.synthesis(ws, noise_mode="const"),
        z_dim=ZDIM, detector=tmu.Detector(model, "vgg", torch.device("cpu")))
    rng, dists = jax.random.PRNGKey(0), []
    for _ in range(n // bs):  # the draws of the JAX loop
        rng, k0, k1, _kt = jax.random.split(rng, 4)
        z0 = torch.from_numpy(np.array(jax.random.normal(k0, (bs, ZDIM))))
        z1 = torch.from_numpy(np.array(jax.random.normal(k1, (bs, ZDIM))))
        with torch.no_grad():
            dists.append(tppl.pair_distances(topts, z0, z1, torch.zeros((bs, 1)), eps,
                                             space).numpy())
    got = tppl.filtered_mean(np.concatenate(dists))
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_ppl2_wend_is_registered_and_needs_ws(tmp_path):
    from gantrack_tpu_torch.tools.calc_metrics import evaluate_metrics

    _, _, tg = _generators()
    registry.check_metric("ppl2_wend")
    det = tmu.make_vgg_detector(seed=0, resize_to=RESIZE)
    opts = tmu.MetricOptions(generator=lambda z, c: tg(z, c, noise_mode="const"), z_dim=ZDIM,
                             detector=det)
    with pytest.raises(ValueError, match="mapping"):
        tppl.compute_ppl(opts, num_samples=4)

    class Data:
        num_channels = 1

    calls = []
    real = tppl.compute_ppl

    def short(opts, **kw):  # the registry's 50k samples, cut to 8
        calls.append(kw)
        return real(opts, **dict(kw, num_samples=8))

    tppl.compute_ppl = short
    try:
        out = evaluate_metrics(tg, ["ppl2_wend"], Data(), det, torch.device("cpu"), batch_size=4,
                               run_dir=str(tmp_path))
    finally:
        tppl.compute_ppl = real
    assert calls == [dict(num_samples=50000, epsilon=1e-4, space="w", sampling="end")]
    assert np.isfinite(out["ppl2_wend"]) and out["ppl2_wend"] > 0
    assert (tmp_path / "metric-ppl2_wend.jsonl").exists()
