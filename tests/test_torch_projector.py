"""The port's projector and visualizer against the JAX package, at a tiny
width.

* ``lr_schedule``, ``_noise_reg`` and ``_renorm_noise`` to 1e-6;
  ``compute_w_stats`` on JAX's latents to 1e-5; ``_split_ids`` exact.
* Five ``project`` steps (w and the noise buffers under Adam, a VGG16
  LPIPS term of ``resize_to`` 32 carried over by ``bridge``, the pixel
  term and the noise regulariser) against the JAX ``project`` with the
  noise init and the per-step w-noise that JAX draws handed in: the
  per-step losses and their terms at rel 1e-4, ``w_history`` and the final
  noise at 1e-4, ``best_step`` exact.
* ``projection_loop`` and the CLI write the per-slice artifacts; the PNGs
  decode with the port's reader.
* ``RenderEngine`` against the JAX engine on JAX's latents (ψ, blending,
  style mixing, StyleGAN3's transform sliders, the layer view), and the
  HTTP routes.
"""

import functools
import json
import os
import pickle
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gantrack_tpu.models import stylegan2 as jsg2
from gantrack_tpu.models import stylegan3 as jsg3
from gantrack_tpu.models import vgg as jvgg
from gantrack_tpu.tools import projector as jproj
from gantrack_tpu.tools import visualizer as jvis
from gantrack_tpu_torch.models import bridge
from gantrack_tpu_torch.models import stylegan2 as tsg2
from gantrack_tpu_torch.models import stylegan3 as tsg3
from gantrack_tpu_torch.models import vgg as tvgg
from gantrack_tpu_torch.tools import projector as tproj
from gantrack_tpu_torch.tools import visualizer as tvis
from gantrack_tpu_torch.utils.checkpoint import decode_png

torch.set_num_threads(1)

RES, ZDIM, RESIZE = 16, 8, 32
SG2_KW = dict(z_dim=ZDIM, c_dim=0, w_dim=ZDIM, img_resolution=RES, img_channels=1,
              mapping_kwargs=dict(num_layers=2),
              synthesis_kwargs=dict(channel_base=256, channel_max=32, num_fp16_res=0))
SG3_KW = dict(z_dim=ZDIM, c_dim=0, w_dim=ZDIM, img_resolution=RES, img_channels=1,
              channel_base=1024, channel_max=32, num_fp16_res=0,
              synthesis_kwargs=dict(num_layers=4))


def _perturb(tree, seed=0, scale=0.2):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(np.shape(a)).astype(np.float32),
        tree)


@functools.lru_cache(maxsize=None)
def _pair(cfg="stylegan2"):
    if cfg == "stylegan2":
        g = jsg2.Generator(**SG2_KW)
        v = dict(jax.device_get(g.init({"params": jax.random.PRNGKey(0),
                                        "noise": jax.random.PRNGKey(1)},
                                       jnp.zeros((1, ZDIM)), None)))
        v["params"] = _perturb(v["params"])
        v["emas"] = _perturb(v["emas"], 1)
        tg = tsg2.Generator(**SG2_KW)
        tg.load_state_dict(bridge.generator_state_dict_from_jax(v))
    else:
        g = jsg3.Generator(**SG3_KW)
        v = dict(jax.device_get(g.init({"params": jax.random.PRNGKey(0)},
                                       jnp.zeros((1, ZDIM)), None)))
        v["params"] = _perturb(v["params"], scale=0.05)
        tg = tsg3.Generator(**SG3_KW)
        tg.load_state_dict(bridge.sg3_generator_state_dict_from_jax(v))
    return g, v, tg.eval().requires_grad_(False)


# ------------------------------------------------------------- projector

def test_schedule_regulariser_and_renorm_match_jax():
    cfg = jproj.ProjectorConfig(num_steps=40)
    for i in range(41):
        np.testing.assert_allclose(tproj.lr_schedule(i, cfg),
                                   float(jproj.lr_schedule(jnp.float32(i), cfg)),
                                   rtol=1e-6, atol=1e-7)
    rng = np.random.default_rng(0)
    for shape in ((4, 4), (16, 16), (32, 32)):
        buf = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
        np.testing.assert_allclose(float(tproj._noise_reg(torch.from_numpy(buf))),
                                   float(jproj._noise_reg(jnp.asarray(buf))), rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(tproj._renorm_noise(torch.from_numpy(buf)).numpy(),
                                   np.asarray(jproj._renorm_noise(jnp.asarray(buf))),
                                   rtol=1e-6, atol=1e-6)
    for name in ("P1/CT/slice_00012.png", "P3_00007", "stem", "a/b/xx.png"):
        assert tproj._split_ids(name, 5) == jproj._split_ids(name, 5)


def test_w_stats_match_jax():
    g, v, tg = _pair()
    want_avg, want_std = jproj.compute_w_stats(g, v, ZDIM, 64, seed=7)
    z = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(7), (64, ZDIM))))
    got_avg, got_std = tproj.compute_w_stats(tg, 64, z=z)
    np.testing.assert_allclose(got_avg.numpy(), np.asarray(want_avg), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_std, want_std, rtol=1e-5)


def _jax_draws(v, cfg, w_dim):
    """The noise init and the per-step w-noise the JAX ``project`` draws,
    by the port's buffer names."""
    leaves = jax.tree_util.tree_flatten_with_path(v["noise_consts"])[0]
    keys = jax.random.split(jax.random.PRNGKey(cfg.seed + 1), len(leaves))
    noise = {}
    for key, (path, leaf) in zip(keys, leaves):
        name = ".".join(p.key for p in path[1:])  # drop "synthesis"
        noise[name] = torch.from_numpy(np.array(jax.random.normal(key, leaf.shape)))
    rng, w_noise = jax.random.PRNGKey(cfg.seed), []
    for _ in range(cfg.num_steps):
        rng, k = jax.random.split(rng)
        w_noise.append(torch.from_numpy(np.array(jax.random.normal(k, (1, 1, w_dim)))))
    return noise, w_noise


@pytest.mark.parametrize("optimize_noise", [True, False])
def test_project_steps_match_jax(optimize_noise):
    g, v, tg = _pair()
    vp = jax.device_get(jvgg.random_params(jax.random.PRNGKey(4), resize_to=RESIZE))
    jmodel = jvgg.VGG16(resize_to=RESIZE)
    vgg = tvgg.VGG16(RESIZE)
    vgg.load_state_dict(bridge.flax_state_dict_from_jax(vp))
    vgg = vgg.eval().requires_grad_(False)
    target = np.tanh(np.random.default_rng(3).standard_normal((RES, RES, 1))).astype(np.float32)
    w_init = np.asarray(g.apply(v, jnp.asarray(np.random.default_rng(4).standard_normal(
        (1, ZDIM)), jnp.float32), None, method=lambda m, z, c: m.mapping(z, c)))[0]
    cfg = jproj.ProjectorConfig(num_steps=5, optimize_noise=optimize_noise,
                                w_lpips_weight=1.0, w_pix_weight=0.01)
    want = jproj.project(g, v, target, jax.jit(lambda x: jvgg.lpips_features(jmodel, vp, x)),
                         cfg, w_init=w_init)
    noise, w_noise = _jax_draws(v, cfg, ZDIM)
    tcfg = tproj.ProjectorConfig(num_steps=5, optimize_noise=optimize_noise)
    got = tproj.project(tg, target, lambda x: tvgg.lpips_features(vgg, x), tcfg, w_init=w_init,
                        noise_init=noise, w_noise=w_noise)
    for key in ("losses", "pix_losses", "lpips_losses", "reg_losses"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)
    assert got["best_step"] == want["best_step"]
    np.testing.assert_allclose(got["w_history"], want["w_history"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["w"], want["w"], rtol=1e-4, atol=1e-4)
    assert got["losses"][-1] < got["losses"][0]
    if optimize_noise:
        want_noise = {".".join(p.key for p in path[1:]): np.asarray(x) for path, x in
                      jax.tree_util.tree_flatten_with_path(want["noise"])[0]}
        assert set(got["noise"]) == set(want_noise)
        for name, buf in got["noise"].items():
            np.testing.assert_allclose(buf, want_noise[name], rtol=1e-4, atol=1e-4, err_msg=name)
            np.testing.assert_allclose([buf.mean(), np.sqrt(np.mean(buf ** 2))], [0, 1],
                                       atol=1e-5)
    else:
        assert got["noise"] is None and want["noise"] is None


def test_project_leaves_the_generator_and_stops_early():
    _, _, tg = _pair()
    before = {k: t.clone() for k, t in tg.state_dict().items()}
    target = np.zeros((RES, RES, 1), np.float32)
    cfg = tproj.ProjectorConfig(num_steps=30, w_avg_samples=32, early_stopping=2,
                                initial_learning_rate=5.0)
    out = tproj.project(tg, target, cfg=cfg)
    for k, t in tg.state_dict().items():
        assert torch.equal(t, before[k]), k  # noise_const buffers included
    n = len(out["losses"])
    assert n < 30 and out["w_history"].shape == (n, 1, ZDIM)
    assert n - 1 - out["best_step"] == 2  # stopped 2 steps without improvement
    assert out["w"].shape == (tg.num_ws, ZDIM)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    from gantrack_tpu_torch.data import pack_shards

    run = tmp_path_factory.mktemp("run")
    os.makedirs(run / "checkpoints")
    torch.manual_seed(0)
    G = tsg2.Generator(z_dim=16, c_dim=0, w_dim=16, img_resolution=RES, img_channels=1,
                       mapping_kwargs=dict(num_layers=2),
                       synthesis_kwargs=dict(channel_base=256, channel_max=16, num_fp16_res=0))
    torch.save({"G_ema": G.state_dict()}, run / "checkpoints" / "state-00000004.pt")
    rng = np.random.default_rng(0)
    images = [rng.uniform(0, 255, (RES, RES, 1)).astype(np.float32) for _ in range(4)]
    data = str(tmp_path_factory.mktemp("data"))
    pack_shards(data, "train", images, ["p0_00000", "p0_00001", "p1_00000", "p1_00001"])
    return str(run), data, G


def test_projection_loop_and_cli_write_artifacts(port_run, tmp_path, monkeypatch):
    from gantrack_tpu_torch.data import open_dataset

    run, data, G = port_run
    G = G.eval().requires_grad_(False)
    cfg = tproj.ProjectorConfig(num_steps=2, w_avg_samples=16)
    out = str(tmp_path / "loop")
    projected = tproj.projection_loop(G, open_dataset(data), out, cfg, first_slice_steps=3,
                                      verbose=False)
    assert set(projected) == {"p0", "p1"} and set(projected["p0"]) == {0, 1}
    with open(os.path.join(out, "projected_w"), "rb") as f:
        assert set(pickle.load(f)) == {"p0", "p1"}
    (npz,) = os.listdir(os.path.join(out, "p0", "projections"))[:1]
    assert np.load(os.path.join(out, "p0", "projections", npz))["w"].shape == (1, G.num_ws, 16)
    (png,) = [f for f in os.listdir(os.path.join(out, "p1", "M0", "image_log"))
              if f.startswith("img_00001")]
    with open(os.path.join(out, "p1", "M0", "image_log", png), "rb") as f:
        assert decode_png(f.read()).shape == (RES, 2 * RES)  # target | synthesis
    with open(os.path.join(out, "p1", "loss", "opt_loss_00001.csv")) as f:
        assert len(f.read().splitlines()) == 1 + 2

    # The CLI, with the LPIPS network from a flat .npz; a patient's first
    # slice cut from the loop's 1000 steps to 2.
    monkeypatch.setattr(tproj, "projection_loop", functools.partial(
        tproj.projection_loop, first_slice_steps=2))
    vgg_npz = str(tmp_path / "vgg.npz")
    sd = tvgg.random_vgg(0, resize_to=224).state_dict()
    np.savez(vgg_npz, **{k.replace(".weight", "/kernel").replace(".bias", "/bias"):
                         (v.permute(2, 3, 1, 0) if v.ndim == 4 else v.T if v.ndim == 2 else v)
                         .numpy() for k, v in sd.items()})
    projected = tproj.main([f"--network={run}", "--resolution=16", "--channels=1",
                            "--cbase=256", "--cmax=16", "--map-depth=2", "--z-dim=16",
                            "--w-dim=16", "--device=cpu", f"--data={data}",
                            f"--outdir={tmp_path / 'cli'}", "--max-items=1",
                            f"--vgg-weights={vgg_npz}", "--num-steps=2"])
    assert list(projected) == ["p0"]
    with open(tmp_path / "cli" / "p0" / "loss" / "opt_loss_00000.csv") as f:
        rows = f.read().splitlines()
    assert len(rows) == 1 + 2 and float(rows[-1].split(",")[3]) > 0  # lpips term on


# ------------------------------------------------------------ visualizer

def _engines(cfg, monkeypatch):
    g, v, tg = _pair(cfg)
    jeng = jvis.RenderEngine(g, v, channels=1)
    teng = tvis.RenderEngine(tg, channels=1)
    monkeypatch.setattr(teng, "latent", lambda seed: torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(int(seed)), (1, ZDIM)))))
    return jeng, teng


def _close_u8(got, want):
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.02, (diff.max(), (diff > 0).mean())


def test_render_engine_matches_jax(monkeypatch):
    jeng, teng = _engines("stylegan2", monkeypatch)
    for kw in (dict(seed=3, psi=0.7), dict(seed=3, seed2=5, blend=0.4),
               dict(seed=3, mix_seed=7, mix_cutoff=2), dict(seed=1, psi=-0.5)):
        _close_u8(teng.render(**kw), jeng.render(**kw))
    np.testing.assert_allclose(teng._ws(3, 0.6, 5, 0.25, 7, 3), jeng._ws(3, 0.6, 5, 0.25, 7, 3),
                               rtol=1e-5, atol=1e-5)
    acts = teng.layer_activations(seed=2, psi=0.8)
    want = jeng.layer_activations(seed=2, psi=0.8)
    assert set(acts) == set(want) and set(teng.layer_shapes()) == set(jeng.layer_shapes())
    for name, a in acts.items():
        assert tuple(a.shape) == tuple(np.shape(want[name])) == teng.layer_shapes()[name]
        np.testing.assert_allclose(a.numpy(), np.asarray(want[name]), rtol=1e-4,
                                   atol=1e-4 * max(np.abs(np.asarray(want[name])).max(), 1.0),
                                   err_msg=name)


def test_render_engine_stylegan3_transform_matches_jax(monkeypatch):
    jeng, teng = _engines("stylegan3", monkeypatch)
    assert teng.has_transform
    before = teng.input.transform.clone()
    for kw in (dict(seed=0), dict(seed=0, tx=0.25, rotate=45.0), dict(seed=4, ty=-0.5, psi=0.5)):
        _close_u8(teng.render(**kw), jeng.render(**kw))
    assert torch.equal(teng.input.transform, before)  # the sliders' transform is put back
    assert not np.array_equal(teng.render(seed=0), teng.render(seed=0, tx=0.25, rotate=45.0))


def test_http_routes():
    _, _, tg = _pair("stylegan2")
    eng = tvis.RenderEngine(tg, channels=1)
    httpd = tvis.serve(eng, "127.0.0.1", 0)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{port}"
        assert b"visualizer" in urllib.request.urlopen(f"{base}/").read()
        info = json.loads(urllib.request.urlopen(f"{base}/api/info").read())
        assert info["resolution"] == RES and not info["has_transform"]
        assert info["num_ws"] == tg.num_ws
        r = urllib.request.urlopen(f"{base}/api/render?seed=1&psi=0.9&mix_seed=4&mix_cutoff=3")
        assert r.headers["Content-Type"] == "image/png" and float(r.headers["X-Render-Ms"]) > 0
        np.testing.assert_array_equal(
            decode_png(r.read()), eng.render(seed=1, psi=0.9, mix_seed=4, mix_cutoff=3))
        layers = json.loads(urllib.request.urlopen(f"{base}/api/layers").read())["layers"]
        names = [layer["name"] for layer in layers]
        assert "synthesis/b16/conv0" in names
        assert layers[names.index("synthesis/b16/conv0")]["shape"] == [RES, RES, 16]
        q = urllib.request.quote("synthesis/b8/conv1")
        img = decode_png(urllib.request.urlopen(f"{base}/api/layer?name={q}&seed=1").read())
        assert img.shape == (6 * 8, 6 * 8)  # 32 channels of 8x8: a 6x6 grid
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/api/layer?name=nope&seed=1")
        assert ei.value.code == 500
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/missing")
        assert ei.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
