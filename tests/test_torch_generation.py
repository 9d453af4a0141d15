"""The port's generation tools against the JAX package, at a tiny width.

* The framework-free helpers, exact: ``parse_range``, ``parse_vec2``,
  ``make_transform``, ``channel_grid``, and the port's copies of the
  spectra functions (``compute_spectrum_batch``, ``azimuthal_average``).
* ``gen_images`` (truncation ψ and cutoff; StyleGAN3's translate/rotate),
  ``style_mixing`` and ``gen_video`` against the same computation with the
  JAX generator carried over by ``bridge``, on injected latents (JAX's own
  for ``gen_images``, whose seed latents the packages draw differently;
  ``np.random.RandomState`` for the other two, as in the JAX tools):
  uint8 images equal but for ±1 at a truncation edge (float32 rounding
  of two frameworks).
* ``capture_layers``: the hooked layer names equal the names the JAX
  tool's Flax capture gives (StyleGAN2 and StyleGAN3), and their
  activations agree at 1e-4.
* The CLIs end to end on a checkpoint of the port, on the CPU; every PNG
  decodes with the port's reader (``utils.checkpoint.decode_png``).
"""

import copy
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gantrack_tpu.models import stylegan2 as jsg2
from gantrack_tpu.models import stylegan3 as jsg3
from gantrack_tpu.tools import avg_spectra as j_spectra
from gantrack_tpu.tools import capture_layers as j_capture
from gantrack_tpu.tools import gen_images as j_gen
from gantrack_tpu_torch.models import bridge
from gantrack_tpu_torch.models import stylegan2 as tsg2
from gantrack_tpu_torch.models import stylegan3 as tsg3
from gantrack_tpu_torch.tools import avg_spectra, capture_layers, gen_images, gen_video
from gantrack_tpu_torch.tools import style_mixing
from gantrack_tpu_torch.utils.checkpoint import decode_png

torch.set_num_threads(1)

RES, ZDIM = 16, 8
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
def _pair(cfg):
    """A JAX generator with perturbed weights and the port's copy of it."""
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


def _u8(img_nhwc):
    return np.clip((np.asarray(img_nhwc) + 1) * 127.5, 0, 255).astype(np.uint8)


def _assert_u8_close(got, want):
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.02, (diff.max(), (diff > 0).mean())


def _jax_z(seed):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (1, ZDIM)))


# ----------------------------------------------------------------- helpers

def test_helpers_equal_jax():
    for s in ("0-3", "1,2,5-10", "7"):
        assert gen_images.parse_range(s) == j_gen.parse_range(s)
    assert gen_images.parse_vec2("0.25,-1") == j_gen.parse_vec2("0.25,-1")
    for translate, angle in (((0, 0), 0.0), ((0.25, -0.5), 33.0), ((1, 2), -270.0)):
        np.testing.assert_array_equal(gen_images.make_transform(translate, angle),
                                      j_gen.make_transform(translate, angle))
    x = np.random.default_rng(0).standard_normal((5, 6, 11)).astype(np.float32)
    for max_channels in (64, 4):
        np.testing.assert_array_equal(capture_layers.channel_grid(x, max_channels),
                                      j_capture.channel_grid(x, max_channels))


def test_spectra_copies_equal_jax():
    imgs = np.random.default_rng(1).standard_normal((3, 16, 20))
    for beta in (8.0, 2.0):
        spec = avg_spectra.compute_spectrum_batch(imgs, beta)
        np.testing.assert_array_equal(spec, j_spectra.compute_spectrum_batch(imgs, beta))
    spec = avg_spectra.compute_spectrum_batch(imgs[:, :, :16])
    for bins in (None, 5):
        np.testing.assert_array_equal(avg_spectra.azimuthal_average(spec, bins),
                                      j_spectra.azimuthal_average(spec, bins))


def test_decode_png_reads_what_the_writer_writes():
    from gantrack_tpu_torch.utils.checkpoint import encode_png

    rng = np.random.default_rng(0)
    for pixels in (rng.integers(0, 256, (9, 13), dtype=np.uint8),
                   rng.integers(0, 256, (7, 5, 3), dtype=np.uint8)):
        data = encode_png(pixels)
        np.testing.assert_array_equal(decode_png(data), pixels)
        broken = bytearray(data)
        broken[40] ^= 1  # inside the IDAT chunk
        with pytest.raises(ValueError, match="CRC"):
            decode_png(bytes(broken))


# ------------------------------------------------------- generation parity

@pytest.mark.parametrize("psi,cutoff", [(1.0, None), (0.7, None), (0.5, 2)])
def test_gen_images_matches_jax(psi, cutoff, tmp_path, monkeypatch):
    g, v, tg = _pair("stylegan2")
    monkeypatch.setattr(gen_images, "seed_latent", lambda seed, z_dim: torch.from_numpy(
        _jax_z(seed)))
    paths = gen_images.generate(tg, [3, 11], str(tmp_path), psi, cutoff)
    assert [os.path.basename(p) for p in paths] == ["seed0003.png", "seed0011.png"]
    for seed, path in zip([3, 11], paths):
        want = g.apply(v, jnp.asarray(_jax_z(seed)), None, truncation_psi=psi,
                       truncation_cutoff=cutoff, noise_mode="const")
        with open(path, "rb") as f:
            _assert_u8_close(decode_png(f.read()), _u8(want)[0, :, :, 0])


def test_gen_images_stylegan3_transform_matches_jax():
    g, v, tg = _pair("stylegan3")
    tg = copy.deepcopy(tg)  # the transform is set in place
    translate, rotate = (0.25, -0.125), 30.0
    assert gen_images.set_input_transform(tg, translate, rotate)
    vt = jax.tree.map(lambda x: x, v)
    vt["consts"]["synthesis"]["input"]["transform"] = jnp.asarray(
        np.linalg.inv(j_gen.make_transform(translate, rotate)))
    z = _jax_z(5)
    want = g.apply(vt, jnp.asarray(z), None, noise_mode="const")
    with torch.no_grad():
        got = gen_images.to_uint8(tg(torch.from_numpy(z), None))
    _assert_u8_close(got[0, :, :, 0], _u8(want)[0, :, :, 0])
    plain = g.apply(v, jnp.asarray(z), None)
    assert np.abs(_u8(plain).astype(int) - _u8(want).astype(int)).max() > 8  # it moved


def test_style_mixing_matches_jax():
    g, v, tg = _pair("stylegan2")
    rows, cols, styles, psi = [0, 1], [2, 3, 4], [0, 1, 2], 0.8
    got = style_mixing.mixing_grid(tg, rows, cols, styles, psi)
    ws = {s: np.asarray(g.apply(v, jnp.asarray(np.random.RandomState(s).randn(1, ZDIM),
                                                jnp.float32), None, truncation_psi=psi,
                                method=lambda m, z, c, **kw: m.mapping(z, c, **kw)))[0]
          for s in rows + cols}

    def render(w):
        return _u8(g.apply(v, jnp.asarray(w[None]), noise_mode="const",
                           method="map_then_synthesize"))[0]

    assert got.shape == (3 * RES, 4 * RES, 1)
    for j, cs in enumerate(cols):
        _assert_u8_close(got[:RES, (j + 1) * RES:(j + 2) * RES], render(ws[cs]))
    for i, rs in enumerate(rows):
        _assert_u8_close(got[(i + 1) * RES:(i + 2) * RES, :RES], render(ws[rs]))
        for j, cs in enumerate(cols):
            w = ws[rs].copy()
            w[styles] = ws[cs][styles]
            _assert_u8_close(got[(i + 1) * RES:(i + 2) * RES, (j + 1) * RES:(j + 2) * RES],
                             render(w))


def test_gen_video_frames_match_jax():
    import scipy.interpolate

    g, v, tg = _pair("stylegan2")
    seeds, w_frames = [0, 1, 2, 3], 3  # a 2x1 grid of 2 keyframes, linear loops
    frames = gen_video.render_frames(tg, seeds, (2, 1), None, w_frames, 1.0)
    assert len(frames) == 2 * w_frames and frames[0].shape == (RES, 2 * RES, 1)
    zs = np.stack([np.random.RandomState(s).randn(ZDIM) for s in seeds]).astype(np.float32)
    ws = np.asarray(g.apply(v, jnp.asarray(zs), None,
                            method=lambda m, z, c: m.mapping(z, c))).reshape(1, 2, 2, -1, ZDIM)
    for fi in (0, 2, 4):
        cells = []
        for xi in range(2):
            loop = np.concatenate([ws[0, xi], ws[0, xi][:1]])
            w = scipy.interpolate.interp1d(np.arange(3), loop, kind="linear", axis=0)(
                (fi / w_frames) % 2)
            cells.append(_u8(g.apply(v, jnp.asarray(w[None], jnp.float32), noise_mode="const",
                                     method="map_then_synthesize"))[0])
        _assert_u8_close(frames[fi], np.concatenate(cells, axis=1))


@pytest.mark.parametrize("cfg", ["stylegan2", "stylegan3"])
def test_capture_layer_names_and_values_match_jax(cfg):
    g, v, tg = _pair(cfg)
    z = _jax_z(2)
    _, mods = g.apply(v, jnp.asarray(z), None, noise_mode="const",
                      capture_intermediates=lambda mdl, method: method == "__call__",
                      mutable=["intermediates"])
    want = {k: np.asarray(a) for k, a in
            j_capture.flatten_intermediates(mods["intermediates"]).items() if a.ndim == 4}
    got = capture_layers.capture(tg, lambda: tg(torch.from_numpy(z), None, noise_mode="const"))
    assert set(got) == set(want)
    assert "" in got and "synthesis" in got
    for name, arr in got.items():
        assert tuple(arr.shape) == want[name].shape, name
        np.testing.assert_allclose(arr.float().numpy(), want[name], rtol=1e-4,
                                   atol=1e-4 * max(np.abs(want[name]).max(), 1.0), err_msg=name)


# --------------------------------------------------------- CLIs on the CPU

@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A run dir with a StyleGAN2 checkpoint of the port, and a dataset."""
    from gantrack_tpu_torch.data import pack_shards

    run = tmp_path_factory.mktemp("run")
    os.makedirs(run / "checkpoints")
    torch.manual_seed(0)
    G = tsg2.Generator(z_dim=16, c_dim=0, w_dim=16, img_resolution=RES, img_channels=1,
                       mapping_kwargs=dict(num_layers=2),
                       synthesis_kwargs=dict(channel_base=256, channel_max=16, num_fp16_res=4))
    torch.save({"G_ema": G.state_dict()}, run / "checkpoints" / "state-00000004.pt")
    rng = np.random.default_rng(0)
    images = [rng.uniform(0, 255, (RES, RES, 1)).astype(np.float32) for _ in range(8)]
    data = str(tmp_path_factory.mktemp("data"))
    pack_shards(data, "train", images, [f"p{i // 4}_{i % 4:05d}" for i in range(8)])
    return str(run), data


NET = ["--resolution=16", "--channels=1", "--cbase=256", "--cmax=16", "--map-depth=2",
       "--z-dim=16", "--w-dim=16", "--device=cpu"]


def _png(path):
    with open(path, "rb") as f:
        return decode_png(f.read())


def test_generation_clis_on_a_port_checkpoint(port_run, tmp_path, capsys):
    run, data = port_run
    net = [f"--network={run}", *NET]
    paths = gen_images.main([*net, "--seeds=0-2", "--trunc=0.7", f"--outdir={tmp_path / 'g'}"])
    assert len(paths) == 3 and all(_png(p).shape == (RES, RES) for p in paths)
    again = gen_images.main([*net, "--seeds=1", f"--outdir={tmp_path / 'g2'}", "--trunc=0.7"])
    np.testing.assert_array_equal(_png(again[0]), _png(paths[1]))  # a seed's latent is fixed

    (grid,) = style_mixing.main([*net, "--rows=0-1", "--cols=2-4", "--col-styles=0-2",
                                 f"--outdir={tmp_path / 'm'}"])
    assert _png(grid).shape == (3 * RES, 4 * RES)

    n = gen_video.main([*net, "--seeds=0-3", "--grid=2x1", "--w-frames=2",
                        f"--output={tmp_path / 'v'}"])
    frames = sorted(os.listdir(tmp_path / "v"))
    assert n == 4 and frames[0] == "frame00000.png"
    assert _png(tmp_path / "v" / frames[-1]).shape == (RES, 2 * RES)

    result = avg_spectra.main([*net, f"--data={data}", "--num=8", f"--outdir={tmp_path / 's'}"])
    saved = np.load(tmp_path / "s" / "spectra.npz")
    assert set(saved.files) == {"spec_real", "spec_fake", "az_real", "az_fake"}
    np.testing.assert_array_equal(saved["az_fake"], result["az_fake"])
    assert saved["spec_real"].shape == (RES, RES) and np.isfinite(saved["az_fake"]).all()

    capsys.readouterr()
    assert capture_layers.main([*net, "--seeds=0"]) == {}
    table = capsys.readouterr().out
    assert "synthesis/b16/conv0" in table and "16x16" in table and "bfloat16" in table
    written = capture_layers.main([*net, "--seeds=0-1", "--layer=conv1$", "--save-pngs",
                                   f"--outdir={tmp_path / 'c'}"])
    assert written[0] == ["synthesis/b4/conv1", "synthesis/b8/conv1", "synthesis/b16/conv1"]
    arr = np.load(tmp_path / "c" / "seed0001" / "synthesis_b16_conv1.npy")
    assert arr.shape == (RES, RES, 16) and arr.dtype == np.float32
    assert _png(tmp_path / "c" / "seed0001" / "synthesis_b16_conv1.png").shape == (4 * RES,
                                                                                  4 * RES)
    with pytest.raises(SystemExit, match="matched nothing"):
        capture_layers.main([*net, "--layer=nope", f"--outdir={tmp_path / 'c'}"])


def test_generation_clis_refuse_cuda_without_a_device(port_run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = [a for a in NET if a != "--device=cpu"]
    with pytest.raises(SystemExit, match="--device=cpu"):
        gen_images.main([f"--network={port_run[0]}", *net, "--seeds=0", "--outdir=unused"])
