"""NVIDIA network pickles in the port, against the JAX package's route.

No NVIDIA tree is needed: the pickles hold stand-ins for the reference's
networks (``chip_smoke.reference_stand_in``), the port's own modules with
the reference's names, its filter buffers in the state dict, the
``in_channels`` / ``out_channels`` its layers carry, D's minibatch-std
settings on NVIDIA's ``b4.mbstd`` layer and, in one of each
pair of cases, NVIDIA's ``init_kwargs`` (without them the architecture
comes from the tensor shapes).  At 32² (StyleGAN3: 4 layers), float32:

* the same pickle through the JAX ``state_dict_from_pickle`` and generator
  and through the port's ``resolve_network`` and ``gen_images.load_generator``:
  images at ``rtol = atol = 1e-4`` (``tests/test_torch_stylegan2.py``'s
  tolerance), StyleGAN2 and StyleGAN3-T;
* ``train --resume=<pkl>``: the state the CLI builds equals a transplant
  into the fresh state bit for bit (weights and buffers; Adam, ``p``,
  ``pl_mean`` and the counters fresh), and the CLI trains a step from it;
  flags that do not match the pickle (widths, minibatch-std group, bf16
  resolutions) fail with a named error;
* ``calc_metrics`` and ``gen_images`` on a pickle;
* ``import_torch_pickle``: the checkpoint holds the pickle's weights,
  and ``--resume`` and the tools read it;
* ROADMAP C14 at cbase 16384 / cmax 64: the JAX tool infers cbase 256
  from the 4² width and its transplant raises on the first shape, where
  the port's tool converts the pickle with its weights;
* ``convert_detector``: the port's ``.npz`` equals the JAX tool's on a
  random torchvision-layout InceptionV3 state dict, through the
  converters and through both CLIs (a state-dict file and a TorchScript
  archive); the port's InceptionV3 loads it.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from gantrack_tpu_torch.models import torch_compat
from gantrack_tpu_torch.models.stylegan2 import Discriminator
from gantrack_tpu_torch.tools import calc_metrics, gen_images, import_torch_pickle
from gantrack_tpu_torch.tools import train as cli
from gantrack_tpu_torch.utils.checkpoint import resolve_network

torch.set_num_threads(1)

RES, ZDIM = 32, 16
TOL = dict(rtol=1e-4, atol=1e-4)


def _nets(cfg, cbase, cmax, seed=0, res=RES, zdim=ZDIM):
    """G, D and G_ema of the port with perturbed weights (so that biases,
    noise strengths and the rest are not at their zero init)."""
    torch.manual_seed(seed)
    kw = dict(resolution=res, channels=1, c_dim=0, cbase=cbase, cmax=cmax, map_depth=2,
              num_fp16_res=0, z_dim=zdim, w_dim=zdim,
              num_layers=None if cfg == "stylegan2" else 4)
    G = cli.make_generator(cfg, **kw)
    D = Discriminator(c_dim=0, img_resolution=res, img_channels=1, channel_base=cbase,
                      channel_max=cmax, num_fp16_res=0,
                      epilogue_kwargs=dict(mbstd_group_size=2))
    G_ema = cli.make_generator(cfg, **kw)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for net in (G, D, G_ema):
            for p in net.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return G.eval(), D.eval(), G_ema.eval()


def _pickle(path, cfg="stylegan2", cbase=256, cmax=64, init_kwargs=True, seed=0, res=RES,
            zdim=ZDIM):
    """A stand-in NVIDIA pickle at ``path``; returns the port's networks in it."""
    G, D, G_ema = _nets(cfg, cbase, cmax, seed, res, zdim)
    mult = 2 if cfg == "stylegan3-r" else 1
    g_kw = d_kw = None
    if init_kwargs:
        common = dict(c_dim=0, img_resolution=res, img_channels=1)
        syn = dict(channel_base=cbase * mult, channel_max=cmax * mult, num_fp16_res=0,
                   conv_clamp=256)
        if cfg == "stylegan2":  # StyleGAN2-ADA nests them, the StyleGAN3 tree does not
            g_kw = dict(z_dim=zdim, w_dim=zdim, mapping_kwargs={"num_layers": 2},
                        synthesis_kwargs=syn, **common)
        else:
            g_kw = dict(z_dim=zdim, w_dim=zdim, mapping_kwargs={"num_layers": 2},
                        num_layers=4, **syn, **common)
        d_kw = dict(channel_base=cbase, channel_max=cmax, num_fp16_res=0, conv_clamp=256,
                    epilogue_kwargs={"mbstd_group_size": 2}, **common)
    chip_smoke.write_reference_pickle(str(path), G, D, G_ema, g_kw, d_kw)
    return G, D, G_ema


def _jax_images(path, cfg, z):
    from gantrack_tpu.models import stylegan2 as jsg2
    from gantrack_tpu.models import stylegan3 as jsg3
    from gantrack_tpu.models.torch_compat import state_dict_from_pickle

    state = state_dict_from_pickle(str(path))
    kw = dict(z_dim=ZDIM, c_dim=0, w_dim=ZDIM, img_resolution=RES, img_channels=1,
              mapping_kwargs=dict(num_layers=2))
    if cfg == "stylegan2":
        g = jsg2.Generator(**kw, synthesis_kwargs=dict(channel_base=256, channel_max=64,
                                                       num_fp16_res=0))
        extra = dict(noise_mode="const")
    else:
        g = jsg3.Generator(**kw, channel_base=256, channel_max=64, num_fp16_res=0,
                           synthesis_kwargs=dict(num_layers=4))
        extra = {}
    variables = {"params": state["params_g_ema"], "emas": state["emas_g"], **state["consts_g"]}
    return np.asarray(g.apply(variables, jnp.asarray(z), None, **extra))  # NHWC


@pytest.mark.parametrize("init_kwargs", [True, False], ids=["init_kwargs", "shapes"])
@pytest.mark.parametrize("cfg", ["stylegan2", "stylegan3-t"])
def test_pickle_images_match_jax(cfg, init_kwargs, tmp_path):
    path = tmp_path / "network-snapshot-000100.pkl"
    _pickle(path, cfg, init_kwargs=init_kwargs)
    z = np.random.default_rng(3).standard_normal((3, ZDIM)).astype(np.float32)
    want = _jax_images(path, cfg, z)

    payload, got_path = resolve_network(str(path))
    arch = payload["architecture"]
    assert got_path == str(path) and arch["cfg"] == cfg and arch["map_depth"] == 2
    assert arch["cmax"] == 64 and (arch["cbase"] == 256 or not init_kwargs)
    opts = gen_images.build_parser().parse_args([f"--network={path}", "--seeds=0",
                                                 "--outdir=unused", "--device=cpu"])
    G = gen_images.load_generator(opts, torch.device("cpu"))
    assert (opts.cfg, opts.resolution, opts.channels, opts.z_dim) == (cfg, RES, 1, ZDIM)
    with torch.no_grad():
        got = G(torch.from_numpy(z), None, noise_mode="const").permute(0, 2, 3, 1).numpy()
    print(f"{cfg}: largest difference from JAX {np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, **TOL)


def test_architecture_from_pickle_reads_stylegan3_r(tmp_path):
    for init_kwargs in (True, False):
        _pickle(tmp_path / "r.pkl", "stylegan3-r", init_kwargs=init_kwargs)
        arch = resolve_network(str(tmp_path / "r.pkl"))[0]["architecture"]
        assert (arch["cfg"], arch["cbase"], arch["cmax"], arch["num_layers"]) == \
            ("stylegan3-r", 256, 64, 4)


@pytest.mark.parametrize("init_kwargs", [True, False], ids=["init_kwargs", "layer"])
def test_minibatch_std_is_read_from_the_reference_layout(init_kwargs, tmp_path):
    """The stand-in's D keeps its minibatch-std settings where NVIDIA's
    does (``b4.mbstd``, and ``epilogue_kwargs`` in ``init_kwargs``), not
    on the port's epilogue attributes; its group size 2 is not the
    default 4.  With neither source the architecture is refused."""
    path = tmp_path / "m.pkl"
    _pickle(path, init_kwargs=init_kwargs)
    _, d, g_ema = torch_compat.load_network_pickle(str(path))
    assert not hasattr(d.b4, "mbstd_group_size") and d.b4.mbstd.group_size == 2
    arch = torch_compat.architecture_from_pickle(g_ema, d)
    assert (arch["mbstd_group"], arch["mbstd_channels"]) == (2, 1)
    del d.b4.mbstd
    d.init_kwargs = {}
    with pytest.raises(ValueError, match="names no minibatch-std group size"):
        torch_compat.architecture_from_pickle(g_ema, d)


def test_flags_that_do_not_match_a_pickle_are_named(tmp_path):
    path = tmp_path / "n.pkl"
    _pickle(path)
    for flag, match in (("--cbase=512", "--cbase=512"), ("--cfg=stylegan3-t", "--cfg"),
                        ("--map-depth=8", "--map-depth"), ("--resolution=64", "--resolution")):
        opts = gen_images.build_parser().parse_args([f"--network={path}", "--seeds=0",
                                                     "--outdir=x", "--device=cpu", flag])
        with pytest.raises(SystemExit, match=match):
            gen_images.load_generator(opts, torch.device("cpu"))
    # The same widths from another --cbase pass: the check holds the widths.
    opts = gen_images.build_parser().parse_args([f"--network={path}", "--seeds=0", "--outdir=x",
                                                 "--device=cpu", "--cbase=260", "--cmax=64"])
    gen_images.load_generator(opts, torch.device("cpu"))


def test_a_filter_that_differs_is_refused(tmp_path):
    G, D, G_ema = _nets("stylegan2", 256, 64)
    sd = chip_smoke.reference_stand_in(G).state_dict()
    assert "synthesis.b8.conv0.resample_filter" in sd
    sd["synthesis.b8.conv0.resample_filter"] = sd["synthesis.b8.conv0.resample_filter"] * 1.01
    with pytest.raises(ValueError, match="resample_filter"):
        torch_compat.load_weights(G_ema, sd, "G")
    sd = chip_smoke.reference_stand_in(G).state_dict()
    sd["synthesis.b8.conv0.extra"] = torch.zeros(1)
    with pytest.raises(ValueError, match="unexpected tensor synthesis.b8.conv0.extra"):
        torch_compat.load_weights(G_ema, sd, "G")


# ------------------------------------------------------------------ the CLIs


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from gantrack_tpu_torch.data import pack_shards

    out = str(tmp_path_factory.mktemp("data"))
    rng = np.random.default_rng(0)
    images = [rng.uniform(0, 255, (RES, RES, 1)).astype(np.float32) for _ in range(8)]
    pack_shards(out, "train", images, [f"s{i}" for i in range(len(images))])
    return out


TRAIN = ["--cfg=stylegan2", "--batch=4", "--gamma=0.4096", "--cbase=256", "--cmax=64",
         "--map-depth=2", "--glr=0.0025", "--dlr=0.0025", "--aug=ada", "--metrics=none",
         "--mbstd-group=2", "--device=cpu", "--fp32=1"]


def _state_tensors(state) -> dict:
    out = {}
    for name in ("G", "D", "G_ema"):
        out.update({f"{name}.{k}": v for k, v in getattr(state, name).state_dict().items()})
    for name in ("opt_g", "opt_d"):
        out[f"{name}.state"] = len(getattr(state, name).state)
    out.update(pl_mean=state.pl_mean, ada_p=state.ada_p, step=state.step,
               cur_nimg=state.cur_nimg)
    return out


def test_resume_from_a_pickle_equals_a_transplant(dataset, tmp_path):
    path = tmp_path / "network-snapshot-000200.pkl"
    _, _, G_ema = _pickle(path, seed=4, zdim=512)  # the CLI's z and w
    argv = [f"--outdir={tmp_path / 'runs'}", f"--data={dataset}", *TRAIN]
    opts = cli.build_parser().parse_args([*argv, f"--resume={path}"])
    _, loader, resumed, stepper = cli.build_training(cli.resolve_config(opts), opts,
                                                     torch.device("cpu"))
    loader.close()
    assert stepper.cfg.ema_rampup is None and stepper.cfg.ada_kimg == 100  # the resume rule
    opts = cli.build_parser().parse_args(argv)
    _, loader, fresh, _ = cli.build_training(cli.resolve_config(opts), opts, torch.device("cpu"))
    loader.close()
    torch_compat.transplant_into_state(fresh, *torch_compat.load_network_pickle(str(path)))
    want, got = _state_tensors(fresh), _state_tensors(resumed)
    assert set(got) == set(want)
    for k in want:
        assert (torch.equal(got[k], want[k]) if isinstance(want[k], torch.Tensor)
                else got[k] == want[k]), k
    for k, v in G_ema.state_dict().items():  # the pickle's G_ema, bit for bit
        assert torch.equal(resumed.G_ema.state_dict()[k], v), k
    assert resumed.step == 0 and resumed.opt_g.state == {} and float(resumed.ada_p) == 0

    # The CLI trains on from it; the tick record carries the JAX fields.
    run_dir = cli.main([*argv, f"--resume={path}", "--kimg=0", "--tick=1", "--snap=1"])
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        (record,) = [json.loads(line) for line in f]
    assert record["Progress/kimg"] == 0.004 and record["Resources/cpu_mem_gb"] > 0
    assert not any(k in record for k in ("Resources/peak_gpu_mem_gb",
                                         "Resources/gb_in_use"))  # none on the CPU

    for flag, match in (("--cbase=512", "--resume: --cbase=512 --cmax=64"),
                        ("--mbstd-group=4", "--resume: --mbstd-group=4 .* mbstd_group 2"),
                        ("--fp32=0", "--resume: --num-fp16-res .*=4 .* num_fp16_res 0")):
        bad = cli.build_parser().parse_args([*argv, f"--resume={path}", flag])
        with pytest.raises(SystemExit, match=match):
            cli.build_training(cli.resolve_config(bad), bad, torch.device("cpu"))


def test_calc_metrics_and_gen_images_on_a_pickle(dataset, tmp_path):
    from gantrack_tpu_torch.utils.checkpoint import decode_png

    path = tmp_path / "network-snapshot-000300.pkl"
    _pickle(path, seed=5)
    results = calc_metrics.main([f"--network={path}", "--metrics=fid1k", f"--data={dataset}",
                                 "--device=cpu", "--batch=50"])
    assert np.isfinite(results["fid1k"])
    with open(tmp_path / "metric-fid1k.jsonl") as f:
        (row,) = [json.loads(line) for line in f]
    assert row["snapshot_path"] == str(path)
    with pytest.raises(SystemExit, match="--cbase=1024"):
        calc_metrics.main([f"--network={path}", "--metrics=fid1k", f"--data={dataset}",
                           "--device=cpu", "--cbase=1024"])
    paths = gen_images.main([f"--network={path}", "--seeds=0-1", "--trunc=0.7",
                             f"--outdir={tmp_path / 'img'}", "--device=cpu"])
    for p in paths:
        with open(p, "rb") as f:
            assert decode_png(f.read()).shape == (RES, RES)


def test_import_torch_pickle_round_trip(dataset, tmp_path):
    path = tmp_path / "network-snapshot-000400.pkl"
    G, D, G_ema = _pickle(path, seed=6, init_kwargs=False, zdim=512)
    ckpt = import_torch_pickle.main([f"--src={path}", f"--dst={tmp_path / 'ckpt'}"])
    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    for name, net in (("G", G), ("D", D), ("G_ema", G_ema)):
        assert set(payload[name]) == set(net.state_dict())
        for k, v in net.state_dict().items():
            assert torch.equal(payload[name][k], v), (name, k)
    assert payload["step"] == 0 and payload["architecture"]["cbase"] == 256
    assert payload["architecture"]["mbstd_group"] == 2  # from b4.mbstd, no init_kwargs

    argv = [f"--outdir={tmp_path / 'runs'}", f"--data={dataset}", *TRAIN, f"--resume={ckpt}"]
    opts = cli.build_parser().parse_args(argv)
    _, loader, state, _ = cli.build_training(cli.resolve_config(opts), opts, torch.device("cpu"))
    loader.close()
    for k, v in G_ema.state_dict().items():
        assert torch.equal(state.G_ema.state_dict()[k], v), k
    opts = gen_images.build_parser().parse_args([f"--network={ckpt}", "--seeds=0",
                                                 "--outdir=x", "--device=cpu"])
    G2 = gen_images.load_generator(opts, torch.device("cpu"))  # the flags from the checkpoint
    assert (opts.cbase, opts.cmax, opts.resolution) == (256, 64, RES)
    z = torch.randn((2, 512), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(G2(z, noise_mode="const"), G_ema(z, noise_mode="const"))


@pytest.mark.parametrize("cfg", ["stylegan2", "stylegan3-t"])
def test_c14_jax_tool_fails_at_claro_widths_the_port_converts(cfg, tmp_path):
    """cbase 16384 / cmax 64: every block has 64 channels.  The JAX tool
    takes cbase = 4 × 64 = 256 (min(256 // 8, 512) = 32 channels at 8²)
    and always a StyleGAN2 G; its transplant raises on the first shape.
    The port's tool reads the architecture and converts.  StyleGAN2 at
    8² (the JAX tool builds its whole train state before it fails)."""
    from click.testing import CliRunner

    from gantrack_tpu.tools.import_torch_pickle import main as jax_main

    path = tmp_path / "network-snapshot-claro.pkl"
    cbase = 16384 if cfg == "stylegan2" else 8192
    G, D, G_ema = _pickle(path, cfg, cbase=cbase, cmax=64, init_kwargs=False, seed=7,
                          res=8 if cfg == "stylegan2" else RES)
    result = CliRunner().invoke(jax_main, ["--src", str(path), "--dst", str(tmp_path / "j")])
    assert result.exit_code != 0
    if cfg == "stylegan2":  # the shape check of torch_compat.py:366-384
        assert isinstance(result.exception, ValueError), result.exception
        assert "pickle shape" in str(result.exception)
    else:  # a StyleGAN2 G read off a StyleGAN3 pickle: no synthesis.b4
        assert isinstance(result.exception, AttributeError), result.exception
        assert "b4" in str(result.exception)

    ckpt = import_torch_pickle.main([f"--src={path}", f"--dst={tmp_path / 't'}"])
    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert payload["architecture"]["cfg"] == cfg
    for k, v in G_ema.state_dict().items():
        assert torch.equal(payload["G_ema"][k], v), k


# --------------------------------------------------------- convert_detector


def _torchvision_inception(small: bool) -> dict:
    """Random weights under torchvision's ``inception_v3`` names (the port's
    layers' shapes, or 2 × 2 × 1 × 1 kernels when ``small``)."""
    from gantrack_tpu_torch.models.inception import InceptionV3Features

    gen = torch.Generator().manual_seed(0)
    sd = {}
    for key, v in InceptionV3Features(variant="tfslim").state_dict().items():
        if not key.endswith(".conv.weight"):
            continue
        shape = (2, 2, 1, 1) if small else tuple(v.shape)
        prefix = key[:-len(".conv.weight")]
        sd[key] = torch.randn(shape, generator=gen)
        sd[f"{prefix}.bn.weight"] = torch.rand(shape[0], generator=gen) + 0.5
        sd[f"{prefix}.bn.bias"] = torch.randn(shape[0], generator=gen)
        sd[f"{prefix}.bn.running_mean"] = torch.randn(shape[0], generator=gen)
        sd[f"{prefix}.bn.running_var"] = torch.rand(shape[0], generator=gen) + 0.5
    sd["fc.weight"] = torch.randn((3, 2) if small else (1008, 2048), generator=gen)
    sd["fc.bias"] = torch.randn(sd["fc.weight"].shape[0], generator=gen)
    return sd


def _same_npz(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_convert_detector_equals_jax(tmp_path):
    from gantrack_tpu.tools import convert_detector as jconv
    from gantrack_tpu_torch.models import inception
    from gantrack_tpu_torch.tools import convert_detector as tconv

    sd = _torchvision_inception(small=False)
    for variant in ("tfslim", "torchvision"):
        np.savez(tmp_path / "j.npz", **jconv.convert_inception_state_dict(sd, variant))
        np.savez(tmp_path / "t.npz", **tconv.convert_inception_state_dict(sd, variant))
        _same_npz(tmp_path / "j.npz", tmp_path / "t.npz")
    model = inception.load_npz(str(tmp_path / "t.npz"), return_logits=True)
    assert model.variant == "torchvision"

    # Both CLIs on a state-dict file and on a TorchScript archive.
    small = _torchvision_inception(small=True)
    torch.save(small, tmp_path / "sd.pth")
    holder = torch.nn.Module()
    for key, value in small.items():
        *path, leaf = key.split(".")
        node = holder
        for part in path:
            if not hasattr(node, part):
                node.add_module(part, torch.nn.Module())
            node = getattr(node, part)
        node.register_buffer(leaf, value)
    torch.jit.save(torch.jit.script(holder), str(tmp_path / "script.pt"))
    from click.testing import CliRunner

    for src in ("sd.pth", "script.pt"):
        args = ["--src", str(tmp_path / src), "--arch", "inception-tfslim"]
        res = CliRunner().invoke(jconv.main, [*args, "--dst", str(tmp_path / "j.npz")],
                                 catch_exceptions=False)
        assert res.exit_code == 0, res.output
        tconv.main(["--src", str(tmp_path / src), "--arch=inception-tfslim",
                    "--dst", str(tmp_path / "t.npz")])
        _same_npz(tmp_path / "j.npz", tmp_path / "t.npz")


def test_detector_weights_by_file_url(tmp_path):
    """``make_inception_detector`` resolves a ``file://`` URL through
    ``utils.url``, as the JAX package does."""
    from gantrack_tpu_torch.metrics import metric_utils
    from gantrack_tpu_torch.models import inception

    path = tmp_path / "inception.npz"
    inception.save_npz(str(path), inception.InceptionV3Features(variant="tfslim"))
    det = metric_utils.make_inception_detector(f"file://{path}")
    assert det.name == "inception-tfslim:inception.npz"
    with pytest.raises(FileNotFoundError):
        metric_utils.make_inception_detector(f"file://{tmp_path / 'missing.npz'}")
