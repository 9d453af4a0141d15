"""The port's runtime utilities against the JAX package's.

* ``utils.config``: ``EasyDict``, ``dump_options``, ``Logger`` and
  ``allocate_run_dir`` (the port's one copy) as in JAX; ``load_yaml`` with PyYAML hidden reads
  every ``configs/*.yaml`` to what ``yaml.safe_load`` gives, and refuses
  YAML outside its subset by name.
* ``utils.url`` (a copy): local paths, ``file://``, a pre-seeded cache hit
  and the mirror, as ``tests/test_url.py`` holds the JAX one; no network.
* ``utils.notify`` (a copy): a no-op without ``GANTRACK_NOTIFY_URL``; with
  one, a POST to a server on localhost.
* ``utils.summary``: for the same small G and D, the port's totals equal
  the JAX ``nn.tabulate`` totals (G's parameters, and with its persistent
  buffers all of JAX's variables; D's parameters); a failing module gives
  a message, not an error.
* ``utils.profiling``: ``device_memory_stats`` is ``{}`` on the CPU,
  ``cpu_mem_gb`` is the process's current resident memory.
* ``precision``: ``high`` and ``pinned_float64``; the real StyleGAN2 G and
  D built and stepped under ``pinned_float64`` are float64 throughout, and
  one rank against two gloo ranks in ``rng_mode="global_sample"`` agree
  to ``tests/test_torch_parallel.py``'s float64 pin (1e-13) in all four
  phase variants; production float32 keeps its bits (the nets built in
  and out of a ``pinned_float64`` that was left are equal).
"""

import glob
import hashlib
import http.server
import json
import os
import re
import sys
import threading

import pytest
import torch

from gantrack_tpu_torch import precision
from gantrack_tpu_torch.models import stylegan2 as tsg2
from gantrack_tpu_torch.parallel import mesh as pm
from gantrack_tpu_torch.utils import config, notify, profiling, summary, url
from test_torch_parallel import PIN_F64, VARIANTS, _assert_ranks_equal, _assert_same, _step
from test_torch_parallel import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


# ------------------------------------------------------------------ config


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_load_yaml_without_pyyaml_equals_safe_load(path, monkeypatch):
    import yaml

    from gantrack_tpu.utils.config import load_yaml as jax_load_yaml

    with open(path) as f:
        want = yaml.safe_load(f)
    assert config.load_yaml(path) == want == jax_load_yaml(path)
    monkeypatch.setitem(sys.modules, "yaml", None)  # as on a machine without PyYAML
    got = config.load_yaml(path)
    assert got == want and isinstance(got, config.EasyDict)
    assert got.data == want["data"] and isinstance(got.data, config.EasyDict)


@pytest.mark.parametrize("text", [
    "a: 1\nb: [1, 2.5, x, 'q', \"r\", null, yes, Off]\nc: {min: -1000, max: 1000}\n",
    "x: ~\ny: 1e5\nz: 1.0e+5\nw: .5\nv: -.inf\nu: 'it''s'\nt: \"a\\tb\"\ns: 0\n",
    "k:\n- 1\n-\n  - 2\n  - 3\nm:\n  n:\n    o: p  # a comment\n  q: 'r # s'\n",
    "- a\n- {b: [c, d]}\n- []\n- {}\n",
])
def test_yaml_subset_cases_equal_safe_load(text):
    import yaml

    assert config.parse_yaml_subset(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: &x 1\nb: *x\n", "a: !!str 1\n", "a: |\n  text\n",
                                  "- a: 1\n", "a: 0x10\n", "a: 2001-12-14\n", "---\na: 1\n",
                                  "a: 1\na: 2\n", "a:\n\tb: 1\n", "- - 2\n  - 3\n"])
def test_yaml_outside_the_subset_is_refused(text):
    with pytest.raises(config.YamlSubsetError):
        config.parse_yaml_subset(text)


def test_config_helpers_equal_jax(tmp_path, capsys):
    from gantrack_tpu.utils import config as jconfig

    for mod, root in ((jconfig, tmp_path / "j"), (config, tmp_path / "t")):
        d = mod.EasyDict(a=1)
        d.b = 2
        assert d == {"a": 1, "b": 2} and d.a == 1
        with pytest.raises(AttributeError):
            d.missing
        run_dirs = [mod.allocate_run_dir(str(root), "step") for _ in range(2)]
        assert [os.path.basename(r) for r in run_dirs] == ["00000-step", "00001-step"]
        mod.dump_options(run_dirs[0], {"x": {1, 2}}, name="o.json")
    for name in ("00000-step/o.json",):
        assert (tmp_path / "j" / name).read_text() == (tmp_path / "t" / name).read_text()

    logger = config.Logger(str(tmp_path / "log.txt"))
    print("to both")
    logger.close()
    assert (tmp_path / "log.txt").read_text() == "to both\n"
    assert "to both" in capsys.readouterr().out


# --------------------------------------------------------------------- url


def test_url_is_the_jax_copy():
    from gantrack_tpu.utils import url as jurl

    for obj in ("https://example.com/x.pkl", "/local/p.pkl", "file:///l/p.pkl", 42,
                "https://nodots/x", "ftp://example.com/x"):
        for allow in (False, True):
            assert url.is_url(obj, allow) == jurl.is_url(obj, allow), obj


def test_open_url_local_file_cache_and_mirror(tmp_path, monkeypatch):
    p = tmp_path / "w.bin"
    p.write_bytes(b"xyz")
    assert url.open_url(str(p), return_filename=True) == str(p)
    with url.open_url(f"file://{p}") as f:
        assert f.read() == b"xyz"
    assert url.open_url(f"file://{p}", return_filename=True) == str(p)

    link = "https://example.com/detector/inception-2015-12-05.pkl"
    cache = tmp_path / "cache"
    cache.mkdir()
    seeded = cache / f"{hashlib.md5(link.encode()).hexdigest()}_inception-2015-12-05.pkl"
    seeded.write_bytes(b"seeded")
    with url.open_url(link, cache_dir=str(cache), num_attempts=1, verbose=False) as f:
        assert f.read() == b"seeded"

    mirrored = "https://example.com/models/vgg16.pt?dl=1"
    (tmp_path / "mirror").mkdir()
    (tmp_path / "mirror" / "vgg16.pt").write_bytes(b"mirrored")
    monkeypatch.setenv("GANTRACK_URL_MIRROR", str(tmp_path / "mirror"))
    with url.open_url(mirrored, cache_dir=str(cache), num_attempts=1, verbose=False) as f:
        assert f.read() == b"mirrored"
    monkeypatch.delenv("GANTRACK_URL_MIRROR")  # the cached copy serves it now
    with url.open_url(mirrored, cache_dir=str(cache), num_attempts=1, verbose=False) as f:
        assert f.read() == b"mirrored"

    import urllib.request

    def unreachable(*args, **kwargs):
        raise OSError("network unreachable")

    monkeypatch.setattr(urllib.request, "urlopen", unreachable)
    with pytest.raises(IOError, match="GANTRACK_URL_MIRROR"):
        url.open_url("https://example.com/x.pkl", cache_dir=str(tmp_path / "c"),
                     num_attempts=1, verbose=False)


# ------------------------------------------------------------------ notify


def test_notify_is_a_noop_without_a_url_and_posts_with_one(monkeypatch):
    monkeypatch.delenv("GANTRACK_NOTIFY_URL", raising=False)
    assert notify.notify("hello") is False
    received = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            received.append(json.loads(self.rfile.read(int(self.headers["Content-Length"]))))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *args):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        monkeypatch.setenv("GANTRACK_NOTIFY_URL", f"http://127.0.0.1:{server.server_port}/hook")
        assert notify.notify("Training complete: run") is True
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert received == [{"Info": "Training complete: run"}]
    assert notify.notify("x", url=f"http://127.0.0.1:{server.server_port}/gone") is False


# ----------------------------------------------------------------- summary

KW = dict(z_dim=16, c_dim=0, w_dim=16, img_resolution=32, img_channels=1,
          mapping_kwargs=dict(num_layers=2),
          synthesis_kwargs=dict(channel_base=256, channel_max=64, num_fp16_res=0))
D_KW = dict(c_dim=0, img_resolution=32, img_channels=1, channel_base=256, channel_max=64,
            num_fp16_res=0)


def _totals(table: str) -> tuple:
    """(parameters, buffers) of the port's total line."""
    last = table.strip().splitlines()[-1].split()
    return int(last[1].replace(",", "")), int(last[2].replace(",", ""))


def test_summary_totals_equal_jax_tabulate():
    import jax
    import jax.numpy as jnp

    from gantrack_tpu.models import stylegan2 as jsg2
    from gantrack_tpu.utils.summary import module_summary as jax_summary

    def jax_total(table):
        return int(re.search(r"Total Parameters: ([\d,]+)", table).group(1).replace(",", ""))

    G, D = tsg2.Generator(**KW), tsg2.Discriminator(**D_KW)
    g_table = summary.module_summary(G, torch.zeros(1, 16), None, noise_mode="const")
    d_table = summary.module_summary(D, torch.zeros(1, 1, 32, 32), None)
    j_g = jax_summary(jsg2.Generator(**KW), jnp.zeros((1, 16)), None,
                      rngs={"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)})
    j_d = jax_summary(jsg2.Discriminator(**D_KW), jnp.zeros((1, 32, 32, 1)), None)
    persistent = sum(v.numel() for k, v in G.state_dict().items()
                     if k not in dict(G.named_parameters()))
    g_params, _ = _totals(g_table)
    d_params, _ = _totals(d_table)
    assert g_params == sum(p.numel() for p in G.parameters())
    assert g_params + persistent == jax_total(j_g)  # JAX counts every collection
    assert d_params == jax_total(j_d)
    assert "synthesis.b32" in g_table and "[1, 1, 32, 32]" in g_table
    assert "mapping.fc1" in g_table and "synthesis.b32.conv1" not in g_table  # depth 2
    broken = summary.module_summary(G, torch.zeros(1, 3), None)
    assert broken.startswith("[module summary unavailable: RuntimeError")


# --------------------------------------------------------------- profiling


def test_profiling_on_the_cpu():
    assert profiling.device_memory_stats("cpu") == {}
    with open("/proc/self/status") as f:
        rss_kb = int(next(line for line in f if line.startswith("VmRSS")).split()[1])
    assert abs(profiling.cpu_mem_gb() - rss_kb / 2**20) < 0.05


# --------------------------------------------------------------- precision


def test_pinned_float64_raises_the_networks_dtype():
    assert precision.high() is torch.float32
    torch.manual_seed(0)
    G32 = tsg2.Generator(**KW)
    with precision.pinned_float64():
        assert precision.high() is torch.float64
        torch.manual_seed(0)
        G64, D64 = tsg2.Generator(**KW), tsg2.Discriminator(**D_KW)
        assert {p.dtype for p in [*G64.parameters(), *G64.buffers(), *D64.parameters()]
                if p.is_floating_point() and p.numel() > 16} == {torch.float64}
        z = torch.randn(2, 16, dtype=torch.float64)
        img = G64(z, None, noise_mode="const")
        assert img.dtype == torch.float64 and D64(img, None).dtype == torch.float64
    assert precision.high() is torch.float32
    torch.manual_seed(0)
    G32b = tsg2.Generator(**KW)
    for (k, a), b in zip(G32.state_dict().items(), G32b.state_dict().values()):
        assert a.dtype == torch.float32 and torch.equal(a, b), k
    assert [v.shape for v in G32.state_dict().values()] == \
        [v.shape for v in G64.state_dict().values()]


def _every_variant(mesh):
    return [_step(mesh, flags, 1, "stylegan2-f64") for flags in VARIANTS]


@pytest.fixture(scope="module")
def float64_steps(tmp_path_factory):
    """Each phase variant's step of the real nets in float64 on one rank,
    and on two gloo ranks (one group, spawned once, for all four)."""
    return _every_variant(pm.Mesh()), run_ranks(_every_variant, 2,
                                                tmp_path_factory.mktemp("f64"))


@pytest.mark.parametrize("flags", VARIANTS, ids=["plain", "Greg", "Dreg", "Greg+Dreg"])
def test_real_networks_in_float64_one_rank_equals_two(flags, float64_steps):
    i = VARIANTS.index(flags)
    one, two = float64_steps[0][i], [rank[i] for rank in float64_steps[1]]
    _assert_ranks_equal(two)
    assert one["G.mapping.fc0.weight"].dtype == torch.float64
    _assert_same(one, two[0], PIN_F64)


def test_configure_device_numerics(monkeypatch):
    assert precision.configure_device_numerics("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device=cpu"):
        precision.configure_device_numerics("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name in ("deterministic", "benchmark", "allow_tf32"):
        monkeypatch.setattr(torch.backends.cudnn, name, not name == "deterministic")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert precision.configure_device_numerics("cuda").type == "cuda"
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
