"""The port's metrics path against the JAX package, on the CPU.

* ``FeatureStats`` (the port's copy) against JAX's, batch for batch.
* The random-projection detector with the JAX matrices carried over by
  ``bridge``: features to 1e-5 (the resize sums in another order).
* The dataset pass's uint8 shim in its three cases, and the C5 fix: the
  feature-cache key carries the shim's token.
* FID and KID as numbers: the port against JAX ``compute_fid`` /
  ``compute_kid`` on the same tiny G (carried over by ``bridge``), the
  same detector matrices and the same packed dataset, with JAX's z-stream
  replayed into the port's ``sample_z``.  Tolerance rel 5e-3, abs 1e-4,
  as ``tests/test_fid_cross_framework.py``: the float32 G and detector
  differ in the last bits, and the floor of the uint8 truncation may
  flip a pixel by one level.
* ``report_metric``'s jsonl row.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gantrack_tpu.metrics import feature_stats as jfs
from gantrack_tpu.metrics import metric_utils as jmu
from gantrack_tpu.metrics.fid import compute_fid as jax_compute_fid
from gantrack_tpu.metrics.kid import compute_kid as jax_compute_kid
from gantrack_tpu.models import stylegan2 as jsg2
from gantrack_tpu_torch.data import open_dataset, pack_shards
from gantrack_tpu_torch.metrics import feature_stats as tfs
from gantrack_tpu_torch.metrics import metric_utils as tmu
from gantrack_tpu_torch.metrics import registry
from gantrack_tpu_torch.metrics.fid import compute_fid
from gantrack_tpu_torch.metrics.kid import compute_kid
from gantrack_tpu_torch.models import bridge
from gantrack_tpu_torch.models import stylegan2 as tsg2

torch.set_num_threads(1)

RES, ZDIM, BATCH = 16, 16, 32
DET_DIM = 24  # few features, so the covariances of 48-64 samples are full rank


def test_feature_stats_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    batches = [rng.standard_normal((n, 5)).astype(np.float32) for n in (4, 7, 6)]
    kw = dict(capture_all=True, capture_mean_cov=True, max_items=13)
    ours, theirs = tfs.FeatureStats(**kw), jfs.FeatureStats(**kw)
    for b in batches:
        ours.append(b)
        theirs.append(b)
    assert ours.num_items == theirs.num_items == 13 and ours.is_full()
    np.testing.assert_array_equal(ours.get_all(), theirs.get_all())
    for a, b in zip(ours.get_mean_cov(), theirs.get_mean_cov()):
        np.testing.assert_array_equal(a, b)
    path = str(tmp_path / "s" / "stats.pkl")
    ours.save(path)
    loaded = tfs.FeatureStats.load(path)
    np.testing.assert_array_equal(loaded.get_mean_cov()[1], ours.get_mean_cov()[1])


def _jax_randproj():
    return jmu.make_random_projection_detector(seed=0, dim=DET_DIM)


def _port_randproj(jdet):
    return tmu.make_random_projection_detector(
        seed=0, dim=DET_DIM, matrices=bridge.random_projection_from_jax(jax.device_get(jdet.params)))


@pytest.mark.parametrize("size", [40, 16])
def test_random_projection_features_match_jax(size):
    jdet = _jax_randproj()
    tdet = _port_randproj(jdet)
    assert tdet.name == f"randproj-torch-{DET_DIM}-seed0" and tdet.name != jdet.name
    x = np.random.default_rng(1).uniform(0, 255, (4, size, size, 3)).astype(np.float32)
    want = jdet(x)
    got = tdet(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))).numpy()
    assert got.shape == (4, DET_DIM)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_port_random_projection_is_seeded_by_a_torch_generator():
    a = tmu.make_random_projection_detector(seed=3, dim=DET_DIM)
    b = tmu.make_random_projection_detector(seed=3, dim=DET_DIM)
    x = torch.rand((2, 3, 20, 20)) * 255
    torch.testing.assert_close(a(x), b(x), rtol=0, atol=0)
    assert tmu.make_inception_detector(None, seed=3).name == "randproj-torch-512-seed3"
    with pytest.raises(FileNotFoundError):
        tmu.make_inception_detector("no-such-weights.npz")


def test_dataset_uint8_shim_cases(monkeypatch):
    monkeypatch.setattr(tmu, "_warned_unshimmed", [])
    rng = np.random.default_rng(2)
    unit = rng.random((3, 8, 8, 1)).astype(np.float32)  # [0, 1] floats: x255, truncated
    np.testing.assert_array_equal(tmu.dataset_uint8_shim(unit),
                                  (unit * 255).astype(np.uint8).astype(np.float32))
    with_255 = np.clip(rng.random((3, 8, 8, 1)) * 300, 0, 255).astype(np.float32)
    assert with_255.max() == 255
    np.testing.assert_array_equal(tmu.dataset_uint8_shim(with_255), with_255)
    no_255 = (rng.random((3, 8, 8, 1)) * 254).astype(np.float32)
    with pytest.warns(UserWarning, match="without an exact 255"):
        np.testing.assert_array_equal(tmu.dataset_uint8_shim(no_255), no_255)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # warned once: silent now
        np.testing.assert_array_equal(tmu.dataset_uint8_shim(no_255), no_255)


def test_feature_cache_key_carries_the_shim_token(tmp_path, monkeypatch, packed):
    kw = dict(dataset="d", detector="x", mode_idx=None, max_items=10)
    assert (tfs.cache_path(str(tmp_path), "features", shim="a", **kw)
            != tfs.cache_path(str(tmp_path), "features", shim="b", **kw))
    dataset = open_dataset(packed)
    opts = tmu.MetricOptions(dataset=dataset, detector=tmu.make_random_projection_detector(
        dim=DET_DIM), batch_size=BATCH, cache_dir=str(tmp_path / "cache"))
    tmu.compute_feature_stats_for_dataset(opts, capture_mean_cov=True, max_items=8)
    first = set(os.listdir(tmp_path / "cache"))
    monkeypatch.setattr(tmu, "SHIM_TOKEN", tmu.SHIM_TOKEN + "-changed")
    tmu.compute_feature_stats_for_dataset(opts, capture_mean_cov=True, max_items=8)
    assert len(first) == 1 and len(set(os.listdir(tmp_path / "cache")) - first) == 1


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """[0, 1) float slices: the regime in which the uint8 shim is live."""
    out = str(tmp_path_factory.mktemp("mdata"))
    rng = np.random.default_rng(7)
    images = [(rng.random((RES, RES, 1)) * 0.97).astype(np.float32) for _ in range(64)]
    pack_shards(out, "train", images, [f"s{i}" for i in range(len(images))])
    return out


@pytest.fixture(scope="module")
def generators():
    kwargs = dict(z_dim=ZDIM, c_dim=0, w_dim=ZDIM, img_resolution=RES, img_channels=1,
                  mapping_kwargs=dict(num_layers=2),
                  synthesis_kwargs=dict(channel_base=128, channel_max=32, num_fp16_res=0))
    g = jsg2.Generator(**kwargs)
    variables = jax.device_get(jax.jit(g.init)(
        {"params": jax.random.PRNGKey(3), "noise": jax.random.PRNGKey(4)},
        jnp.zeros((1, ZDIM)), None))
    rng = np.random.default_rng(5)
    variables = dict(variables)
    variables["params"] = jax.tree.map(
        lambda a: np.asarray(a) + 0.2 * rng.standard_normal(np.shape(a)).astype(np.float32),
        variables["params"])
    gt = tsg2.Generator(**kwargs)
    gt.load_state_dict(bridge.generator_state_dict_from_jax(variables))
    return g, variables, gt.eval()


def _both_sides(packed, generators, monkeypatch, jax_fn, port_fn, **metric_kw):
    g, variables, gt = generators
    dataset = open_dataset(packed)
    jdet = _jax_randproj()
    jopts = jmu.MetricOptions(generator=lambda z, c: g.apply(variables, z, c, noise_mode="const"),
                              z_dim=ZDIM, dataset=dataset, detector=jdet, batch_size=BATCH)
    theirs = jax_fn(jopts, **metric_kw)

    # Replay the z's the JAX generator pass drew: fold_in(PRNGKey(seed), step).
    steps = -(-metric_kw["num_gen"] // BATCH)
    z_all = np.concatenate([np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(0), s), (BATCH, ZDIM))) for s in range(steps)])
    drawn = []

    def replay(generator, n, z_dim, device):
        k = sum(len(z) for z in drawn)
        drawn.append(z_all[k:k + n])
        assert len(drawn[-1]) == n and z_dim == ZDIM
        return torch.from_numpy(drawn[-1].copy()).to(device)

    monkeypatch.setattr(tmu, "sample_z", replay)
    topts = tmu.MetricOptions(generator=lambda z, c: gt(z, c, noise_mode="const"), z_dim=ZDIM,
                              dataset=dataset, detector=_port_randproj(jdet), batch_size=BATCH)
    ours = port_fn(topts, **metric_kw)
    assert sum(len(z) for z in drawn) == len(z_all)
    return ours, theirs


def test_fid_number_matches_jax(packed, generators, monkeypatch):
    ours, theirs = _both_sides(packed, generators, monkeypatch, jax_compute_fid, compute_fid,
                               max_real=48, num_gen=64)
    assert np.isfinite(ours) and theirs > 0
    assert ours == pytest.approx(theirs, rel=5e-3, abs=1e-4), (ours, theirs)


def test_kid_number_matches_jax(packed, generators, monkeypatch):
    ours, theirs = _both_sides(packed, generators, monkeypatch, jax_compute_kid, compute_kid,
                               max_real=48, num_gen=64)
    assert np.isfinite(ours)
    assert ours == pytest.approx(theirs, rel=5e-3, abs=1e-4), (ours, theirs)


def test_report_metric_writes_the_jsonl_row(tmp_path, capsys):
    rd = dict(results={"fid1k": 12.5}, metric="fid1k", mode=None, total_time=1.0,
              total_time_str="1.0s")
    registry.report_metric(rd, run_dir=str(tmp_path), snapshot_path="ckpt.pt", kimg=3)
    registry.report_metric(dict(rd, mode="CT"), run_dir=str(tmp_path), kimg=4)
    with open(tmp_path / "metric-fid1k.jsonl") as f:
        (row,) = [json.loads(line) for line in f]
    assert row["results"] == {"fid1k": 12.5} and row["kimg"] == 3
    assert row["snapshot_path"] == "ckpt.pt" and "timestamp" in row
    with open(tmp_path / "metric-CT-fid1k.jsonl") as f:
        assert json.loads(f.readline())["kimg"] == 4
    assert '"fid1k": 12.5' in capsys.readouterr().out


@pytest.mark.parametrize("name,item", [("ppl2_zend", "unknown"), ("eqt2k_int", "unknown"),
                                       ("eqr", "unknown"), ("fid2k", "unknown")])
def test_unported_and_unknown_metrics_are_refused(name, item):
    with pytest.raises(ValueError, match=item):
        registry.check_metric(name)


# ---------------------------------------------------------------- equivariance
# The image-space transforms and the whole metric against the JAX package,
# with one narrow StyleGAN3-T carried over by ``bridge``.

from gantrack_tpu.metrics import equivariance as jeq  # noqa: E402
from gantrack_tpu.models import stylegan3 as jsg3  # noqa: E402
from gantrack_tpu_torch.metrics import equivariance as teq  # noqa: E402
from gantrack_tpu_torch.models import stylegan3 as tsg3  # noqa: E402
from gantrack_tpu_torch.tools import calc_metrics as tcalc  # noqa: E402

SG3_KW = dict(z_dim=ZDIM, c_dim=0, w_dim=ZDIM, img_resolution=32, img_channels=1,
              mapping_kwargs=dict(num_layers=2), channel_base=512, channel_max=32,
              num_fp16_res=0)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(x), (0, 3, 1, 2))))


@pytest.mark.parametrize("which,args", [
    ("apply_integer_translation", (0.11, -0.07)), ("apply_integer_translation", (-0.2, 0.0)),
    ("apply_fractional_translation", (0.043, -0.091)), ("apply_rotation", (0.7,)),
    ("apply_rotation", (-2.9,)),
])
def test_equivariance_transforms_and_masks_match_jax(which, args):
    """Transformed image to 1e-5 (the warp's positions round in another
    order), mask exactly, and the masked PSNR to 1e-4 dB."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, 20, 3)).astype(np.float32)
    other = rng.standard_normal(x.shape).astype(np.float32)
    want, want_mask = getattr(jeq, which)(jnp.asarray(x), *args)
    got, got_mask = getattr(teq, which)(_nchw(x), *args)
    np.testing.assert_array_equal(got_mask.numpy().transpose(0, 2, 3, 1), np.asarray(want_mask))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert 0 < float(got_mask.sum()) < got_mask.numel()
    psnr = float(teq._psnr(got, _nchw(other), got_mask))
    assert psnr == pytest.approx(float(jeq._psnr(want, jnp.asarray(other), want_mask)), abs=1e-4)
    assert float(teq._psnr(got, _nchw(other))) == pytest.approx(
        float(jeq._psnr(want, jnp.asarray(other))), abs=1e-4)


def test_equivariance_metrics_match_jax():
    """``compute_equivariance_metrics`` at 8 samples: the same numpy draws
    on both sides, so the three PSNRs agree within 1e-3 dB; the run goes
    through ``evaluate_metrics``'s transform hook, which puts the trained
    transform back."""
    jg = jsg3.Generator(**SG3_KW)
    variables = dict(jax.device_get(jax.jit(jg.init)(
        {"params": jax.random.PRNGKey(2)}, jnp.zeros((1, ZDIM)), None)))
    rng = np.random.default_rng(2)
    variables["params"] = jax.tree.map(
        lambda a: np.asarray(a) + 0.2 * rng.standard_normal(np.shape(a)).astype(np.float32),
        variables["params"])
    g = tsg3.Generator(**SG3_KW)
    g.load_state_dict(bridge.sg3_generator_state_dict_from_jax(variables))
    g.eval().requires_grad_(False)

    @jax.jit
    def j_apply(v, z, transform):
        v = {**v, "consts": {"synthesis": {"input": {
            **v["consts"]["synthesis"]["input"], "transform": transform}}}}
        return jg.apply(v, z, None)

    jopts = jmu.MetricOptions(z_dim=ZDIM, batch_size=8)
    jopts.generator_with_transform = lambda z, c, m: j_apply(
        variables, z, jnp.asarray(np.linalg.inv(m), jnp.float32))
    want = jeq.compute_equivariance_metrics(jopts, num_samples=8)

    seen = {}

    def fake_calc(metric, opts, mode_name=None):
        seen["opts"] = opts
        return dict(results=teq.compute_equivariance_metrics(opts, num_samples=8), metric=metric,
                    mode=mode_name)

    class OneChannel:
        num_channels = 1

    import gantrack_tpu_torch.metrics as tmetrics
    orig = tmetrics.calc_metric
    tmetrics.calc_metric = fake_calc
    try:
        got = tcalc.evaluate_metrics(g, ["eq"], OneChannel(), None, torch.device("cpu"),
                                     batch_size=8)
    finally:
        tmetrics.calc_metric = orig
    assert set(got) == set(want) == {"eqt_int", "eqt_frac", "eqr"}
    for k in want:
        assert np.isfinite(want[k]) and got[k] == pytest.approx(want[k], abs=1e-3), k
    assert seen["opts"].generator_with_transform is not None
    assert torch.equal(g.synthesis.input.transform, torch.eye(3))


def test_equivariance_metrics_are_registered_and_need_stylegan3():
    for name in ("eqt50k_int", "eqt50k_frac", "eqr50k", "eqt1k_int", "eqr1k"):
        registry.check_metric(name)
    with pytest.raises(ValueError, match="transform-capable"):
        teq.compute_equivariance_metrics(tmu.MetricOptions(), num_samples=8)


def test_metric_batch_follows_jax_and_is_cut_for_stylegan3():
    from gantrack_tpu_torch.tools.train import METRIC_BATCH_DIVISOR, metric_batch

    for res in (64, 256, 512, 1024):
        assert tmu.auto_metric_batch(res) == jmu.auto_metric_batch(res)
        assert metric_batch("stylegan2", res) == jmu.auto_metric_batch(res)
        for cfg in ("stylegan3-t", "stylegan3-r"):
            assert metric_batch(cfg, res) == jmu.auto_metric_batch(res) // METRIC_BATCH_DIVISOR[cfg]
    assert metric_batch("stylegan3-r", 256) < metric_batch("stylegan2", 256)
