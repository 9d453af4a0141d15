"""The port's training loop, checkpoints and CLI, on the CPU at a tiny size.

* Resume exactness: 3 steps → checkpoint → restore into fresh objects →
  3 more steps equals 6 uninterrupted steps bit for bit (parameters,
  G_ema, ``w_avg``, both optimizers, ``pl_mean``, ADA state), as
  ``test_resume_exactness.py`` holds the JAX package.
* The CLI's ``train`` at 16², two ticks: ``stats.jsonl`` records, image
  grids that decode as PNG, and a checkpoint that loads back.
* The CLI surface: dry run, the options this slice refuses, and no
  silent fall-back to the CPU when CUDA is missing.
* Metrics: a CLI run with ``--metrics=fid1k --metric-snap=2`` writes
  finite ``metric-fid1k.jsonl`` rows on every other snapshot (and the
  last); a failing metric is logged and training goes on;
  ``calc_metrics --device=cpu`` on the run directory writes ``kid10k``.
* ``metric_async``, as ``tests/test_metric_cadence.py`` holds the JAX
  loop: kimg stamps 1, 2, 3, the snapshots that are not the last off the
  loop's thread, the last on it; the thread reads the snapshot's
  ``G_ema`` after the loop has stepped on; ``--metric-async`` trains
  through the CLI; the zip reader gives the same items read from threads
  at once as read in turn.
* StyleGAN3: exact resume of a state that holds ``magnitude_ema``; the
  CLI with ``--cfg=stylegan3-t`` and ``-r`` for two ticks, a checkpoint,
  ``--resume``, and the equivariance metrics of the run's G_ema at 8
  samples (the 1000-sample tiers are too slow for the CPU).
"""

import functools
import json
import os
import pickle
import struct
import threading
import time
import zipfile
import zlib

import numpy as np
import pytest
import torch

from gantrack_tpu_torch.data import pack_shards
from gantrack_tpu_torch.data.dataset import ZipSliceDataset
from gantrack_tpu_torch.metrics import registry
from gantrack_tpu_torch.metrics.equivariance import compute_equivariance_metrics
from gantrack_tpu_torch.models import stylegan2 as tsg2
from gantrack_tpu_torch.models import stylegan3 as tsg3
from gantrack_tpu_torch.tools import calc_metrics
from gantrack_tpu_torch.tools import train as cli
from gantrack_tpu_torch.training import augment as taug
from gantrack_tpu_torch.training import loop
from gantrack_tpu_torch.training import loss as tloss
from gantrack_tpu_torch.training import step as tstep
from gantrack_tpu_torch.training.train_state import create_train_state
from gantrack_tpu_torch.utils.checkpoint import (
    encode_png,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)

torch.set_num_threads(1)

RES, ZDIM, BATCH = 16, 8, 4
TINY_ARGS = ["--cfg=stylegan2", "--batch=4", "--gamma=0.4096", "--cbase=256", "--cmax=16",
             "--map-depth=2", "--glr=0.0025", "--dlr=0.0025", "--aug=ada", "--target=0.6",
             "--mirror=1", "--metrics=none", "--mbstd-group=2", "--device=cpu"]


def _stepper(seed=0, sg3=False):
    torch.manual_seed(seed)
    if sg3:
        g = tsg3.Generator(z_dim=ZDIM, c_dim=0, w_dim=ZDIM, img_resolution=RES, img_channels=1,
                           channel_base=256, channel_max=16, num_fp16_res=0,
                           synthesis_kwargs=dict(num_layers=6))
    else:
        g = tsg2.Generator(z_dim=ZDIM, c_dim=0, w_dim=ZDIM, img_resolution=RES, img_channels=1,
                           mapping_kwargs=dict(num_layers=2),
                           synthesis_kwargs=dict(channel_base=128, channel_max=32,
                                                 num_fp16_res=0))
    d = tsg2.Discriminator(c_dim=0, img_resolution=RES, img_channels=1, channel_base=128,
                           channel_max=32, num_fp16_res=0,
                           epilogue_kwargs=dict(mbstd_group_size=2))
    state = create_train_state(g, d, 0.002, 0.002, g_reg_interval=2, d_reg_interval=3)
    state.ada_p = torch.tensor(0.5)
    pipe = taug.AugmentPipe(taug.medical_augment_config(), RES, RES, 1)
    loss_cfg = tloss.StyleGAN2LossConfig(r1_gamma=1.0)
    if sg3:  # no path length, no mixing; the blur fades inside the 6 steps
        loss_cfg = tloss.StyleGAN2LossConfig(r1_gamma=1.0, style_mixing_prob=0.0, pl_weight=0.0,
                                             blur_init_sigma=1.0, blur_fade_kimg=0.02)
    loss = tloss.StyleGAN2Loss(g, d, loss_cfg, augment_fn=pipe)
    cfg = tstep.TrainStepConfig(batch_size=BATCH, z_dim=ZDIM, ada_target=0.6, ada_interval=2,
                                g_reg_interval=2, d_reg_interval=3)  # all phases in 6 steps
    return state, tstep.TrainStepper(loss, cfg, torch.Generator().manual_seed(seed))


def _leaves(state):
    out = [t for m in (state.G, state.D, state.G_ema) for t in m.state_dict().values()]
    for opt in (state.opt_g, state.opt_d):
        for s in opt.state_dict()["state"].values():
            out += [v for v in s.values() if isinstance(v, torch.Tensor)]
    return out + [state.pl_mean, state.ada_p, state.ada_signs]


@pytest.mark.parametrize("sg3", [False, True], ids=["stylegan2", "stylegan3"])
def test_resume_matches_uninterrupted(tmp_path, sg3):
    rng = np.random.default_rng(7)
    imgs = [torch.from_numpy(rng.standard_normal((BATCH, 1, RES, RES)).astype(np.float32))
            for _ in range(6)]

    state_a, stepper_a = _stepper(sg3=sg3)
    for b in imgs:
        stepper_a(state_a, b)
    if sg3:  # the state a StyleGAN3 step mutates beyond StyleGAN2's
        emas = [v for k, v in state_a.G.state_dict().items() if k.endswith("magnitude_ema")]
        assert len(emas) == 7 and all(float(v) != 1 for v in emas)
        assert all(torch.equal(a, b) for a, b in zip(state_a.G.buffers(),
                                                     state_a.G_ema.buffers()))

    state_b, stepper_b = _stepper(sg3=sg3)
    for b in imgs[:3]:
        stepper_b(state_b, b)
    path = save_checkpoint(str(tmp_path / "ckpt"), state_b, stepper_b.generator)

    state_c, stepper_c = _stepper(seed=1, sg3=sg3)  # other weights and draws until restored
    load_checkpoint(path, state_c, stepper_c.generator)
    assert state_c.step == 3
    for b in imgs[3:]:
        stepper_c(state_c, b)

    assert state_c.step == state_a.step == 6 and state_c.cur_nimg == 6 * BATCH
    leaves_a, leaves_c = _leaves(state_a), _leaves(state_c)
    assert len(leaves_a) == len(leaves_c)  # a dropped leaf fails, not truncates
    for a, c in zip(leaves_a, leaves_c, strict=True):
        assert torch.equal(a, c)


def _decode_png(path):
    """Minimal decoder for the writer's 8-bit, filter-0 PNGs."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, color = header[:4]
    ch = 1 if color == 0 else 3
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * ch)
    assert depth == 8 and not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, ch).squeeze(-1) if ch == 1 else rows[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("shape", [(5, 7), (4, 6, 3)])
def test_png_writer_round_trips(tmp_path, shape):
    pixels = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "x.png"
    path.write_bytes(encode_png(pixels))
    np.testing.assert_array_equal(_decode_png(path), pixels)


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("data"))
    rng = np.random.default_rng(0)
    images = [rng.uniform(0, 255, (RES, RES, 1)).astype(np.float32) for _ in range(16)]
    pack_shards(out, "train", images, [f"s{i}" for i in range(len(images))])
    return out


def test_cli_train_writes_stats_grids_and_checkpoints(tiny_dataset, tmp_path):
    argv = [f"--outdir={tmp_path / 'runs'}", f"--data={tiny_dataset}", *TINY_ARGS]
    opts = cli.build_parser().parse_args(argv)
    cli.check_slice(opts)
    c = cli.resolve_config(opts)
    c.update(total_kimg=0.008, kimg_per_tick=0.004, snapshot_ticks=1)  # 2 steps, 1 per tick
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    cli.train(c, opts, run_dir)

    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["Progress/tick"] for r in records] == [0, 1]
    assert records[-1]["Progress/kimg"] == 0.008
    for rec in records:
        assert all(np.isfinite(v) for k, v in rec.items() if k.startswith("Loss/"))
    assert "Loss/r1_penalty" in records[0] and "Loss/pl_penalty" in records[0]  # step 0
    for name in ("reals.png", "fakes_init.png", "fakes000000.png"):
        grid = _decode_png(os.path.join(run_dir, name))
        assert grid.shape == (32 * RES, 32 * RES)  # the 32 x 32 grid of 16² images

    _, loader, state, stepper = cli.build_training(c, opts, torch.device("cpu"))
    loader.close()
    load_checkpoint(latest_checkpoint(os.path.join(run_dir, "checkpoints")), state,
                    stepper.generator)
    assert state.step == 2 and state.cur_nimg == 8


def test_cli_dry_run_prints_config(capsys, tmp_path):
    assert cli.main([f"--outdir={tmp_path}", "--data=unused", "--dry-run", *TINY_ARGS]) is None
    out = capsys.readouterr().out
    config = json.loads(out[:out.rindex("}") + 1])
    assert config["G"]["channel_base"] == 256 and config["gamma"] == 0.4096
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flag", ["--metrics=eqr1k", "--metrics=ppl2_wend", "--devices=2",
                                  "--batch-gpu=2", "--freezed=2"])
def test_cli_refuses_what_the_slice_does_not_run(flag, tmp_path):
    opts = cli.build_parser().parse_args(
        [f"--outdir={tmp_path}", "--data=unused", *TINY_ARGS, flag])
    with pytest.raises(SystemExit, match="ROADMAP|not ported|needs a StyleGAN3"):
        cli.check_slice(opts)


@pytest.mark.parametrize("flag", ["--dtype=float32", "--rng-impl=rbg"])
def test_cli_takes_no_inert_options(flag, tmp_path, capsys):
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args([f"--outdir={tmp_path}", "--data=unused", *TINY_ARGS, flag])
    assert "unrecognized arguments" in capsys.readouterr().err


def test_cli_refuses_cuda_without_a_device(tiny_dataset, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in TINY_ARGS if a != "--device=cpu"]  # the default is --device=cuda
    with pytest.raises(SystemExit, match="--device=cpu"):
        cli.main([f"--outdir={tmp_path}", f"--data={tiny_dataset}", *args])


def _train(tiny_dataset, run_dir, extra, steps):
    argv = [f"--outdir={run_dir}", f"--data={tiny_dataset}", *TINY_ARGS, *extra]
    opts = cli.build_parser().parse_args(argv)
    cli.check_slice(opts)
    c = cli.resolve_config(opts)
    c.update(total_kimg=0.004 * steps, kimg_per_tick=0.004, snapshot_ticks=1)  # 1 step a tick
    os.makedirs(run_dir)
    cli.train(c, opts, run_dir)


@pytest.fixture(scope="module")
def metric_run(tiny_dataset, tmp_path_factory):
    """4 steps, snapshots at ticks 1, 2 and 3, fid1k on every other one."""
    run_dir = str(tmp_path_factory.mktemp("mruns") / "run")
    _train(tiny_dataset, run_dir, ["--metrics=fid1k", "--metric-snap=2"], steps=4)
    return run_dir


def test_cli_train_evaluates_metrics_every_nth_snapshot(metric_run):
    assert len(os.listdir(os.path.join(metric_run, "checkpoints"))) == 3
    with open(os.path.join(metric_run, "metric-fid1k.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 2  # snapshots 1 and 3 (the last); 2 is skipped
    for row in rows:
        assert row["metric"] == "fid1k" and row["kimg"] == 0
        assert np.isfinite(row["results"]["fid1k"]) and row["results"]["fid1k"] >= 0


def test_cli_train_goes_on_when_a_metric_fails(tiny_dataset, tmp_path, monkeypatch, capsys):
    def broken(opts):
        raise RuntimeError("detector exploded")

    monkeypatch.setitem(registry._metric_dict, "fid1k", broken)
    run_dir = str(tmp_path / "run")
    _train(tiny_dataset, run_dir, ["--metrics=fid1k"], steps=2)
    assert "metric evaluation failed at kimg 0" in capsys.readouterr().out
    assert latest_checkpoint(os.path.join(run_dir, "checkpoints")).endswith("00000002.pt")
    assert not os.path.exists(os.path.join(run_dir, "metric-fid1k.jsonl"))


def test_calc_metrics_on_the_run_dir_writes_kid(metric_run, tiny_dataset):
    results = calc_metrics.main([
        f"--network={metric_run}", "--metrics=kid10k", f"--data={tiny_dataset}",
        "--cbase=256", "--cmax=16", "--map-depth=2", "--batch=500", "--device=cpu"])
    assert np.isfinite(results["kid10k"])
    with open(os.path.join(metric_run, "metric-kid10k.jsonl")) as f:
        (row,) = [json.loads(line) for line in f]
    assert row["results"] == results
    assert row["snapshot_path"] == latest_checkpoint(os.path.join(metric_run, "checkpoints"))


@pytest.mark.parametrize("args,match", [
    (["--metrics=eqr50k"], "needs a StyleGAN3"),
    (["--network=x.pkl"], "A11"),
    (["--metrics=ppl2_wend", "--cfg=stylegan3-r"], "A8"),
])
def test_calc_metrics_refuses_what_is_not_ported(args, match, tiny_dataset):
    argv = ["--network=unused", f"--data={tiny_dataset}", "--device=cpu", *args]
    with pytest.raises(SystemExit, match=match):
        calc_metrics.main(argv)


def test_calc_metrics_refuses_cuda_without_a_device(tiny_dataset, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device=cpu"):
        calc_metrics.main(["--network=unused", f"--data={tiny_dataset}"])


@pytest.mark.parametrize("cfg", ["stylegan3-t", "stylegan3-r"])
def test_cli_trains_stylegan3_and_resumes(cfg, tiny_dataset, tmp_path, monkeypatch):
    """Two ticks of ``--cfg=stylegan3-*`` through the CLI, a checkpoint
    that ``--resume`` continues from, and finite equivariance metrics of
    the run's G_ema.  The image grids are cut to 4 × 4 (1024 images
    through 15 layers take minutes on one CPU thread)."""
    monkeypatch.setattr(loop, "setup_snapshot_image_grid",
                        functools.partial(loop.setup_snapshot_image_grid, gw=4, gh=4))
    args = [a for a in TINY_ARGS if not a.startswith("--cfg")] + [f"--cfg={cfg}"]
    argv = [f"--outdir={tmp_path / 'runs'}", f"--data={tiny_dataset}", *args]
    opts = cli.build_parser().parse_args(argv)
    cli.check_slice(opts)
    c = cli.resolve_config(opts)
    assert c["G"]["map_depth"] == 2 and c["glr"] == 0.0025
    c.update(total_kimg=0.008, kimg_per_tick=0.004, snapshot_ticks=1)  # 2 steps, 1 per tick
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    registry.check_metric("eqr1k")
    state = cli.train(c, opts, run_dir)

    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["Progress/tick"] for r in records] == [0, 1]
    for rec in records:
        assert all(np.isfinite(v) for k, v in rec.items() if k.startswith("Loss/"))
    assert "Loss/r1_penalty" in records[0] and "Loss/pl_penalty" not in records[0]
    G = state.G
    assert type(G).__module__.endswith("stylegan3")
    first = getattr(G.synthesis, G.synthesis.layer_names[0])
    assert first.conv_kernel == (1 if cfg == "stylegan3-r" else 3)
    assert first.weight.shape[0] == (32 if cfg == "stylegan3-r" else 16)  # -r doubles cmax
    assert float(first.magnitude_ema) != 1
    _, loader, fresh, stepper = cli.build_training(c, opts, torch.device("cpu"))
    loader.close()
    loss_cfg = stepper.loss.cfg
    assert (loss_cfg.blur_init_sigma, loss_cfg.blur_fade_kimg) == (
        (10.0, 25.0) if cfg == "stylegan3-r" else (0.0, 0.0))
    assert loss_cfg.pl_weight == 0 and loss_cfg.style_mixing_prob == 0
    assert stepper.cfg.g_reg_interval is None

    ckpt = latest_checkpoint(os.path.join(run_dir, "checkpoints"))
    load_checkpoint(ckpt, fresh, stepper.generator)
    assert fresh.step == 2
    for a, b in zip(fresh.G_ema.state_dict().values(), state.G_ema.state_dict().values()):
        assert torch.equal(a, b)

    # calc_metrics rebuilds the StyleGAN3 G_ema of --cfg from the checkpoint.
    if cfg == "stylegan3-t":
        results = calc_metrics.main([f"--network={run_dir}", f"--data={tiny_dataset}",
                                     f"--cfg={cfg}", "--metrics=fid1k", "--cbase=256",
                                     "--cmax=16", "--device=cpu"])
        assert np.isfinite(results["fid1k"])
        with pytest.raises(SystemExit, match="needs a StyleGAN3"):
            calc_metrics.main([f"--network={run_dir}", f"--data={tiny_dataset}",
                               "--metrics=eqr1k", "--device=cpu"])

    # --resume picks the run's latest checkpoint up and trains on.
    opts2 = cli.build_parser().parse_args([*argv, f"--resume={run_dir}"])
    c2 = dict(c, total_kimg=0.012)
    run2 = str(tmp_path / "run2")
    os.makedirs(run2)
    state2 = cli.train(c2, opts2, run2)
    assert state2.step == 3 and state2.cur_nimg == 12

    # The eq metrics at 8 samples, through evaluate_metrics' transform hook.
    import gantrack_tpu_torch.metrics as tmetrics
    saved = tmetrics.calc_metric

    def fake_calc(metric, mopts, mode_name=None):
        return dict(results=compute_equivariance_metrics(mopts, num_samples=8), metric=metric,
                    mode=mode_name)

    tmetrics.calc_metric = fake_calc
    try:
        class OneChannel:
            num_channels = 1

        results = calc_metrics.evaluate_metrics(state2.G_ema, ["eq"], OneChannel(), None,
                                                torch.device("cpu"), batch_size=4)
    finally:
        tmetrics.calc_metric = saved
    assert set(results) == {"eqt_int", "eqt_frac", "eqr"}
    assert all(np.isfinite(v) for v in results.values())


class _CountingStepper:
    """A stand-in step for the loop's metric cadence: ``batch_size`` images
    a call, and every ``G_ema`` parameter raised by 1 in place, as
    ``update_ema`` writes it."""

    def __init__(self, batch_size):
        self.cfg = tstep.TrainStepConfig(batch_size=batch_size, z_dim=ZDIM)
        self.generator = torch.Generator().manual_seed(0)

    def __call__(self, state, real_img, real_c):
        with torch.no_grad():
            for p in state.G_ema.parameters():
                p.add_(1.0)
        state.step += 1
        state.cur_nimg += self.cfg.batch_size
        return {}


class _Batches:
    dataset = None

    def __next__(self):
        return np.zeros((BATCH, RES, RES, 1), np.float32), np.zeros((BATCH, 0), np.float32)


def _cadence_run(tmp_path, metric_fn, **kwargs):
    """3 kimg at 250 images a step, a tick a kimg after tick 0 (the first
    step), a snapshot every tick: metrics at kimg 1, 2 and 3 (the last)."""
    state, _ = _stepper()
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    loop.training_loop(run_dir=run_dir, stepper=_CountingStepper(250), state=state,
                       loader=_Batches(), device=torch.device("cpu"), total_kimg=3,
                       kimg_per_tick=1, snapshot_ticks=1, image_snapshot_ticks=None,
                       metrics=["fake_metric"], metric_fn=metric_fn, verbose=False, **kwargs)
    return state


@pytest.mark.parametrize("metric_async", [False, True], ids=["sync", "async"])
def test_metric_cadence_and_threads(tmp_path, metric_async):
    calls = []

    def metric_fn(state, kimg=None):
        calls.append(dict(kimg=kimg, thread=threading.get_ident(), step=state.step))
        return {"fake_metric": float(kimg)}

    _cadence_run(tmp_path, metric_fn, metric_async=metric_async)
    assert [c["kimg"] for c in calls] == [1, 2, 3]
    main = threading.get_ident()
    if metric_async:  # the snapshots that are not the last run off the loop's thread
        assert all(c["thread"] != main for c in calls[:-1])
    else:
        assert all(c["thread"] == main for c in calls)
    assert calls[-1]["thread"] == main
    steps = [c["step"] for c in calls]  # each call sees its own snapshot's state
    assert steps == sorted(steps) and len(set(steps)) == 3


def test_metric_thread_reads_the_snapshot_g_ema(tmp_path):
    """A background metric that waits until the loop has taken another step
    still reads ``G_ema`` as the snapshot left it: the live one has moved
    on in place (every step adds 1 to each parameter)."""
    seen = []
    live = {}

    def metric_fn(state, kimg=None):
        if threading.get_ident() != main:
            deadline = time.monotonic() + 60
            while live["state"].step <= state.step and time.monotonic() < deadline:
                time.sleep(0.001)
        first = next(state.G_ema.parameters())
        seen.append(dict(step=state.step, live_step=live["state"].step,
                         shift=float((first - init).max()), spread=float((first - init).min())))
        return {"fake_metric": 0.0}

    main = threading.get_ident()
    state, _ = _stepper()
    init = next(state.G_ema.parameters()).detach().clone()
    live["state"] = state
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    loop.training_loop(run_dir=run_dir, stepper=_CountingStepper(250), state=state,
                       loader=_Batches(), device=torch.device("cpu"), total_kimg=3,
                       kimg_per_tick=1, snapshot_ticks=1, image_snapshot_ticks=None,
                       metrics=["fake_metric"], metric_fn=metric_fn, metric_async=True,
                       verbose=False)
    # Each step moves G_ema by 1; 1e-3 is the float32 rounding of the adds.
    assert len(seen) == 3
    for row in seen[:-1]:
        assert row["live_step"] > row["step"]  # the loop stepped on while the metric ran
        for moved in (row["shift"], row["spread"]):  # the snapshot's G_ema, not the live one
            assert abs(moved - row["step"]) < 1e-3
    assert seen[-1]["step"] == state.step and abs(seen[-1]["shift"] - state.step) < 1e-3


def test_cli_train_with_metric_async(tiny_dataset, tmp_path):
    """``--metric-async`` through the CLI: the first snapshot's fid1k runs
    on the thread, the last one's in the loop; both rows are written."""
    run_dir = str(tmp_path / "run")
    _train(tiny_dataset, run_dir, ["--metrics=fid1k", "--metric-async"], steps=3)
    with open(os.path.join(run_dir, "metric-fid1k.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 2  # snapshots at ticks 1 and 2 (the last)
    for row in rows:
        assert row["metric"] == "fid1k" and np.isfinite(row["results"]["fid1k"])


def test_zip_reader_reads_alike_from_threads(tmp_path):
    """The metric thread reads real images from the dataset the loader's
    workers read: a zip reader shares one ``ZipFile``, whose member reads
    CPython serialises, so four threads at once read what one reads in
    turn."""
    path = str(tmp_path / "slices.zip")
    rng = np.random.default_rng(1)
    with zipfile.ZipFile(path, "w") as z:
        for i in range(24):
            item = {m: rng.uniform(0, 255, (RES, RES)).astype(np.float32)
                    for m in ("MR_nonrigid_CT", "MR_MR_T2")}
            z.writestr(f"train/p{i}/p{i}_0.pickle", pickle.dumps(item))
    dataset = ZipSliceDataset(path)
    want = [dataset[i][0] for i in range(len(dataset))]
    got = {}

    def read(k):
        for _ in range(5):
            for i in range(k, len(dataset), 4):
                got.setdefault(i, []).append(dataset[i][0])

    threads = [threading.Thread(target=read, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(got) == list(range(len(dataset)))
    for i, images in got.items():
        assert all(np.array_equal(img, want[i]) for img in images)
