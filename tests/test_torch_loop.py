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
"""

import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from gantrack_tpu_torch.data import pack_shards
from gantrack_tpu_torch.metrics import registry
from gantrack_tpu_torch.models import stylegan2 as tsg2
from gantrack_tpu_torch.tools import calc_metrics
from gantrack_tpu_torch.tools import train as cli
from gantrack_tpu_torch.training import augment as taug
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


def _stepper(seed=0):
    torch.manual_seed(seed)
    g = tsg2.Generator(z_dim=ZDIM, c_dim=0, w_dim=ZDIM, img_resolution=RES, img_channels=1,
                       mapping_kwargs=dict(num_layers=2),
                       synthesis_kwargs=dict(channel_base=128, channel_max=32, num_fp16_res=0))
    d = tsg2.Discriminator(c_dim=0, img_resolution=RES, img_channels=1, channel_base=128,
                           channel_max=32, num_fp16_res=0,
                           epilogue_kwargs=dict(mbstd_group_size=2))
    state = create_train_state(g, d, 0.002, 0.002, g_reg_interval=2, d_reg_interval=3)
    state.ada_p = torch.tensor(0.5)
    pipe = taug.AugmentPipe(taug.medical_augment_config(), RES, RES, 1)
    loss = tloss.StyleGAN2Loss(g, d, tloss.StyleGAN2LossConfig(r1_gamma=1.0), augment_fn=pipe)
    cfg = tstep.TrainStepConfig(batch_size=BATCH, z_dim=ZDIM, ada_target=0.6, ada_interval=2,
                                g_reg_interval=2, d_reg_interval=3)  # all phases in 6 steps
    return state, tstep.TrainStepper(loss, cfg, torch.Generator().manual_seed(seed))


def _leaves(state):
    out = [t for m in (state.G, state.D, state.G_ema) for t in m.state_dict().values()]
    for opt in (state.opt_g, state.opt_d):
        for s in opt.state_dict()["state"].values():
            out += [v for v in s.values() if isinstance(v, torch.Tensor)]
    return out + [state.pl_mean, state.ada_p, state.ada_signs]


def test_resume_matches_uninterrupted(tmp_path):
    rng = np.random.default_rng(7)
    imgs = [torch.from_numpy(rng.standard_normal((BATCH, 1, RES, RES)).astype(np.float32))
            for _ in range(6)]

    state_a, stepper_a = _stepper()
    for b in imgs:
        stepper_a(state_a, b)

    state_b, stepper_b = _stepper()
    for b in imgs[:3]:
        stepper_b(state_b, b)
    path = save_checkpoint(str(tmp_path / "ckpt"), state_b, stepper_b.generator)

    state_c, stepper_c = _stepper(seed=1)  # other weights and draws until restored
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


@pytest.mark.parametrize("flag", ["--cfg=stylegan3-t", "--metrics=ppl2_wend", "--devices=2",
                                  "--batch-gpu=2", "--freezed=2", "--metric-async"])
def test_cli_refuses_what_the_slice_does_not_run(flag, tmp_path):
    opts = cli.build_parser().parse_args(
        [f"--outdir={tmp_path}", "--data=unused", *TINY_ARGS, flag])
    with pytest.raises(SystemExit, match="ROADMAP|not ported"):
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
    (["--metrics=eqr50k"], "A9"),
    (["--network=x.pkl"], "A11"),
    (["--cfg=stylegan3-r"], "A9"),
])
def test_calc_metrics_refuses_what_is_not_ported(args, match, tiny_dataset):
    argv = ["--network=unused", f"--data={tiny_dataset}", "--device=cpu", *args]
    with pytest.raises(SystemExit, match=match):
        calc_metrics.main(argv)


def test_calc_metrics_refuses_cuda_without_a_device(tiny_dataset, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device=cpu"):
        calc_metrics.main(["--network=unused", f"--data={tiny_dataset}"])
