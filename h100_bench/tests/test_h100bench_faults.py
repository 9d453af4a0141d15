"""The correctness check catches what it must: a whole run at a tiny size
on the CPU, past the harness's look for a card, with the timed path
broken underneath, reads ``correct`` false; the control (the reference
one precision step below the configuration's, in the program's place)
fails the limits the sound program passes.

The limits here are the fixture configuration's, set from CPU readings
at its tiny size; the cells' own limits are set from chip readings at
their sizes (``PERF.md``)."""

import dataclasses
import os
import time

import pytest
import torch

from h100_bench import core, faults
from h100_bench.kinds import eval as eval_kind
from h100_bench.kinds import train

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _ctx(traffic: str, tmp_path, seed: int = 3000000001) -> core.Context:
    return core.Context(cell={"name": "tiny"},
                        config=core.load_json(FIXTURES, "configs", "tiny-sg2.json"),
                        traffic=core.load_json(FIXTURES, "traffic", f"{traffic}.json"),
                        seed=seed, seconds=0.5, trace=False, t0=time.monotonic(),
                        tmpdir=str(tmp_path), device=torch.device("cpu"))


@pytest.fixture
def small_metric_batch(monkeypatch):
    from gantrack_tpu_torch.metrics import metric_utils

    monkeypatch.setattr(metric_utils, "auto_metric_batch", lambda res, floor=32, cap=256: 8)


def test_the_sound_program_is_correct(tmp_path):
    assert train.run(_ctx("train-tiny", tmp_path)).correct


def test_a_step_that_leaves_the_state_unchanged_is_caught(tmp_path):
    with faults.unchanged():
        out = train.run(_ctx("train-tiny", tmp_path))
    assert not out.correct
    assert dict((k, v) for k, v, _ in out.checks)["change_ratio"] >= 100


def test_half_the_batch_left_out_is_caught(tmp_path):
    with faults.half_batch():
        assert not train.run(_ctx("train-tiny", tmp_path)).correct


def _device_for(control):
    """TF32 exists on the card alone."""
    if control == "tf32" and not torch.cuda.is_available():
        pytest.skip("TF32 needs a CUDA card")
    return torch.device("cuda" if control == "tf32" else "cpu")


CONTROLS = ["fp8", pytest.param("tf32", marks=pytest.mark.cuda)]


@pytest.mark.parametrize("control", CONTROLS)
def test_the_training_control_fails_the_limits(tmp_path, control):
    limits = core.load_json(FIXTURES, "configs", "tiny-sg2.json")["limits"]["train"]
    ctx = dataclasses.replace(_ctx("train-tiny", tmp_path), device=_device_for(control))
    numbers, _ = train.readings(ctx, control=control)
    assert any(numbers[k] > limits[k] for k in limits)


def test_the_sound_generator_pass_is_correct(tmp_path, small_metric_batch):
    out = eval_kind.run(_ctx("eval-tiny", tmp_path))
    assert out.correct and out.attempted >= 8


def test_an_altered_answer_is_caught(tmp_path, small_metric_batch):
    with faults.altered_answer():
        assert not eval_kind.run(_ctx("eval-tiny", tmp_path)).correct


@pytest.mark.parametrize("control", CONTROLS)
def test_the_evaluation_control_fails_the_limits(tmp_path, small_metric_batch, control):
    limits = core.load_json(FIXTURES, "configs", "tiny-sg2.json")["limits"]["eval"]
    ctx = dataclasses.replace(_ctx("eval-tiny", tmp_path), device=_device_for(control))
    numbers, _ = eval_kind.readings(ctx, control=control)
    assert any(numbers[k] > limits[k] for k in limits)


def test_the_data_parallel_run_on_four_cpu_ranks(tmp_path):
    """Four gloo ranks on the CPU: the sound run is correct; with the
    gradients' exchange left out it is not."""
    ctx = _ctx("train-dp4-tiny", tmp_path)
    out = train.run(ctx)
    assert out.correct and out.chips == 4
    assert not train.run(dataclasses.replace(ctx, fault="no_exchange")).correct
