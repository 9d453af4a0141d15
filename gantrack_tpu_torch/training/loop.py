"""Training loop: ticks, ``stats.jsonl``, image grids, snapshots, metrics.

Port of ``gantrack_tpu/training/loop.py``.  Same tick report (field
names), real/fake grids, full-state snapshots and metric evaluation at
every ``metric_snapshot_every``-th snapshot (a metric failure is logged
and training goes on), in the loop's thread or, with ``metric_async``,
on a background thread as the JAX loop runs them.  The loop keeps the
step's moments on the device and fetches them once per tick.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import resource
import threading
import time
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..utils.checkpoint import save_checkpoint, save_image_grid
from . import stats as stats_lib
from .step import TrainStepper
from .train_state import TrainState


def setup_snapshot_image_grid(dataset, random_seed: int = 0, gw: Optional[int] = None,
                              gh: Optional[int] = None):
    """A random grid of real images (as the JAX loop picks it)."""
    rnd = np.random.RandomState(random_seed)
    gw = gw or max(min(7680 // dataset.image_shape[1], 32), 4)
    gh = gh or max(min(4320 // dataset.image_shape[0], 32), 4)
    indices = rnd.choice(len(dataset), size=gw * gh, replace=len(dataset) < gw * gh)
    images, labels = [], []
    for i in indices:
        img, label, _ = dataset[int(i)]
        images.append(img)
        labels.append(label)
    return (gw, gh), np.stack(images), np.stack(labels)


def to_device_batch(images: np.ndarray, labels: np.ndarray, device):
    """Loader batch (NHWC float32 numpy) → NCHW tensors on ``device``."""
    img = torch.from_numpy(images)
    lab = torch.from_numpy(labels)
    if device.type == "cuda":
        img, lab = img.pin_memory(), lab.pin_memory()
    img = img.to(device, non_blocking=True).permute(0, 3, 1, 2).contiguous()
    return img, lab.to(device, non_blocking=True)


def metric_snapshot(state: TrainState) -> TrainState:
    """The state a background metric evaluates: ``state`` with a copy of
    ``G_ema``, the one network the metrics read.  JAX arrays are immutable,
    so the JAX loop hands its thread the state itself; here the next step
    updates ``G_ema`` in place.  The copy is queued on the caller's stream,
    so it reads ``G_ema`` as the steps queued before it leave it.  The other
    fields are shared with ``state`` and are not read by the metrics."""
    return dataclasses.replace(state, G_ema=copy.deepcopy(state.G_ema))


def _hand_to_stream(snap: TrainState, stream) -> None:
    """Let ``stream`` run after the copy in ``snap`` and keep the copy's
    memory from reuse on the loop's stream until ``stream``'s work on it
    is done."""
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    for t in (*snap.G_ema.parameters(), *snap.G_ema.buffers()):
        t.record_stream(stream)


def training_loop(
    *,
    run_dir: str,
    stepper: TrainStepper,
    state: TrainState,
    loader,
    device: torch.device,
    total_kimg: int = 25000,
    kimg_per_tick: int = 4,
    snapshot_ticks: Optional[int] = 50,
    image_snapshot_ticks: Optional[int] = 50,
    sample_fn: Optional[Callable[[TrainState, np.ndarray, np.ndarray], np.ndarray]] = None,
    metrics: Sequence[str] = (),
    metric_fn: Optional[Callable[..., dict]] = None,
    metric_snapshot_every: int = 1,
    metric_async: bool = False,
    verbose: bool = True,
) -> TrainState:
    """Run until ``total_kimg``; returns the final state.

    ``sample_fn(state, grid_z, grid_c) -> images`` (NHWC numpy) renders
    G_ema samples for the fakes grid; ``metric_fn(state, kimg=...) ->
    {name: value}`` evaluates ``metrics`` on every
    ``metric_snapshot_every``-th snapshot (and on the last one).

    ``metric_async=True`` runs ``metric_fn`` of a snapshot that is not the
    last on a daemon thread while training goes on, as the JAX loop does:
    on :func:`metric_snapshot` of the state, stamped with the snapshot's
    kimg.  At most one metric thread runs (a still-running one is joined
    first, a wait that lands in ``Timing/maintenance_sec``); the last
    snapshot joins it and runs in the loop's thread, and the loop joins
    any thread before it returns.  On a CUDA device the thread queues its
    work on a stream of its own, which waits for the copy.
    """
    start_time = time.time()
    collector = stats_lib.Collector()
    jsonl = stats_lib.JsonlLogger(os.path.join(run_dir, "stats.jsonl"))
    batch_size = stepper.cfg.batch_size

    grid_z = grid_c = None
    if image_snapshot_ticks is not None and sample_fn is not None:
        (gw, gh), reals, grid_labels = setup_snapshot_image_grid(loader.dataset)
        save_image_grid(reals / 127.5 - 1, os.path.join(run_dir, "reals.png"), grid_size=(gw, gh))
        rng = np.random.default_rng(0)
        grid_z = rng.standard_normal((gw * gh, stepper.cfg.z_dim)).astype(np.float32)
        grid_c = grid_labels.astype(np.float32)
        save_image_grid(sample_fn(state, grid_z, grid_c),
                        os.path.join(run_dir, "fakes_init.png"), grid_size=(gw, gh))

    def run_metrics(snap_state: TrainState, kimg: int, stream=None) -> None:
        # A metric failure must not end a long training run: the snapshot
        # holds the state, so log it and go on.
        try:
            with torch.cuda.stream(stream):  # None: the caller's stream
                results = metric_fn(snap_state, kimg=kimg)
            for name, value in results.items():
                print(f"metric {name}: {value:.4f}", flush=True)
        except Exception as e:  # noqa: BLE001 (deliberate isolation)
            print(f"metric evaluation failed at kimg {kimg} (continuing): {e!r}", flush=True)
            traceback.print_exc()

    metric_thread = None
    metric_stream = torch.cuda.Stream(device) if metric_async and device.type == "cuda" else None

    snapshot_idx = 0
    cur_tick = 0
    tick_start_nimg = state.cur_nimg
    tick_start_time = time.time()
    maintenance_time = 0.0
    done = False
    pending = []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    while not done:
        images, labels = next(loader)
        real_img, real_c = to_device_batch(images, labels, device)
        pending.append(stepper(state, real_img, real_c))
        done = state.cur_nimg >= total_kimg * 1000
        if (not done) and cur_tick != 0 and state.cur_nimg < tick_start_nimg + kimg_per_tick * 1000:
            continue

        for m in pending:
            collector.update(m)
        pending.clear()

        tick_end_time = time.time()
        fields = {
            "Progress/tick": cur_tick,
            "Progress/kimg": state.cur_nimg / 1e3,
            "Timing/total_sec": tick_end_time - start_time,
            "Timing/sec_per_tick": tick_end_time - tick_start_time,
            "Timing/sec_per_kimg": (tick_end_time - tick_start_time)
            / max(state.cur_nimg - tick_start_nimg, 1) * 1000,
            "Timing/maintenance_sec": maintenance_time,
            "Resources/peak_cpu_mem_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
            "Progress/augment": collector.mean("Progress/augment"),
        }
        if device.type == "cuda":
            fields["Resources/peak_gpu_mem_gb"] = torch.cuda.max_memory_allocated(device) / 2**30
        if verbose:
            print(" ".join([
                f"tick {cur_tick:<5d}",
                f"kimg {fields['Progress/kimg']:<8.1f}",
                f"time {fields['Timing/total_sec']:<8.1f}s",
                f"sec/kimg {fields['Timing/sec_per_kimg']:<7.2f}",
                f"augment {fields['Progress/augment']:.3f}",
                f"G_loss {collector.mean('Loss/G/loss'):.3f}",
                f"D_loss {collector.mean('Loss/D/loss'):.3f}",
            ]), flush=True)
        jsonl.write({**fields, **{k: v["mean"] for k, v in collector.as_dict().items()}})
        collector.clear()

        maintenance_start = time.time()
        if (image_snapshot_ticks is not None and sample_fn is not None and cur_tick > 0
                and (done or cur_tick % image_snapshot_ticks == 0)):
            save_image_grid(sample_fn(state, grid_z, grid_c),
                            os.path.join(run_dir, f"fakes{state.cur_nimg // 1000:06d}.png"),
                            grid_size=(gw, gh))
        if snapshot_ticks is not None and cur_tick > 0 and (done or cur_tick % snapshot_ticks == 0):
            save_checkpoint(os.path.join(run_dir, "checkpoints"), state, stepper.generator)
            snapshot_idx += 1
            if (metric_fn is not None and metrics
                    and (done or (snapshot_idx - 1) % max(metric_snapshot_every, 1) == 0)):
                kimg = state.cur_nimg // 1000
                if metric_thread is not None:
                    metric_thread.join()
                    metric_thread = None
                if metric_async and not done:
                    snap = metric_snapshot(state)
                    if metric_stream is not None:
                        _hand_to_stream(snap, metric_stream)
                    metric_thread = threading.Thread(target=run_metrics,
                                                     args=(snap, kimg, metric_stream), daemon=True)
                    metric_thread.start()
                else:
                    run_metrics(state, kimg)

        cur_tick += 1
        tick_start_nimg = state.cur_nimg
        maintenance_time = time.time() - maintenance_start
        tick_start_time = time.time()

    if metric_thread is not None:
        metric_thread.join()
    jsonl.close()
    return state
