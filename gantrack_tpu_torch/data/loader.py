"""Infinite shuffled data loading for the single-process trainer.

The port's own copy of ``gantrack_tpu/data/loader.py``, kept equal to
it: the same seed gives the same batches in both packages.

Capability parity with the reference's ``misc.InfiniteSampler`` +
``torch.utils.data.DataLoader`` combination
(``torch_utils/misc.py:111-142``, ``training_loop_mi_multimodal.py:177-179``):
seeded windowed-shuffle infinite iteration with per-replica striding,
background prefetch, and the ``[0,255] → [-1,1]`` normalisation the
training loop applies (``training_loop:316``).

One host process feeds the device, so the loader yields *global*
batches (NHWC float32 numpy); ``training.loop.to_device_batch`` places
them.  ``rank`` / ``num_replicas`` stride the sampler like reference
ranks.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from ..utils.profiling import span
from .dataset import GANDataset


def infinite_indices(
    n: int,
    rank: int = 0,
    num_replicas: int = 1,
    shuffle: bool = True,
    seed: int = 0,
    window_size: float = 0.5,
) -> Iterator[int]:
    """Reference ``InfiniteSampler.__iter__`` semantics, bit-for-bit:
    initial seeded shuffle then a sliding-window swap per visit."""
    assert n > 0
    order = np.arange(n)
    rnd = None
    window = 0
    if shuffle:
        rnd = np.random.RandomState(seed)
        rnd.shuffle(order)
        window = int(np.rint(order.size * window_size))
    idx = 0
    while True:
        i = idx % order.size
        if idx % num_replicas == rank:
            yield int(order[i])
        if window >= 2:
            j = (i - rnd.randint(window)) % order.size
            order[i], order[j] = order[j], order[i]
        idx += 1


def _build_batch(dataset, normalize: bool, idx) -> Tuple[np.ndarray, np.ndarray]:
    if hasattr(dataset, "gather_batch"):
        # Native C++ batched gather (sharded memmap datasets);
        # get_label reads the in-memory label table only.
        labels = np.stack([dataset.get_label(i) for i in idx]).astype(np.float32)
        images = dataset.gather_batch(np.asarray(idx), normalize=normalize)
        return images, labels
    items = [dataset[i] for i in idx]  # one raw read per item
    labels = np.stack([it[1] for it in items]).astype(np.float32)
    images = np.stack([it[0] for it in items]).astype(np.float32)
    if normalize:
        images = images / 127.5 - 1.0
    return images, labels


def _process_worker(dataset, normalize, task_q, result_q):
    """Subprocess batch worker: the zip-pickle format decodes under the
    GIL (``pickle.loads``), so thread workers scale negatively
    (docs/SCALING.md) — processes sidestep it exactly like the
    reference's 3-worker-process torch DataLoader
    (``training_loop_mi_multimodal.py:177-179``).  Each child lazily
    reopens its own zip handle (``ZipSliceDataset.__getstate__`` drops
    it)."""
    try:
        while True:
            item = task_q.get()
            if item is None:
                return
            seq, idx = item
            result_q.put((seq, _build_batch(dataset, normalize, idx)))
    except BaseException as e:  # noqa: BLE001 — re-raised in the parent
        import traceback

        result_q.put(("error", repr(e), traceback.format_exc()))


class InfiniteLoader:
    """Yields ``(images [B,H,W,C] f32 in [-1,1], labels [B,label_dim])``
    batches forever, prefetched on background workers.

    ``num_workers > 1`` parallelises batch construction (the reference
    feeds each rank with a 3-worker torch DataLoader,
    ``training_loop_mi_multimodal.py:177-179``) while keeping the batch
    STREAM deterministic: workers claim sequence-numbered index lists
    from the shared sampler under a lock and a reorder buffer yields
    batches in sequence order, so the consumed stream is bit-identical
    to ``num_workers=1``.

    ``worker_mode`` selects the parallelism substrate:

    * ``"thread"`` (default) — zero-copy into the consumer; right for the
      sharded-memmap format whose C++ gather releases the GIL.
    * ``"process"`` — spawned worker processes; right for the reference
      zip-pickle on-disk format whose ``pickle.loads`` decode holds the
      GIL (threads scale *negatively* there, docs/SCALING.md).  One
      feeder thread claims (seq, indices) with the same backpressure as
      thread mode and one collector thread drains results into the same
      reorder buffer, so ordering, determinism, and error semantics are
      identical.
    """

    def __init__(
        self,
        dataset: GANDataset,
        batch_size: int,
        rank: int = 0,
        num_replicas: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        window_size: float = 0.5,
        normalize: bool = True,
        prefetch: int = 2,
        start: bool = True,
        num_workers: int = 1,
        worker_mode: str = "thread",
    ):
        assert worker_mode in ("thread", "process")
        self.dataset = dataset
        self.batch_size = batch_size
        self.normalize = normalize
        self._indices = infinite_indices(
            len(dataset), rank=rank, num_replicas=num_replicas,
            shuffle=shuffle, seed=seed, window_size=window_size,
        )
        self._stop = threading.Event()
        self._threads: list = []
        self._procs: list = []
        self._task_q = None
        self._result_q = None
        self._seq_lock = threading.Lock()
        self._next_build = 0
        self._cond = threading.Condition()
        self._results: dict = {}
        self._error: Optional[BaseException] = None
        self._next_yield = 0
        self._cap = max(prefetch, num_workers)
        self._num_workers = max(1, int(num_workers)) if start else 0
        if self._num_workers and worker_mode == "process":
            self._start_processes()
        else:
            for _ in range(self._num_workers):
                t = threading.Thread(target=self._worker, daemon=True)
                t.start()
                self._threads.append(t)

    def _build(self, idx) -> Tuple[np.ndarray, np.ndarray]:
        return _build_batch(self.dataset, self.normalize, idx)

    def _make_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._build([next(self._indices) for _ in range(self.batch_size)])

    # ------------------------------------------------- process mode
    def _start_processes(self):
        import multiprocessing as mp

        # spawn, not fork: the parent holds the framework's thread pools and fork
        # would deadlock it (torch spawns its DataLoader workers too).
        ctx = mp.get_context("spawn")
        self._task_q = ctx.Queue()
        self._result_q = ctx.Queue()
        for _ in range(self._num_workers):
            p = ctx.Process(
                target=_process_worker,
                args=(self.dataset, self.normalize, self._task_q, self._result_q),
                daemon=True,
            )
            p.start()
            self._procs.append(p)
        for name, target in (("feeder", self._feeder), ("collector", self._collector)):
            t = threading.Thread(target=target, daemon=True, name=f"loader-{name}")
            t.start()
            self._threads.append(t)

    def _feeder(self):
        try:
            while not self._stop.is_set():
                seq, idx = self._claim()
                with self._cond:
                    while (seq - self._next_yield >= self._cap
                           and not self._stop.is_set()):
                        self._cond.wait(0.5)
                    if self._stop.is_set():
                        return
                self._task_q.put((seq, idx))
        except BaseException as e:  # noqa: BLE001 — re-raised in __next__
            self._record_error(e)

    def _collector(self):
        import queue as _queue

        try:
            while not self._stop.is_set():
                try:
                    item = self._result_q.get(timeout=0.5)
                except _queue.Empty:
                    continue
                if item[0] == "error":
                    raise RuntimeError(
                        f"loader worker process failed: {item[1]}\n{item[2]}")
                seq, batch = item
                with self._cond:
                    self._results[seq] = batch
                    self._cond.notify_all()
        except BaseException as e:  # noqa: BLE001 — re-raised in __next__
            self._record_error(e)

    def _record_error(self, e: BaseException):
        with self._cond:
            if self._error is None:
                self._error = e
            self._stop.set()
            self._cond.notify_all()

    def _claim(self):
        with self._seq_lock:
            seq = self._next_build
            self._next_build += 1
            idx = [next(self._indices) for _ in range(self.batch_size)]
        return seq, idx

    def _worker(self):
        # Worker faults must surface in the consumer, not hang it: the
        # reference's torch DataLoader re-raises worker exceptions at
        # the iterator (``training_loop_mi_multimodal.py:177-179``); a
        # silently-dead daemon thread would stall a multi-day run.
        try:
            while not self._stop.is_set():
                seq, idx = self._claim()
                batch = self._build(idx)
                with self._cond:
                    while (seq - self._next_yield >= self._cap
                           and not self._stop.is_set()):
                        self._cond.wait(0.5)
                    if self._stop.is_set():
                        return
                    self._results[seq] = batch
                    self._cond.notify_all()
        except BaseException as e:  # noqa: BLE001 — re-raised in __next__
            self._record_error(e)

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        """The next batch (the span ``data.fetch``: the wait for it, or its
        making where no worker runs)."""
        with span("data.fetch"):
            if not self._threads:
                return self._make_batch()
            with self._cond:
                while self._next_yield not in self._results:
                    if self._error is not None:
                        raise RuntimeError(
                            "InfiniteLoader worker failed while building batch "
                            f"{self._next_yield}") from self._error
                    self._cond.wait(0.5)
                batch = self._results.pop(self._next_yield)
                self._next_yield += 1
                self._cond.notify_all()
            return batch

    def close(self):
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for p in self._procs:
            self._task_q.put(None)
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        for p in self._procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()
        self._procs = []
