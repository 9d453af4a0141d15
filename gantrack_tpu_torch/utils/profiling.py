"""Memory readings for the training loop's tick record, and the port's
spans and counters.

Port of the part of ``gantrack_tpu/utils/profiling.py`` that the loop
calls: :func:`device_memory_stats` maps ``torch.cuda.memory_stats`` to
the JAX package's keys (``gb_in_use``, ``peak_gb_in_use``, ``gb_limit``),
and :func:`cpu_mem_gb` reads the process's current resident memory.

Spans and counters (one recorder for the whole process):

* ``with span(name, **ids):`` marks a piece of host work where it
  happens (the training step's phases, the loader, the metric tick's
  passes).  With no recorder installed it returns one shared no-op
  context: one module-global check, no clock read, no object made.
* ``count(key, n=1)`` adds ``n`` to a counter (the kernels' launches by
  form, the FIR routing decisions); nothing without a recorder.
* ``with recording() as rec:`` installs a :class:`Recorder` for the block
  and yields it.  ``rec.spans`` holds ``[name, parent, start_ns, end_ns,
  thread, ids]`` in the order the spans opened: ``parent`` is the index
  of the span open on the same thread when this one opened (None at the
  top), times are ``time.time_ns()`` (the clock ``torch.profiler``'s
  timeline is kept in), ``thread`` is the OS thread id, and ``ids``
  are the identifiers passed, over those of the parent (the step number
  in training, the round's seed in the metric tick).  ``rec.counters``
  maps each key to its count.

A span never synchronises the device and opens no
``torch.profiler.record_function``: it reads the host clock only, so it
adds no operation to a device trace.  :func:`launched_device_us` puts
the device operations of a ``torch.profiler`` run down to the spans
recorded during it, by the launch of each operation.
"""

from __future__ import annotations

import bisect
import contextlib
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple


def device_memory_stats(device=None) -> Dict[str, float]:
    """Current and peak allocated memory of a CUDA device and its size, in
    GiB, under the JAX package's keys; ``{}`` for the CPU."""
    import torch  # here: the data modules import this module without torch

    device = torch.device(device) if device is not None else None
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "gb_in_use": stats.get("allocated_bytes.all.current", 0) / 2**30,
        "peak_gb_in_use": stats.get("allocated_bytes.all.peak", 0) / 2**30,
        "gb_limit": torch.cuda.mem_get_info(device)[1] / 2**30,
    }


def cpu_mem_gb() -> Optional[float]:
    """The process's current resident memory in GiB (``/proc/self/statm``;
    None where there is no ``/proc``)."""
    try:
        with open("/proc/self/statm") as f:
            resident_pages = int(f.read().split()[1])
    except OSError:
        return None
    return resident_pages * os.sysconf("SC_PAGE_SIZE") / 2**30


class Recorder:
    """The spans and counters recorded while it is installed (see the
    module docstring for their form)."""

    def __init__(self):
        self.spans: List[list] = []
        self.counters: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def under(self, prefix: str) -> Dict[str, int]:
        """The counters ``<prefix>/<name>``, by name."""
        head = prefix + "/"
        return {k[len(head):]: n for k, n in self.counters.items() if k.startswith(head)}

    def _count(self, key: str, n: int) -> None:
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + n

    def _close(self) -> None:
        """Parents as indices into ``spans`` (they are held as the parent's
        own entry while recording)."""
        index = {id(entry): i for i, entry in enumerate(self.spans)}
        for entry in self.spans:
            if isinstance(entry[1], list):
                entry[1] = index[id(entry[1])]


class _Span:
    __slots__ = ("rec", "name", "ids", "entry")

    def __init__(self, rec: Recorder, name: str, ids: dict):
        self.rec, self.name, self.ids = rec, name, ids

    def __enter__(self):
        stack = self.rec._stack()
        parent = stack[-1] if stack else None
        ids = {**parent[5], **self.ids} if parent is not None and parent[5] else self.ids
        self.entry = [self.name, parent, time.time_ns(), None, threading.get_native_id(), ids]
        stack.append(self.entry)
        self.rec.spans.append(self.entry)
        return self

    def __exit__(self, *exc) -> bool:
        self.entry[3] = time.time_ns()
        self.rec._stack().pop()
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()
_RECORDER: Optional[Recorder] = None


def span(name: str, **ids):
    """A span of host work named ``name``, with identifiers ``ids``; the
    shared no-op :data:`NO_SPAN` when no recorder is installed."""
    rec = _RECORDER
    if rec is None:
        return NO_SPAN
    return _Span(rec, name, ids)


def count(key: str, n: int = 1) -> None:
    """Adds ``n`` to the installed recorder's counter ``key``; nothing
    without one."""
    rec = _RECORDER
    if rec is not None:
        rec._count(key, n)


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Installs a fresh :class:`Recorder` for the block (the one installed
    before is put back after it) and yields it."""
    global _RECORDER
    rec, outer = Recorder(), _RECORDER
    _RECORDER = rec
    try:
        yield rec
    finally:
        _RECORDER = outer
        rec._close()


def launched_device_us(spans: List[list], prof) -> Tuple[List[float], Optional[float]]:
    """The device time each of a recorder's ``spans`` launched during the
    finished ``torch.profiler`` run ``prof`` (CUDA activity recorded), and
    the share of the device's busy time that the top-level spans launched
    (None where the trace holds no device operation).

    A device operation belongs to the spans that were open on the host
    when the runtime or driver call that launched it started
    (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...: the
    call with the operation's correlation id); a span's device time is the
    union of its operations' intervals, its children's included.  Launches
    are put down by their time alone, on whichever thread they ran.
    Operations that are host spans' shadows (user annotations) are left
    out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    launch: Dict[int, int] = {}
    ops = []
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation():
            continue
        if ev.device_type() == cuda:
            ops.append((ev.correlation_id(), ev.start_ns(), ev.end_ns()))
        elif ev.name().startswith("cu"):  # a runtime (cuda...) or driver (cu...) call
            corr, t = ev.correlation_id(), ev.start_ns()
            if t < launch.get(corr, t + 1):
                launch[corr] = t
    launched = sorted((launch[c], a, b) for c, a, b in ops if c in launch)
    keys = [t for t, _, _ in launched]
    device = [_union_us(launched[bisect.bisect_left(keys, a):bisect.bisect_left(keys, b)])
              for _, _, a, b, _, _ in spans]
    busy = _union_us(ops)
    if busy <= 0:
        return device, None
    tops = _union_intervals((a, b) for _, parent, a, b, _, _ in spans if parent is None)
    starts = [a for a, _ in tops]
    inside = [op for op in launched
              if (i := bisect.bisect_right(starts, op[0]) - 1) >= 0 and op[0] < tops[i][1]]
    return device, _union_us(inside) / busy


def _union_intervals(intervals) -> List[Tuple[int, int]]:
    """The union of ``(start, end)`` intervals, as disjoint ones in order."""
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _union_us(ops) -> float:
    """Microseconds covered by the ``(_, start_ns, end_ns)`` of ``ops``."""
    return sum(b - a for a, b in _union_intervals((a, b) for _, a, b in ops)) / 1e3
