"""The traced window's record and what every reader needs from it.

A record is plain data, so the readers can be tested on synthetic ones:

* ``window_us``: the traced window's length;
* ``ops``: device operations ``[label, start_us, dur_us, is_kernel]``,
  kernels named by :func:`kernel_label`, copies and fills with
  ``is_kernel`` false;
* ``spans``: the benchmark's own host spans
  ``[name, start_us, end_us, device_us]``, ``device_us`` the device time
  of the kernels launched inside the span;
* ``counters``: what the traffic kind counted (steps, images, the least
  times of the FIR calls and of the matrix work, and ``untraced_s`` and
  ``traced_s``: the host seconds of the same work run untraced just
  before, and traced).

:func:`profile_record` makes one from a ``torch.profiler`` run that
records host operations and spans too; :func:`device_record` from one
that records device activity alone, with spans taken by the host clock.
"""

from __future__ import annotations

import contextlib
import re
import sys
import time
from typing import Callable, Dict, List, Optional

_FIR_FORMS = ("same (K5)", "down2 (K6)", "up2 (K7)")
_WARP_ROWS = {"upwarp_kernel": "K1 upwarp", "upsplat_kernel": "K2 upsplat",
              "warp_kernel": "K3 warp", "splat_kernel": "K4 splat"}
_DTYPES = {"__nv_bfloat16": "bf16", "float": "f32"}
# A FIR kernel's label (:func:`kernel_label`) or raw name.
FIR_KERNEL = re.compile(r"\[(fir_kernel|fir_up_kernel)\]|\b(fir_kernel|fir_up_kernel)<")


def kernel_label(name: str) -> str:
    """A FIR kernel (``fir_kernel<T, form, taps>``, ``fir_up_kernel<T,
    factor, taps>``) named by form, taps and dtype, a warp kernel
    (K1–K4) by its row, any other kernel by its own name."""
    m = re.search(r"\b(" + "|".join(_WARP_ROWS) + r")<([\w:]+)", name)
    if m:
        kind, dtype = m.groups()
        return f"{_WARP_ROWS[kind]}, {_DTYPES.get(dtype, dtype)} [{kind}]"
    m = re.search(r"\b(fir_kernel|fir_up_kernel)<([\w:]+), (\d+), (\d+)>", name)
    if not m:
        return name
    kind, dtype, form, taps = m.groups()
    what = _FIR_FORMS[int(form)] if kind == "fir_kernel" else f"up{form} (K7)"
    taps = taps if taps != "0" else "any"
    return f"FIR {what}, {taps} taps, {_DTYPES.get(dtype, dtype)} [{kind}]"


def union_us(intervals) -> float:
    """Length of the union of ``(start, dur)`` intervals."""
    total, end = 0.0, float("-inf")
    for start, dur in sorted(intervals):
        stop = start + dur
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def busy_us(record: dict) -> float:
    return union_us((s, d) for _, s, d, _ in record["ops"])


def device_us(record: dict, pattern=None) -> float:
    """Summed device time of the operations whose label matches ``pattern``
    (a compiled regex; None: all)."""
    return sum(d for label, _, d, _ in record["ops"] if pattern is None or pattern.search(label))


def idle_gaps(record: dict) -> List[list]:
    """Gaps between device operations inside the window, each named by
    the benchmark span the host was in when the device fell idle:
    ``[name, seconds]``, longest first (the innermost span: the latest
    to start)."""
    ops = sorted((s, s + d) for _, s, d, _ in record["ops"])
    spans = record["spans"]
    gaps, end = [], record.get("t0_us", ops[0][0] if ops else 0.0)
    for start, stop in ops + [(record.get("t0_us", 0.0) + record["window_us"],) * 2]:
        if start > end:
            host = max(((a, n) for n, a, b, _ in spans if a <= end < b), default=None)
            gaps.append([host[1] if host else "outside the spans", (start - end) / 1e6])
        end = max(end, stop)
    return sorted(gaps, key=lambda g: -g[1])


def breakdown(record: dict, top: int = 10) -> dict:
    by_label: Dict[str, float] = {}
    for label, _, d, _ in record["ops"]:
        by_label[label] = by_label.get(label, 0.0) + d
    ops = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v / 1e6] for k, v in ops], "idle_gaps": idle_gaps(record)[:top]}


@contextlib.contextmanager
def profiler(device, host: bool = True, warm: Optional[Callable[[], None]] = None):
    """``torch.profiler`` over the block, after a warm-up stage that runs
    ``warm`` (default: one small kernel): the profiler's own start-up and
    the first sight of each kernel fall in that stage and not in the
    window.  ``host`` False records device activity alone: the host is
    not slowed by recording each of its operations."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 acc_events=True) as prof:
        if warm is None:
            torch.ones(16, device=device).sum().item()
        else:
            warm()
        prof.step()
        yield prof
        prof.step()


class HostSpans:
    """Host-clock spans (``time.time_ns``, the clock the profiler's
    timeline is kept in) of a device-only trace."""

    def __init__(self):
        self.spans: List[list] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = time.time_ns()
        try:
            yield
        finally:
            self.spans.append([name, start, time.time_ns()])


def _trace_start_ns(prof) -> int:
    results = prof.profiler.kineto_results
    if hasattr(results, "trace_start_ns"):
        return int(results.trace_start_ns())
    return int(results.trace_start_us()) * 1000


def device_record(prof, window_ns, spans: HostSpans) -> dict:
    """The record of a finished device-only ``torch.profiler.profile``
    run whose window is the host-clock interval ``window_ns`` (which ends
    after a device synchronise); device operations are clipped to it."""
    origin = _trace_start_ns(prof)
    t0, t1 = ((t - origin) / 1e3 for t in window_ns)
    ops = [[label, max(s, t0), min(s + d, t1) - max(s, t0), k]
           for label, s, d, k in _device_ops(prof) if s < t1 and s + d > t0]
    if not ops:
        raise RuntimeError("the device trace holds no operation inside the host's window")
    return {"t0_us": t0, "window_us": t1 - t0, "ops": ops,
            "spans": [[n, (a - origin) / 1e3, (b - origin) / 1e3, 0.0] for n, a, b in spans.spans],
            "counters": {}}


def _device_ops(prof, skip=()) -> List[list]:
    import torch

    ops = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.name in skip \
                or getattr(ev, "is_user_annotation", False):
            continue  # a host span's shadow on the device timeline
        start, end = ev.time_range.start, ev.time_range.end
        is_kernel = not ev.name.lower().startswith(("memcpy", "memset"))
        ops.append([kernel_label(ev.name) if is_kernel else ev.name, start, end - start,
                    is_kernel])
    return ops


def report(record: dict) -> None:
    """One line on standard error: the traced window against the same
    work untraced, and where its operations begin and end in it."""
    c = record["counters"]
    ops = record["ops"]
    first = min(s for _, s, _, _ in ops) - record["t0_us"]
    last = record["t0_us"] + record["window_us"] - max(s + d for _, s, d, _ in ops)
    print(f"trace: {c['traced_s']!r} s traced against {c['untraced_s']!r} s untraced "
          f"(slowdown {slowdown(record)!r}); first operation {first:.0f} us after the "
          f"window's start, last ends {last:.0f} us before its end", file=sys.stderr)


def slowdown(record: dict) -> Optional[float]:
    """How much longer the traced work took than the same work untraced
    (a share); None without both readings."""
    c = record["counters"]
    if not c.get("untraced_s") or not c.get("traced_s"):
        return None
    return c["traced_s"] / c["untraced_s"] - 1.0


@contextlib.contextmanager
def record_fir_calls(calls: Dict[tuple, int]):
    """Counts every FIR kernel call of the program by ``(spec, planes
    shape, dtype)`` while the block runs (the program's launch entry
    ``fir.fir_planes``, wrapped and put back)."""
    from gantrack_tpu_torch.ops import fir

    launch = fir.fir_planes

    def recording(x, spec, **kw):
        key = (spec, tuple(x.shape), str(x.dtype).replace("torch.", ""))
        calls[key] = calls.get(key, 0) + 1
        return launch(x, spec, **kw)

    fir.fir_planes = recording
    try:
        yield calls
    finally:
        fir.fir_planes = launch


def profile_record(prof, span_names, window: str = "window") -> dict:
    """The record of a finished ``torch.profiler.profile`` run (host and
    device) whose window is the host span ``window`` (which ends after a
    device synchronise); device operations are clipped to it.
    ``span_names`` are the benchmark's other spans."""
    import torch

    spans = [[ev.name, ev.time_range.start, ev.time_range.end, ev.device_time_total]
             for ev in prof.events() if ev.device_type != torch.autograd.DeviceType.CUDA
             and (ev.name in span_names or ev.name == window)]
    (t0, t1), = [(a, b) for name, a, b, _ in spans if name == window]
    clipped = [[label, max(s, t0), min(s + d, t1) - max(s, t0), k]
               for label, s, d, k in _device_ops(prof, tuple(span_names) + (window,))
               if s < t1 and s + d > t0]
    return {"t0_us": t0, "window_us": t1 - t0, "ops": clipped,
            "spans": [sp for sp in spans if sp[0] != window], "counters": {}}
