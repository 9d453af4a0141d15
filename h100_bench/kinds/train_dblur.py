"""Training traffic whose discriminator sees StyleGAN3-R's blur ramp.

The ``train`` kind (:mod:`.train`), its functions run inside
:func:`blurred`, which differs in two ways:

* the plain references blur every image D sees before the augment
  (:class:`..reference.blur.BlurTrainer`), with ``σ₀`` and the fade that
  the configuration's family and batch give as NVIDIA's ``train.py``
  derives them (:func:`..reference.blur.ramp`: 10 and ``batch · 200 / 32``
  kimg for ``stylegan3-r``, no blur otherwise), never read from the
  program;
* a traced run keeps the program's own spans and counters of the traced
  cycle (``utils.profiling``'s recorder, opened inside the profiler
  after its warm-up step, so the untraced cycle's seconds are free of
  it): ``record["program_spans"]``, ``[name, parent, start_us, end_us,
  device_us, ids]`` on the record's clock with the device time each span
  launched, and ``record["program_counters"]``; and prints the blur's
  device ms a step (the ``d_blur`` spans' launches: the blur's forward
  passes) and the plain-route share of the ``upfirdn2d`` calls.  No
  metric reads them yet.  A program without the ``d_blur`` span runs
  the same cycle and prints that it has none.

Traffic parameters: the ``train`` kind's.  Faults: the calibration
plants them around :func:`readings` (as it does for every kind but
``train``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Optional

from .. import core
from .. import trace
from ..reference import blur as ref_blur
from ..reference import training as ref_training
from . import train


def _blur_trainer(family: str):
    """``ref_training.Trainer`` with the blur ramp of ``family`` at the
    step's global batch."""
    def make(G, D, cfg, *args, **kwargs):
        sigma0, fade = ref_blur.ramp(family, cfg.batch)
        return ref_blur.BlurTrainer(G, D, cfg, *args, blur_init_sigma=sigma0,
                                    blur_fade_kimg=fade, **kwargs)
    return make


def _program_record(rec, prof, record: dict) -> None:
    """The recorder's spans on the record's clock, with the device time
    each launched, and its counters, into ``record``."""
    from gantrack_tpu_torch.utils import profiling

    device, _ = profiling.launched_device_us(rec.spans, prof)
    origin = trace._trace_start_ns(prof)
    record["program_spans"] = [[name, parent, (a - origin) / 1e3, (b - origin) / 1e3, us, ids]
                               for (name, parent, a, b, _, ids), us in zip(rec.spans, device)]
    record["program_counters"] = dict(rec.counters)


def _report_blur(record: dict) -> None:
    steps = record["counters"]["steps"]
    c = record["program_counters"]
    blur = [sp for sp in record["program_spans"] if sp[0] == "d_blur"]
    plain = sum(n for k, n in c.items() if k.startswith("upfirdn2d.plain_route/"))
    calls = plain + c.get("upfirdn2d.kernel_route", 0)
    share = f"{100 * plain / calls!r} %" if calls else "no call"
    taps = {k.split("/", 1)[1]: n for k, n in c.items() if k.startswith("loss.blur/")}
    print(("trace: D's blur " + (f"{sum(sp[4] for sp in blur) / 1e3 / steps!r} device ms a step "
                                 f"in {len(blur)} d_blur spans, taps {taps}" if blur
                                 else "has no d_blur span")
           + f"; plain-route share of the upfirdn2d calls {share} ({plain} of {calls})"),
          file=sys.stderr)


@contextlib.contextmanager
def blurred(ctx: core.Context):
    """The ``train`` kind's functions, inside the block, build the blurred
    reference, and their traced cycle (``trace.profiler``, which
    ``train._traced`` looks up when it runs) runs under the program's
    recorder, whose spans and counters ``trace.report`` adds to the
    record before it reports."""
    from gantrack_tpu_torch.utils import profiling

    profiler, report, trainer = trace.profiler, trace.report, ref_training.Trainer
    kept = {}

    @contextlib.contextmanager
    def recorded(*args, **kwargs):
        with profiler(*args, **kwargs) as prof:
            with profiling.recording() as rec:
                yield prof
        kept.update(prof=prof, rec=rec)

    def report_program(record: dict) -> None:
        report(record)
        if kept:
            _program_record(kept.pop("rec"), kept.pop("prof"), record)
            _report_blur(record)

    trace.profiler, trace.report = recorded, report_program
    ref_training.Trainer = _blur_trainer(ctx.config["model"]["family"])
    try:
        yield
    finally:
        trace.profiler, trace.report, ref_training.Trainer = profiler, report, trainer


def run(ctx: core.Context) -> core.Outcome:
    with blurred(ctx):
        return train.run(ctx)


def readings(ctx: core.Context, control: Optional[str] = None):
    """``train.readings`` with the blurred references; the fault, if any,
    is planted by the caller."""
    with blurred(ctx):
        return train.readings(dataclasses.replace(ctx, fault=None), control)
