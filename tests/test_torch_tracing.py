"""The port's spans and counters (``gantrack_tpu_torch.utils.profiling``).

* Without a recorder ``span`` hands back one shared no-op context and
  reads no clock, and ``count`` keeps nothing.
* With one: nesting, parents, threads and identifiers (a child carries
  its parent's), a span that raises, recorders one inside another, and
  counts from many threads at once.
* Where the program records: a claro-like step (G-reg and D-reg, two
  chunks) gives Gmain, Greg, Dmain, Dreg in order, each with its chunks'
  forward and backward and its ``opt``, the path-length and R1 passes
  inside their chunks' forward, and one step number throughout; the
  loader's ``data.fetch`` and ``data.h2d``; the metric tick's generate,
  detect, fetch and sums once a batch with the pass's seed; and
  ``upfirdn2d``'s routing counters, kernel and plain by reason.
* ``launched_device_us`` on a synthetic trace: each device operation goes
  to the spans open when the runtime or driver call with its correlation
  id started; a span's device time is the union of its operations'.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from gantrack_tpu_torch.data import InfiniteLoader
from gantrack_tpu_torch.metrics.metric_utils import (Detector, MetricOptions,
                                                     compute_feature_stats_for_generator)
from gantrack_tpu_torch.models import stylegan2 as tsg2
from gantrack_tpu_torch.ops.upfirdn2d import Filter, setup_filter, upfirdn2d
from gantrack_tpu_torch.training import loss as tloss
from gantrack_tpu_torch.training import step as tstep
from gantrack_tpu_torch.training.loop import to_device_batch
from gantrack_tpu_torch.training.train_state import create_train_state
from gantrack_tpu_torch.utils import profiling

torch.set_num_threads(1)

RES, ZDIM, BATCH = 16, 8, 4
G_KW = dict(z_dim=ZDIM, c_dim=0, w_dim=ZDIM, img_resolution=RES, img_channels=1,
            mapping_kwargs=dict(num_layers=2),
            synthesis_kwargs=dict(channel_base=128, channel_max=32, num_fp16_res=0))
D_KW = dict(c_dim=0, img_resolution=RES, img_channels=1, channel_base=128, channel_max=32,
            num_fp16_res=0, epilogue_kwargs=dict(mbstd_group_size=2))


def _tree(rec):
    """Each span as (name, parent's name, ids)."""
    return [(n, None if p is None else rec.spans[p][0], ids) for n, p, _, _, _, ids in rec.spans]


def test_without_a_recorder_span_is_the_shared_no_op_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a span without a recorder read the clock")

    monkeypatch.setattr(time, "time_ns", no_clock)
    first, second = profiling.span("a", step=1), profiling.span("b")
    assert first is second is profiling.NO_SPAN
    with first as entered:
        assert entered is profiling.NO_SPAN


def test_without_a_recorder_count_keeps_nothing():
    profiling.count("fir.launch/same", 3)
    with profiling.recording() as rec:
        pass
    profiling.count("fir.launch/same")
    assert rec.counters == {} and rec.spans == []


def test_spans_nest_with_parents_threads_and_inherited_ids():
    seen = {}

    def other():
        seen["thread"] = threading.get_native_id()
        with profiling.span("elsewhere", seed=7):
            pass

    with profiling.recording() as rec:
        with profiling.span("Gmain", step=3):
            with profiling.span("forward", chunk=1):
                with profiling.span("pl_grads"):
                    worker = threading.Thread(target=other)
                    worker.start()
                    worker.join(timeout=10)
            with profiling.span("opt"):
                profiling.count("fir.launch/up2", 2)
                profiling.count("fir.launch/up2")
        with profiling.span("ema", step=3):
            pass
    assert not worker.is_alive()
    here = threading.get_native_id()
    by_name = {s[0]: s for s in rec.spans}
    assert _tree(rec)[:3] == [("Gmain", None, {"step": 3}),
                              ("forward", "Gmain", {"step": 3, "chunk": 1}),
                              ("pl_grads", "forward", {"step": 3, "chunk": 1})]
    assert by_name["opt"][1] == 0 and by_name["ema"][1] is None
    # Another thread has a stack of its own: no parent, its own thread id.
    assert by_name["elsewhere"][1] is None and by_name["elsewhere"][5] == {"seed": 7}
    assert by_name["elsewhere"][4] == seen["thread"] != here
    assert all(s[4] == here for s in rec.spans if s[0] != "elsewhere")
    for name, parent, start, end, _, _ in rec.spans:
        assert start <= end
        if parent is not None:
            assert rec.spans[parent][2] <= start and end <= rec.spans[parent][3]
    assert rec.counters == {"fir.launch/up2": 3}
    assert rec.under("fir.launch") == {"up2": 3} and rec.under("fir") == {}


def test_a_span_that_raises_is_closed_and_the_recorder_put_back():
    with profiling.recording() as outer:
        with pytest.raises(ValueError):
            with profiling.span("data.fetch"):
                raise ValueError("no batch")
        with profiling.recording() as inner:
            with profiling.span("metric.sums"):
                profiling.count("upfirdn2d.kernel_route")
        with profiling.span("data.h2d"):
            pass
    assert [s[0] for s in outer.spans] == ["data.fetch", "data.h2d"]
    assert outer.spans[0][3] is not None and outer.spans[1][1] is None
    assert [s[0] for s in inner.spans] == ["metric.sums"] and outer.counters == {}
    assert inner.counters == {"upfirdn2d.kernel_route": 1}
    assert profiling.span("after") is profiling.NO_SPAN


def test_counts_from_many_threads_are_not_lost():
    workers, each = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            threads = [threading.Thread(target=lambda: [profiling.count("k") for _ in range(each)])
                       for _ in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert rec.counters == {"k": workers * each}


def _stepper():
    torch.manual_seed(0)
    g, d = tsg2.Generator(**G_KW), tsg2.Discriminator(**D_KW)
    state = create_train_state(g, d, 0.002, 0.002)
    loss = tloss.StyleGAN2Loss(g, d, tloss.StyleGAN2LossConfig(
        r1_gamma=1.0, style_mixing_prob=0.0, pl_weight=2.0, noise_mode="const"))
    stepper = tstep.TrainStepper(loss, tstep.TrainStepConfig(
        batch_size=BATCH, z_dim=ZDIM, ada_target=0.6, ada_interval=4, micro_batches=2),
        torch.Generator().manual_seed(1))
    return state, stepper


def test_a_step_with_both_regularisations_spans_its_phases_in_order():
    state, stepper = _stepper()
    state.step = 32  # a step of both intervals, as the CLI's schedule has it
    reals = torch.randn((BATCH, 1, RES, RES), generator=torch.Generator().manual_seed(2))
    assert stepper.phase_flags(state.step) == (True, True)
    with profiling.recording() as rec:
        stepper(state, reals)
    tree = _tree(rec)
    tops = [n for n, parent, _ in tree if parent is None]
    assert tops == ["Gmain", "Greg", "Dmain", "Dreg", "ema", "ada"]
    assert all(ids.get("step") == 32 for _, _, ids in tree)
    for phase in ("Gmain", "Greg", "Dmain", "Dreg"):
        inner = [(n, ids.get("chunk")) for n, parent, ids in tree if parent == phase]
        assert inner == [("forward", 0), ("backward", 0), ("forward", 1), ("backward", 1),
                         ("opt", None)], phase
    assert [(n, parent, ids["chunk"]) for n, parent, ids in tree if n.endswith("_grads")] == [
        ("pl_grads", "forward", 0), ("pl_grads", "forward", 1),
        ("r1_grads", "forward", 0), ("r1_grads", "forward", 1)]
    # A plain step has neither regularisation phase.
    with profiling.recording() as plain:
        stepper(state, reals)
    assert [n for n, p, _ in _tree(plain) if p is None] == ["Gmain", "Dmain", "ema", "ada"]


def test_the_loader_and_the_device_batch_are_spans():
    class Rows:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return np.full((RES, RES, 1), i, np.uint8), np.zeros(0, np.float32)

    for workers in (0, 1):
        loader = InfiniteLoader(Rows(), batch_size=2, seed=0, start=workers > 0,
                                num_workers=max(workers, 1))
        try:
            with profiling.recording() as rec:
                images, labels = next(loader)
                img, _ = to_device_batch(images, labels, torch.device("cpu"))
        finally:
            loader.close()
        assert img.shape == (2, 1, RES, RES)
        assert [(n, p) for n, p, *_ in rec.spans] == [("data.fetch", None), ("data.h2d", None)]


def test_the_generator_pass_spans_each_batch_with_its_seed():
    def generator(z, c):
        return torch.tanh(z[:, :1, None, None].expand(-1, 1, RES, RES))

    det = Detector(lambda x: x.flatten(1)[:, :16], "first-pixels", torch.device("cpu"))
    opts = MetricOptions(generator=generator, detector=det, batch_size=4, seed=11, z_dim=ZDIM)
    with profiling.recording() as rec:
        stats = compute_feature_stats_for_generator(opts, capture_mean_cov=True, max_items=8)
    assert stats.num_items == 8
    names = [n for n, *_ in rec.spans]
    assert names == ["metric.generate", "metric.detect", "metric.fetch", "metric.sums"] * 2
    assert all(p is None for _, p, *_ in rec.spans)
    assert [ids for *_, ids in rec.spans if ids] == [{"seed": 11}] * 6


def _route_case(case):
    f = Filter(setup_filter([1, 3, 3, 1]))
    if case == "kernel":
        return f, dict(up=2, padding=[2, 1, 2, 1]), "upfirdn2d.kernel_route"
    if case == "x4 kernel":
        return f, dict(up=4, padding=[2, 1, 2, 1]), "upfirdn2d.kernel_route"
    if case == "factor 4":  # a factor 4 outside the kernels' contract: 33 taps
        f33 = Filter(setup_filter(np.hanning(35)[1:-1]))
        return f33, dict(up=4, padding=[17, 16, 17, 16]), \
            "upfirdn2d.plain_route/33 x 33 taps (at most 32 per axis)"
    radial = torch.outer(torch.arange(1.0, 5.0), torch.arange(1.0, 5.0)) + torch.eye(4)
    return Filter(radial), dict(padding=[1, 2, 1, 2]), \
        "upfirdn2d.plain_route/2-D filter, not separable"


@pytest.mark.parametrize("case", ["kernel", "factor 4", "radial", "x4 kernel"])
def test_upfirdn2d_counts_its_route_where_it_decides(case):
    f, kw, key = _route_case(case)
    x = torch.randn((2, 3, 8, 8), generator=torch.Generator().manual_seed(3))
    with profiling.recording() as rec:
        upfirdn2d(x, f, **kw)
    # On the CPU the kernel route computes the plain form: no launch counted.
    assert rec.counters == {key: 1}


class _Event:
    """What ``launched_device_us`` reads of a profiler's event (times in us)."""

    def __init__(self, name, device, corr, start_us, end_us, annotation=False):
        self.values = (name, device, corr, int(start_us * 1e3), int(end_us * 1e3), annotation)

    def name(self):
        return self.values[0]

    def device_type(self):
        return self.values[1]

    def correlation_id(self):
        return self.values[2]

    def start_ns(self):
        return self.values[3]

    def end_ns(self):
        return self.values[4]

    def is_user_annotation(self):
        return self.values[5]


def _prof(events):
    results = type("Results", (), {"events": lambda self: events})()
    return type("Prof", (), {"profiler": type("P", (), {"kineto_results": results})()})()


CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
# A phase [0, 100) us with a chunk's forward [15, 50) inside it, then the
# tail [100, 110); a recorder's form, times in ns.
SPANS = [["Gmain", None, 0, 100_000, 7, {"step": 3}],
         ["forward", 0, 15_000, 50_000, 7, {"step": 3, "chunk": 0}],
         ["ema", None, 100_000, 110_000, 7, {"step": 3}]]


def test_device_time_goes_to_the_spans_open_at_each_launch():
    events = [
        _Event("cudaLaunchKernel", CPU, 11, 5, 6),
        _Event("void fir_kernel<__nv_bfloat16, 0, 4>(FirArgs)", CUDA, 11, 10, 30),
        _Event("cuLaunchKernel", CPU, 12, 20, 21),               # a driver launch
        _Event("sm90_xmma_gemm_bf16", CUDA, 12, 25, 45),         # overlaps the one before
        _Event("cudaMemcpyAsync", CPU, 13, 60, 61),
        _Event("Memcpy DtoH (Device -> Pageable)", CUDA, 13, 62, 70),
        _Event("aten::mm", CPU, 14, 1, 2),                       # a host op, not a launch
        _Event("cudaLaunchKernel", CPU, 14, 120, 121),           # after every span
        _Event("elementwise_kernel", CUDA, 14, 122, 130),
        _Event("Lazy Function Loading", CPU, 15, 0.5, 0.6),      # CUPTI's own record
        _Event("orphan_kernel", CUDA, 15, 140, 141),             # no launch in the trace
        _Event("generator", CUDA, 0, 0, 200, annotation=True),   # a host span's shadow
    ]
    device, share = profiling.launched_device_us(SPANS, _prof(events))
    # Gmain launched at 5, 20 and 60: [10, 45] and [62, 70]; its forward the one at 20.
    assert device == [35.0 + 8.0, 20.0, 0.0]
    # Busy [10, 45] + [62, 70] + [122, 130] + [140, 141] = 52 us; the top spans launched 43.
    assert share == pytest.approx(43.0 / 52.0)
    assert profiling.launched_device_us(SPANS, _prof(events[6:7])) == ([0.0, 0.0, 0.0], None)
