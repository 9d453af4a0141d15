"""Every per-layer metric's reader on a synthetic traced record, and the
record's arithmetic (busy time, idle gaps, breakdown)."""

import pytest

from h100_bench import core, trace

BENCH = core.load_json(core.ROOT, "BENCHMARK.json")
FIR = "void fir_kernel<__nv_bfloat16, 0, 4>(FirArgs)"

# A 10 ms window from t = 1000 us: four kernels and a copy, two of them
# overlapping; the host in ``loader`` then ``step`` twice.
RECORD = {
    "t0_us": 1000.0,
    "window_us": 10000.0,
    "ops": [
        [trace.kernel_label(FIR), 1000.0, 1000.0, True],
        ["void cudnn::conv_depthwise2d_forward_kernel<float>", 2500.0, 2000.0, True],
        ["sm90_xmma_gemm_bf16", 4000.0, 1000.0, True],      # overlaps the one before
        ["ncclDevKernel_AllReduce_Sum_f32_RING_LL", 6000.0, 500.0, True],
        ["Memcpy HtoD (Pageable -> Device)", 9000.0, 1000.0, False],
    ],
    "spans": [["loader", 1000.0, 1500.0, 0.0], ["step", 1500.0, 6000.0, 4500.0],
              ["loader", 6000.0, 7000.0, 0.0], ["step", 7000.0, 11000.0, 1000.0],
              ["generator", 1500.0, 4000.0, 2000.0], ["detector", 4000.0, 6000.0, 1500.0]],
    "counters": {"steps": 2, "images": 64, "least_s": 0.0025, "fir_least_s": 0.0004,
                 "untraced_s": 0.01, "traced_s": 0.0102, "loader_s": 0.0015},
}
# busy: [1000, 2000] + [2500, 5000] + [6000, 6500] + [9000, 10000] = 5000 us
EXPECTED = {
    "loader_wait_ms.train": (0.5 + 1.0) / 2,
    "launches_per_img.train": 4 / 64,
    "plain_fir_share.train": 100 * 2000 / 5500,
    "fir_roofline.train": 100 * 400 / 1000,
    "idle_share.train": 50.0,
    "idle_share.eval": 50.0,
    "mfu.train": 25.0,
    "mfu.eval": 25.0,
    "nccl_share.train": 100 * 500 / 5500,
    "gen_ms_per_img.eval": 2.0 / 64,
    "detector_ms_per_img.eval": 1.5 / 64,
}


def test_every_metric_of_the_benchmark_has_a_case():
    assert {m["name"] for m in BENCH["per_layer"]} <= set(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader(name):
    assert core.reader_for(name).read(RECORD) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_with_nothing_to_read_returns_none(name):
    empty = {"t0_us": 0.0, "window_us": 1000.0, "ops": [], "spans": [], "counters": {}}
    assert core.reader_for(name).read(empty) is None


@pytest.mark.parametrize("name", ["idle_share.train", "idle_share.eval"])
def test_idle_share_is_of_the_untraced_time(name):
    slow = dict(RECORD, window_us=20000.0, counters=dict(RECORD["counters"], traced_s=0.02))
    assert core.reader_for(name).read(slow) == pytest.approx(50.0)
    busier = dict(RECORD, counters=dict(RECORD["counters"], untraced_s=0.004))
    assert core.reader_for(name).read(busier) is None


def test_a_metric_without_a_file_of_its_own_is_read_by_its_stem():
    assert core.reader_for("mfu.train").__file__.endswith("mfu.py")
    assert core.reader_for("fir_roofline.train").__file__.endswith("fir_roofline.train.py")


def test_shares_stay_at_or_under_100_percent():
    full = dict(RECORD, window_us=5000.0, t0_us=1000.0,
                counters=dict(RECORD["counters"], least_s=0.005))
    for name in ("idle_share.train", "mfu.train", "plain_fir_share.train", "nccl_share.train"):
        assert 0.0 <= core.reader_for(name).read(full) <= 100.0


def test_busy_idle_gaps_and_breakdown():
    assert trace.busy_us(RECORD) == 5000.0
    gaps = trace.idle_gaps(RECORD)
    assert gaps[0] == ["loader", 0.0025]     # 6500 .. 9000, the host in the loader
    assert ["detector", 0.001] in gaps and ["step", 0.001] in gaps   # 5000 .. 6000, 10000 ..
    assert sorted(g[1] for g in gaps) == pytest.approx([0.0005, 0.001, 0.001, 0.0025])
    b = trace.breakdown(RECORD)
    assert b["device_ops"][0] == ["void cudnn::conv_depthwise2d_forward_kernel<float>", 0.002]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_kernel_labels():
    assert trace.kernel_label(FIR) == "FIR same (K5), 4 taps, bf16 [fir_kernel]"
    assert trace.kernel_label("void fir_up_kernel<float, 2, 12>(A)") == \
        "FIR up2 (K7), 12 taps, f32 [fir_up_kernel]"
    assert trace.kernel_label("void upwarp_kernel<__nv_bfloat16>(B)") == \
        "K1 upwarp, bf16 [upwarp_kernel]"
    assert trace.kernel_label("ampere_sgemm") == "ampere_sgemm"
    assert trace.FIR_KERNEL.search(trace.kernel_label(FIR))
