"""The plain versions of the probes P1–P6 (``ops/probes.py``) against the
closed form of the probes' inputs.

The JAX probes (``scripts/probe_matmul.py``, ``scripts/probe_mosaic.py``)
are ``pallas_call``s with TPU memory spaces and no ``interpret`` argument:
they compile only on a TPU and cannot be run here.  What they compute on
their inputs (ones) is known in closed form, and that is what the port's
plain versions are held to; the CUDA kernels are held to the plain
versions on the card (``tests/test_torch_conv3x3_cuda.py``).  On a CPU
tensor every probe takes its plain version.  All checks are exact: the
values are small integers.
"""

import numpy as np
import pytest
import torch

from gantrack_tpu_torch.ops import probes
from gantrack_tpu_torch.utils import profiling

BF16 = torch.bfloat16


@pytest.mark.parametrize("case", range(len(probes.matmul_cases())))
def test_probe_matmul_on_ones_is_k(case):
    label, m, k, n, adt, bdt, odt, b_t = probes.matmul_cases()[case]
    a = torch.ones((m, k), dtype=adt)
    b = torch.ones((n, k) if b_t else (k, n), dtype=bdt)
    out = probes.probe_matmul(a, b, odt, b_t)
    assert out.shape == (m, n) and out.dtype == odt, label
    assert torch.equal(out.float(), torch.full((m, n), float(k)))


def test_probe_matmul_transposed_operand_and_checks():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-3, 4, (16, 32)).astype(np.float32)).to(BF16)
    b = torch.from_numpy(rng.integers(-3, 4, (32, 8)).astype(np.float32)).to(BF16)
    want = torch.from_numpy(a.float().numpy() @ b.float().numpy())
    assert torch.equal(probes.probe_matmul(a, b), want)
    assert torch.equal(probes.probe_matmul(a, b.t().contiguous(), b_transposed=True), want)
    with pytest.raises(ValueError):
        probes.probe_matmul(a, b[:20].contiguous())
    with pytest.raises(ValueError):
        probes.probe_matmul(a[:10].contiguous(), b)


@pytest.mark.parametrize("probe,rows,cols", [("probe_halo_tile", 18, 34),
                                             ("probe_padded_tile", 24, 40)])
def test_conv_tile_probes(probe, rows, cols):
    fn = getattr(probes, probe)
    w = torch.ones((576, 64), dtype=BF16)
    out = fn(torch.ones((4, rows, cols, 64), dtype=BF16), w)
    assert out.shape == (4, 16, 32, 64) and out.dtype == BF16
    assert torch.equal(out.float(), torch.full((4, 16, 32, 64), 576.0))  # 9 taps x 64 channels
    # One non-zero input pixel and one weight: the tile holds that weight
    # where the tap lands, so the tap order is (dy, dx) with ci inside.
    x = torch.zeros((1, rows, cols, 64), dtype=BF16)
    x[0, 5, 7, 3] = 2.0
    w = torch.zeros((576, 64), dtype=BF16)
    dy, dx = 2, 0
    w[(dy * 3 + dx) * 64 + 3, 10] = 3.0
    out = fn(x, w).float()
    assert float(out[0, 5 - dy, 7 - dx, 10]) == 6.0 and float(out.sum()) == 6.0
    with pytest.raises(ValueError):
        fn(torch.ones((4, rows + 1, cols, 64), dtype=BF16), w)


def test_ring_concat_and_row_slice_probes():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(-8, 9, (4, 24, 40, 64)).astype(np.float32)).to(BF16)
    assert torch.equal(probes.probe_ring(x), x[:, :16, :32])
    pieces = torch.from_numpy(rng.integers(-8, 9, (9, 256, 64)).astype(np.float32)).to(BF16)
    cat = probes.probe_concat(pieces)
    assert cat.shape == (256, 576)
    for k in range(9):
        assert torch.equal(cat[:, 64 * k: 64 * (k + 1)], pieces[k])
    rows = torch.from_numpy(rng.integers(-8, 9, (40, 128)).astype(np.float32)).to(BF16)
    assert torch.equal(probes.probe_row_slice(rows), rows[1:33])
    with pytest.raises(ValueError):
        probes.probe_concat(pieces[:, :100].contiguous())
    with pytest.raises(ValueError):
        probes.probe_row_slice(rows.float())


def test_run_probes_prints_the_scripts_lines(capsys):
    with profiling.recording() as rec:
        sums = probes.run_probes("cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(sums) == len(probes.matmul_cases()) + 5
    assert all(": OK sum=" in line for line in lines)
    assert sums["A halo-window-as-it-lies"] == 576.0 * 4 * 16 * 32 * 64
    assert sums["B padded-window-shifted-reads"] == 576.0 * 4 * 16 * 32 * 64
    assert sums["C two-slot-ring-dynslot"] == 4.0 * 16 * 32 * 64
    assert sums["D concat-9x64"] == 256.0 * 576
    assert sums["E row-offset-slice"] == 32.0 * 128
    assert rec.under("probes.launch") == {}  # a CPU run launches no kernel
