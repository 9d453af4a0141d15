"""Device time of one profiled training step by kernel, on one NVIDIA GPU,
for this checkout or another one of the repository.

    python3 step_profile.py            # claro, StyleGAN3-T, unfused claro
    python3 step_profile.py --ab=DIR   # DIR's tree and this one in turns:
                                       # DIR, this, this, DIR

Each configuration is built as the training CLI builds it, from a fixed
seed, on a synthetic 256² dataset: the claro StyleGAN2-ADA recipe at
batch 32 (default routes), StyleGAN3-T at full width at batch 16
(``chip_smoke.CLARO_ARGS``, ``chip_smoke.SG3_ARGS``) and the claro recipe
with ``AugmentPipe(impl="unfused")`` (K7 → K3 → K6, K4 in the backward),
with ADA p = 0.3.  After three warm-up steps it takes three plain steps
on the host clock (median) and one plain step under ``torch.profiler``;
the rows of the FIR kernels are named by form and tap count, those of
K1–K4 by kernel (``chip_smoke.kernel_label``).  Then it takes a digest
of what K7, K6, K5 and K4 give at StyleGAN3-T's largest ×2 and ↓2 calls,
the claro G post-filter and the unfused augment's warp, of what K1 and
K2 give at the augment's call (bf16, 64 planes of 406 × 403 ↔ 524²,
transforms drawn by the pipe at p = 1), and of what K3 gives at its two
calls (``chip_smoke._warp_cases``), from seeded inputs.  With ``--ab``
each turn is a process of its own that imports the ``gantrack_tpu_torch``
of its tree (so each tree builds and launches its own kernels), and the
last lines compare the turns: times, the FIR rows by form, tap count and
dtype, the K1–K4 rows, and whether the two trees' kernels give the same
bits.  Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = ("claro", "stylegan3-t", "claro-unfused")


def profile_tree(tree: str) -> dict:
    """Profile one plain step of each configuration with the package of
    ``tree``.  Returns {cfg: {"total_ms", "rows", "step_ms"}, "digests":
    {kernel: sha256 of its output}}."""
    import chip_smoke as cs  # this tree's script; the package comes from ``tree``

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from gantrack_tpu_torch.tools import train as cli
    from gantrack_tpu_torch.training.loop import to_device_batch

    card = cs.card_line()
    print(f"tree {os.path.abspath(tree)}: package {os.path.dirname(cli.__file__)}; card {card}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    with tempfile.TemporaryDirectory(prefix="step_profile_") as tmp:
        data = cs._synthetic_dataset(tmp, count=64)
        for cfg in CONFIGS:
            args = cs.CLARO_ARGS if cfg.startswith("claro") else [*cs.SG3_ARGS, "--batch=16"]
            opts = cli.build_parser().parse_args([f"--outdir={tmp}", f"--data={data}", *args])
            device = cs._cli_device(cli, args)
            torch.manual_seed(0)
            impl = "unfused" if cfg == "claro-unfused" else "fused"
            _, loader, state, stepper = cli.build_training(cli.resolve_config(opts), opts, device,
                                                           augment_impl=impl)
            try:
                real_img, real_c = to_device_batch(*next(loader), device)
            finally:
                loader.close()
            state.ada_p = torch.tensor(0.3, device=device)
            for _ in range(3):
                stepper.run(state, real_img, real_c, False, False)
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                stepper.run(state, real_img, real_c, False, False)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            step_ms = sorted(times)[1]
            print(f"  {cfg}: plain step median {step_ms:.1f} ms of 3 (host clock) on {card}")
            out[cfg] = {**cs._profile_step(stepper, state, real_img, real_c, (False, False), card,
                                           f"plain {cfg}"), "step_ms": step_ms}
            del state, stepper, real_img, real_c
            torch.cuda.empty_cache()
    out["digests"] = kernel_digests()
    for kernel, digest in out["digests"].items():
        print(f"  {kernel}: sha256 {digest}")
    return out


def _digest(t) -> str:
    import torch

    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()).hexdigest()


def kernel_digests() -> dict:
    """sha256 of K7's output at StyleGAN3-T's largest ×2 call (bf16
    ``[16,128,278,278]`` → 562², 12 taps, pads (9, 8)), of K6's at its
    largest ↓2 call (bf16 ``[16,256,562,562]`` → 276², 12 taps, pads 0),
    of K5's at the claro G post-filter (bf16 ``[32,64,259,259]`` → 256²,
    4 taps, gain 4) and of K4's at the unfused augment's warp (bf16 64 ×
    812×806 → 524², a rotation and a shrink of 0.55–0.75), from inputs
    made on the card from fixed seeds; and of K1's and K2's at the
    augment's call (``chip_smoke._upwarp_case``, 64 planes), and of K3's at
    its two calls (``chip_smoke._warp_cases``: the unfused augment's bf16
    64 × 812×806 → 524² at the pipe's draws at p = 1, the eq metrics' f32
    8 × 256² at rotations)."""
    import importlib
    import math

    import torch

    import chip_smoke as cs
    from gantrack_tpu_torch.models.stylegan3 import design_lowpass_filter
    from gantrack_tpu_torch.ops import upwarp as uw
    from gantrack_tpu_torch.ops import warp as wp
    from gantrack_tpu_torch.ops.grid_sample import warp_coefficients

    ufd = importlib.import_module("gantrack_tpu_torch.ops.upfirdn2d")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    f_host = torch.from_numpy(design_lowpass_filter(*cs.SG3_FILTER))
    x = torch.randn((16, 128, 278, 278), device=dev, generator=gen).bfloat16()
    y = ufd.upfirdn2d(x, f_host.to(dev), taps=ufd.filter_taps(f_host), up=2,
                      padding=[9, 8, 9, 8], gain=4)
    out = {"fir_up2 bf16 [16,128,278,278] -> 562²": _digest(y)}
    del x, y
    cpu = torch.Generator().manual_seed(4)
    a = torch.rand(64, generator=cpu, dtype=torch.float64) * 2 * math.pi
    sc = 0.55 + 0.2 * torch.rand((64, 2), generator=cpu, dtype=torch.float64)
    rot = torch.stack([torch.stack([a.cos(), -a.sin()], 1), torch.stack([a.sin(), a.cos()], 1)], 1)
    lin = rot * sc[:, None, :]
    shift = 0.2 * torch.rand((64, 2, 1), generator=cpu, dtype=torch.float64) - 0.1
    theta = torch.cat([lin, shift], 2).float().to(dev)
    g = torch.randn((64, 524, 524), device=dev, generator=gen).bfloat16()
    adj = wp.splat_planes(g, warp_coefficients(theta, 812, 806, 524, 524), 812, 806)
    out["splat bf16 64 x 812x806 <- 524²"] = _digest(adj)
    del g, adj
    x = torch.randn((16, 256, 562, 562), device=dev, generator=gen).bfloat16()
    y = ufd.upfirdn2d(x, f_host.to(dev), taps=ufd.filter_taps(f_host), down=2)
    out["fir_down2 bf16 [16,256,562,562] -> 276²"] = _digest(y)
    del x, y
    f4 = ufd.setup_filter([1, 3, 3, 1])
    x = torch.randn((32, 64, 259, 259), device=dev, generator=gen).bfloat16()
    y = ufd.upfirdn2d(x, f4.to(dev), taps=ufd.filter_taps(f4), gain=4)
    out["fir_same bf16 [32,64,259,259] -> 256²"] = _digest(y)
    del x, y
    coeffs, taps, _, (h1, w1, oh, ow), gen_k = cs._upwarp_case(64, seed=5)
    x = torch.randn((64, h1, w1), device=dev, generator=gen_k).bfloat16()
    g = torch.randn((64, oh, ow), device=dev, generator=gen_k).bfloat16()
    out[f"upwarp bf16 64 x {h1}x{w1} -> {oh}²"] = _digest(
        uw.upwarp_planes(x, coeffs, taps, oh, ow))
    out[f"upsplat bf16 64 x {h1}x{w1} <- {oh}²"] = _digest(
        uw.upsplat_planes(g, coeffs, taps, h1, w1))
    del x, g
    cases, gen_w = cs._warp_cases()
    for _, theta, h, w, oh, ow, dtype in cases:
        n = theta.shape[0]
        x = torch.randn((n, h, w), device=dev, generator=gen_w)
        x = x.bfloat16() if dtype == "bf16" else x
        out[f"warp {dtype} {n} x {h}x{w} -> {oh}x{ow}"] = _digest(
            wp.warp_planes(x, warp_coefficients(theta, h, w, oh, ow), oh, ow))
        del x
    return out


def _rows_ms(rows: dict, prefix: str) -> float:
    return sum(t for k, t in rows.items() if k.startswith(prefix))


def run_ab(other: str) -> int:
    """Turns other, this, this, other, each in a process of its own."""
    turns = [("other", other), ("this", HERE), ("this", HERE), ("other", other)]
    results = []
    for label, tree in turns:
        with tempfile.NamedTemporaryFile(suffix=".json", delete=False) as f:
            path = f.name
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), f"--tree={tree}",
                               f"--json={path}"], cwd=HERE)
        if proc.returncode != 0:
            print(f"turn {label} ({tree}) failed with exit code {proc.returncode}", file=sys.stderr)
            return proc.returncode
        with open(path) as f:
            results.append((label, json.load(f)))
        os.remove(path)
    print("A/B (turns other, this, this, other), ms of one profiled plain step:")
    summary = []
    for label, res in results:
        for cfg in CONFIGS:
            r = res[cfg]
            row = {"turn": label, "cfg": cfg, "device_ms": r["total_ms"], "step_ms": r["step_ms"],
                   **{f"fir_{form}_ms": _rows_ms(r["rows"], f"FIR {form}")
                      for form in ("same", "down2", "up2")},
                   **{f"k{i}_ms": _rows_ms(r["rows"], f"K{i} ") for i in (1, 2, 3, 4)}}
            summary.append(row)
            print(f"  {label:5s} {cfg:12s} device {row['device_ms']:9.2f}  host step "
                  f"{row['step_ms']:9.1f}  FIR up2 {row['fir_up2_ms']:8.2f}  down2 "
                  f"{row['fir_down2_ms']:8.2f}  same {row['fir_same_ms']:8.2f}  K1 "
                  f"{row['k1_ms']:7.3f}  K2 {row['k2_ms']:7.3f}  K3 {row['k3_ms']:7.3f}  K4 "
                  f"{row['k4_ms']:7.3f}")
            print("        K1-K4 by kernel and dtype: " + "; ".join(
                f"{k} {t:.3f}" for k, t in sorted(r["rows"].items())
                if k.startswith(("K1 ", "K2 ", "K3 ", "K4 "))))
            print("        by form, taps and dtype: " + "; ".join(
                f"{k[4:].split(' [')[0]} {t:.2f}" for k, t in sorted(r["rows"].items())
                if k.startswith("FIR ")))
    same = {}
    for kernel in results[0][1]["digests"]:
        by_turn = [(label, res["digests"][kernel]) for label, res in results]
        same[kernel] = len({d for _, d in by_turn}) == 1
        print(f"  {kernel}: {'the same bits in every turn' if same[kernel] else 'bits differ'} ("
              + ", ".join(f"{label} {d[:12]}" for label, d in by_turn) + ")")
    print(json.dumps({"ab": summary, "bitwise_equal": same}))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ab", default="", help="another checkout, profiled in turns with this one")
    # A turn of --ab: the checkout whose package it profiles, and its result file.
    parser.add_argument("--tree", default=HERE, help=argparse.SUPPRESS)
    parser.add_argument("--json", default="", help=argparse.SUPPRESS)
    opts = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("step_profile: no CUDA device", file=sys.stderr)
        return 2
    if opts.ab:
        return run_ab(opts.ab)
    result = profile_tree(opts.tree)
    if opts.json:
        with open(opts.json, "w") as f:
            json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
