"""Evaluation traffic: the generator pass of a metric tick.

Set-up builds G_ema as the CLI builds the configuration's generator,
with weights the benchmark makes on the card from the seed, writes a
seeded InceptionV3 (the TF-slim graph) with ``inception.save_npz`` and
loads it with ``make_inception_detector``, as a run given
``--detector-weights`` does.  The window calls
``metric_utils.compute_feature_stats_for_generator`` as the FID metric
does (``capture_mean_cov``: the float64 sums of the features and their
products on the host after every batch), in rounds of one metric batch
(``auto_metric_batch`` at the resolution), each round with its own
``opts.seed``, until ``--seconds`` have passed; one round warms up
first.  The detector the window hands to ``MetricOptions`` keeps, as
uint8, the images of ``keep_rows`` consecutive rows of each round (the
first drawn from the seed) and their features (``capture_all``), for
the check.  The traced run times ``trace_rounds`` rounds untraced, then
profiles as many, with spans around the generator and the detector
callables.

Correctness: after the window, a sample of ``sample`` images drawn from
the seed among the kept ones is judged by the plain float32 references:

* ``feature_gap``: G_ema from the same z, the same uint8 truncation and
  InceptionV3 with TF1's resize make the sampled images' features again;
  the widest relative distance ``|f - f_ref| / |f_ref|`` of a sampled
  image's features (the whole pass; the configuration states bfloat16 in
  G's top resolutions);
* ``detector_gap``: the reference InceptionV3 on the very images the
  program's detector got; the widest relative distance of its features
  from the program's (the detector alone, float32 with TF32 off);
* ``no_answer``: sampled images whose features never came back.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Dict

import numpy as np
import torch

from .. import core
from ..counts import inception as inception_counts
from ..counts import stylegan2 as counts
from ..reference import inception as ref_inception
from ..reference import nets as ref_nets
from ..reference import weights as ref_weights
from ..reference.numerics import Numerics
from ..slices import sub_seed
from .train import peak_bytes, sync

SPANS = ("generator", "detector")


def _round_seed(seed: int, r: int) -> int:
    return sub_seed(seed, 1000 + r)


def _kept_start(seed: int, r: int, batch: int, keep: int) -> int:
    """The first of the rows of round ``r`` whose images the check keeps."""
    return int(np.random.default_rng(sub_seed(seed, 2000 + r)).integers(0, batch - keep + 1))


def _program(ctx, device, wg, winc):
    from gantrack_tpu_torch.metrics import make_inception_detector
    from gantrack_tpu_torch.metrics.metric_utils import auto_metric_batch
    from gantrack_tpu_torch.models import inception
    from gantrack_tpu_torch.tools import train as cli

    m = ctx.config["model"]
    G = cli.make_generator("stylegan2", resolution=m["resolution"], channels=m["channels"],
                           c_dim=0, cbase=m["cbase"], cmax=m["cmax"], map_depth=m["map_depth"],
                           num_fp16_res=m["num_fp16_res"]).to(device)
    G.load_state_dict(wg, strict=True)
    G_ema = G.eval().requires_grad_(False)
    net = inception.InceptionV3Features(variant="tfslim")
    net.load_state_dict({k: v.cpu() for k, v in winc.items()}, strict=True)
    path = os.path.join(ctx.tmpdir, "inception.npz")
    inception.save_npz(path, net)
    del net
    detector = make_inception_detector(path, device=device)
    return G_ema, detector, auto_metric_batch(m["resolution"])


def _rounds(ctx, G_ema, detector, batch, device, first: int, until, spans: bool):
    """Runs rounds from ``first`` while ``until(rounds_done)``; returns
    {round: (images done, {row: (uint8 image, features)})} of the kept
    rows."""
    from torch.profiler import record_function

    from gantrack_tpu_torch.metrics.metric_utils import (Detector, MetricOptions,
                                                         compute_feature_stats_for_generator)

    keep = int(ctx.traffic["keep_rows"])
    held = {}

    def generator(z, c):
        if not spans:
            return G_ema(z, c, noise_mode="const")
        with record_function("generator"):
            return G_ema(z, c, noise_mode="const")

    def fn(x):
        # The kept rows' images as the detector gets them (0..255, exact
        # in uint8); a slice, so no index goes to the card.
        held["images"] = x[held["start"]:held["start"] + keep].to(torch.uint8)
        if not spans:
            return detector.fn(x)
        with record_function("detector"):
            return detector.fn(x)

    det = Detector(fn, detector.name, device)
    out = {}
    r = first
    while until(r - first):
        held["start"] = start = _kept_start(ctx.seed, r, batch, keep)
        opts = MetricOptions(generator=generator, detector=det, device=device,
                             batch_size=batch, seed=_round_seed(ctx.seed, r), z_dim=512)
        stats = compute_feature_stats_for_generator(opts, capture_all=True,
                                                    capture_mean_cov=True, max_items=batch)
        feats = stats.get_all()
        images = held["images"].cpu()
        out[r] = (len(feats), {start + i: (images[i], feats[start + i]) for i in range(keep)})
        r += 1
    return out


def _ref_images(ctx, device, wg, batch, picks, nm):
    """The picked ``(round, row)`` images by the reference G at ``nm``:
    uint8 ``[3, H, W]``."""
    G, _ = ref_nets.build(ctx.config["model"], device)
    ref_weights.load(G, wg)
    out = {}
    with torch.no_grad(), nm.matmul_precision():
        for r in sorted({r for r, _ in picks}):
            gen = torch.Generator(device=device).manual_seed(_round_seed(ctx.seed, r))
            z = torch.randn((batch, 512), generator=gen, device=device)
            rows = [i for rr, i in picks if rr == r]
            img = G(z[rows], nm, noise_mode="const")
            img = torch.floor(torch.clamp(img * 127.5 + 128, 0, 255)).repeat(1, 3, 1, 1)
            for i, row in enumerate(rows):
                out[(r, row)] = img[i].to(torch.uint8).cpu()
    return out


def _ref_features(device, winc, images: Dict, nm, chunk: int = 32):
    """The reference InceptionV3's features (at ``nm``) of uint8 images."""
    net = ref_weights.load(ref_inception.InceptionV3().to(device), winc)
    keys = sorted(images)
    out = {}
    with torch.no_grad(), nm.matmul_precision():
        for i in range(0, len(keys), chunk):
            part = keys[i:i + chunk]
            x = torch.stack([images[k] for k in part]).to(device, torch.float32)
            for k, f in zip(part, net(x).cpu().numpy()):
                out[k] = f
    return out


def _picks(ctx, rounds: Dict):
    """``sample`` of the kept ``(round, row)`` images, drawn from the seed."""
    keys = sorted((r, row) for r, (_, kept) in rounds.items() for row in kept)
    rng = np.random.default_rng(sub_seed(ctx.seed, 3))
    n = min(int(ctx.traffic["sample"]), len(keys))
    return [keys[i] for i in sorted(rng.choice(len(keys), size=n, replace=False))]


def _gap(prog: Dict, ref: Dict, picks):
    """The widest relative gap of the picked features, and how many of
    the picks have none from the program."""
    gaps, missing = [], 0
    for key in picks:
        if key not in prog:
            missing += 1
            continue
        f, g = prog[key], ref[key]
        gaps.append(float(np.linalg.norm(f - g) / np.linalg.norm(g)))
    return (max(gaps) if gaps else float("inf")), missing, sorted(gaps)


def _weights(ctx, device):
    G, D = ref_nets.build(ctx.config["model"], device)
    gen = torch.Generator(device=device).manual_seed(sub_seed(ctx.seed, 2))
    wg, _ = ref_nets.make_weights(G, D, gen)
    with torch.device("meta"):
        net = ref_inception.InceptionV3()
    winc = ref_weights.make_weights(net, gen)
    return wg, winc


def _judge(ctx, device, wg, winc, batch, picks, feats: Dict, images: Dict):
    """The compared numbers of the picked images' features ``feats``,
    made by a detector from ``images``, and what lies behind them."""
    plain = Numerics()
    ref = _ref_features(device, winc, _ref_images(ctx, device, wg, batch, picks, plain), plain)
    feature_gap, missing, gaps = _gap(feats, ref, picks)
    detector_gap, _, det_gaps = _gap(feats, _ref_features(device, winc, images, plain), picks)
    numbers = {"feature_gap": feature_gap, "detector_gap": detector_gap,
               "no_answer": float(missing)}
    return numbers, {"feature_gaps": gaps[-8:], "feature_gap_median": gaps[len(gaps) // 2],
                     "detector_gaps": det_gaps[-8:],
                     "detector_gap_median": det_gaps[len(det_gaps) // 2]}


def _kept(rounds: Dict, picks):
    feats = {(r, row): rounds[r][1][row][1] for r, row in picks if r in rounds}
    images = {(r, row): rounds[r][1][row][0] for r, row in picks if r in rounds}
    return feats, images


def run(ctx: core.Context) -> core.Outcome:
    from gantrack_tpu_torch.precision import configure_device_numerics

    device = ctx.device or configure_device_numerics("cuda")
    wg, winc = _weights(ctx, device)
    G_ema, detector, batch = _program(ctx, device, wg, winc)
    _rounds(ctx, G_ema, detector, batch, device, -1, lambda n: n < 1, False)  # warm-up
    sync(device)
    setup_peak = peak_bytes(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    e2e, record = {}, None
    if ctx.trace:
        from torch.profiler import record_function

        from .. import trace

        n = int(ctx.traffic["trace_rounds"])
        # The same rounds untraced, then traced: the rate the least time
        # is held against, and the tracer's cost.
        t0 = time.perf_counter()
        _rounds(ctx, G_ema, detector, batch, device, -1 - n, lambda k: k < n, False)
        sync(device)
        untraced_s = time.perf_counter() - t0
        with trace.profiler(device) as prof:
            t0 = time.perf_counter()
            with record_function("window"):
                rounds = _rounds(ctx, G_ema, detector, batch, device, 0, lambda k: k < n, True)
                sync(device)
            traced_s = time.perf_counter() - t0
        record = trace.profile_record(prof, SPANS)
        flops = counts.phase_flops(ctx.config["model"], "generate", n * batch)
        flops["f32"] += inception_counts.flops_per_image() * n * batch
        record["counters"] = {"images": n * batch, "rounds": n, "flops": flops,
                              "least_s": counts.least_seconds(flops),
                              "untraced_s": untraced_s, "traced_s": traced_s}
        trace.report(record)
    else:
        setup_s = core.setup_seconds(ctx.t0)
        t0 = time.perf_counter()
        rounds = _rounds(ctx, G_ema, detector, batch, device, 0,
                         lambda k: time.perf_counter() - t0 < ctx.seconds, False)
        sync(device)
        elapsed = time.perf_counter() - t0
        e2e = {"eval_img_per_s": sum(n for n, _ in rounds.values()) / elapsed,
               "peak_mem_gib": peak_bytes(device) / 2 ** 30, "setup_s": setup_s}
    memory_peak = max(setup_peak, peak_bytes(device))
    del G_ema, detector
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    picks = _picks(ctx, rounds)
    numbers, _ = _judge(ctx, device, wg, winc, batch, picks, *_kept(rounds, picks))
    limits = ctx.config["limits"]["eval"]
    checks = [(k, numbers[k], float(limits[k])) for k in limits]
    return core.Outcome(e2e=e2e, attempted=sum(n for n, _ in rounds.values()),
                        failed=int(numbers["no_answer"]), checks=checks,
                        memory_peak_bytes=memory_peak, record=record)


def readings(ctx: core.Context, control=None):
    """The compared numbers of the program (``control`` None: a short
    window of ``sample_rounds`` rounds) or of a control (``"fp8"``,
    ``"tf32"``: the reference at that precision) in its place, and what
    lies behind them."""
    from gantrack_tpu_torch.metrics.metric_utils import auto_metric_batch
    from gantrack_tpu_torch.precision import configure_device_numerics

    device = ctx.device or configure_device_numerics("cuda")
    wg, winc = _weights(ctx, device)
    n = int(ctx.traffic["sample_rounds"])
    batch = auto_metric_batch(ctx.config["model"]["resolution"])
    keep = int(ctx.traffic["keep_rows"])
    if control:
        start = {r: _kept_start(ctx.seed, r, batch, keep) for r in range(n)}
        picks = _picks(ctx, {r: (batch, {start[r] + i: None for i in range(keep)})
                             for r in range(n)})
        nm = Numerics(control)
        images = _ref_images(ctx, device, wg, batch, picks, nm)
        feats = _ref_features(device, winc, images, nm)
    else:
        G_ema, detector, batch = _program(ctx, device, wg, winc)
        rounds = _rounds(ctx, G_ema, detector, batch, device, 0, lambda k: k < n, False)
        del G_ema, detector
        picks = _picks(ctx, rounds)
        feats, images = _kept(rounds, picks)
    return _judge(ctx, device, wg, winc, batch, picks, feats, images)
