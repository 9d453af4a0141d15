"""Training traffic: the training loop's own step path.

Set-up builds the run as the training CLI builds it
(``tools.train.build_training`` over packed shards of seeded slices),
loads weights that the benchmark makes on the card from the seed, sets
ADA's ``p``, and drives that same stepper and state through its first
steps with the window's own call (``next(loader)`` →
``loop.to_device_batch`` → ``TrainStepper.__call__``), keeping what the
correctness check compares.  It then warms up every phase variant and
moves the step counter to the next whole regularisation cycle, as a
resume from a checkpoint there would.  The window runs whole steps
until ``--seconds`` have passed; the traced run profiles one whole cycle
instead.

Correctness: after the window, with the program's state freed, the
plain float32 reference (:mod:`h100_bench.reference.training`) runs the
same first steps (``check_steps``) from the same weights, data and seed,
and so does the same reference at the precision the configuration
states (bfloat16 where it states bfloat16): the yardstick of rounding.
Leaf gaps are ``|norm - norm_ref| / max(norm_ref, median leaf's)``.
Compared, each against its limit from the configuration file:

* ``loader_gap``: the largest difference between a row the loader fed
  and the row the reference sampler reads from the raw slices;
* ``loss_gap``: the relative gaps of every loss of the first step,
  summed;
* ``grad_ratio``: the median leaf gap of the root of Adam's second moment
  after step 1 (the gradients of the step's phases as the optimiser took
  them), over the stated reference's;
* ``change_ratio``: the median leaf gap of the change of G's, D's and
  G_ema's parameters over the checked steps, over the stated reference's;
* ``f32_layer_gap``: ``|x - x_ref| / |x_ref|`` of the output of G's last
  float32 layer (the configuration's ``probes``) in the first step's
  first G pass: no bfloat16 comes before it, so it reads float32's
  rounding alone;
* ``bf16_layer_ratio``: the same of the first bfloat16 layer, over the
  stated reference's.

Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by round-off alone and are left out of the last
two.  Traffic parameters: ``items`` (slices in the dataset), ``ada_p``,
``check_steps``, ``warm_steps``, ``cycle``, and ``devices`` (ranks, one
process and card each: the training CLI's ``--devices``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import core
from ..counts import fir as fir_counts
from ..counts import stylegan2 as counts
from ..reference import augment as ref_augment
from ..reference import data as ref_data
from ..reference import nets as ref_nets
from ..reference import weights as ref_weights
from ..reference import training as ref_training
from ..reference.numerics import Numerics
from ..slices import make_slices, sub_seed

SPANS = ("loader", "step")


@dataclasses.dataclass
class Setup:
    ctx: core.Context
    device: torch.device
    raw: np.ndarray
    data_dir: str
    opts: object
    c: dict
    model: dict
    weights_g: Dict[str, torch.Tensor]
    weights_d: Dict[str, torch.Tensor]
    mesh: object = None   # parallel.mesh.Mesh of a data-parallel run; None: one process
    host_group: object = None  # a gloo group for the window's host-side stop flag

    @property
    def world(self) -> int:
        return self.mesh.world if self.mesh is not None else 1

    @property
    def rank(self) -> int:
        return self.mesh.rank if self.mesh is not None else 0


def _program_seed(seed: int) -> int:
    # The CLI's seed also seeds numpy's RandomState (below 2**32).
    return seed % (1 << 32)


def prepare(ctx: core.Context, mesh=None, host_group=None) -> Setup:
    """Data and weights from the seed (every rank makes the same; rank 0
    packs the shards); the CLI's options of the cell."""
    import torch.distributed as dist

    from gantrack_tpu_torch.data import pack_shards
    from gantrack_tpu_torch.precision import configure_device_numerics
    from gantrack_tpu_torch.tools import train as cli

    device = ctx.device or configure_device_numerics("cuda")
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    model = ctx.config["model"]
    world = mesh.world if mesh is not None else 1
    raw = make_slices(ctx.seed, ctx.traffic["items"], model["resolution"], device)
    data_dir = os.path.join(ctx.tmpdir, "data")
    if mesh is None or mesh.is_main:
        pack_shards(data_dir, "train", raw, [f"s{i}" for i in range(len(raw))])
    if mesh is not None and mesh.distributed:
        dist.barrier()
    opts = cli.build_parser().parse_args([
        *ctx.config["cli"], f"--outdir={ctx.tmpdir}", f"--data={data_dir}",
        f"--seed={_program_seed(ctx.seed)}", f"--devices={world}", "--metrics=none",
        f"--device={device.type}"])
    c = cli.resolve_config(opts)
    G, D = ref_nets.build(model, device)
    gen = torch.Generator(device=device).manual_seed(sub_seed(ctx.seed, 2))
    wg, wd = ref_nets.make_weights(G, D, gen)
    return Setup(ctx, device, raw, data_dir, opts, c, model, wg, wd, mesh, host_group)


# ------------------------------------------------------------- readings

def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    if not tensors:
        return {}
    names = sorted(tensors)
    vals = torch.stack([tensors[k].float().norm() for k in names]).cpu().tolist()
    return dict(zip(names, vals))


def _moment_norms(m: Dict[str, torch.Tensor], v: Dict[str, torch.Tensor]):
    """Each leaf's norm of Adam's first moment and of its second's root."""
    out = {f"{k}/m": t for k, t in m.items()}
    out.update({f"{k}/v": t.sqrt() for k, t in v.items()})
    return _norms(out)


@contextlib.contextmanager
def _probed(G: torch.nn.Module, probes: Dict[str, str], out: Dict[str, torch.Tensor]):
    """Keeps, on the host, the first output of each probed layer of G
    (``probes``: {key: submodule name}) while the block runs."""
    def hook(key):
        def keep(module, args, output):
            if key not in out:
                x = output[0] if isinstance(output, tuple) else output
                out[key] = x.detach().float().cpu()
        return keep

    handles = [G.get_submodule(name).register_forward_hook(hook(key))
               for key, name in probes.items()]
    try:
        yield out
    finally:
        for h in handles:
            h.remove()


def _change(nets: Dict[str, torch.nn.Module], start: Dict[str, Dict[str, torch.Tensor]]):
    return _norms({f"{name}.{k}": p.detach() - start[name][k]
                   for name, net in nets.items() for k, p in net.named_parameters()})


def program_readings(s: Setup):
    """Builds the program's run and drives its first steps; returns the
    readings and the run (dataset, loader, state, stepper)."""
    from gantrack_tpu_torch.tools import train as cli
    from gantrack_tpu_torch.training.loop import to_device_batch

    dataset, loader, state, stepper = cli.build_training(s.c, s.opts, s.device, mesh=s.mesh)
    for net, w in ((state.G, s.weights_g), (state.G_ema, s.weights_g), (state.D, s.weights_d)):
        net.load_state_dict(w, strict=True)
    state.ada_p.fill_(float(s.ctx.traffic["ada_p"]))
    steps = s.ctx.traffic["check_steps"]
    # This rank's rows as the reference sampler reads them from the raw
    # slices, against the rows the loader feeds.
    rows = ref_data.batches(s.raw, s.opts.batch // s.world, _program_seed(s.ctx.seed),
                            s.opts.mirror, steps, s.rank, s.world)
    loader_gap, losses, grads, probes = 0.0, [], None, {}
    for step in range(steps):
        images, labels = next(loader)
        loader_gap = max(loader_gap, float(np.abs(images - rows[step].transpose(0, 2, 3, 1)).max()))
        img, lab = to_device_batch(images, labels, s.device)
        with _probed(state.G, s.ctx.config["probes"] if step == 0 else {}, probes):
            moments = stepper(state, img, lab)
        losses.append({k: v[1] / v[0] for k, v in moments.items() if k.startswith("Loss/")})
        if step == 0:
            m, v = {}, {}
            for net, opt, prefix in ((state.G, state.opt_g, "G."), (state.D, state.opt_d, "D.")):
                for k, p in net.named_parameters():
                    if p in opt.state:
                        m[prefix + k] = opt.state[p]["exp_avg"]
                        v[prefix + k] = opt.state[p]["exp_avg_sq"]
            grads = _moment_norms(m, v)
    change = _change({"G": state.G, "D": state.D, "G_ema": state.G_ema},
                     {"G": s.weights_g, "D": s.weights_d, "G_ema": s.weights_g})
    readings = dict(loader_gap=_max_over_ranks(s, loader_gap),
                    losses=[{k: float(v) for k, v in d.items()} for d in losses],
                    grads=grads, change=change, probes=probes)
    return readings, (dataset, loader, state, stepper)


def reference_readings(s: Setup, control: Optional[str] = None, stated: bool = False):
    """The plain float32 reference's readings over the same first steps
    (``stated``: at the precision the configuration states; ``control``:
    one precision step below it, ``"fp8"`` or ``"tf32"``)."""
    t = s.ctx.traffic
    opts = s.opts
    G, D = ref_nets.build(s.model, s.device)
    ref_weights.load(G, s.weights_g)
    ref_weights.load(D, s.weights_d)
    aug = None
    if opts.aug != "noaug":
        aug_opts = {k: 1.0 for k in opts.aug_opts}
        aug_opts.update(xint_max=opts.xint_max, rotate_max=opts.rotate_max / 360,
                        xfrac_std=opts.xfrac_std, scale_std=opts.scale_std,
                        aniso_std=opts.aniso_std)
        aug = ref_augment.AugmentPipe(aug_opts, s.model["resolution"], s.model["resolution"])
    c = s.c
    sg2 = s.model["family"] == "stylegan2"
    cfg = ref_training.StepConfig(
        batch=opts.batch, glr=c["glr"], dlr=c["dlr"], gamma=c["gamma"], ema_kimg=c["ema_kimg"],
        micro_batches=opts.batch // s.world // c["batch_gpu"],
        g_reg_interval=4 if sg2 else None, style_mixing=0.9 if sg2 else 0.0,
        pl_weight=2.0 if sg2 else 0.0,
        ada_target=opts.target if opts.aug == "ada" else None, ada_kimg=opts.ada_kimg)
    seed = _program_seed(s.ctx.seed)
    # Rank r of the program draws from a generator seeded seed * world + r.
    gens = [torch.Generator(device=s.device).manual_seed(seed * s.world + r)
            for r in range(s.world)]
    tr = ref_training.Trainer(G, D, cfg, aug, Numerics(control, stated), gens, t["ada_p"])
    per_rank = [ref_data.batches(s.raw, opts.batch // s.world, seed, opts.mirror,
                                 t["check_steps"], r, s.world) for r in range(s.world)]
    losses, grads, probes = [], None, {}
    for step in range(t["check_steps"]):
        with _probed(tr.G, s.ctx.config["probes"] if step == 0 else {}, probes):
            losses.append(tr.step([torch.from_numpy(b[step]).to(s.device) for b in per_rank]))
        if step == 0:
            grads = _moment_norms({"G." + k: v for k, v in tr.opt_g.m.items()} |
                                  {"D." + k: v for k, v in tr.opt_d.m.items()},
                                  {"G." + k: v for k, v in tr.opt_g.v.items()} |
                                  {"D." + k: v for k, v in tr.opt_d.v.items()})
    change = _change({"G": tr.G, "D": tr.D, "G_ema": tr.G_ema},
                     {"G": s.weights_g, "D": s.weights_d, "G_ema": s.weights_g})
    return dict(loader_gap=0.0, losses=losses, grads=grads, change=change, probes=probes)


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> list:
    names = [k for k in ref if keep(k)]
    median = float(np.median([ref[k] for k in names]))
    return [abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], median) for k in names] or [np.inf]


def compare(prog: dict, ref: dict, stated: dict) -> Dict[str, float]:
    """The compared numbers (see the module docstring) and the medians
    they are ratios of.  ``stated``: the readings of the reference at the
    configuration's precision, whose gaps to the float32 reference are
    the yardstick of rounding."""
    # Leaves that only round-off moves: reference gradient (the root of
    # Adam's second moment) under a thousandth of the median leaf's.
    rv = {k[:-2]: v for k, v in ref["grads"].items() if k.endswith("/v")}
    floor = 1e-3 * float(np.median(list(rv.values())))
    moved = {k for k, v in rv.items() if v >= floor}
    out = {"loader_gap": prog["loader_gap"]}
    for name, side in (("", prog), ("stated_", stated)):
        out[f"{name}grad_gap_median"] = float(np.median(_leaf_gaps(
            side["grads"], ref["grads"], lambda k: k.endswith("/v") and k[:-2] in moved)))
        out[f"{name}change_gap_median"] = float(np.median(_leaf_gaps(
            side["change"], ref["change"], lambda k: k.replace("G_ema.", "G.", 1) in moved)))
    for k in ("grad_gap_median", "change_gap_median"):
        out[k.replace("gap_median", "ratio")] = out[k] / max(out["stated_" + k], 1e-30)
    # The first step's losses: the sum of their relative gaps.  (The
    # second step's swing with Adam's sign-like first update, which turns
    # a rounding into a whole step on some seeds; over the stated
    # reference's sum, as a ratio, they swing with its smallest gaps.)
    out["loss_gap"] = _loss_sum(prog, ref, [0])
    out["stated_loss_gap"] = _loss_sum(stated, ref, [0])
    # G's first forward pass of the first step: the last float32 layer's
    # output (no bfloat16 before it), and the first bfloat16 layer's over
    # the stated reference's.
    out["f32_layer_gap"] = _probe_gap(prog, ref, "f32")
    out["stated_bf16_layer_gap"] = _probe_gap(stated, ref, "bf16")
    out["bf16_layer_gap"] = _probe_gap(prog, ref, "bf16")
    out["bf16_layer_ratio"] = out["bf16_layer_gap"] / max(out["stated_bf16_layer_gap"], 1e-30)
    return out


def _probe_gap(side: dict, ref: dict, key: str) -> float:
    """``|x - x_ref| / |x_ref|`` of a probed layer's output; infinite
    where the shapes differ or a side has none."""
    x, r = side["probes"].get(key), ref["probes"][key]
    if x is None or x.shape != r.shape:
        return float("inf")
    return float((x - r).norm() / r.norm())


def _loss_sum(side: dict, ref: dict, steps) -> float:
    total = 0.0
    for step in steps:
        for k, v in ref["losses"][step].items():
            if k.startswith(("Loss/G/", "Loss/D/")):
                p = side["losses"][step].get(k, float("nan"))
                total += abs(p - v) / abs(v) if np.isfinite(p) else float("inf")
    return total


# --------------------------------------------------------------- window

def _align(state, stepper, cycle: int) -> None:
    """Moves the counters to the next whole cycle of the regularisation
    schedule (a resume at that step)."""
    step = -(-state.step // cycle) * cycle
    state.step = step
    state.cur_nimg = step * stepper.cfg.batch_size


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _max_over_ranks(s: Setup, value: float) -> float:
    if s.mesh is None:
        return value
    import torch.distributed as dist

    t = torch.tensor([float(value)], dtype=torch.float64, device=s.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def _stop(s: Setup, t0: float) -> bool:
    """Whether the window has run its seconds, by rank 0's clock; every
    rank gets the same answer over a host-side (gloo) group, so no step
    waits for the device."""
    done = time.perf_counter() - t0 >= s.ctx.seconds
    if s.mesh is None:
        return done
    import torch.distributed as dist

    flag = torch.tensor([int(done)])
    dist.broadcast(flag, src=0, group=s.host_group)
    return bool(flag)


def _timed(s: Setup, loader, state, stepper) -> dict:
    from gantrack_tpu_torch.training.loop import to_device_batch

    dev = s.device
    sync(dev)
    setup_peak = peak_bytes(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = core.setup_seconds(s.ctx.t0)
    steps = 0
    t0 = time.perf_counter()
    while True:
        img, lab = to_device_batch(*next(loader), dev)
        stepper(state, img, lab)
        steps += 1
        if _stop(s, t0):
            break
    sync(dev)
    elapsed = time.perf_counter() - t0
    peak = _max_over_ranks(s, peak_bytes(dev))
    images = steps * stepper.cfg.batch_size  # the global batch
    return dict(e2e={"train_img_per_s": images / elapsed, "peak_mem_gib": peak / 2 ** 30,
                     "setup_s": setup_s},
                attempted=steps, memory_peak_bytes=_max_over_ranks(s, max(setup_peak, peak)))


def _cycle_flops(s: Setup, state, stepper, steps: int) -> Dict[str, float]:
    """This rank's share of the operations of the next ``steps`` steps."""
    flops = {"bf16": 0.0, "f32": 0.0}
    for step in range(state.step, state.step + steps):
        for k, v in counts.step_flops(s.model, stepper.cfg.batch_size // s.world,
                                      *stepper.phase_flags(step)).items():
            flops[k] += v
    return flops


def _traced(s: Setup, loader, state, stepper) -> dict:
    """One whole cycle untraced, timed by the host clock (the rate the
    least time is held against, and the loader's wait), then one step in
    the profiler's warm-up stage and one whole cycle traced, device
    activity alone, with host-clock spans.  Rank 0's record, with the
    device's busy time averaged over the ranks."""
    from gantrack_tpu_torch.training.loop import to_device_batch

    from .. import trace

    dev = s.device
    steps = int(s.ctx.traffic["cycle"])

    def run(spans, times):
        """A cycle; each step's host seconds in the loader and in all."""
        for _ in range(steps):
            t = time.perf_counter()
            with spans("loader"):
                img, lab = to_device_batch(*next(loader), dev)
            t_loader = time.perf_counter() - t
            with spans("step"):
                stepper(state, img, lab)
            times.append((t_loader, time.perf_counter() - t))
        sync(dev)

    flops = _cycle_flops(s, state, stepper, steps)
    untraced, traced = [], []
    sync(dev)
    t0 = time.perf_counter()
    run(trace.HostSpans(), untraced)
    untraced_s = time.perf_counter() - t0

    def warm():
        stepper(state, *to_device_batch(*next(loader), dev))
        sync(dev)

    calls: Dict[tuple, int] = {}
    spans = trace.HostSpans()
    with trace.profiler(dev, host=False, warm=warm) as prof, trace.record_fir_calls(calls):
        w0 = time.time_ns()
        t0 = time.perf_counter()
        run(spans, traced)
        traced_s = time.perf_counter() - t0
        w1 = time.time_ns()
    record = trace.device_record(prof, (w0, w1), spans)
    fir_least = sum(n * fir_counts.least_seconds(spec.form, (len(spec.taps_y), len(spec.taps_x)),
                                                  spec.pads, shape, dtype)
                    for (spec, shape, dtype), n in calls.items())
    busy = trace.busy_us(record)
    if s.mesh is not None:
        import torch.distributed as dist

        t = torch.tensor([busy], dtype=torch.float64, device=dev)
        dist.all_reduce(t)
        busy = float(t) / s.world
    record["busy_us"] = busy
    record["counters"] = {"steps": steps, "images": steps * stepper.cfg.batch_size // s.world,
                          "flops": flops, "least_s": counts.least_seconds(flops),
                          "untraced_s": untraced_s, "traced_s": traced_s,
                          "loader_s": sum(t for t, _ in untraced), "fir_least_s": fir_least,
                          "fir_calls": sum(calls.values())}
    trace.report(record)
    print("trace: host ms a step, untraced " + " ".join(f"{1e3 * t:.1f}" for _, t in untraced)
          + "; traced " + " ".join(f"{1e3 * t:.1f}" for _, t in traced), file=sys.stderr)
    return dict(record=record, attempted=2 * steps + 1,
                memory_peak_bytes=_max_over_ranks(s, peak_bytes(dev)))


def _program(ctx: core.Context, mesh=None, host_group=None):
    """This rank's part of a run: set-up, the checked first steps, the
    warm-up and the window.  Returns the set-up, the readings and the
    window's results."""
    from gantrack_tpu_torch.training.loop import to_device_batch

    s = prepare(ctx, mesh, host_group)
    prog, (dataset, loader, state, stepper) = program_readings(s)
    try:
        while state.step < ctx.traffic["warm_steps"]:
            stepper(state, *to_device_batch(*next(loader), s.device))
        _align(state, stepper, int(ctx.traffic["cycle"]))
        out = (_traced if ctx.trace else _timed)(s, loader, state, stepper)
    finally:
        loader.close()
    return s, prog, out


def _rank(ctx: core.Context, rank: int, world: int, port: int):
    """Rank ``rank`` of a data-parallel run, in its own process (rank 0
    in the harness's), joined as the training CLI's workers join."""
    import torch.distributed as dist

    from gantrack_tpu_torch.parallel.mesh import create_mesh, initialize_distributed

    launch = dict(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                  MASTER_ADDR="localhost", MASTER_PORT=str(port))
    saved = {k: os.environ.get(k) for k in launch}
    os.environ.update(launch)
    device_type = ctx.device.type if ctx.device is not None else "cuda"
    threads = torch.get_num_threads()
    if device_type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        initialize_distributed(device_type)
        try:
            mesh = create_mesh(world, device_type)
            host_group = dist.new_group(backend="gloo") if device_type == "cuda" else None
            with _planted(ctx):
                s, prog, out = _program(ctx, mesh, host_group)
            dist.barrier()
        finally:
            dist.destroy_process_group()
    finally:  # rank 0 runs in the harness's own process, which goes on
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        torch.set_num_threads(threads)
    return s, prog, out


def _planted(ctx: core.Context):
    from .. import faults

    return faults.FAULTS[ctx.fault]() if ctx.fault else contextlib.nullcontext()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _run_ranks(ctx: core.Context):
    """The program's part of a run on every rank; rank 0's results."""
    world = int(ctx.traffic.get("devices", 1))
    if world == 1:
        with _planted(ctx):
            return _program(ctx)
    else:
        import multiprocessing

        port = _free_port()
        spawn = multiprocessing.get_context("spawn")
        procs = [spawn.Process(target=_rank, args=(ctx, r, world, port), daemon=True)
                 for r in range(1, world)]
        for p in procs:
            p.start()
        try:
            s, prog, out = _rank(ctx, 0, world, port)
        finally:
            for p in procs:
                p.join(timeout=300)
                if p.is_alive():
                    p.terminate()
                    p.join()
        failed = [p.exitcode for p in procs if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"ranks of the data-parallel run failed: exit codes {failed}")
        return s, prog, out


def run(ctx: core.Context) -> core.Outcome:
    s, prog, out = _run_ranks(ctx)
    gc.collect()
    if s.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = compare(prog, reference_readings(s), reference_readings(s, stated=True))
    limits = ctx.config["limits"]["train"]
    checks = [(k, numbers[k], float(limits[k])) for k in limits]
    return core.Outcome(e2e=out.get("e2e", {}), attempted=out["attempted"], failed=0,
                        checks=checks, memory_peak_bytes=out["memory_peak_bytes"],
                        record=out.get("record"), chips=s.world)


def detail(prog: dict, ref: dict, stated: dict) -> dict:
    """What lies behind the compared numbers, for setting limits: every
    step's reported means and every leaf's norms, of all three."""
    return {side: {k: d[k] for k in ("losses", "grads", "change")}
            for side, d in (("program", prog), ("reference", ref), ("stated", stated))}


def readings(ctx: core.Context, control: Optional[str] = None):
    """The compared numbers of the program (``control`` None) or of a
    control (``"fp8"``, ``"tf32"``: the reference at that precision) in
    its place, with no window, and what lies behind them: for setting the
    limits."""
    if control:
        from gantrack_tpu_torch.parallel.mesh import Mesh

        # The control stands in for every rank, in this one process.
        s = prepare(ctx, Mesh(world=int(ctx.traffic.get("devices", 1))))
        prog = reference_readings(s, control=control)
    elif int(ctx.traffic.get("devices", 1)) > 1:
        # The ranks' processes, with a window of one step.
        s, prog, _ = _run_ranks(dataclasses.replace(ctx, seconds=0.0, trace=False))
    else:
        s = prepare(ctx)
        with _planted(ctx):
            prog, run_objects = program_readings(s)
        run_objects[1].close()
        del run_objects
    gc.collect()
    if s.device.type == "cuda":
        torch.cuda.empty_cache()
    ref, stated = reference_readings(s), reference_readings(s, stated=True)
    return compare(prog, ref, stated), detail(prog, ref, stated)

