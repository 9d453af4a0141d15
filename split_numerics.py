"""How far the float32 claro gradients move when the same samples are
stepped otherwise, and why, on one NVIDIA GPU.

    python3 split_numerics.py            # all three probes, about two minutes
    python3 split_numerics.py kinks      # or one: kinks, spread, fir

The networks are ``chip_smoke.claro_float32``: the claro G and D at full
width in float32 (``num_fp16_res=0``), seed-0 weights, minibatch-std off,
const noise, no style mixing, TF32 off.

* ``kinks``: the G-main gradient of a batch of 8 against the mean of its
  halves' and against the batch with z scaled by 1 + 2^-23 (a change of
  one rounding: the mapping normalises z), on the FIR kernels K5–K7 and on
  their plain version, without cuDNN and with its deterministic
  algorithms.  Each comparison runs twice: as it is, and with every
  leaky-ReLU and clamp branch within 1e-3 of its threshold replayed from
  the batch of 8 (``chip_smoke.KinkPins``).  Prints the relative norm
  error of the whole gradient, the elements whose branch flipped, the
  first activation whose input differs from the batch of 8's and the
  largest such difference; where a comparison moves the gradient by more
  than 1e-3, the one activation whose branches, pinned alone, take most of
  that away.
* ``spread``: the float32 accumulation check of
  ``tests/test_torch_generation_cuda.py`` (batch 4, minibatch-std group
  1) with cuDNN's default algorithms: two identical ``micro_batches=1``
  steps against each other, per tensor.
* ``fir``: whether a FIR kernel's output for a plane depends on the planes
  launched beside it: every FIR call of one G-main step at batch 8
  (forward and backward) launched again on each half of its planes, bit
  for bit, and against ``fir_plain``.

Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import contextlib
import sys

import chip_smoke

NUDGE = 1 + 2.0 ** -23


def _rel(want, got) -> float:
    diff = sum(float((a.double() - b.double()).square().sum()) for a, b in zip(want, got))
    return (diff / sum(float(a.double().square().sum()) for a in want)) ** 0.5


@contextlib.contextmanager
def _fir_route(plain: bool):
    """K5–K7, or their plain version in their place."""
    from gantrack_tpu_torch.ops import fir

    launch = fir.fir_planes
    if plain:
        fir.fir_planes = lambda x, spec, **kw: fir.fir_plain(x.float(), spec).to(x.dtype)
    try:
        yield
    finally:
        fir.fir_planes = launch


def _gmain(z, pins=None):
    import torch

    G, _, state, loss, stepper = chip_smoke.claro_float32(z.device, z.shape[0], mixing=0.0)
    with pins.active() if pins is not None else contextlib.nullcontext():
        value = loss.gmain(z, None, stepper.generator, state.ada_p, 0.0)[0]
        return torch.autograd.grad(value, list(G.parameters()))


def _flipped(flips) -> dict:
    """{call: (shape, flips)} of the calls whose branches flipped."""
    return {k: (shape, f) for k, (shape, f) in enumerate(flips) if f}


def _culprit(flipped: dict, whole, run) -> None:
    """Which activation's flips move the gradient: of the calls in
    ``flipped``, the one that alone, pinned, brings the gradient nearest
    ``whole``."""
    gaps = [(_rel(whole, run({k})), k, shape, f) for k, (shape, f) in flipped.items()]
    gap, k, shape, f = min(gaps)
    print(f"    pinning call {k} {shape} alone ({f} flips) leaves {gap:.3e}; "
          f"{len(flipped)} calls flipped", flush=True)


def kinks(card: str) -> None:
    import torch

    dev = torch.device("cuda")
    z = torch.randn((8, 512), generator=torch.Generator().manual_seed(1)).to(dev)
    for cudnn in ("off", "deterministic"):
        torch.backends.cudnn.enabled = cudnn != "off"
        torch.backends.cudnn.deterministic = cudnn == "deterministic"
        for plain in (False, True):
            label = f"cuDNN {cudnn}, FIR {'plain' if plain else 'kernels'}"
            with _fir_route(plain):
                pins = chip_smoke.KinkPins(keep=True)
                whole = _gmain(z, pins)
                halves = [_gmain(z[j:j + 4]) for j in (0, 4)]
                mean = [(a + b) / 2 for a, b in zip(*halves)]
                pinned, flips, drift, flipped = [], 0, [], {}
                for j in (0, 4):
                    pinned.append(_gmain(z[j:j + 4], pins.replay(j)))
                    flips += sum(f for _, f in pins.flips)
                    drift.append(pins.drift)
                    for k, (shape, f) in _flipped(pins.flips).items():
                        flipped[k] = (shape, flipped.get(k, (shape, 0))[1] + f)
                first = next((k for k, d in enumerate(max(a, b) for a, b in zip(*drift)) if d > 0),
                             None)
                where = "none" if first is None else f"call {first} {pins.calls[first]['shape']}"
                print(f"{label}: batch 8 against its halves {_rel(whole, mean):.3e}, kinks pinned "
                      f"{_rel(whole, [(a + b) / 2 for a, b in zip(*pinned)]):.3e} ({flips} of "
                      f"{sum(len(r['kink'][0]) if 'kink' in r else 0 for r in pins.calls)} "
                      f"elements near a kink flipped); first input that differs: {where} of "
                      f"{len(pins.calls)}, largest {max(max(d) for d in drift):.3e} of its rms",
                      flush=True)
                if _rel(whole, mean) > 1e-3:
                    _culprit(flipped, whole, lambda only: [(a + b) / 2 for a, b in zip(*(
                        _gmain(z[j:j + 4], pins.replay(j, only)) for j in (0, 4)))])
                nudged = _gmain(z * NUDGE)
                nudged_pinned = _gmain(z * NUDGE, pins.replay(0))
                print(f"{label}: z scaled by 1 + 2^-23 {_rel(whole, nudged):.3e}, kinks pinned "
                      f"{_rel(whole, nudged_pinned):.3e} "
                      f"({sum(f for _, f in pins.flips)} flipped)", flush=True)
                if _rel(whole, nudged) > 1e-3:
                    _culprit(_flipped(pins.flips), whole,
                             lambda only: _gmain(z * NUDGE, pins.replay(0, only)))
    torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic = True, False
    print(f"  (kinks on {card})")


def spread(card: str) -> None:
    import torch

    from gantrack_tpu_torch.training import step as tstep

    dev = torch.device("cuda")
    z = torch.randn((4, 512), generator=torch.Generator().manual_seed(1)).to(dev)
    reals = torch.randn((4, 1, 256, 256), generator=torch.Generator().manual_seed(2)).to(dev)
    apply = tstep._apply
    runs = []
    for _ in range(2):
        G, _, state, _, stepper = chip_smoke.claro_float32(dev, 4, mbstd=(1, 1), mixing=0.0)
        seen = []
        tstep._apply = lambda opt, p, g: seen.append([x.clone() for x in g]) or apply(opt, p, g)
        try:
            stepper.run(state, reals, None, False, False, draws={"z_gmain": z, "z_dmain": z})
        finally:
            tstep._apply = apply
        runs.append(seen[0])
    names = [n for n, _ in G.named_parameters()]
    errs = {n: _rel([a], [b]) for n, a, b in zip(names, *runs)}
    worst = sorted(errs, key=errs.get)[-4:]
    print(f"cuDNN default, two identical micro_batches=1 steps at batch 4: whole gradient "
          f"{_rel(*runs):.3e}; bit-equal {all(torch.equal(a, b) for a, b in zip(*runs))}; worst "
          + ", ".join(f"{n} {errs[n]:.3e}" for n in worst) + f" (on {card})", flush=True)


def fir(card: str) -> None:
    import torch

    from gantrack_tpu_torch.ops import fir as fir_ops

    dev = torch.device("cuda")
    calls = []
    launch = fir_ops.fir_planes

    def recorded(x, spec, **kw):
        calls.append((x.clone(), spec))
        return launch(x, spec, **kw)

    z = torch.randn((8, 512), generator=torch.Generator().manual_seed(1)).to(dev)
    fir_ops.fir_planes = recorded
    try:
        _gmain(z)
    finally:
        fir_ops.fir_planes = launch
    worst_plain, differs = 0.0, []
    for x, spec in calls:
        whole = launch(x, spec)
        h = x.shape[0] // 2
        parts = torch.cat([launch(x[:h].contiguous(), spec), launch(x[h:].contiguous(), spec)])
        if not torch.equal(parts, whole):
            differs.append((spec.form, tuple(x.shape), float((parts - whole).abs().max())))
        plain = fir_ops.fir_plain(x.float(), spec)
        worst_plain = max(worst_plain, float((whole.float() - plain).abs().max()
                                             / plain.abs().max().clamp(min=1e-30)))
    print(f"{len(calls)} FIR calls of a G-main step at batch 8: whole against halves bit-equal "
          f"in {len(calls) - len(differs)}; differing {differs[:6]}; worst against fir_plain "
          f"{worst_plain:.3e} of the largest output (on {card})", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("split_numerics: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    probes = {"kinks": kinks, "spread": spread, "fir": fir}
    for name in sys.argv[1:] or list(probes):
        probes[name](card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
