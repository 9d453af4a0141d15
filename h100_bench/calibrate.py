"""Read the numbers a cell's correctness check compares, for the program
and for the control, on many seeds in one process: the readings its
limits are set from.  The benchmark's own runs never run the control.

    python3 h100_bench/calibrate.py --workload claro.train \\
        --program-seeds 11,12,13 --control fp8 --control tf32 --control-seeds 21,22,23 \\
        --fault unchanged --fault-seeds 31,32,33

``--control`` puts the reference one precision step below the
configuration's in the program's place (``fp8`` where it states
bfloat16, ``tf32`` where it states float32 with TF32 off) for the
``--control-seeds``; ``--fault`` plants one of ``h100_bench/faults.py``'s
faults in the program for the ``--fault-seeds``.  Prints one JSON line a reading:
``{"mode", "seed", "numbers", "detail"}``.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv):
    import argparse
    import contextlib
    import shutil
    import tempfile

    from h100_bench import core

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control", action="append", default=[], choices=("fp8", "tf32"))
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--fault-seeds", default="")
    args = p.parse_args(argv)
    from h100_bench import faults

    bench = core.load_json(ROOT, "BENCHMARK.json")
    cell, config, traffic = core.find_cell(bench, args.workload)
    kind = core.kind_for(traffic)
    runs = [("program", args.program_seeds)]
    runs += [(f"control:{name}", args.control_seeds) for name in args.control]
    runs += [(f"fault:{name}", args.fault_seeds) for name in args.fault]
    for mode, seeds in runs:
        for seed in [int(s) for s in seeds.split(",") if s]:
            tmpdir = tempfile.mkdtemp(prefix="h100_bench-")
            t = time.monotonic()
            try:
                ctx = core.Context(cell=cell, config=config, traffic=traffic, seed=seed,
                                   seconds=0.0, trace=False, t0=t, tmpdir=tmpdir,
                                   fault=mode[6:] if mode.startswith("fault:") else None)
                # The training kind plants the fault in every rank; the
                # evaluation kind runs in this process.
                fault = faults.FAULTS[ctx.fault]() if ctx.fault and traffic["kind"] != "train" \
                    else contextlib.nullcontext()
                with fault:
                    numbers, detail = kind.readings(
                        ctx, control=mode[8:] if mode.startswith("control:") else None)
            finally:
                shutil.rmtree(tmpdir, ignore_errors=True)
            print(json.dumps({"mode": mode, "seed": seed, "numbers": numbers,
                              "seconds": time.monotonic() - t, "detail": detail}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
