"""The harness: finds a cell's pieces by name, runs its traffic kind, reads its
per-layer metrics and prints the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

* ``configs/<config>.json``: the configuration (source, the training
  CLI's arguments, cuts, sizes assumed, the limits of its correctness
  checks per traffic kind);
* ``traffic/<traffic>.json``: a traffic mix, the parameters of one of
  the general kinds of traffic in ``kinds/`` (``"kind"`` names it);
* ``metrics/<metric>.py``: the reader of one per-layer metric,
  ``read(record) -> float | None``, over the traced window's record
  (:mod:`h100_bench.trace`); where there is none, ``metrics/<stem>.py``
  (``<stem>``: the name up to its first dot) reads every metric of that
  stem, as ``mfu.py`` reads ``mfu.train`` and ``mfu.eval``.

A kind's ``run(ctx)`` sets the cell up, measures, checks what the
timed path produced and returns an :class:`Outcome`.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Top-level modules the benchmark never loads: the JAX stack and the JAX
# package the port was made from (compared by whole top-level name, since
# ``gantrack_tpu_torch`` begins with ``gantrack_tpu``).
FORBIDDEN = ("jax", "jaxlib", "flax", "gantrack_tpu")


@dataclasses.dataclass
class Context:
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    t0: float
    tmpdir: str
    device: Any = None
    fault: Optional[str] = None  # a fault of ``faults.py`` planted in every rank (checks only)


@dataclasses.dataclass
class Outcome:
    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Tuple[str, float, float]]  # (name, value, limit): correct iff value <= limit
    memory_peak_bytes: int
    record: Optional[dict] = None  # the traced window (trace runs)
    chips: int = 1

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for _, v, lim in self.checks) \
            and self.failed == 0


def forbidden_modules() -> List[str]:
    """Forbidden top-level names among the loaded modules."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_file_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find_cell(bench: dict, workload: str, root: str = ROOT):
    """The cell's ``workloads`` entry, its configuration file and its
    traffic file (raises ``KeyError`` for an unknown name)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(root, entry["file"])
    traffic = load_json(root, "h100_bench", "traffic", f"{cell['traffic']}.json")
    return cell, config, traffic


def cell_metrics(bench: dict, workload: str) -> Tuple[List[dict], List[dict]]:
    """The end-to-end and the per-layer metrics the cell reports.  A
    metric with ``workloads`` belongs to those cells; a per-layer metric
    without it belongs to every cell that reports the metric it moves."""
    def mine(m):
        return workload in m["workloads"] if "workloads" in m else None

    e2e = [m for m in bench["end_to_end"] if mine(m) is not False]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if mine(m) or (mine(m) is None and m["moves"] in names)]
    return e2e, layer


def kind_for(traffic: dict):
    return importlib.import_module(f"h100_bench.kinds.{traffic['kind']}")


def reader_for(metric: str, root: str = ROOT):
    folder = os.path.join(root, "h100_bench", "metrics")
    name = metric if os.path.exists(os.path.join(folder, f"{metric}.py")) \
        else metric.split(".")[0]
    return load_file_module(os.path.join(folder, f"{name}.py"),
                            f"h100_bench_metric_{name.replace('.', '_')}")


def read_layer_metrics(layer: List[dict], record: dict, root: str = ROOT) -> Dict[str, dict]:
    """Each per-layer metric its reader finds something to read for; the
    others are left out."""
    out = {}
    for m in layer:
        value = reader_for(m["name"], root).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _parse(argv):
    p = argparse.ArgumentParser(prog="python3 h100_bench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _checks_text(checks) -> List[str]:
    return [f"check {name}: {value!r} limit {limit!r} {'ok' if value <= limit else 'FAIL'}"
            for name, value, limit in checks]


def result_line(outcome: Outcome, e2e: List[dict], layer: List[dict], trace: bool,
                root: str = ROOT) -> dict:
    """The JSON object of the last line, the compared numbers last."""
    from . import trace as tr

    import torch

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": outcome.chips,
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line: Dict[str, Any] = {"correct": outcome.correct, "attempted": int(outcome.attempted),
                            "failed": int(outcome.failed)}
    if trace:
        rec = outcome.record
        metrics = read_layer_metrics(layer, rec, root)
        device["busy_s"] = rec.get("busy_us", tr.busy_us(rec)) / 1e6
        device["window_s"] = rec["window_us"] / 1e6
        line["metrics"] = metrics
        line["device"] = device
        line["breakdown"] = tr.breakdown(rec)
    else:
        line["metrics"] = {m["name"]: {"value": float(outcome.e2e[m["name"]]), "unit": m["unit"]}
                           for m in e2e}
        line["device"] = device
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in outcome.checks}
    return line


def main(argv, t0: float) -> int:
    args = _parse(argv)
    try:
        import gantrack_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"h100_bench: the program is not in this checkout: {e}", file=sys.stderr)
        return 3
    import torch

    bench = load_json(ROOT, "BENCHMARK.json")
    cell, config, traffic = find_cell(bench, args.workload)
    e2e, layer = cell_metrics(bench, args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100_bench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    tmpdir = tempfile.mkdtemp(prefix="h100_bench-")
    try:
        ctx = Context(cell=cell, config=config, traffic=traffic, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace), t0=t0, tmpdir=tmpdir)
        outcome = kind_for(traffic).run(ctx)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print(f"h100_bench: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    line = result_line(outcome, e2e, layer, bool(args.trace))
    for text in _checks_text(outcome.checks):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def setup_seconds(t0: float) -> float:
    """Seconds since the process started (``run.py``'s first line)."""
    return time.monotonic() - t0
