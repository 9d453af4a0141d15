"""Run-directory analysis: metric trends, the best snapshot, a metric loop
over every checkpoint, and the clean-up of old checkpoints.

    python -m gantrack_tpu_torch.tools.analysis --run-dir=<run dir> --metric=fid1k \\
        [--plot=trend.png]

Port of ``gantrack_tpu/tools/analysis.py`` (``argparse`` here, the same
flags).  :func:`metric_trend` and :func:`best_snapshot` read the
``metric-*.jsonl`` rows that both packages write alike
(``metrics/registry.report_metric``).  What differs is the checkpoint:
the port's are files ``checkpoints/state-<step>.pt``
(``utils/checkpoint.save_checkpoint``), the JAX package's directories
``state-<step>``.  So :func:`emit_metric_loop` lists the files and emits
``python -m gantrack_tpu_torch.tools.calc_metrics`` lines, with the
run's architecture flags from its ``training_options.json``, and
:func:`clean_run_dir` removes files.  Both take ``state-<digits>.pt``
only: a torn ``state-<step>.pt.tmp`` of an interrupted save sorts after
the last real checkpoint and is never taken for one.

Neither package's training loop stamps ``snapshot_path`` on the metric
rows it writes; only ``calc_metrics`` does.  So :func:`best_snapshot`
names a checkpoint file only for rows that ``calc_metrics`` wrote (the
emitted loop's); for the loop's own rows it gives ``""``, as in the JAX
package.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from typing import List, Optional, Tuple

_CHECKPOINT = re.compile(r"state-\d+\.pt")


def load_metric_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def metric_trend(run_dir: str, metric: str = "fid50k_full",
                 mode: Optional[str] = None) -> List[Tuple[str, float]]:
    """(snapshot, value) pairs from ``metric-*.jsonl``."""
    name = f"metric-{mode}-{metric}.jsonl" if mode else f"metric-{metric}.jsonl"
    path = os.path.join(run_dir, name)
    if not os.path.exists(path):
        candidates = glob.glob(os.path.join(run_dir, f"metric-*{metric}.jsonl"))
        if not candidates:
            return []
        path = candidates[0]
    out = []
    for rec in load_metric_jsonl(path):
        value = rec["results"].get(metric)
        if value is not None:
            out.append((rec.get("snapshot_path") or "", float(value)))
    return out


def best_snapshot(run_dir: str, metric: str = "fid50k_full",
                  mode: Optional[str] = None, minimize: bool = True
                  ) -> Optional[Tuple[str, float]]:
    """Best snapshot by metric (reference ``analyze_gan.py:21-53``)."""
    trend = metric_trend(run_dir, metric, mode)
    if not trend:
        return None
    key = min if minimize else max
    return key(trend, key=lambda t: t[1])


def plot_trend(run_dir: str, metric: str, out_path: str,
               mode: Optional[str] = None) -> Optional[str]:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    trend = metric_trend(run_dir, metric, mode)
    if not trend:
        return None
    values = [v for _, v in trend]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(values, marker="o")
    ax.set_xlabel("snapshot")
    ax.set_ylabel(metric)
    ax.set_title(os.path.basename(run_dir))
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def checkpoints(run_dir: str) -> List[str]:
    """The run's checkpoint files ``state-<step>.pt``, oldest first."""
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(e for e in os.listdir(ckpt_dir) if _CHECKPOINT.fullmatch(e))


def architecture_flags(run_dir: str) -> List[str]:
    """``--cfg --cbase --cmax --map-depth`` of the run, from its
    ``training_options.json`` (none where the file is absent)."""
    path = os.path.join(run_dir, "training_options.json")
    if not os.path.isfile(path):
        return []
    with open(path) as f:
        c = json.load(f)
    g = c.get("G", {})
    flags = [("cfg", c.get("cfg")), ("cbase", g.get("channel_base")),
             ("cmax", g.get("channel_max")), ("map-depth", g.get("map_depth"))]
    return [f"--{k}={v}" for k, v in flags if v is not None]


def emit_metric_loop(run_dir: str, data: str, metrics: str = "fid10k") -> str:
    """Emit a shell script evaluating every checkpoint (reference
    ``create_bashloop.py``)."""
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    arch = "".join(f" {flag}" for flag in architecture_flags(run_dir))
    lines = ["#!/bin/bash", "set -e"]
    for entry in checkpoints(run_dir):
        lines.append(
            f"python -m gantrack_tpu_torch.tools.calc_metrics "
            f"--network={os.path.join(ckpt_dir, entry)} --metrics={metrics} --data={data}{arch}"
        )
    out = os.path.join(run_dir, "run_metrics.sh")
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.chmod(out, 0o755)
    return out


def clean_run_dir(run_dir: str, keep_snapshots: Optional[List[str]] = None,
                  dry_run: bool = True, metric: str = "fid50k_full",
                  mode: Optional[str] = None,
                  minimize: Optional[bool] = None) -> List[str]:
    """Delete all but whitelisted checkpoints (reference
    ``run_recursively_clean.py``).  Always keeps the latest snapshot and
    the best one by ``metric`` (when that metric was recorded).
    ``minimize`` defaults by metric family: equivariance PSNRs (eq*) and
    precision/recall/IS are higher-is-better; FID/KID/PPL lower."""
    if minimize is None:
        minimize = not metric.startswith(("eq", "pr", "is", "precision", "recall"))
    keep = set(keep_snapshots or [])
    best = best_snapshot(run_dir, metric, mode, minimize=minimize)
    if best and best[0]:
        keep.add(os.path.basename(best[0]))
    removed = []
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    for entry in checkpoints(run_dir)[:-1]:  # always keep the latest
        if entry not in keep:
            removed.append(os.path.join(ckpt_dir, entry))
            if not dry_run:
                os.remove(os.path.join(ckpt_dir, entry))
    return removed


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gantrack_tpu_torch.tools.analysis",
                                description="Report metric trend + best snapshot for a run dir.")
    p.add_argument("--run-dir", dest="run_dir", required=True)
    p.add_argument("--metric", default="fid50k_full")
    p.add_argument("--mode", default=None)
    p.add_argument("--plot", dest="plot_path", default=None)
    return p


def main(argv: Optional[List[str]] = None) -> Optional[Tuple[str, float]]:
    """Print the trend and the best snapshot; returns the best."""
    opts = build_parser().parse_args(argv)
    run_dir, metric, mode = opts.run_dir, opts.metric, opts.mode
    for snap, value in metric_trend(run_dir, metric, mode):
        print(f"{os.path.basename(snap) if snap else '?':>20}  {value:.4f}")
    best = best_snapshot(run_dir, metric, mode)
    if best:
        print(f"best: {best[0]} = {best[1]:.4f}")
    if opts.plot_path:
        plot_trend(run_dir, metric, opts.plot_path, mode)
        print(f"plot: {opts.plot_path}")
    return best


if __name__ == "__main__":
    main()
