"""Dataset statistics reports.

    python -m gantrack_tpu_torch.tools.analyze_dataset --source=<dir of NIfTI> \\
        --out=stats.csv [--percentiles 1 99] [--plot=hist.png]

Port of ``gantrack_tpu/tools/analyze_dataset.py`` (``argparse`` here, the
same flags): per-volume shape, spacing and intensity stats, exported to a
CSV (or ``.xlsx``), and the pooled percentiles that set the
intensity-normalisation range (reference ``src/data/analyze_dataset.py``
and ``dataset_analysis_percentile.py``).  Volumes are read by the port's
``data/preprocess/nifti.py``, and the pooled sample is drawn by the same
``np.random.default_rng(seed).choice`` as in the JAX tool, so both give
the same percentiles to the bit.  The CSV is written by the ``csv``
module, its values as ``repr`` gives them, which ``pandas`` parses back
to what the JAX tool's ``DataFrame.to_csv`` wrote; an ``.xlsx`` needs
pandas and openpyxl (``utils.config.write_excel``); ``--plot``, matplotlib.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
from typing import List, Optional

import numpy as np

COLUMNS = ("file", "shape", "spacing", "min", "max", "mean", "std", "p01", "p99")


def volume_stats(path: str) -> dict:
    from ..data.preprocess.nifti import read_nifti

    vol, zooms = read_nifti(path)
    v = np.asarray(vol, np.float64)
    return {
        "file": os.path.basename(path),
        "shape": "x".join(map(str, vol.shape)),
        "spacing": "x".join(f"{z:.3f}" for z in zooms),
        "min": float(v.min()),
        "max": float(v.max()),
        "mean": float(v.mean()),
        "std": float(v.std()),
        "p01": float(np.percentile(v, 1)),
        "p99": float(np.percentile(v, 99)),
    }


def percentile_search(paths: List[str], lower_pct: float = 1.0, upper_pct: float = 99.0,
                      sample_per_volume: int = 200000, seed: int = 0) -> dict:
    """Pooled percentile estimate over a dataset (reference
    ``dataset_analysis_percentile.py``)."""
    from ..data.preprocess.nifti import read_nifti

    rng = np.random.default_rng(seed)
    samples = []
    for p in paths:
        vol, _ = read_nifti(p)
        flat = np.asarray(vol).ravel()
        idx = rng.choice(flat.size, min(sample_per_volume, flat.size), replace=False)
        samples.append(flat[idx].astype(np.float64))
    pooled = np.concatenate(samples)
    return {
        "lower": float(np.percentile(pooled, lower_pct)),
        "upper": float(np.percentile(pooled, upper_pct)),
        "n_volumes": len(paths),
        "n_samples": int(pooled.size),
    }


def write_table(rows: List[dict], out_path: str) -> None:
    """The stats rows as ``out_path``: ``.xlsx`` through pandas, else CSV."""
    if out_path.endswith(".xlsx"):
        from ..utils.config import write_excel

        write_excel(out_path, rows)
        return
    with open(out_path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(COLUMNS)
        for row in rows:
            writer.writerow([repr(row[k]) if isinstance(row[k], float) else row[k]
                             for k in COLUMNS])


def summary(rows: List[dict]) -> str:
    """Mean, min and max of each numeric column (what the JAX tool prints
    from ``DataFrame.describe``)."""
    numeric = [k for k in COLUMNS if isinstance(rows[0][k], float)]
    table = np.array([[row[k] for k in numeric] for row in rows], np.float64)
    lines = [" " * 5 + "".join(f"{k:>14}" for k in numeric)]
    for name, values in (("mean", table.mean(0)), ("min", table.min(0)), ("max", table.max(0))):
        lines.append(f"{name:<5}" + "".join(f"{v:>14.6g}" for v in values))
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gantrack_tpu_torch.tools.analyze_dataset",
                                description="Report per-volume stats and pooled "
                                            "normalisation percentiles.")
    p.add_argument("--source", required=True, help="directory of NIfTI volumes")
    p.add_argument("--out", dest="out_path", required=True, help="output CSV/XLSX")
    p.add_argument("--percentiles", type=float, nargs=2, default=(1.0, 99.0))
    p.add_argument("--plot", dest="plot_path", default=None, help="optional histogram PNG")
    return p


def main(argv: Optional[List[str]] = None) -> dict:
    """Write the table, print the summary and the range; returns
    ``{"rows": [...], "range": percentile_search(...)}``."""
    opts = build_parser().parse_args(argv)
    source, out_path, percentiles = opts.source, opts.out_path, opts.percentiles
    paths = sorted(glob.glob(os.path.join(source, "**", "*.nii*"), recursive=True))
    if not paths:
        raise SystemExit(f"no NIfTI volumes under {source}")
    rows = [volume_stats(p) for p in paths]
    write_table(rows, out_path)
    print(summary(rows))

    pr = percentile_search(paths, percentiles[0], percentiles[1])
    print(f"normalisation range (p{percentiles[0]:g}..p{percentiles[1]:g}): "
          f"[{pr['lower']:.1f}, {pr['upper']:.1f}] over {pr['n_volumes']} volumes")

    if opts.plot_path:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from ..data.preprocess.nifti import read_nifti

        pooled = np.concatenate([
            np.asarray(read_nifti(p)[0]).ravel()[::50] for p in paths[:20]
        ])
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.hist(pooled, bins=200, density=True)
        ax.axvline(pr["lower"], color="r", ls="--")
        ax.axvline(pr["upper"], color="r", ls="--")
        ax.set_title("intensity distribution")
        fig.savefig(opts.plot_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        print(f"plot: {opts.plot_path}")
    return {"rows": rows, "range": pr}


if __name__ == "__main__":
    main()
