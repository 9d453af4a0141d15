"""claro TIFF-stage preparation runner.

    python -m gantrack_tpu_torch.tools.prepare_dataset --source=<raw dir> --dest=<interim dir> \\
        --patients-info=<table> [--box-file=<table>] [--resolution=256] [--convert-to-uint8]

Port of ``gantrack_tpu/tools/prepare_dataset.py`` (``argparse`` here, the
same flags and defaults), which rebuilds the reference's interactive
prep script (``src/data/dataset_preparation.py:1-166``): intersect the
patient-info table with the lung-box annotation table, push every
annotated slice through the claro per-slice pipeline (box-crop → resize
→ clip → normalise, ``util_medical_data.py:111-134``), and export
per-slice images into an interim directory for the downstream
``dataset_tool`` stages.

Without PIL: slices are read by the port's TIFF decoder
(``data/preprocess/tiff.py``; PIL only for a TIFF it refuses, through
``dataset_tool.read_slice_image``) and written by its encoder, float32
TIFFs with the bytes PIL writes for a mode ``F`` image.  Under
``--convert-to-uint8`` they are PNGs of ``utils.checkpoint.save_png``:
the same pixels as the JAX tool's, other bytes (zlib level 6 where PIL
writes ``compress_level=0``).  Tables are CSV (the ``csv`` module, every
cell as text, as the JAX tool's ``dtype=str``) or, with pandas and
openpyxl, ``.xlsx`` (``utils.config.read_excel``).

Differences from the reference, by design (as in the JAX tool):

* The ``input()``-gated "develop" mode (``dataset_preparation.py:48-50``)
  becomes an explicit ``--interactive`` flag, asked before the run dir
  is allocated, so an aborted attempt leaves nothing behind.
* Box lists are parsed with ``ast.literal_eval``, not ``eval``
  (reference ``util_medical_data.py:156``).
"""

from __future__ import annotations

import argparse
import ast
import csv
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def _read_table(path: str) -> Tuple[List[str], List[Dict[str, str]]]:
    """CSV (native) or XLSX (with pandas and openpyxl) → its columns and
    its rows, every cell as text."""
    if path.lower().endswith((".xlsx", ".xls")):
        from ..utils.config import read_excel

        df = read_excel(path, dtype=str)
        return list(df.columns), df.to_dict("records")
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
        return list(reader.fieldnames or []), rows


def _load_boxes(path: Optional[str], box_value: str) -> Optional[Dict[str, list]]:
    """'img ID' → box list, reference ``util_medical_data.py:154-158``."""
    if path is None:
        return None
    columns, rows = _read_table(path)
    if "img ID" not in columns or box_value not in columns:
        raise SystemExit(
            f"box file {path} needs columns 'img ID' and {box_value!r}; found {columns}")
    return {os.path.basename(str(r["img ID"])): ast.literal_eval(str(r[box_value]))
            for r in rows}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gantrack_tpu_torch.tools.prepare_dataset",
                                description="Prepare the claro TIFF stage (reference "
                                            "dataset_preparation.py).")
    p.add_argument("--config", dest="config_path", type=str, default=None,
                   help="YAML config (configs/claro_preprocessing.yaml layout)")
    p.add_argument("--source", required=True,
                   help="Raw data dir: <patient>/images/<patient>_<slice>.tif")
    p.add_argument("--dest", required=True, help="Interim output root")
    p.add_argument("--patients-info", dest="patients_info", required=True,
                   help="Table with an 'image' column of <dir>/<patient>_<slice>.tif rows")
    p.add_argument("--box-file", dest="box_file", default=None,
                   help="Table keyed 'img ID' with a box-list column")
    p.add_argument("--box-value", dest="box_value", default="box lung")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--clip-min", dest="clip_min", type=float, default=-1000.0)
    p.add_argument("--clip-max", dest="clip_max", type=float, default=1000.0)
    p.add_argument("--convert-to-uint8", dest="convert_to_uint8", action="store_true",
                   help="Export uint8 PNG instead of float TIFF")
    p.add_argument("--max-slices", dest="max_slices", type=int, default=None, help="Debug cap")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--interactive", action="store_true",
                   help="Confirm the resolved config on stdin before running")
    return p


def main(argv: Optional[List[str]] = None) -> Optional[str]:
    """Prepare the claro TIFF stage; returns the run dir (None when
    ``--interactive`` is declined)."""
    from ..data.preprocess.medical import load_slice
    from ..data.preprocess.tiff import write_tiff
    from ..utils.config import Logger, allocate_run_dir, dump_options, load_yaml
    from .dataset_tool import read_slice_image

    o = build_parser().parse_args(argv)
    source, dest, convert_to_uint8 = o.source, o.dest, o.convert_to_uint8
    cfg = load_yaml(o.config_path) if o.config_path else {}
    data_cfg = dict(cfg.get("data", {}))
    resolution = int(data_cfg.get("image_size", o.resolution))
    clip = {"min": float(data_cfg.get("clip_min", o.clip_min)),
            "max": float(data_cfg.get("clip_max", o.clip_max))}

    opts = dict(source=source, dest=dest, patients_info=o.patients_info,
                box_file=o.box_file, box_value=o.box_value, resolution=resolution,
                clip=clip, convert_to_uint8=convert_to_uint8, seed=o.seed,
                config=dict(cfg))
    print(json.dumps(opts, indent=2))
    # Confirm BEFORE allocating the run dir, so an aborted attempt leaves
    # nothing behind (reference dataset_preparation.py gates with input()
    # before its submit-run block).
    if o.interactive and input("run with the config above? [y/N] ") != "y":
        print("aborted")
        return None
    run_dir = allocate_run_dir(os.path.join(dest, "runs"), "prepare_dataset")
    logger = Logger(os.path.join(run_dir, "log.txt"))
    try:
        print(json.dumps(opts, indent=2))  # into log.txt too
        dump_options(run_dir, opts, name="configuration.json")
        np.random.seed(o.seed)

        # Patient/box intersection (reference dataset_preparation.py:136-146).
        columns, info = _read_table(o.patients_info)
        if "image" not in columns:
            raise SystemExit(f"{o.patients_info} needs an 'image' column; found {columns}")
        slice_ids = [os.path.basename(str(r["image"])).split(".tif")[0] for r in info]
        boxes = _load_boxes(o.box_file, o.box_value)
        if boxes is not None:
            slice_ids = sorted(np.intersect1d(slice_ids, list(boxes)))
        print(f"Number of images: {len(slice_ids)}")
        print(f"Number of patients: {len({s.split('_')[0] for s in slice_ids})}")

        out_dir = os.path.join(dest, "images")
        os.makedirs(out_dir, exist_ok=True)
        scale = dict(clip)
        todo = slice_ids[:o.max_slices]
        for n, sid in enumerate(todo):
            patient = sid.split("_")[0]
            img_path = os.path.join(source, patient, "images", f"{sid}.tif")
            img = read_slice_image(img_path).astype(np.float64)
            x = load_slice(
                img, img_dim=resolution,
                box=None if boxes is None else boxes[sid],
                clip=clip, scale=scale,
                convert_to_uint8=convert_to_uint8, scale_by_255=True,
            )
            if convert_to_uint8:
                from ..utils.checkpoint import save_png

                assert x.dtype == np.uint8 and x.ndim == 2
                save_png(os.path.join(out_dir, f"{sid}.png"), x)
            else:  # PIL's mode F: the slice as float32
                write_tiff(os.path.join(out_dir, f"{sid}.tif"), x.astype(np.float32))
            if (n + 1) % 200 == 0:
                print(f"{n + 1}/{len(todo)} slices")
        print(f"done: {len(todo)} slices → {out_dir}")
    finally:  # the JAX CLI's process ends here; a caller in-process gets its streams back
        logger.close()
    return run_dir


if __name__ == "__main__":
    main()
