"""Label-file generation (reference ``src/data/create_files.py:15-47``).

    python -m gantrack_tpu_torch.tools.create_label_files --patients-dir=<dir of per-patient
        pickles> --labels=<CSV/XLSX/JSON id -> class> --split-file=<split json> --out-dir=<dir>
        [--classes=benign,malignant]

Port of ``gantrack_tpu/tools/create_label_files.py`` (``argparse`` here,
the same flags): per-split ``dataset_<split>.json`` files ``{"labels":
[[path, int], ...]}`` from a patient→class table, for conditional
training through the dataset's label plumbing.

The CSV is read by the ``csv`` module, every cell as text.  The JAX tool
reads it through pandas' type inference, which turns a zero-padded id
column into integers: ``001,alive`` becomes key ``'1'``, which names no
patient directory ``001``, and those patients' slices get no label
(ROADMAP C16, a fault of the JAX package).  The port keeps ``'001'``, as
the JAX ``prepare_dataset`` keeps its ids (``dtype=str``) and as the same
table in JSON does; on every other table the two tools agree
(``tests/test_torch_tools.py``).  ``.xlsx``/``.xls`` tables need pandas
(``utils.config.read_excel``), and are read with ``dtype=str`` too.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Dict, List, Optional


def build_label_file(
    patients_dir: str,
    patient_classes: Dict[str, int],
    split_patients,
    out_path: str,
) -> int:
    labels = []
    for patient in split_patients:
        pdir = os.path.join(patients_dir, patient)
        if not os.path.isdir(pdir) or patient not in patient_classes:
            continue
        for fn in sorted(os.listdir(pdir)):
            if fn.endswith(".pickle"):
                labels.append([f"{patient}/{fn}", int(patient_classes[patient])])
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"labels": labels}, f)
    return len(labels)


def read_table(path: str, id_col: str = "id", label_col: str = "label") -> Dict[str, str]:
    """``{id: label}`` of a CSV or Excel table, every cell as text."""
    if path.endswith((".xlsx", ".xls")):
        from ..utils.config import read_excel

        df = read_excel(path, dtype=str)
        return dict(zip(df[id_col], df[label_col]))
    with open(path, newline="") as f:
        return {row[id_col]: row[label_col] for row in csv.DictReader(f)}


def load_patient_classes(path: str, id_col: str = "id", label_col: str = "label",
                         classes=None) -> Dict[str, int]:
    """CSV/XLSX/JSON patient→class table (reference reads xlsx bootstrap
    folds)."""
    if path.endswith(".json"):
        with open(path) as f:
            mapping = json.load(f)
    else:
        mapping = read_table(path, id_col, label_col)
    if classes is not None:
        cls_idx = {c: i for i, c in enumerate(classes)}
        return {k: cls_idx[v] if v in cls_idx else int(v) for k, v in mapping.items()}
    vals = sorted(set(mapping.values()), key=str)
    cls_idx = {c: i for i, c in enumerate(vals)}
    return {k: cls_idx[v] for k, v in mapping.items()}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gantrack_tpu_torch.tools.create_label_files",
                                description="Write per-split dataset.json label files.")
    p.add_argument("--patients-dir", dest="patients_dir", required=True,
                   help="temp dir of per-patient pickles")
    p.add_argument("--labels", dest="labels_path", required=True,
                   help="CSV/XLSX/JSON patient->class")
    p.add_argument("--split-file", dest="split_file", required=True,
                   help="train/val/test split json")
    p.add_argument("--out-dir", dest="out_dir", required=True)
    p.add_argument("--classes", default=None, help="comma-separated class names (order = index)")
    return p


def main(argv: Optional[List[str]] = None) -> Dict[str, int]:
    """Write ``dataset_{train,val,test}.json``; returns the labels a split."""
    opts = build_parser().parse_args(argv)
    with open(opts.split_file) as f:
        split = json.load(f)
    class_list = opts.classes.split(",") if opts.classes else None
    patient_classes = load_patient_classes(opts.labels_path, classes=class_list)
    counts = {}
    for split_name in ("train", "val", "test"):
        counts[split_name] = build_label_file(
            opts.patients_dir, patient_classes, split.get(split_name, []),
            os.path.join(opts.out_dir, f"dataset_{split_name}.json"),
        )
        print(f"{split_name}: {counts[split_name]} labels")
    return counts


if __name__ == "__main__":
    main()
