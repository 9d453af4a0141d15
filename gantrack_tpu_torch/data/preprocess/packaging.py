"""Dataset packaging: slices → pickles → splits → zip / memmap shards.

The port's own copy of ``gantrack_tpu/data/preprocess/packaging.py`` (framework-free;
``tests/test_torch_preprocess.py`` holds the two bit-equal); ``data/packaging.py`` re-exports ``pack_shards``.

Capability parity with the reference's ``snap_pickle`` / ``snap_zip``
stages (``src/data/dataset_tool_mi.py:580-861``): per-patient per-slice
pickle dicts, the deterministic ``random.Random(max_patients)`` patient
hold-out split (reused if already on disk), and the
``<split>/<patient>/<slice>.pickle`` zip layout the training dataset
reads.  Additionally writes the TPU-native **sharded memmap format**
(``pack_shards``) consumed by ``ShardedArrayDataset``.
"""

from __future__ import annotations

import json
import os
import pickle
import random
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def write_slice_pickles(
    out_dir: str,
    patient: str,
    slices: Dict[str, np.ndarray],   # modality -> [H, W, D]
    pop_range: int = 10,
    drop_ranges: Optional[Sequence[Tuple[int, int]]] = None,
    mask: Optional[np.ndarray] = None,
) -> List[str]:
    """Write ``<out_dir>/<patient>/<patient>_<slice:05d>.pickle`` files.

    Reference semantics (``dataset_tool_mi.py:580-714``): drop
    ``pop_range`` slices at each stack end plus any explicit per-patient
    problem ranges; multiply every modality by the body mask.
    """
    modalities = list(slices)
    depth = slices[modalities[0]].shape[2]
    drop = set()
    drop.update(range(0, min(pop_range, depth)))
    drop.update(range(max(depth - pop_range, 0), depth))
    for lo, hi in drop_ranges or []:
        drop.update(range(lo, hi + 1))

    pdir = os.path.join(out_dir, patient)
    os.makedirs(pdir, exist_ok=True)
    written = []
    for d in range(depth):
        if d in drop:
            continue
        entry = {}
        for m in modalities:
            sl = slices[m][:, :, d]
            if mask is not None:
                sl = sl * mask[:, :, d]
            entry[m] = sl.astype(np.float32)
        fname = os.path.join(pdir, f"{patient}_{d:05d}.pickle")
        with open(fname, "wb") as f:
            pickle.dump(entry, f)
        written.append(fname)
    return written


def split_list(lst: Sequence, fraction: float) -> Tuple[list, list]:
    n = int(round(len(lst) * fraction))
    return list(lst[:n]), list(lst[n:])


def holdout_split(
    patients: Sequence[str],
    max_patients: int = 100000,
    fractions: Dict[str, float] = None,
) -> Dict[str, list]:
    """Deterministic patient-level hold-out split.

    Reference (``dataset_tool_mi.py:811-833``): sort, shuffle with
    ``random.Random(max_patients)``, truncate to ``max_patients``, then
    split train / val / test by normalised fractions.
    """
    fractions = fractions or {"train": 0.7, "val": 0.1, "test": 0.2}
    tr, va, te = fractions["train"], fractions["val"], fractions["test"]
    tot = tr + va + te
    tr, va, te = tr / tot, va / tot, te / tot

    patients = sorted(patients)
    max_patients = min(max_patients, len(patients))
    random.Random(max_patients).shuffle(patients)
    sample = patients[:max_patients]
    train, rest = split_list(sample, tr)
    val, test = split_list(rest, va / (va + te))
    return {"sample_patients": sample, "train": train, "val": val, "test": test}


def load_or_create_split(split_path: str, patients: Sequence[str], **kwargs) -> Dict[str, list]:
    """Reuse an existing split file if present (reference ``:799-806``)."""
    if os.path.exists(split_path):
        with open(split_path) as f:
            return json.load(f)
    s = holdout_split(patients, **kwargs)
    os.makedirs(os.path.dirname(split_path), exist_ok=True)
    with open(split_path, "w") as f:
        json.dump(s, f, ensure_ascii=False, indent=4)
    return s


def write_zip(
    source: str,
    out_path: str,
    split: Dict[str, list],
    labels: Optional[Dict[str, Dict[str, int]]] = None,
) -> str:
    """Assemble ``<split>/<patient>/<slice>.pickle`` zip + per-split
    ``dataset.json`` label files (reference ``:839-860``)."""
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_STORED) as z:
        for split_name in ("train", "val", "test"):
            if labels and split_name in labels:
                z.writestr(
                    f"{split_name}/dataset.json",
                    json.dumps({"labels": sorted(labels[split_name].items())}),
                )
            for patient in split.get(split_name, []):
                pdir = os.path.join(source, patient)
                if not os.path.isdir(pdir):
                    continue
                for fn in sorted(os.listdir(pdir)):
                    if fn.endswith(".pickle"):
                        z.write(os.path.join(pdir, fn), f"{split_name}/{patient}/{fn}")
    return out_path


def pack_shards(
    out_dir: str,
    split_name: str,
    images: Sequence[np.ndarray],     # each [H, W, C] float32
    names: Sequence[str],
    labels: Optional[Sequence[int]] = None,
    shard_size: int = 2048,
    dataset_name: str = "dataset",
) -> str:
    """Write the TPU-native sharded memmap format.

    ``<out_dir>/<split>/shard-NNNN.npy`` + ``index.json`` — see
    ``ShardedArrayDataset``.
    """
    sdir = os.path.join(out_dir, split_name)
    os.makedirs(sdir, exist_ok=True)
    shards = []
    for i in range(0, len(images), shard_size):
        chunk = np.stack(images[i : i + shard_size]).astype(np.float32)
        fname = f"shard-{i // shard_size:04d}.npy"
        np.save(os.path.join(sdir, fname), chunk)
        shards.append({"file": fname, "n": int(chunk.shape[0])})
    index = {
        "name": dataset_name,
        "shards": shards,
        "names": list(names),
        "labels": list(int(v) for v in labels) if labels is not None else None,
    }
    with open(os.path.join(sdir, "index.json"), "w") as f:
        json.dump(index, f)
    return sdir
