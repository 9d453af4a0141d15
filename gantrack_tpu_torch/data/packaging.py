"""Dataset packaging: the sharded memmap format.

The port's own copy of ``pack_shards`` from
``gantrack_tpu/data/preprocess/packaging.py``: writes the
``<split>/shard-NNNN.npy`` + ``index.json`` layout that
``ShardedArrayDataset`` reads.  The pickle / zip stages of the
preprocessing pipeline are not carried.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np


def pack_shards(
    out_dir: str,
    split_name: str,
    images: Sequence[np.ndarray],     # each [H, W, C] float32
    names: Sequence[str],
    labels: Optional[Sequence[int]] = None,
    shard_size: int = 2048,
    dataset_name: str = "dataset",
) -> str:
    """Write the sharded memmap format.

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
