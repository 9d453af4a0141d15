"""The port's own data modules against the JAX package's, exactly.

``gantrack_tpu_torch/data`` carries copies of the JAX package's
framework-free data modules (the port imports nothing of that package).
One packed shard directory, written by either packer, goes through both
packages' ``open_dataset`` and ``InfiniteLoader`` with the same seed: the
files, the items and the batches must be equal bit for bit.
"""

import filecmp
import os

import numpy as np
import pytest

from gantrack_tpu.data import dataset as jdataset
from gantrack_tpu.data import loader as jloader
from gantrack_tpu.data.preprocess.packaging import pack_shards as j_pack_shards
from gantrack_tpu_torch import data as tdata

RES = 12


def _images(n=37, channels=1):
    rng = np.random.default_rng(0)
    return [rng.uniform(0, 255, (RES, RES, channels)).astype(np.float32) for _ in range(n)]


def test_packers_write_the_same_files(tmp_path):
    images, names = _images(), [f"s{i}" for i in range(37)]
    labels = [i % 3 for i in range(37)]
    a = j_pack_shards(str(tmp_path / "a"), "train", images, names, labels=labels, shard_size=16)
    b = tdata.pack_shards(str(tmp_path / "b"), "train", images, names, labels=labels,
                          shard_size=16)
    files = sorted(os.listdir(a))
    assert files == sorted(os.listdir(b)) and len(files) == 4  # 3 shards + index.json
    match, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert (sorted(match), mismatch, errors) == (files, [], [])


@pytest.mark.parametrize("kwargs", [
    dict(), dict(xflip=True), dict(use_labels=True), dict(max_size=20, random_seed=3),
])
def test_datasets_read_the_same_items(tmp_path, kwargs):
    root = str(tmp_path / "d")
    tdata.pack_shards(root, "train", _images(), [f"s{i}" for i in range(37)],
                      labels=[i % 3 for i in range(37)], shard_size=16)
    ours, theirs = tdata.open_dataset(root, **kwargs), jdataset.open_dataset(root, **kwargs)
    assert type(ours).__name__ == type(theirs).__name__ == "ShardedArrayDataset"
    assert type(ours).__module__.startswith("gantrack_tpu_torch.")
    assert len(ours) == len(theirs)
    for attr in ("resolution", "num_channels", "label_dim", "has_labels", "name"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    for i in (0, 5, len(ours) - 1):
        for a, b in zip(ours[i], theirs[i]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    idx = np.asarray([3, 0, len(ours) - 1, 7])
    np.testing.assert_array_equal(ours.gather_batch(idx), theirs.gather_batch(idx))


@pytest.mark.parametrize("seed,xflip,workers", [(0, False, 1), (5, True, 1), (5, True, 2)])
def test_loaders_yield_the_same_batches(tmp_path, seed, xflip, workers):
    root = str(tmp_path / "d")
    tdata.pack_shards(root, "train", _images(), [f"s{i}" for i in range(37)], shard_size=16)
    kw = dict(split="train", xflip=xflip, random_seed=seed)
    ours = tdata.InfiniteLoader(tdata.open_dataset(root, **kw), batch_size=8, seed=seed,
                                num_workers=workers)
    theirs = jloader.InfiniteLoader(jdataset.open_dataset(root, **kw), batch_size=8, seed=seed,
                                    num_workers=workers)
    try:
        for _ in range(7):  # more than one pass over the 37 (or 74) items
            (img_a, lab_a), (img_b, lab_b) = next(ours), next(theirs)
            assert img_a.shape == (8, RES, RES, 1) and img_a.dtype == np.float32
            np.testing.assert_array_equal(img_a, img_b)
            np.testing.assert_array_equal(lab_a, lab_b)
    finally:
        ours.close()
        theirs.close()
    np.testing.assert_array_equal(
        np.fromiter(tdata.infinite_indices(37, seed=seed), np.int64, 100),
        np.fromiter(jloader.infinite_indices(37, seed=seed), np.int64, 100))
