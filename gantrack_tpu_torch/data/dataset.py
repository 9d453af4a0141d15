"""Streaming datasets for training.

The port's own copy of ``gantrack_tpu/data/dataset.py`` (numpy and the
standard library only), kept equal to it: the same files give the same
items in both packages.

Capability parity with the reference data layer
(``training/dataset_mi_multimodal.py:30-285``, ``dataset_mi.py``,
``dataset.py``): max_size clamping, x-flip doubling, one-hot labels,
split-aware zip-of-pickles multimodal reading, and PNG-zip natural-image
reading.  Plus the **sharded memmap format** (written by the
preprocessing pipeline) that serves batches with zero-copy reads instead
of per-item zip decompression + unpickling.

Output layout is **HWC** float32 (as the JAX package's reader; the
training loop moves it to NCHW on the device).
"""

from __future__ import annotations

import json
import os
import pickle
import zipfile
from typing import List, Optional, Sequence, Tuple

import numpy as np


class GANDataset:
    """Base dataset: indexing, max_size, xflip doubling, labels.

    Mirrors reference ``Dataset`` (``dataset_mi_multimodal.py:30-187``):
    ``max_size`` subsamples (seeded shuffle then sort) before the optional
    x-flip doubling; integer labels are one-hot encoded on access.
    """

    def __init__(
        self,
        name: str,
        raw_shape: Sequence[int],     # [N, H, W, C]
        max_size: Optional[int] = None,
        use_labels: bool = False,
        xflip: bool = False,
        random_seed: int = 0,
    ):
        self._name = name
        self._raw_shape = list(raw_shape)
        self._use_labels = use_labels
        self._raw_labels: Optional[np.ndarray] = None

        self._raw_idx = np.arange(self._raw_shape[0], dtype=np.int64)
        if max_size is not None and self._raw_idx.size > max_size:
            np.random.RandomState(random_seed).shuffle(self._raw_idx)
            self._raw_idx = np.sort(self._raw_idx[:max_size])

        self._xflip = np.zeros(self._raw_idx.size, dtype=np.uint8)
        if xflip:
            self._raw_idx = np.tile(self._raw_idx, 2)
            self._xflip = np.concatenate([self._xflip, np.ones_like(self._xflip)])

    # -- to be overridden ------------------------------------------------
    def _load_raw_image(self, raw_idx: int) -> Tuple[np.ndarray, str]:
        raise NotImplementedError

    def _load_raw_labels(self) -> Optional[np.ndarray]:
        raise NotImplementedError

    def close(self):
        pass

    # --------------------------------------------------------------------
    def _get_raw_labels(self) -> np.ndarray:
        if self._raw_labels is None:
            self._raw_labels = self._load_raw_labels() if self._use_labels else None
            if self._raw_labels is None:
                self._raw_labels = np.zeros([self._raw_shape[0], 0], dtype=np.float32)
            assert self._raw_labels.shape[0] == self._raw_shape[0]
            assert self._raw_labels.dtype in (np.float32, np.int64)
        return self._raw_labels

    def __len__(self) -> int:
        return self._raw_idx.size

    def __getitem__(self, idx: int):
        image, fname = self._load_raw_image(int(self._raw_idx[idx]))
        assert image.ndim == 3  # HWC
        if self._xflip[idx]:
            image = image[:, ::-1, :]  # mirror left-right
        return np.ascontiguousarray(image), self.get_label(idx), fname

    def get_label(self, idx: int) -> np.ndarray:
        label = self._get_raw_labels()[self._raw_idx[idx]]
        if label.dtype == np.int64:
            onehot = np.zeros(self.label_shape, dtype=np.float32)
            onehot[label] = 1
            return onehot
        return label.copy()

    # -- shape/metadata properties (reference ``:128-187``) --------------
    @property
    def name(self) -> str:
        return self._name

    @property
    def image_shape(self) -> List[int]:  # [H, W, C]
        return list(self._raw_shape[1:])

    @property
    def num_channels(self) -> int:
        return self._raw_shape[3]

    @property
    def resolution(self) -> int:
        assert self._raw_shape[1] == self._raw_shape[2]
        return self._raw_shape[1]

    @property
    def label_shape(self) -> List[int]:
        labels = self._get_raw_labels()
        if labels.dtype == np.int64:
            return [int(np.max(labels)) + 1 if labels.size else 0]
        return [labels.shape[1]]

    @property
    def label_dim(self) -> int:
        assert len(self.label_shape) == 1
        return self.label_shape[0]

    @property
    def has_labels(self) -> bool:
        return any(x != 0 for x in self.label_shape)

    @property
    def has_onehot_labels(self) -> bool:
        return self._get_raw_labels().dtype == np.int64


class ZipSliceDataset(GANDataset):
    """Reference-format reader: zip of per-slice pickle dicts.

    Layout ``<split>/<patient>/<patient>_<slice>.pickle`` where each
    pickle maps modality name → HxW array; labels in
    ``<split>/dataset.json`` (reference
    ``dataset_mi_multimodal.py:193-285``).
    """

    def __init__(
        self,
        path: str,
        split: str = "train",
        modalities: Optional[Sequence[str]] = None,
        resolution: Optional[int] = None,
        **super_kwargs,
    ):
        self._path = path
        self._split = split
        self._modalities = list(modalities) if modalities else ["MR_nonrigid_CT", "MR_MR_T2"]
        self._zipfile: Optional[zipfile.ZipFile] = None
        if os.path.splitext(path)[1].lower() != ".zip":
            raise IOError("Path must point to a zip")
        self._all_fnames = set(self._zip().namelist())
        self._image_fnames = sorted(
            f for f in self._all_fnames
            if os.path.splitext(f)[1].lower() == ".pickle" and split in f
        )
        if not self._image_fnames:
            raise IOError(f"No {split} pickles found in {path}")
        name = os.path.splitext(os.path.basename(path))[0]
        raw_shape = [len(self._image_fnames)] + list(self._load_raw_image(0)[0].shape)
        if resolution is not None and (raw_shape[1] != resolution or raw_shape[2] != resolution):
            raise IOError("Image files do not match the specified resolution")
        super().__init__(name=name, raw_shape=raw_shape, **super_kwargs)

    def _zip(self) -> zipfile.ZipFile:
        if self._zipfile is None:
            self._zipfile = zipfile.ZipFile(self._path)
        return self._zipfile

    def close(self):
        if self._zipfile is not None:
            self._zipfile.close()
            self._zipfile = None

    def __getstate__(self):
        return dict(self.__dict__, _zipfile=None, _raw_labels=None)

    def _load_raw_image(self, raw_idx: int) -> Tuple[np.ndarray, str]:
        fname = self._image_fnames[raw_idx]
        with self._zip().open(fname, "r") as f:
            p = pickle.load(f)
        mats = [np.asarray(p[m], dtype=np.float32) for m in self._modalities]
        return np.stack(mats, axis=-1), fname  # HWC

    def _load_raw_labels(self) -> Optional[np.ndarray]:
        fname = f"{self._split}/dataset.json"
        if fname not in self._all_fnames:
            return None
        with self._zip().open(fname, "r") as f:
            labels = json.load(f)["labels"]
        if labels is None:
            return None
        labels = dict(labels)
        labels = [
            labels[os.path.relpath(f.replace("\\", "/"), f"{self._split}/")]
            for f in self._image_fnames
        ]
        labels = np.array(labels)
        return labels.astype({1: np.int64, 2: np.float32}[labels.ndim])


class ImageFolderZipDataset(GANDataset):
    """PNG-in-zip natural image reader (upstream ``training/dataset.py``
    parity, used by the vanilla train path).  Emits uint8→float32 HWC."""

    def __init__(self, path: str, resolution: Optional[int] = None, **super_kwargs):
        import importlib

        Image = importlib.import_module("PIL.Image")  # lazy: only this reader needs it

        self._path = path
        self._Image = Image
        self._zipfile: Optional[zipfile.ZipFile] = None
        self._all_fnames = set(self._zip().namelist())
        exts = {".png", ".jpg", ".jpeg"}
        self._image_fnames = sorted(
            f for f in self._all_fnames if os.path.splitext(f)[1].lower() in exts
        )
        if not self._image_fnames:
            raise IOError(f"No images found in {path}")
        name = os.path.splitext(os.path.basename(path))[0]
        raw_shape = [len(self._image_fnames)] + list(self._load_raw_image(0)[0].shape)
        if resolution is not None and (raw_shape[1] != resolution or raw_shape[2] != resolution):
            raise IOError("Image files do not match the specified resolution")
        super().__init__(name=name, raw_shape=raw_shape, **super_kwargs)

    def _zip(self) -> zipfile.ZipFile:
        if self._zipfile is None:
            self._zipfile = zipfile.ZipFile(self._path)
        return self._zipfile

    def close(self):
        if self._zipfile is not None:
            self._zipfile.close()
            self._zipfile = None

    def __getstate__(self):
        return dict(self.__dict__, _zipfile=None, _raw_labels=None)

    def _load_raw_image(self, raw_idx: int) -> Tuple[np.ndarray, str]:
        fname = self._image_fnames[raw_idx]
        with self._zip().open(fname, "r") as f:
            img = np.asarray(self._Image.open(f), dtype=np.float32)
        if img.ndim == 2:
            img = img[:, :, None]
        return img, fname

    def _load_raw_labels(self) -> Optional[np.ndarray]:
        fname = "dataset.json"
        if fname not in self._all_fnames:
            return None
        with self._zip().open(fname, "r") as f:
            labels = json.load(f)["labels"]
        if labels is None:
            return None
        labels = dict(labels)
        labels = [labels[f.replace("\\", "/")] for f in self._image_fnames]
        labels = np.array(labels)
        return labels.astype({1: np.int64, 2: np.float32}[labels.ndim])


class ShardedArrayDataset(GANDataset):
    """The training format: memmapped ``.npy`` shards + json index.

    Written by :func:`.packaging.pack_shards`.  Each
    shard is one ``float32``/``uint8`` array ``[n, H, W, C]``; the index
    records shard files, per-item names, and integer labels.  Reads are
    zero-copy memmap slices — no decompression, no unpickling — which is
    what the single-controller loader needs to keep up with the device.
    """

    INDEX_NAME = "index.json"

    def __init__(self, path: str, split: str = "train", **super_kwargs):
        self._dir = os.path.join(path, split)
        with open(os.path.join(self._dir, self.INDEX_NAME)) as f:
            self._index = json.load(f)
        self._shards = [
            np.load(os.path.join(self._dir, s["file"]), mmap_mode="r")
            for s in self._index["shards"]
        ]
        self._offsets = np.cumsum([0] + [s.shape[0] for s in self._shards])
        self._names = self._index.get("names")
        self._labels = self._index.get("labels")
        n = int(self._offsets[-1])
        h, w, c = self._shards[0].shape[1:]
        super().__init__(
            name=self._index.get("name", os.path.basename(path)),
            raw_shape=[n, h, w, c],
            **super_kwargs,
        )

    def _load_raw_image(self, raw_idx: int) -> Tuple[np.ndarray, str]:
        shard = int(np.searchsorted(self._offsets, raw_idx, side="right") - 1)
        local = raw_idx - self._offsets[shard]
        img = np.asarray(self._shards[shard][local], dtype=np.float32)
        name = self._names[raw_idx] if self._names else str(raw_idx)
        return img, name

    def _load_raw_labels(self) -> Optional[np.ndarray]:
        if not self._labels:
            return None
        return np.asarray(self._labels, dtype=np.int64)

    def gather_batch(self, idx: np.ndarray, normalize: bool = True) -> np.ndarray:
        """Fast whole-batch gather via the native C++ assembler
        (``data/native.py``), honouring xflip doubling and max_size
        remapping.  Returns ``[B, H, W, C]`` float32 (normalised to
        [-1, 1] when ``normalize``)."""
        from .native import assemble_batch

        idx = np.asarray(idx, np.int64)
        raw = self._raw_idx[idx]
        flips = self._xflip[idx].astype(np.uint8)
        return assemble_batch(self._shards, raw, flips, normalize=normalize)


def open_dataset(path: str, **kwargs) -> GANDataset:
    """Dispatch by path: directory with index.json → sharded memmap;
    ``.zip`` with pickles → reference format; ``.zip`` with PNGs →
    natural images."""
    if os.path.isdir(path) or os.path.isdir(os.path.join(path, kwargs.get("split", "train"))):
        return ShardedArrayDataset(path, **kwargs)
    if path.endswith(".zip"):
        with zipfile.ZipFile(path) as z:
            names = z.namelist()[:200]
        if any(n.endswith(".pickle") for n in names):
            return ZipSliceDataset(path, **kwargs)
        kwargs.pop("split", None)
        kwargs.pop("modalities", None)
        return ImageFolderZipDataset(path, **kwargs)
    raise IOError(f"Unrecognised dataset path: {path}")
