"""Data reading and packing: the port's own copies of the JAX package's
framework-free data modules (dataset readers, the infinite loader, the
native batch assembler's binding and the shard packer)."""

from .dataset import (
    GANDataset,
    ImageFolderZipDataset,
    ShardedArrayDataset,
    ZipSliceDataset,
    open_dataset,
)
from .loader import InfiniteLoader, infinite_indices
from .packaging import pack_shards

__all__ = [
    "GANDataset",
    "ImageFolderZipDataset",
    "ShardedArrayDataset",
    "ZipSliceDataset",
    "open_dataset",
    "InfiniteLoader",
    "infinite_indices",
    "pack_shards",
]
