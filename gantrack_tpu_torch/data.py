"""Data reading and packing, shared with the JAX package.

The dataset, loader and shard packer of ``gantrack_tpu.data`` use only
numpy and the standard library, so the port imports them rather than
carrying copies.  This module is the one place where it does: callers
of the port (its CLI, ``chip_smoke.py``) import them from here.
"""

import gantrack_tpu_torch  # noqa: F401  (switches the JAX compile cache off first)

from gantrack_tpu.data.dataset import open_dataset
from gantrack_tpu.data.loader import InfiniteLoader
from gantrack_tpu.data.preprocess.packaging import pack_shards

__all__ = ["InfiniteLoader", "open_dataset", "pack_shards"]
