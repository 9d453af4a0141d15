"""Dataset packaging: the sharded memmap format.

``pack_shards`` lives in ``data/preprocess/packaging.py``, the port's
copy of ``gantrack_tpu/data/preprocess/packaging.py``; this module
re-exports it, so ``from gantrack_tpu_torch.data.packaging import
pack_shards`` keeps working.
"""

from .preprocess.packaging import pack_shards

__all__ = ["pack_shards"]
