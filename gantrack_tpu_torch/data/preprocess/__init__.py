"""Offline preprocessing: volume → slices → packaged training data.

The port's own copy of ``gantrack_tpu/data/preprocess``, the
re-design of the reference ``src/data/dataset_tool_mi.py`` multi-stage
pipeline (SURVEY §2.7): NIfTI and DICOM (with JPEG-LS) readers, the
per-slice and per-volume steps, and the packaging into pickles, zips
and memmap shards.
"""

from .medical import (
    body_mask_slice,
    body_mask_volume,
    compute_epi_mask,
    epi_body_mask_volume,
    clip_and_rescale_volume,
    get_box,
    load_slice,
    normalize,
    resample_volume,
)
from .packaging import (
    holdout_split,
    load_or_create_split,
    pack_shards,
    split_list,
    write_slice_pickles,
    write_zip,
)

__all__ = [
    "get_box",
    "normalize",
    "load_slice",
    "clip_and_rescale_volume",
    "body_mask_slice",
    "body_mask_volume",
    "compute_epi_mask",
    "epi_body_mask_volume",
    "resample_volume",
    "holdout_split",
    "load_or_create_split",
    "pack_shards",
    "split_list",
    "write_slice_pickles",
    "write_zip",
]
