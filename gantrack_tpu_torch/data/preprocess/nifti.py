"""Minimal pure-NumPy NIfTI-1 I/O.

The port's own copy of ``gantrack_tpu/data/preprocess/nifti.py`` (framework-free;
``tests/test_torch_preprocess.py`` holds the two bit-equal).

The reference uses nibabel/SimpleITK for volume I/O
(``src/engine/utils/utils.py``); neither ships in this environment, so
this module implements the NIfTI-1 container directly: 348-byte header
parse/build, gzip support, ``scl_slope/scl_inter`` scaling, and pixdim
zooms.  Falls back to nibabel automatically when it is installed (for
full affine/orientation fidelity).
"""

from __future__ import annotations

import gzip
import struct
from typing import Optional, Tuple

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: str) -> Tuple[np.ndarray, Tuple[float, float, float]]:
    """Return (volume array in file order, zooms (dx, dy, dz))."""
    try:
        import nibabel as nib  # optional, preferred when present

        img = nib.load(path)
        return np.asanyarray(img.dataobj), tuple(img.header.get_zooms()[:3])
    except ImportError:
        pass

    with _open(path, "rb") as f:
        hdr = f.read(348)
        sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
        if sizeof_hdr != 348:
            raise IOError(f"{path}: not a little-endian NIfTI-1 file")
        dim = struct.unpack("<8h", hdr[40:56])
        datatype = struct.unpack("<h", hdr[70:72])[0]
        pixdim = struct.unpack("<8f", hdr[76:108])
        vox_offset = struct.unpack("<f", hdr[108:112])[0]
        scl_slope = struct.unpack("<f", hdr[112:116])[0]
        scl_inter = struct.unpack("<f", hdr[116:120])[0]
        magic = hdr[344:348]
        if magic[:3] not in (b"n+1", b"ni1"):
            raise IOError(f"{path}: bad NIfTI magic {magic!r}")

        ndim = dim[0]
        shape = tuple(dim[1 : 1 + max(ndim, 1)])
        dtype = _DTYPES.get(datatype)
        if dtype is None:
            raise IOError(f"{path}: unsupported NIfTI datatype {datatype}")
        f.seek(int(vox_offset))
        data = np.frombuffer(f.read(), dtype=dtype)[: int(np.prod(shape))]
        vol = data.reshape(shape, order="F")
        if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
            slope = scl_slope if scl_slope != 0 else 1.0
            vol = vol.astype(np.float32) * slope + scl_inter
        zooms = tuple(abs(z) for z in pixdim[1:4])
        return np.asarray(vol), zooms


def write_nifti(
    path: str,
    vol: np.ndarray,
    zooms: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> None:
    """Write a NIfTI-1 single file (.nii or .nii.gz)."""
    try:
        import nibabel as nib

        affine = np.diag(list(zooms[:3]) + [1.0])
        nib.save(nib.Nifti1Image(vol, affine), path)
        return
    except ImportError:
        pass

    vol = np.asarray(vol)
    code = _DTYPE_CODES.get(vol.dtype)
    if code is None:
        vol = vol.astype(np.float32)
        code = _DTYPE_CODES[np.dtype(np.float32)]

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)                       # sizeof_hdr
    dim = [vol.ndim] + list(vol.shape) + [1] * (7 - vol.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)                    # dim
    struct.pack_into("<h", hdr, 70, code)                     # datatype
    struct.pack_into("<h", hdr, 72, vol.dtype.itemsize * 8)   # bitpix
    pixdim = [1.0] + list(zooms[:3]) + [1.0] * (7 - 3)
    struct.pack_into("<8f", hdr, 76, *pixdim)                 # pixdim
    struct.pack_into("<f", hdr, 108, 352.0)                   # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)                     # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)                     # scl_inter
    # qform/sform codes 0; quatern defaults; srow rows from zooms.
    struct.pack_into("<h", hdr, 252, 0)                       # qform_code
    struct.pack_into("<h", hdr, 254, 1)                       # sform_code
    struct.pack_into("<4f", hdr, 280, zooms[0], 0, 0, 0)      # srow_x
    struct.pack_into("<4f", hdr, 296, 0, zooms[1], 0, 0)      # srow_y
    struct.pack_into("<4f", hdr, 312, 0, 0, zooms[2], 0)      # srow_z
    hdr[344:348] = b"n+1\x00"

    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00\x00\x00\x00")  # 4-byte pad to vox_offset 352
        f.write(np.asfortranarray(vol).tobytes(order="F"))
