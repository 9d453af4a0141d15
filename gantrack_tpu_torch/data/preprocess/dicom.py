"""Minimal native DICOM series reader → NIfTI.

The port's own copy of ``gantrack_tpu/data/preprocess/dicom.py`` (framework-free;
``tests/test_torch_preprocess.py`` holds the two bit-equal); JPEG Baseline and JPEG 2000
need PIL, imported inside the decode: without it they raise
:class:`MissingCodecError` naming the transfer syntax.

The reference converts DICOM series with the ``dicom2nifti`` package
(``dataset_tool_mi.py:226-255``), which is not installable in this
environment.  This module implements the subset the CT/MR pipeline
needs natively: single-frame DICOM files in

* Implicit VR Little Endian            (1.2.840.10008.1.2)
* Explicit VR Little Endian            (1.2.840.10008.1.2.1)
* Deflated Explicit VR Little Endian   (1.2.840.10008.1.2.1.99, zlib)
* RLE Lossless                         (1.2.840.10008.1.2.5, native
  PackBits decoder per PS3.5 Annex G)
* JPEG Baseline (Process 1)            (1.2.840.10008.1.2.4.50, via PIL)
* JPEG-LS (lossless + near-lossless)   (1.2.840.10008.1.2.4.80/.81,
  native T.87 decoder, ``preprocess/jpegls.py``)
* JPEG 2000 (lossless + lossy)         (1.2.840.10008.1.2.4.90/.91, via PIL)

parsing only the tags required to assemble a volume (geometry, rescale,
pixel data).  Unsupported transfer syntaxes (big-endian, JPEG
Extended/Lossless) raise with the syntax *named* so the failure is
actionable.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IMPLICIT_VR_LE = "1.2.840.10008.1.2"
EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
DEFLATED_VR_LE = "1.2.840.10008.1.2.1.99"
RLE_LOSSLESS = "1.2.840.10008.1.2.5"
JPEG_BASELINE = "1.2.840.10008.1.2.4.50"
JPEG_LS_LL = "1.2.840.10008.1.2.4.80"
JPEG_LS_NEAR = "1.2.840.10008.1.2.4.81"
JPEG_2000_LL = "1.2.840.10008.1.2.4.90"
JPEG_2000 = "1.2.840.10008.1.2.4.91"

#: encapsulated syntaxes this reader decodes (fragment decoder key)
_ENCAPSULATED = {
    RLE_LOSSLESS: "rle",
    JPEG_BASELINE: "pil",
    JPEG_LS_LL: "jls",      # native T.87 decoder (preprocess/jpegls.py)
    JPEG_LS_NEAR: "jls",
    JPEG_2000_LL: "pil",
    JPEG_2000: "pil",
}

#: human names for rejection messages (PS3.5 §10 registry subset)
_TS_NAMES = {
    "1.2.840.10008.1.2.2": "Explicit VR Big Endian (retired)",
    "1.2.840.10008.1.2.4.51": "JPEG Extended (Process 2 & 4)",
    "1.2.840.10008.1.2.4.57": "JPEG Lossless (Process 14)",
    "1.2.840.10008.1.2.4.70": "JPEG Lossless SV1 (Process 14)",
}

#: the PIL-decoded syntaxes, for the error without PIL
_SYNTAX_NAMES = {JPEG_BASELINE: "JPEG Baseline (Process 1)", JPEG_2000_LL: "JPEG 2000 lossless",
                 JPEG_2000: "JPEG 2000"}

# VRs with a 2-byte reserved field and 4-byte length in explicit mode.
_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN"}

_TAGS = {
    (0x0002, 0x0010): "transfer_syntax",
    (0x0018, 0x0050): "slice_thickness",
    (0x0018, 0x0088): "spacing_between_slices",
    (0x0020, 0x0013): "instance_number",
    (0x0020, 0x0032): "image_position",
    (0x0020, 0x0037): "image_orientation",
    (0x0028, 0x0010): "rows",
    (0x0028, 0x0011): "cols",
    (0x0028, 0x0030): "pixel_spacing",
    (0x0028, 0x0100): "bits_allocated",
    (0x0028, 0x0103): "pixel_representation",
    (0x0028, 0x1052): "rescale_intercept",
    (0x0028, 0x1053): "rescale_slope",
    (0x7FE0, 0x0010): "pixel_data",
}


def _parse_fragments(buf: bytes, offset: int) -> Tuple[List[bytes], int]:
    """Encapsulated pixel-data items (PS3.5 A.4): a Basic Offset Table item
    followed by one fragment item per frame, closed by a sequence
    delimiter.  Returns the fragment list (BOT excluded)."""
    frags: List[bytes] = []
    first = True
    while offset + 8 <= len(buf):
        group, elem = struct.unpack_from("<HH", buf, offset)
        length = struct.unpack_from("<I", buf, offset + 4)[0]
        offset += 8
        if (group, elem) == (0xFFFE, 0xE0DD):  # sequence delimitation
            break
        if (group, elem) != (0xFFFE, 0xE000):
            raise ValueError("malformed encapsulated pixel data item")
        if not first:
            frags.append(buf[offset : offset + length])
        first = False  # the first item is the Basic Offset Table
        offset += length
    return frags, offset


def _skip_undefined_sq(buf: bytes, offset: int, explicit: bool) -> int:
    """Skip an undefined-length sequence: walk items (defined or undefined
    length, recursively) until the sequence delimitation item.  Nested
    elements use the dataset's VR mode."""
    while offset + 8 <= len(buf):
        group, elem = struct.unpack_from("<HH", buf, offset)
        length = struct.unpack_from("<I", buf, offset + 4)[0]
        offset += 8
        if (group, elem) == (0xFFFE, 0xE0DD):
            return offset
        if (group, elem) != (0xFFFE, 0xE000):
            raise ValueError("malformed undefined-length sequence")
        if length != 0xFFFFFFFF:
            offset += length
            continue
        # undefined-length item: walk nested elements to the item delimiter
        while offset + 8 <= len(buf):
            g2, e2 = struct.unpack_from("<HH", buf, offset)
            if (g2, e2) == (0xFFFE, 0xE00D):
                offset += 8
                break
            offset += 4
            if explicit:
                vr = buf[offset : offset + 2]
                if vr in _LONG_VRS:
                    l2 = struct.unpack_from("<I", buf, offset + 4)[0]
                    offset += 8
                else:
                    l2 = struct.unpack_from("<H", buf, offset + 2)[0]
                    offset += 4
            else:
                l2 = struct.unpack_from("<I", buf, offset)[0]
                offset += 4
            if l2 == 0xFFFFFFFF:
                offset = _skip_undefined_sq(buf, offset, explicit)
            else:
                offset += l2
    return offset


def _parse_elements(buf: bytes, offset: int, explicit: bool,
                    stop_group: Optional[int] = None) -> Tuple[Dict, int]:
    out: Dict[str, object] = {}
    n = len(buf)
    while offset + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, offset)
        if stop_group is not None and group != stop_group:
            break
        offset += 4
        if explicit:
            vr = buf[offset : offset + 2]
            if vr in _LONG_VRS:
                length = struct.unpack_from("<I", buf, offset + 4)[0]
                offset += 8
            else:
                length = struct.unpack_from("<H", buf, offset + 2)[0]
                offset += 4
        else:
            vr = b"UN"
            length = struct.unpack_from("<I", buf, offset)[0]
            offset += 4
        if length == 0xFFFFFFFF:
            if (group, elem) == (0x7FE0, 0x0010):
                frags, offset = _parse_fragments(buf, offset)
                out["pixel_fragments"] = (frags, b"OB")
                continue
            # undefined-length sequence (referenced-image sequences etc.
            # are routine in clinical exports): skip, don't abort
            offset = _skip_undefined_sq(buf, offset, explicit)
            continue
        value = buf[offset : offset + length]
        offset += length
        name = _TAGS.get((group, elem))
        if name:
            out[name] = (value, vr)
    return out, offset


def _packbits(data: bytes, expected: int) -> np.ndarray:
    """PackBits run-length decode (PS3.5 G.3.1) to exactly ``expected``
    bytes."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expected:
        h = data[i]
        i += 1
        if h < 128:  # literal run of h+1 bytes
            out += data[i : i + h + 1]
            i += h + 1
        elif h > 128:  # replicate next byte 257-h times
            out += data[i : i + 1] * (257 - h)
            i += 1
        # h == 128: no-op
    if len(out) < expected:
        raise ValueError("RLE segment shorter than expected")
    return np.frombuffer(bytes(out[:expected]), np.uint8)


def _rle_decode(fragment: bytes, rows: int, cols: int, nbytes: int) -> np.ndarray:
    """One RLE frame (PS3.5 Annex G): a 64-byte header (segment count +
    15 offsets) then PackBits byte planes, MSB plane first."""
    n_seg = struct.unpack_from("<I", fragment, 0)[0]
    offsets = struct.unpack_from("<15I", fragment, 4)
    if n_seg != nbytes:
        raise ValueError(
            f"RLE: {n_seg} segments for {nbytes}-byte samples "
            "(multi-sample images unsupported)")
    npx = rows * cols
    planes = []
    for s in range(n_seg):
        start = offsets[s]
        end = offsets[s + 1] if s + 1 < n_seg and offsets[s + 1] else len(fragment)
        planes.append(_packbits(fragment[start:end], npx))
    if nbytes == 1:
        return planes[0].reshape(rows, cols)
    comp = (planes[0].astype(np.uint16) << 8) | planes[1].astype(np.uint16)
    return comp.reshape(rows, cols)


class MissingCodecError(ImportError):
    """An image form the port does not decode, whose decoder (PIL) is not
    installed: a DICOM transfer syntax here, a TIFF form in ``tiff.py``."""


def _decode_encapsulated(kind: str, frags: List[bytes], rows: int, cols: int,
                         bits: int, signed: bool, syntax: str = "") -> np.ndarray:
    if not frags:
        raise ValueError("encapsulated pixel data with no fragments")
    if kind == "rle":
        px = _rle_decode(frags[0], rows, cols, bits // 8)
    elif kind == "jls":  # JPEG-LS via the native T.87 decoder
        from . import jpegls

        px, _bits = jpegls.decode(b"".join(frags))
        if px.shape != (rows, cols):
            raise ValueError(
                f"JPEG-LS frame {px.shape} != Rows/Cols {(rows, cols)}")
        px = px.astype(np.uint16 if bits > 8 else np.uint8)
    else:  # PIL-decodable codestream (JPEG baseline / JPEG 2000)
        import io

        try:
            from PIL import Image
        except ImportError:
            raise MissingCodecError(
                f"transfer syntax {syntax} ({_SYNTAX_NAMES.get(syntax, kind)}) needs PIL to "
                f"decode, and PIL is not installed; uncompressed, deflated, RLE and JPEG-LS "
                f"series decode without it") from None

        img = Image.open(io.BytesIO(b"".join(frags)))
        px = np.asarray(img)
        if px.shape[:2] != (rows, cols):
            raise ValueError(
                f"decoded frame {px.shape[:2]} != Rows/Cols {(rows, cols)}")
    if signed and bits == 16:
        px = px.astype(np.uint16).view(np.int16)
    return px


def _ascii(v: Tuple[bytes, bytes]) -> str:
    return v[0].decode("ascii", "ignore").strip("\x00 ").strip()


def _floats(v) -> List[float]:
    return [float(x) for x in _ascii(v).split("\\") if x]


def _uint(v, text: bool = False) -> int:
    """Integer tag value.  ``text=True`` marks IS-VR tags (ASCII digits
    under implicit VR); binary US/UL otherwise — decided by tag, not by
    sniffing bytes (binary values can alias ASCII digits)."""
    raw, vr = v
    if vr == b"US":
        return struct.unpack("<H", raw)[0]
    if vr == b"UL":
        return struct.unpack("<I", raw)[0]
    if vr == b"UN":
        if text:
            return int(_ascii(v))
        if len(raw) == 2:
            return struct.unpack("<H", raw)[0]
        if len(raw) == 4:
            return struct.unpack("<I", raw)[0]
    return int(_ascii(v))


def read_dicom_file(path: str) -> Dict[str, object]:
    """One DICOM file → dict with ``pixels`` (float32 [H, W], rescaled),
    ``position_z``, ``instance``, ``pixel_spacing``, ``slice_spacing``."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[128:132] != b"DICM":
        raise ValueError(f"{path}: not a DICOM part-10 file (no DICM magic)")
    # File meta group (0002) is always explicit VR LE.
    meta, offset = _parse_elements(buf, 132, explicit=True, stop_group=0x0002)
    ts = _ascii(meta["transfer_syntax"]) if "transfer_syntax" in meta else EXPLICIT_VR_LE
    encapsulated = _ENCAPSULATED.get(ts)
    if ts == EXPLICIT_VR_LE or encapsulated:
        explicit = True  # encapsulated syntaxes carry an explicit-LE dataset
    elif ts == IMPLICIT_VR_LE:
        explicit = False
    elif ts == DEFLATED_VR_LE:
        buf = buf[:offset] + zlib.decompress(buf[offset:], -15)
        explicit = True
    else:
        name = _TS_NAMES.get(ts, "unknown")
        raise ValueError(
            f"{path}: transfer syntax {ts} [{name}] is not supported by the "
            "native reader (supported: implicit/explicit/deflated LE, RLE "
            "Lossless, JPEG Baseline, JPEG 2000; convert externally or "
            "install dicom2nifti)")
    tags, _ = _parse_elements(buf, offset, explicit=explicit)

    rows = _uint(tags["rows"])
    cols = _uint(tags["cols"])
    bits = _uint(tags.get("bits_allocated", (b"16", b"UN"))) if "bits_allocated" in tags else 16
    signed = bool(_uint(tags["pixel_representation"])) if "pixel_representation" in tags else False
    if encapsulated:
        px = _decode_encapsulated(encapsulated, tags["pixel_fragments"][0],
                                  rows, cols, bits, signed, syntax=ts)
    else:
        raw = tags["pixel_data"][0]
        dtype = {8: np.uint8, 16: np.int16 if signed else np.uint16}[bits]
        px = np.frombuffer(raw[: rows * cols * (bits // 8)], dtype=dtype).reshape(rows, cols)
    slope = _floats(tags["rescale_slope"])[0] if "rescale_slope" in tags else 1.0
    inter = _floats(tags["rescale_intercept"])[0] if "rescale_intercept" in tags else 0.0
    pixels = px.astype(np.float32) * slope + inter

    pos = _floats(tags["image_position"]) if "image_position" in tags else [0.0, 0.0, 0.0]
    pos = (pos + [0.0, 0.0, 0.0])[:3]
    orient = (_floats(tags["image_orientation"])
              if "image_orientation" in tags else [1, 0, 0, 0, 1, 0])
    spacing = _floats(tags["pixel_spacing"]) if "pixel_spacing" in tags else [1.0, 1.0]
    z_sp = None
    for key in ("spacing_between_slices", "slice_thickness"):
        if key in tags:
            z_sp = _floats(tags[key])[0]
            break
    return {
        "pixels": pixels,
        "position": pos,
        "position_z": pos[2],
        "orientation": orient,
        "instance": (_uint(tags["instance_number"], text=True)
                     if "instance_number" in tags else 0),
        "pixel_spacing": spacing,
        "slice_spacing": z_sp,
    }


def read_dicom_series(directory: str) -> Tuple[np.ndarray, Tuple[float, float, float]]:
    """All ``.dcm``/extensionless DICOM files in a directory → ([H, W, D]
    float32 volume sorted by slice position, (sy, sx, sz) spacing)."""
    files = sorted(
        os.path.join(directory, f) for f in os.listdir(directory)
        if not f.startswith(".") and os.path.isfile(os.path.join(directory, f))
    )
    # Stray non-DICOM files (DICOMDIR, README, .txt) are common in exported
    # series — skip anything without the part-10 magic instead of aborting.
    slices = []
    for p in files:
        with open(p, "rb") as f:
            head = f.read(132)
        if len(head) < 132 or head[128:132] != b"DICM":
            continue
        slices.append(read_dicom_file(p))
    if not slices:
        raise ValueError(f"no DICOM files under {directory}")
    # Sort along the slice NORMAL (row_dir × col_dir from
    # ImageOrientationPatient), like dicom2nifti's common.sort_dicoms —
    # raw z ordering is wrong for coronal/sagittal series and instance
    # numbers can run opposite to geometry.
    o = slices[0]["orientation"]
    normal = np.cross(o[0:3], o[3:6]).astype(np.float64)
    for s in slices:
        s["_proj"] = float(np.dot(s["position"], normal))
    slices.sort(key=lambda s: (s["_proj"], s["instance"]))
    vol = np.stack([s["pixels"] for s in slices], axis=2)
    sy, sx = slices[0]["pixel_spacing"]
    sz = slices[0]["slice_spacing"]
    projs = [s["_proj"] for s in slices]
    if len(projs) > 1:
        import warnings

        # Geometric spacing beats the SliceThickness tag (dicom2nifti uses
        # inter-slice distance; gaps/overlap make the tag unreliable).
        d = np.diff(projs)
        sz = float(np.median(d))
        if np.max(np.abs(d - sz)) > max(0.01 * abs(sz), 1e-6):
            warnings.warn(
                f"{directory}: non-uniform slice spacing "
                f"(min {d.min():.4g}, max {d.max():.4g}); using the median "
                f"{sz:.4g} — resample explicitly if this series matters",
                stacklevel=2)
        # Gantry tilt shows as an in-plane component of the inter-slice
        # position step (dicom2nifti refuses such series without its tilt
        # correction path); we stack as-is but say so.
        deltas = np.diff(np.asarray([s["position"] for s in slices],
                                    np.float64), axis=0)
        perp = deltas - np.outer(deltas @ normal, normal)
        if float(np.max(np.linalg.norm(perp, axis=1))) > 1e-3:
            warnings.warn(
                f"{directory}: gantry-tilted/sheared series — slices are "
                "stacked without shear correction", stacklevel=2)
    elif sz is None:
        sz = 1.0
    return vol, (float(sy), float(sx), float(abs(sz) or 1.0))


def dicom_series_to_nifti(src_dir: str, out_path: str) -> None:
    """Native replacement for ``dicom2nifti.dicom_series_to_nifti``
    (uncompressed series)."""
    from .nifti import write_nifti

    vol, zooms = read_dicom_series(src_dir)
    write_nifti(out_path, vol, zooms=zooms)
