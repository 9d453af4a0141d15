"""TIFF codec without PIL, for the claro slice images.

The JAX tools read and write the claro TIFF stage through PIL
(``gantrack_tpu/tools/prepare_dataset.py``, ``dataset_tool.py``'s
``process_tiff``); the port reads and writes it here, with numpy and
``zlib`` only.  ``tests/test_torch_tools.py`` holds the decoder to PIL's
reading of the same files and the encoder to PIL's bytes.

:func:`decode` reads single-image TIFFs of one sample a pixel:

* byte order ``II`` or ``MM``;
* strips of any ``RowsPerStrip``, or tiles;
* compression none (1), PackBits (32773), Deflate (8, 32946) or LZW (5),
  with predictor 1 or 2 (horizontal differencing);
* unsigned 8/16/32-bit, signed 16/32-bit or IEEE float 32/64-bit samples
  (``SampleFormat`` 1, 2, 3), BlackIsZero.

Anything else (BigTIFF, more than one image, colour, palettes, JPEG, the
floating-point predictor, ...) raises :class:`MissingCodecError` naming
the tag and its value, as the DICOM reader names a transfer syntax.

:func:`encode` writes what PIL writes for a mode ``F`` image (the JAX
``prepare_dataset``'s float32 slices): little-endian, uncompressed, one
strip, Pillow's tags in Pillow's order, so the bytes are PIL's.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from .dicom import MissingCodecError

__all__ = ["MissingCodecError", "decode", "encode", "read_tiff", "write_tiff"]

# Field type → (struct code, bytes) of the types whose values are read.
_TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8)}
# (SampleFormat, BitsPerSample) → numpy dtype of a sample.
_SAMPLES = {(1, 8): "u1", (1, 16): "u2", (1, 32): "u4", (2, 16): "i2", (2, 32): "i4",
            (3, 32): "f4", (3, 64): "f8"}
# none, LZW, Deflate, PackBits, Deflate (the old code).
_COMPRESSIONS = (1, 5, 8, 32773, 32946)
_TAG_NAMES = {254: "NewSubfileType", 256: "ImageWidth", 257: "ImageLength",
              258: "BitsPerSample", 259: "Compression", 262: "PhotometricInterpretation",
              273: "StripOffsets", 277: "SamplesPerPixel", 278: "RowsPerStrip",
              279: "StripByteCounts", 284: "PlanarConfiguration", 317: "Predictor",
              322: "TileWidth", 323: "TileLength", 324: "TileOffsets", 325: "TileByteCounts",
              339: "SampleFormat"}


def _refuse(tag: int, value) -> MissingCodecError:
    return MissingCodecError(
        f"TIFF {_TAG_NAMES.get(tag, 'tag')} ({tag}) = {value} is not read without PIL; the "
        f"port's decoder reads single-image, one-sample TIFFs (uint 8/16/32, int 16/32, float "
        f"32/64; none, PackBits, Deflate or LZW; predictor 1 or 2)")


def _ifd(data: bytes, order: str, offset: int) -> Tuple[Dict[int, tuple], int]:
    """The entries of the IFD at ``offset`` as {tag: values}, and the
    offset of the next IFD."""
    (n,) = struct.unpack_from(order + "H", data, offset)
    tags = {}
    for i in range(n):
        tag, typ, count, field = struct.unpack_from(order + "HHI4s", data, offset + 2 + 12 * i)
        if typ not in _TYPES:
            continue
        code, size = _TYPES[typ]
        raw = field if size * count <= 4 else data[
            struct.unpack(order + "I", field)[0]:][:size * count]
        if len(raw) < size * count:
            raise ValueError(f"TIFF tag {tag}: values past the end of the file")
        tags[tag] = struct.unpack(order + code * count, raw[:size * count])
    (next_ifd,) = struct.unpack_from(order + "I", data, offset + 2 + 12 * n)
    return tags, next_ifd


def _packbits(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
    return bytes(out)


def _lzw(data: bytes) -> bytes:
    """TIFF LZW: MSB-first codes of 9 to 12 bits, Clear 256, EOI 257, the
    code width growing one code early (as libtiff writes it)."""
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    width, prev = 9, None
    buf = nbits = pos = 0
    n = len(data)
    while True:
        while nbits < width:
            if pos >= n:
                return bytes(out)  # no EOI: what was read is the strip
            buf = (buf << 8) | data[pos]
            pos += 1
            nbits += 8
        nbits -= width
        code = (buf >> nbits) & ((1 << width) - 1)
        buf &= (1 << nbits) - 1
        if code == 257:
            return bytes(out)
        if code == 256:
            del table[258:]
            width, prev = 9, None
            continue
        if prev is None:
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
            elif code == len(table):
                entry = prev + prev[:1]
            else:
                raise ValueError(f"TIFF LZW: code {code} past the table ({len(table)})")
            table.append(prev + entry[:1])
            if len(table) >= (1 << width) - 1 and width < 12:
                width += 1
        out += entry
        prev = entry


def decode(data: bytes) -> np.ndarray:
    """A TIFF file's bytes → its image ``[H, W]`` in its sample type."""
    order = {b"II": "<", b"MM": ">"}.get(bytes(data[:2]))
    if order is None:
        raise ValueError("not a TIFF file (no II/MM byte order mark)")
    (magic, first) = struct.unpack_from(order + "HI", data, 2)
    if magic != 42:
        raise MissingCodecError(f"TIFF version {magic} (43 is BigTIFF) is not read without PIL")
    tags, next_ifd = _ifd(data, order, first)
    if next_ifd:
        raise _refuse(254, "an image after the first (a multi-page TIFF)")

    def one(tag, default=None):
        values = tags.get(tag, (default,) if default is not None else None)
        if values is None:
            raise ValueError(f"TIFF: {_TAG_NAMES.get(tag, tag)} ({tag}) missing")
        if len(set(values)) != 1:
            raise _refuse(tag, values)
        return values[0]

    width, height = one(256), one(257)
    spp = one(277, 1)
    if spp != 1:
        raise _refuse(277, spp)
    photometric = one(262)
    if photometric != 1:
        raise _refuse(262, photometric)
    bits, fmt = one(258, 1), one(339, 1)
    if (fmt, bits) not in _SAMPLES:
        raise _refuse(339 if fmt not in (1, 2, 3) else 258, f"{bits} bits of SampleFormat {fmt}")
    compression, predictor = one(259, 1), one(317, 1)
    if compression not in _COMPRESSIONS:
        raise _refuse(259, compression)
    if predictor not in (1, 2):
        raise _refuse(317, predictor)
    dtype = np.dtype(_SAMPLES[fmt, bits]).newbyteorder(order)

    if 322 in tags:  # tiles, each a full tile_h x tile_w, padded at the edges
        tile_w, tile_h = one(322), one(323)
        offsets, counts = tags[324], tags[325]
        across = -(-width // tile_w)
        boxes = [((i // across) * tile_h, (i % across) * tile_w, tile_h, tile_w)
                 for i in range(-(-height // tile_h) * across)]
    else:
        rows = min(one(278, 2**32 - 1), height)
        offsets, counts = tags[273], tags[279]
        boxes = [(r, 0, min(rows, height - r), width) for r in range(0, height, rows)]
    if len(offsets) != len(boxes) or len(counts) != len(boxes):
        raise ValueError(f"TIFF: {len(offsets)} offsets and {len(counts)} byte counts for "
                         f"{len(boxes)} strips or tiles")

    image = np.empty((height, width), dtype.newbyteorder("="))
    words = np.dtype(f"u{dtype.itemsize}").newbyteorder(order)
    for (r, c, h, w), offset, count in zip(boxes, offsets, counts):
        chunk = bytes(data[offset:offset + count])
        if compression == 5:
            chunk = _lzw(chunk)
        elif compression in (8, 32946):
            chunk = zlib.decompress(chunk)
        elif compression == 32773:
            chunk = _packbits(chunk)
        need = h * w * dtype.itemsize
        if len(chunk) < need:
            raise ValueError(f"TIFF: a strip or tile of {len(chunk)} bytes where {need} are due")
        block = np.frombuffer(chunk[:need], words).reshape(h, w)
        if predictor == 2:  # horizontal differencing on the sample's bits
            block = np.cumsum(block.astype(words.newbyteorder("=")), axis=1,
                              dtype=words.newbyteorder("="))
        block = np.ascontiguousarray(block).view(dtype if predictor == 1 else
                                                 dtype.newbyteorder("="))
        hh, ww = min(h, height - r), min(w, width - c)
        image[r:r + hh, c:c + ww] = block[:hh, :ww]
    return image


def read_tiff(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def encode(pixels: np.ndarray) -> bytes:
    """Float32 ``[H, W]`` samples → the bytes PIL writes for
    ``Image.fromarray(pixels).save(path, "tiff")`` (mode ``F``): an
    uncompressed little-endian TIFF of one strip."""
    pixels = np.asarray(pixels)
    if pixels.ndim != 2 or pixels.dtype != np.float32:
        raise ValueError(f"encode takes float32 [H, W] samples, not {pixels.dtype} "
                         f"{pixels.shape}")
    height, width = pixels.shape
    body = pixels.astype("<f4").tobytes()
    entries = [(256, 4, width), (257, 4, height), (258, 3, 32), (259, 3, 1), (262, 3, 1),
               (273, 4, 0), (278, 4, height), (279, 4, len(body)), (284, 3, 1), (339, 3, 3)]
    start = 8 + 2 + 12 * len(entries) + 4
    ifd = struct.pack("<H", len(entries)) + b"".join(
        struct.pack("<HHI", tag, typ, 1) + struct.pack("<I" if typ == 4 else "<HH",
                                                       start if tag == 273 else value,
                                                       *(() if typ == 4 else (0,)))
        for tag, typ, value in entries) + struct.pack("<I", 0)
    return b"II*\x00" + struct.pack("<I", 8) + ifd + body


def write_tiff(path: str, pixels: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(pixels))
