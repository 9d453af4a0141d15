"""Full-state checkpoints and PNG image grids.

A checkpoint holds everything a step mutates: G, D and G_ema state
dicts, both optimizers, ``pl_mean``, the ADA state, the step counters
and the step generator's state, so a resumed run continues exactly.
Images are written (and read back) by a small numpy + ``zlib`` PNG
encoder and decoder: no image library is needed.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import Optional

import numpy as np
import torch


def save_checkpoint(ckpt_dir: str, state, generator: Optional[torch.Generator] = None,
                    extra: Optional[dict] = None) -> str:
    """Write ``<ckpt_dir>/state-<step>.pt`` atomically, with the entries of
    ``extra`` beside the state's; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"state-{state.step:08d}.pt")
    payload = {
        "G": state.G.state_dict(),
        "D": state.D.state_dict(),
        "G_ema": state.G_ema.state_dict(),
        "opt_g": state.opt_g.state_dict(),
        "opt_d": state.opt_d.state_dict(),
        "pl_mean": state.pl_mean.detach().cpu(),
        "ada_p": state.ada_p.detach().cpu(),
        "ada_signs": state.ada_signs.detach().cpu(),
        "step": state.step,
        "cur_nimg": state.cur_nimg,
        "generator": generator.get_state() if generator is not None else None,
        **(extra or {}),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, state, generator: Optional[torch.Generator] = None):
    """Restore ``state`` (and ``generator``) in place from ``path``.  Read on
    the CPU, as the CLI's ``--resume`` reads it: the networks and the
    optimizers' moments go to their parameters' device, and Adam's step
    counters stay on the CPU, where an uninterrupted run keeps them."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return apply_checkpoint(payload, state, generator)


def apply_checkpoint(payload: dict, state, generator: Optional[torch.Generator] = None):
    """Restore ``state`` (and ``generator``) in place from a loaded
    checkpoint (the data-parallel CLI loads it on rank 0 and hands it to
    every rank)."""
    device = state.pl_mean.device
    state.G.load_state_dict(payload["G"])
    state.D.load_state_dict(payload["D"])
    state.G_ema.load_state_dict(payload["G_ema"])
    state.opt_g.load_state_dict(payload["opt_g"])
    state.opt_d.load_state_dict(payload["opt_d"])
    state.pl_mean = payload["pl_mean"].to(device)
    state.ada_p = payload["ada_p"].to(device)
    state.ada_signs = payload["ada_signs"].to(device)
    state.step = int(payload["step"])
    state.cur_nimg = int(payload["cur_nimg"])
    if generator is not None and payload["generator"] is not None:
        generator.set_state(payload["generator"].cpu())
    return state


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    entries = sorted(e for e in os.listdir(ckpt_dir) if re.fullmatch(r"state-\d+\.pt", e))
    return os.path.join(ckpt_dir, entries[-1]) if entries else None


def resolve_checkpoint_path(checkpoint: str) -> Optional[str]:
    """A ``state-*.pt`` file, or the latest one in a run dir's
    ``checkpoints/`` or in the directory itself."""
    if os.path.isfile(checkpoint):
        return checkpoint
    if os.path.isdir(checkpoint):
        return (latest_checkpoint(os.path.join(checkpoint, "checkpoints"))
                or latest_checkpoint(checkpoint))
    return None


def resolve_network(network: str):
    """A ``--network`` / ``--resume`` argument → ``(payload, path)``.

    ``network`` is a run dir, a ``state-*.pt`` (its payload: ``G``, ``D``,
    ``G_ema`` state dicts and the rest of the state) or a NVIDIA
    ``*.pkl`` / ``*.pickle`` (``models.torch_compat.state_dict_from_pickle``:
    the three state dicts and the pickle's ``architecture``).  The
    counterpart of ``gantrack_tpu/utils/checkpoint.py``'s
    ``resolve_network``; ``(None, None)`` when nothing is found.
    """
    if network.endswith((".pkl", ".pickle")):
        from ..models.torch_compat import state_dict_from_pickle

        if not os.path.isfile(network):
            return None, None
        return state_dict_from_pickle(network), network
    path = resolve_checkpoint_path(network)
    if path is None:
        return None, None
    return torch.load(path, map_location="cpu", weights_only=True), path


def encode_png(pixels: np.ndarray) -> bytes:
    """8-bit grayscale ``[H, W]`` or RGB ``[H, W, 3]`` → PNG bytes."""
    assert pixels.dtype == np.uint8 and pixels.ndim in (2, 3)
    h, w = pixels.shape[:2]
    color_type = 0 if pixels.ndim == 2 else 2
    rows = pixels.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()  # filter 0

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def save_png(path: str, pixels: np.ndarray) -> None:
    """Write 8-bit grayscale ``[H, W]`` or RGB ``[H, W, 3]`` pixels."""
    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(pixels)))


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth) of
    ``rows`` ``[H, 1 + stride]`` uint8; returns ``[H, stride]`` uint8."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        kind, raw = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = raw
        elif kind == 1:  # Sub: a running sum along each byte lane
            lanes = np.zeros(-(-stride // bpp) * bpp, np.int32)
            lanes[:stride] = raw
            cur = (np.cumsum(lanes.reshape(-1, bpp), axis=0).reshape(-1)[:stride]) & 0xFF
        elif kind == 2:  # Up
            cur = (raw + prior) & 0xFF
        elif kind in (3, 4):  # Average, Paeth: byte by byte
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prior[i])
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(prior[i - bpp]) if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (int(raw[i]) + pred) & 0xFF
        else:
            raise ValueError(f"PNG row filter {kind}")
        out[y] = cur
        prior = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """A non-interlaced grayscale (8 or 16 bit) or 8-bit RGB PNG, with any
    row filters, → ``[H, W]`` uint8 / uint16 or ``[H, W, 3]`` uint8; raises
    ``ValueError`` on anything else or on a chunk whose CRC does not match."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if crc != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"PNG chunk {tag!r}: CRC mismatch")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, color, _, _, interlace = header
    if interlace or (color, depth) not in ((0, 8), (0, 16), (2, 8)):
        raise ValueError(f"PNG of depth {depth}, colour type {color}, interlace {interlace}")
    ch = 1 if color == 0 else 3
    bpp = ch * depth // 8
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * bpp)
    pixels = rows[:, 1:] if not rows[:, 0].any() else _unfilter(rows, bpp)
    if depth == 16:
        return np.ascontiguousarray(pixels).view(">u2").astype(np.uint16).reshape(h, w)
    return pixels.reshape(h, w) if ch == 1 else pixels.reshape(h, w, 3)


def save_image_grid(images: np.ndarray, path: str, drange=(-1, 1),
                    grid_size: Optional[tuple] = None) -> None:
    """Export an ``[N, H, W, C]`` batch as one PNG grid (2-channel pairs
    side by side, as the JAX package writes them)."""
    lo, hi = drange
    img = (np.asarray(images, np.float32) - lo) * (255 / (hi - lo))
    img = np.rint(img).clip(0, 255).astype(np.uint8)
    n, h, w, c = img.shape
    if grid_size is None:
        gw = max(int(np.ceil(np.sqrt(n))), 1)
        gh = int(np.ceil(n / gw))
    else:
        gw, gh = grid_size
    grid = np.zeros((gh * h, gw * w, c), dtype=np.uint8)
    for i in range(min(n, gw * gh)):
        y, x = divmod(i, gw)
        grid[y * h:(y + 1) * h, x * w:(x + 1) * w] = img[i]
    if c == 1:
        pixels = grid[:, :, 0]
    elif c == 2:
        pixels = np.concatenate([grid[:, :, 0], grid[:, :, 1]], axis=1)
    else:
        pixels = grid
    save_png(path, pixels)
