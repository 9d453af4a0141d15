"""Pure-python JPEG-LS (ITU-T T.87) codec — lossless & near-lossless.

The port's own copy of ``gantrack_tpu/data/preprocess/jpegls.py`` (framework-free;
``tests/test_torch_preprocess.py`` holds the two bit-equal).

Widens the DICOM ingest envelope (``preprocess/dicom.py``) to the
JPEG-LS transfer syntaxes (1.2.840.10008.1.2.4.80/.81) that clinical
exporters emit; the reference reaches these only through the external
``dicom2nifti``/pydicom/CharLS stack (``dataset_tool_mi.py:226-255``),
which this image cannot install.

Scope: single-component (grayscale) scans, 2–16 bit, ILV=none — the
shape of DICOM CT/MR pixel data.  Multi-component scans and restart
intervals raise with a named error.

Implements the full LOCO-I pipeline of T.87: gradient quantization with
default or LSE-preset thresholds, MED prediction with bias correction,
limited-length Golomb coding with byte stuffing, run mode with the
J-table run index, run-interruption contexts (365/366), and the NEAR
quantizer.  The decoder is the product path; a mirror encoder lives
here too (used by ``tools/dataset_tool`` fixtures and tests) — both are
independent walks of the spec's A.4–A.7 flowcharts and are round-trip-
and stream-level tested in ``tests/test_jpegls.py``.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

SOI, EOI = 0xFFD8, 0xFFD9
SOF55, LSE, SOS, DRI = 0xFFF7, 0xFFF8, 0xFFDA, 0xFFDD

# J table (T.87 A.2.3) — run-length code order.
J = [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 5, 5, 6, 6,
     7, 7, 8, 9, 10, 11, 12, 13, 14, 15]


def default_thresholds(maxval: int, near: int) -> Tuple[int, int, int, int]:
    """T1/T2/T3/RESET defaults (T.87 C.2.4.1.1.1; BASIC_T = 3/7/21).
    8-bit lossless ⇒ (3, 7, 21, 64)."""
    def clamp(v, floor_v):
        return floor_v if (v > maxval or v < floor_v) else v

    if maxval >= 128:
        f = (min(maxval, 4095) + 128) // 256
        t1 = clamp(f * (3 - 2) + 2 + 3 * near, near + 1)
        t2 = clamp(f * (7 - 3) + 3 + 5 * near, t1)
        t3 = clamp(f * (21 - 4) + 4 + 7 * near, t2)
    else:
        f = 256 // (maxval + 1)
        t1 = clamp(max(2, 3 // f) + 3 * near, near + 1)
        t2 = clamp(max(3, 7 // f) + 5 * near, t1)
        t3 = clamp(max(4, 21 // f) + 7 * near, t2)
    return t1, t2, t3, 64


class _Params:
    def __init__(self, maxval: int, near: int,
                 t1: int, t2: int, t3: int, reset: int):
        self.maxval, self.near = maxval, near
        self.t1, self.t2, self.t3, self.reset = t1, t2, t3, reset
        self.range = (maxval + 2 * near) // (2 * near + 1) + 1
        self.qbpp = (self.range - 1).bit_length()     # ceil(log2(RANGE))
        self.bpp = max(2, maxval.bit_length())        # ceil(log2(MAXVAL+1))
        self.limit = 2 * (self.bpp + max(8, self.bpp))


class _Contexts:
    """A/B/C/N for the 365 regular contexts + run-interruption contexts
    365 (RItype=0) and 366 (RItype=1), per T.87 A.2.1/A.8."""

    def __init__(self, p: _Params):
        init_a = max((p.range + 32) // 64, 2)
        self.A = [init_a] * 367
        self.B = [0] * 365
        self.C = [0] * 365
        self.N = [1] * 367
        self.Nn = [0, 0]
        self.run_index = 0
        self.p = p

    # ---- regular mode helpers (shared state arithmetic only: the
    # encode/decode *bit* paths below are written independently).
    def golomb_k(self, q: int) -> int:
        k = 0
        while (self.N[q] << k) < self.A[q]:
            k += 1
        return k

    def special_regime(self, q: int, k: int) -> bool:
        return self.p.near == 0 and k == 0 and 2 * self.B[q] <= -self.N[q]

    def update_regular(self, q: int, errval: int):
        p = self.p
        self.B[q] += errval * (2 * p.near + 1)
        self.A[q] += abs(errval)
        if self.N[q] == p.reset:
            self.A[q] >>= 1
            self.B[q] = self.B[q] >> 1 if self.B[q] >= 0 else -((1 - self.B[q]) >> 1)
            self.N[q] >>= 1
        self.N[q] += 1
        if self.B[q] <= -self.N[q]:
            self.B[q] += self.N[q]
            if self.C[q] > -128:
                self.C[q] -= 1
            if self.B[q] <= -self.N[q]:
                self.B[q] = -self.N[q] + 1
        elif self.B[q] > 0:
            self.B[q] -= self.N[q]
            if self.C[q] < 127:
                self.C[q] += 1
            if self.B[q] > 0:
                self.B[q] = 0

    def ri_k(self, ritype: int) -> int:
        q = 365 + ritype
        temp = self.A[q] + ((self.N[q] >> 1) if ritype else 0)
        k = 0
        while (self.N[q] << k) < temp:
            k += 1
        return k

    def update_ri(self, ritype: int, errval: int, emerrval: int):
        q = 365 + ritype
        if errval < 0:
            self.Nn[ritype] += 1
        self.A[q] += (emerrval + 1 - ritype) >> 1
        if self.N[q] == self.p.reset:
            self.A[q] >>= 1
            self.N[q] >>= 1
            self.Nn[ritype] >>= 1
        self.N[q] += 1


def _quantize_gradient(d: int, p: _Params) -> int:
    if d <= -p.t3:
        return -4
    if d <= -p.t2:
        return -3
    if d <= -p.t1:
        return -2
    if d < -p.near:
        return -1
    if d <= p.near:
        return 0
    if d < p.t1:
        return 1
    if d < p.t2:
        return 2
    if d < p.t3:
        return 3
    return 4


def _med(a: int, b: int, c: int) -> int:
    if c >= max(a, b):
        return min(a, b)
    if c <= min(a, b):
        return max(a, b)
    return a + b - c


def _modrange(errval: int, rng: int) -> int:
    """A.4.5: reduce the (quantized) error into [-⌈R/2⌉? .. )."""
    if errval < 0:
        errval += rng
    if errval >= (rng + 1) // 2:
        errval -= rng
    return errval


class _BitReader:
    """MSB-first bit reader with JPEG-LS byte stuffing: a byte following
    0xFF carries only 7 bits (its MSB is 0 in valid entropy data)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.cur = 0
        self.nbits = 0
        self.prev_ff = False

    def _load(self):
        if self.pos >= len(self.data):
            self.cur = (self.cur << 8)   # trailing padding
            self.nbits += 8
            return
        b = self.data[self.pos]
        self.pos += 1
        if self.prev_ff:
            self.cur = (self.cur << 7) | (b & 0x7F)
            self.nbits += 7
        else:
            self.cur = (self.cur << 8) | b
            self.nbits += 8
        self.prev_ff = (b == 0xFF)

    def bit(self) -> int:
        if self.nbits == 0:
            self._load()
        self.nbits -= 1
        return (self.cur >> self.nbits) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.cur = 0
        self.nbits = 0
        self.prev_ff = False

    def _flush_byte(self):
        width = 7 if self.prev_ff else 8
        while self.nbits >= width:
            byte = (self.cur >> (self.nbits - width)) & ((1 << width) - 1)
            self.nbits -= width
            self.cur &= (1 << self.nbits) - 1
            self.out.append(byte)
            self.prev_ff = (byte == 0xFF)
            width = 7 if self.prev_ff else 8

    def write(self, value: int, n: int):
        if n == 0:
            return
        self.cur = (self.cur << n) | (value & ((1 << n) - 1))
        self.nbits += n
        self._flush_byte()

    def unary(self, n: int):
        while n > 24:
            self.write(0, 24)
            n -= 24
        self.write(1, n + 1)

    def finish(self) -> bytes:
        width = 7 if self.prev_ff else 8
        if self.nbits:
            pad = width - self.nbits
            self.write_padding(pad)
        return bytes(self.out)

    def write_padding(self, pad: int):
        self.cur <<= pad
        self.nbits += pad
        self._flush_byte()
        self.nbits = 0
        self.cur = 0


def _golomb_decode(br: _BitReader, k: int, limit: int, qbpp: int) -> int:
    u = 0
    while br.bit() == 0:
        u += 1
        if u > 64 + limit:
            raise ValueError("JPEG-LS: runaway unary code (corrupt stream)")
    if u < limit - qbpp - 1:
        return (u << k) | br.bits(k)
    return br.bits(qbpp) + 1


def _golomb_encode(bw: _BitWriter, value: int, k: int, limit: int, qbpp: int):
    hi = value >> k
    if hi < limit - qbpp - 1:
        bw.unary(hi)
        bw.write(value, k)
    else:
        bw.unary(limit - qbpp - 1)
        bw.write(value - 1, qbpp)


# --------------------------------------------------------------- decode

def decode_scan(data: bytes, rows: int, cols: int, p: _Params) -> np.ndarray:
    ctx = _Contexts(p)
    br = _BitReader(data)
    out = np.zeros((rows, cols), np.int64)
    rng_full = p.range * (2 * p.near + 1)

    for y in range(rows):
        prev = out[y - 1] if y > 0 else None
        row = out[y]
        x = 0
        while x < cols:
            if prev is not None:
                b = int(prev[x])
                d = int(prev[x + 1]) if x + 1 < cols else b
                if x > 0:
                    a, c = int(row[x - 1]), int(prev[x - 1])
                else:
                    a = b  # Ra at line start := Rb
                    c = self_c0(y, out)
            else:
                b = c = d = 0
                a = int(row[x - 1]) if x > 0 else 0

            d1, d2, d3 = d - b, b - c, c - a
            if abs(d1) <= p.near and abs(d2) <= p.near and abs(d3) <= p.near:
                # -------- run mode (A.7; segment semantics per A.7.1.2:
                # each '1' covers min(2^J, remaining) samples, the run
                # index advances only on FULL segments, and a line filled
                # by segments carries no interruption sample)
                run = 0
                interrupted = True
                while br.bit() == 1:
                    seg = 1 << J[ctx.run_index]
                    count = min(seg, cols - x - run)
                    run += count
                    if count == seg and ctx.run_index < 31:
                        ctx.run_index += 1
                    if x + run == cols:
                        interrupted = False
                        break
                if interrupted and J[ctx.run_index]:
                    run += br.bits(J[ctx.run_index])
                for i in range(run):
                    row[x + i] = a
                x += run
                if not interrupted or x >= cols:
                    continue
                # -------- run interruption sample (A.7.2)
                b = int(prev[x]) if prev is not None else 0
                ritype = 1 if abs(a - b) <= p.near else 0
                px = a if ritype else b
                sign = -1 if (ritype == 0 and a > b) else 1
                q = 365 + ritype
                k = ctx.ri_k(ritype)
                emerr = _golomb_decode(br, k, p.limit - J[ctx.run_index] - 1,
                                       p.qbpp)
                temp = emerr + ritype
                map_ = temp & 1
                eabs = (temp + map_) // 2
                s_flag = (k != 0) or (2 * ctx.Nn[ritype] >= ctx.N[q])
                errval = -eabs if (map_ == (1 if s_flag else 0)) else eabs
                ctx.update_ri(ritype, errval, emerr)
                rx = px + sign * errval * (2 * p.near + 1)
                if rx < -p.near:
                    rx += rng_full
                elif rx > p.maxval + p.near:
                    rx -= rng_full
                row[x] = min(max(rx, 0), p.maxval)
                if ctx.run_index > 0:
                    ctx.run_index -= 1
                x += 1
                continue

            # -------- regular mode (A.4–A.6)
            q1 = _quantize_gradient(d1, p)
            q2 = _quantize_gradient(d2, p)
            q3 = _quantize_gradient(d3, p)
            sign = 1
            if q1 < 0 or (q1 == 0 and (q2 < 0 or (q2 == 0 and q3 < 0))):
                q1, q2, q3, sign = -q1, -q2, -q3, -1
            q = (q1 * 9 + q2) * 9 + q3
            px = _med(a, b, c) + sign * ctx.C[q]
            px = min(max(px, 0), p.maxval)
            k = ctx.golomb_k(q)
            merr = _golomb_decode(br, k, p.limit, p.qbpp)
            if ctx.special_regime(q, k):
                errval = (merr - 1) // 2 if (merr & 1) else -(merr // 2) - 1
            else:
                errval = -((merr + 1) // 2) if (merr & 1) else merr // 2
            ctx.update_regular(q, errval)
            rx = px + sign * errval * (2 * p.near + 1)
            if rx < -p.near:
                rx += rng_full
            elif rx > p.maxval + p.near:
                rx -= rng_full
            row[x] = min(max(rx, 0), p.maxval)
            x += 1
    return out


def self_c0(y, out):
    """Rc at x=0 (T.87 edge rule): the Ra used at x=0 of the PREVIOUS
    line, which itself was that line's Rb := out[y-2][0] (0 on line 1)."""
    return int(out[y - 2][0]) if y > 1 else 0


# --------------------------------------------------------------- encode

def encode_scan(img: np.ndarray, p: _Params) -> bytes:
    """Mirror encoder (A.4–A.7) — fixtures/tests; also usable to write
    DICOM-embeddable codestreams via :func:`encode`."""
    rows, cols = img.shape
    src = img.astype(np.int64)
    recon = np.zeros_like(src)
    ctx = _Contexts(p)
    bw = _BitWriter()
    rng_full = p.range * (2 * p.near + 1)

    def reconstruct(px, sign, errval):
        rx = px + sign * errval * (2 * p.near + 1)
        if rx < -p.near:
            rx += rng_full
        elif rx > p.maxval + p.near:
            rx -= rng_full
        return min(max(rx, 0), p.maxval)

    for y in range(rows):
        prev = recon[y - 1] if y > 0 else None
        row = recon[y]
        x = 0
        while x < cols:
            if prev is not None:
                b = int(prev[x])
                d = int(prev[x + 1]) if x + 1 < cols else b
                if x > 0:
                    a, c = int(row[x - 1]), int(prev[x - 1])
                else:
                    a = b
                    c = self_c0(y, recon)
            else:
                b = c = d = 0
                a = int(row[x - 1]) if x > 0 else 0

            d1, d2, d3 = d - b, b - c, c - a
            if abs(d1) <= p.near and abs(d2) <= p.near and abs(d3) <= p.near:
                # -------- run mode
                run = 0
                while (x + run < cols
                       and abs(int(src[y][x + run]) - a) <= p.near):
                    row[x + run] = a
                    run += 1
                rem = run
                while rem >= (1 << J[ctx.run_index]):
                    bw.write(1, 1)
                    rem -= 1 << J[ctx.run_index]
                    if ctx.run_index < 31:
                        ctx.run_index += 1
                x += run
                if x >= cols:
                    # Run reaches end-of-line: a trailing partial segment
                    # is coded as a single '1' and the run index does NOT
                    # advance (A.7.1.2 end-of-line rule).
                    if rem:
                        bw.write(1, 1)
                    break
                # run broken by a mismatching sample
                bw.write(0, 1)
                if J[ctx.run_index]:
                    bw.write(rem, J[ctx.run_index])
                # -------- run interruption sample
                b = int(prev[x]) if prev is not None else 0
                ritype = 1 if abs(a - b) <= p.near else 0
                px = a if ritype else b
                sign = -1 if (ritype == 0 and a > b) else 1
                ix = int(src[y][x])
                errval = ix - px
                if sign < 0:
                    errval = -errval
                if p.near:
                    errval = ((errval + p.near) // (2 * p.near + 1)
                              if errval > 0 else
                              -((p.near - errval) // (2 * p.near + 1)))
                errval = _modrange(errval, p.range)
                q = 365 + ritype
                k = ctx.ri_k(ritype)
                s_flag = (k != 0) or (2 * ctx.Nn[ritype] >= ctx.N[q])
                if errval == 0:
                    map_ = 0
                elif errval > 0:
                    map_ = 0 if s_flag else 1
                else:
                    map_ = 1 if s_flag else 0
                emerr = 2 * abs(errval) - ritype - map_
                _golomb_encode(bw, emerr, k, p.limit - J[ctx.run_index] - 1,
                               p.qbpp)
                ctx.update_ri(ritype, errval, emerr)
                row[x] = reconstruct(px, sign, errval)
                if ctx.run_index > 0:
                    ctx.run_index -= 1
                x += 1
                continue

            # -------- regular mode
            q1 = _quantize_gradient(d1, p)
            q2 = _quantize_gradient(d2, p)
            q3 = _quantize_gradient(d3, p)
            sign = 1
            if q1 < 0 or (q1 == 0 and (q2 < 0 or (q2 == 0 and q3 < 0))):
                q1, q2, q3, sign = -q1, -q2, -q3, -1
            q = (q1 * 9 + q2) * 9 + q3
            px = _med(a, b, c) + sign * ctx.C[q]
            px = min(max(px, 0), p.maxval)
            ix = int(src[y][x])
            errval = ix - px
            if sign < 0:
                errval = -errval
            if p.near:
                errval = ((errval + p.near) // (2 * p.near + 1)
                          if errval > 0 else
                          -((p.near - errval) // (2 * p.near + 1)))
            errval = _modrange(errval, p.range)
            k = ctx.golomb_k(q)
            if ctx.special_regime(q, k):
                merr = 2 * errval + 1 if errval >= 0 else -2 * (errval + 1)
            else:
                merr = 2 * errval if errval >= 0 else -2 * errval - 1
            _golomb_encode(bw, merr, k, p.limit, p.qbpp)
            ctx.update_regular(q, errval)
            row[x] = reconstruct(px, sign, errval)
            x += 1
    return bw.finish()


# ------------------------------------------------------- full codestream

def decode(stream: bytes) -> Tuple[np.ndarray, int]:
    """Decode a complete JPEG-LS codestream → (image [H, W], precision).

    Raises ``ValueError`` naming the unsupported feature for
    multi-component scans, interleaved modes, or restart intervals.
    """
    if len(stream) < 4 or struct.unpack(">H", stream[:2])[0] != SOI:
        raise ValueError("JPEG-LS: missing SOI")
    pos = 2
    bits = rows = cols = ncomp = None
    maxval = t1 = t2 = t3 = reset = None
    while pos + 4 <= len(stream):
        marker, seglen = struct.unpack(">HH", stream[pos: pos + 4])
        if marker == DRI:
            raise ValueError("JPEG-LS: restart intervals (DRI) unsupported")
        body = stream[pos + 4: pos + 2 + seglen]
        pos += 2 + seglen
        if marker == SOF55:
            bits, rows, cols, ncomp = struct.unpack(">BHHB", body[:6])
            if ncomp != 1:
                raise ValueError(
                    f"JPEG-LS: {ncomp}-component scans unsupported "
                    "(DICOM grayscale only)")
        elif marker == LSE:
            if body[0] == 1:
                maxval, t1, t2, t3, reset = struct.unpack(">5H", body[1:11])
        elif marker == SOS:
            ns = body[0]
            if ns != 1:
                raise ValueError("JPEG-LS: interleaved scans unsupported")
            near = body[1 + 2 * ns]
            ilv = body[2 + 2 * ns]
            if ilv != 0:
                raise ValueError(f"JPEG-LS: ILV={ilv} unsupported")
            if bits is None:
                raise ValueError("JPEG-LS: SOS before SOF55")
            mv = maxval if maxval else (1 << bits) - 1
            dt1, dt2, dt3, drst = default_thresholds(mv, near)
            p = _Params(mv, near,
                        t1 or dt1, t2 or dt2, t3 or dt3, reset or drst)
            # entropy data: up to the next marker (FF followed by >=0x80)
            end = pos
            while end + 1 < len(stream):
                if stream[end] == 0xFF and stream[end + 1] >= 0x80:
                    break
                end += 1
            img = decode_scan(stream[pos:end], rows, cols, p)
            return img, bits
    raise ValueError("JPEG-LS: no SOS marker found")


def encode(img: np.ndarray, bits: Optional[int] = None, near: int = 0) -> bytes:
    """Encode [H, W] unsigned ints → complete JPEG-LS codestream."""
    img = np.asarray(img)
    assert img.ndim == 2
    if bits is None:
        bits = max(2, int(img.max()).bit_length())
    maxval = (1 << bits) - 1
    assert img.min() >= 0 and img.max() <= maxval
    t1, t2, t3, reset = default_thresholds(maxval, near)
    p = _Params(maxval, near, t1, t2, t3, reset)
    rows, cols = img.shape
    head = struct.pack(">H", SOI)
    head += struct.pack(">HHBHHB", SOF55, 11, bits, rows, cols, 1)
    head += bytes([1, 0x11, 0])              # component id / sampling / Tq
    head += struct.pack(">HHB", SOS, 8, 1) + bytes([1, 0, near, 0, 0])
    return head + encode_scan(img, p) + struct.pack(">H", EOI)
