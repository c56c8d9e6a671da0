"""Plain image arithmetic: 8-bit quantisation and a PNG reader.

``to_u8`` is the upstream project's output step (``main.cxx:39-45``,
``cuda_impl.cu:85-99``): gamma 1/2.2, times 255, clamped to [0, 255] and
truncated. ``read_png`` decodes an 8-bit RGB PNG (colour type 2, no
interlace) with ``zlib`` and undoes the five scanline filters of the PNG
specification (ISO/IEC 15948, section 9).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_u8(linear) -> np.ndarray:
    x = np.clip(np.asarray(linear, np.float32), 0.0, None)
    return np.clip(np.power(x, np.float32(1.0 / 2.2)) * np.float32(255.0),
                   0.0, 255.0).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(kind: int, row: np.ndarray, prev: np.ndarray, bpp: int):
    if kind == 0:
        return row
    if kind == 2:
        return (row.astype(np.int64) + prev) & 0xFF
    out = row.astype(np.int64)
    if kind == 1:
        for i in range(bpp, len(out)):
            out[i] = (out[i] + out[i - bpp]) & 0xFF
        return out
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        up = int(prev[i])
        if kind == 3:
            out[i] = (out[i] + (left + up) // 2) & 0xFF
        elif kind == 4:
            ul = int(prev[i - bpp]) if i >= bpp else 0
            out[i] = (out[i] + _paeth(left, up, ul)) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter {kind}")
    return out


def read_png(data: bytes) -> np.ndarray:
    """An 8-bit RGB PNG's bytes -> (H, W, 3) uint8."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, head = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if head is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = head
    if (depth, color, interlace) != (8, 2, 0):
        raise ValueError(f"PNG depth {depth} colour {color} interlace "
                         f"{interlace}; expected 8-bit RGB")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = 3 * w
    if raw.size != h * (stride + 1):
        raise ValueError("PNG data of the wrong length")
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        prev = _unfilter(int(rows[y, 0]), rows[y, 1:], prev, 3)
        out[y] = prev
        prev = np.asarray(prev, np.int64)
    return out.reshape(h, w, 3)
