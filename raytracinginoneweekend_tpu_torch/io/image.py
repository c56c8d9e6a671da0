"""Host-side image writers.

Equivalent of app::save_to_file's binary P6 PPM writer (main.cxx:87-101),
plus a dependency-free PNG writer (stdlib zlib). A native (C++) encoder
(native/, the port's copy of the JAX package's) writes the same bytes and
is used when it builds; these pure-Python writers are the always-available
fallback.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _as_u8(image) -> np.ndarray:
    if hasattr(image, "detach"):  # a torch tensor, on any device
        image = image.detach().cpu().numpy()
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        raise TypeError(f"expected uint8 image, got {arr.dtype}")
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3), got {arr.shape}")
    return arr


def write_ppm(path, image) -> None:
    """Binary P6 PPM, byte-identical header format to main.cxx:96-100."""
    arr = _as_u8(image)
    from .. import native

    if native.write_ppm(path, arr):
        return
    h, w, _ = arr.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode("ascii"))
        f.write(arr.tobytes())


def read_ppm(path) -> np.ndarray:
    """Read a binary P6 PPM back -> (H, W, 3) uint8 (for tests)."""
    with open(path, "rb") as f:
        data = f.read()
    # Header: magic, whitespace-separated width/height/maxval.
    parts = data.split(b"\n", 3)
    if len(parts) != 4 or parts[0] != b"P6" or int(parts[2]) != 255:
        raise ValueError(f"{path}: not a binary P6 PPM with maxval 255")
    w, h = (int(x) for x in parts[1].split())
    pixels = parts[3][: w * h * 3]
    return np.frombuffer(pixels, np.uint8).reshape(h, w, 3)


def write_png(path, image) -> None:
    """RGB8 PNG writer: native (C++/zlib) when built, stdlib zlib fallback."""
    arr = _as_u8(image)
    from .. import native

    if native.write_png(path, arr):
        return
    h, w, _ = arr.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload +
                struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    # Filter byte 0 (None) per scanline.
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
