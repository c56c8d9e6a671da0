"""Native (C++) image codec, loaded via ctypes.

Counterpart of ``raytracinginoneweekend_tpu/native``: gamma/quantize and the
PPM and PNG writers in C++ (``imagecodec.cpp``, the port's own copy), with
the pure-Python writers in io/image.py as the always-available fallback.
This is host code, not a device kernel.

``lib()`` returns the loaded ctypes library, building it with g++ on first
use into the package's ``build/`` directory (not under version control),
keyed by a hash of the source; it returns None when no toolchain or no
zlib is available, and callers fall back to Python. Nothing is built when
the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "imagecodec.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False
# Why the library is unavailable (the compiler's last words), or None.
build_error: str | None = None


def so_path() -> str:
    """Where the library for the current source and flags is built."""
    with open(SRC, "rb") as f:
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libimagecodec_{h.hexdigest()[:16]}.so")


def build(force: bool = False) -> str | None:
    """Compile the native library; returns the .so path or None."""
    global build_error
    so = so_path()
    if not force and os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Per-process tmp name: concurrent first-use builders (test workers, a
    # server beside a CLI) must not interleave g++ output into one shared
    # tmp file; each writes its own, and os.replace stays atomic.
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, SRC, "-o", tmp, "-lz", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, so)
        return so
    except subprocess.CalledProcessError as e:
        build_error = (e.stderr or "")[-2000:] or f"g++ exit {e.returncode}"
    except (OSError, subprocess.SubprocessError) as e:
        build_error = f"{type(e).__name__}: {e}"
    try:
        os.unlink(tmp)
    except OSError:
        pass
    return None


def lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = build()
        if so is None:
            return None
        try:
            l = ctypes.CDLL(so)
        except OSError as e:
            build_error = f"OSError: {e}"
            return None
        l.rtw_gamma_quantize.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        l.rtw_gamma_quantize.restype = None
        for name in ("rtw_write_ppm", "rtw_write_png"):
            fn = getattr(l, name)
            fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                           ctypes.c_int, ctypes.c_int]
            fn.restype = ctypes.c_int
        _lib = l
        return _lib


def gamma_quantize(rgb_f32, clamp: bool = True):
    """Gamma 1/2.2 + u8 quantize on the host via C++; None if no native lib.

    rgb_f32: float32 numpy array (any shape); returns uint8 of the same
    shape.
    """
    import numpy as np

    l = lib()
    if l is None:
        return None
    arr = np.ascontiguousarray(rgb_f32, np.float32)
    out = np.empty(arr.shape, np.uint8)
    l.rtw_gamma_quantize(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), arr.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        1 if clamp else 0)
    return out


def _write(name: str, path: str, u8) -> bool:
    import numpy as np

    l = lib()
    if l is None:
        return False
    arr = np.ascontiguousarray(u8, np.uint8)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3), got {arr.shape}")
    h, w, _ = arr.shape
    return getattr(l, name)(
        os.fsencode(path), arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w, h) == 0


def write_ppm(path: str, u8) -> bool:
    """Binary P6 PPM via C++; False if no native lib or the write failed."""
    return _write("rtw_write_ppm", path, u8)


def write_png(path: str, u8) -> bool:
    """RGB8 PNG via C++/zlib; False if no native lib or the write failed."""
    return _write("rtw_write_png", path, u8)
