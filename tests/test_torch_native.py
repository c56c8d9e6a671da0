"""PyTorch port: the native (C++) image codec against the pure-Python
writers and against the JAX package's native codec.

The codec is host code (the port's own copy of imagecodec.cpp), built with
g++ and zlib into the port's build/ directory; where no toolchain is found
these tests skip, as tests/test_native.py does. Tolerances: the PPM and
PNG bytes equal to the byte (the same bytes, the same zlib level and
filter); gamma/quantize within one 8-bit step of ``to_u8`` (``pow`` may
differ by an ulp before the quantization).
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from raytracinginoneweekend_tpu import native as jnative
from raytracinginoneweekend_tpu_torch import kernels, native
from raytracinginoneweekend_tpu_torch.io import image as io_image
from raytracinginoneweekend_tpu_torch.io.image import read_ppm
from raytracinginoneweekend_tpu_torch.ops.postprocess import to_u8


@pytest.fixture(scope="module")
def lib():
    built = native.lib()
    if built is None:
        pytest.skip(f"no C++ toolchain available: {native.build_error}")
    return built


def _img(h=23, w=31, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1.2, size=(h, w, 3)).astype(np.float32)


def _u8(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)


def _png_pixels(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            size = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = size
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()  # filter None on every scanline
    return raw[:, 1:].reshape(h, w, 3)


def test_native_gamma_quantize_matches_python(lib):
    img = _img()
    for clamp in (True, False):
        got = native.gamma_quantize(img, clamp=clamp)
        want = to_u8(torch.from_numpy(img), clamp=clamp).numpy()
        assert got.shape == want.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_native_ppm_roundtrip(lib, tmp_path):
    u8 = (np.arange(7 * 5 * 3, dtype=np.uint32) % 256).astype(
        np.uint8).reshape(5, 7, 3)
    path = str(tmp_path / "n.ppm")
    assert native.write_ppm(path, u8)
    np.testing.assert_array_equal(read_ppm(path), u8)


def test_native_png_decodes(lib, tmp_path):
    u8 = (np.arange(9 * 4 * 3, dtype=np.uint32) % 256).astype(
        np.uint8).reshape(4, 9, 3)
    path = str(tmp_path / "n.png")
    assert native.write_png(path, u8)
    np.testing.assert_array_equal(_png_pixels(path), u8)


@pytest.mark.parametrize("ext", ["ppm", "png"])
def test_io_image_writes_the_same_bytes_either_way(lib, tmp_path,
                                                  monkeypatch, ext):
    """io.image goes through the native writer when it is built, and the
    pure-Python fallback writes the same bytes."""
    u8 = _u8(8, 6)
    writer = getattr(io_image, f"write_{ext}")
    fast, slow = str(tmp_path / f"a.{ext}"), str(tmp_path / f"b.{ext}")
    calls = []
    native_writer = getattr(native, f"write_{ext}")
    monkeypatch.setattr(native, f"write_{ext}",
                        lambda p, a: calls.append(p) or native_writer(p, a))
    writer(fast, u8)
    assert calls == [fast]  # the native path wrote it
    monkeypatch.setattr(native, f"write_{ext}", lambda p, a: False)
    writer(slow, torch.from_numpy(u8))  # the fallback, from a tensor
    assert open(fast, "rb").read() == open(slow, "rb").read()


def test_native_bytes_equal_the_jax_packages(lib, tmp_path):
    """The port's copy of the codec writes what the JAX package's writes:
    the PPM to the byte, the PNG to the same pixels."""
    if jnative.lib() is None:
        pytest.skip("the JAX package's native codec did not build")
    u8 = _u8(17, 29, seed=3)
    for ext in ("ppm", "png"):
        ours, theirs = str(tmp_path / f"p.{ext}"), str(tmp_path / f"j.{ext}")
        assert getattr(native, f"write_{ext}")(ours, u8)
        assert getattr(jnative, f"write_{ext}")(theirs, u8)
        if ext == "ppm":
            assert open(ours, "rb").read() == open(theirs, "rb").read()
        else:
            np.testing.assert_array_equal(_png_pixels(ours),
                                          _png_pixels(theirs))
            np.testing.assert_array_equal(_png_pixels(ours), u8)


def test_library_lands_in_the_ports_build_directory(lib):
    so = native.so_path()
    assert os.path.dirname(so) == kernels.BUILD_DIR == native.BUILD_DIR
    assert os.path.exists(so)
    src_dir = os.path.dirname(native.SRC)
    assert not any(f.endswith(".so") for f in os.listdir(src_dir))
