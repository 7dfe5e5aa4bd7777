"""The native runtime's zlib-only PNG decoder (native/viso_native.cpp
built with -DVN_NO_LIBPNG, what native/build.py falls back to on a host
without libpng).  Oracle: the numpy codec (io/png.py) and PIL."""

import ctypes
import subprocess

import numpy as np
import pytest

from libviso_tpu.io.png import encode_png, read_png_gray
from libviso_tpu.native import build as nbuild


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("nolibpng") / "nolibpng.so")
    proc = subprocess.run(
        ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
         "-DVN_NO_LIBPNG", "-DVN_NO_JPEG", nbuild._SRC, "-lz", "-o", so],
        capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        pytest.skip(f"no g++/zlib toolchain here: {proc.stderr[:200]}")
    lib = ctypes.CDLL(so)
    lib.vn_decode_image_gray.restype = ctypes.c_int
    lib.vn_decode_image_gray.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    return lib


def _decode(lib, path, cap=64 * 64):
    buf = np.zeros(cap, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.vn_decode_image_gray(
        str(path).encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap, ctypes.byref(h), ctypes.byref(w))
    return rc, buf[:h.value * w.value].reshape(h.value, w.value)


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("kind", ["gray", "rgb"])
def test_decodes_every_filter_like_numpy(lib, tmp_path, rng, kind,
                                         filter_type):
    shape = (37, 53) if kind == "gray" else (37, 53, 3)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    if filter_type == "mixed":
        filter_type = np.arange(shape[0]) % 5
    p = tmp_path / "a.png"
    p.write_bytes(encode_png(img, filter_type=filter_type))
    rc, got = _decode(lib, p)
    assert rc == 0
    np.testing.assert_array_equal(got, read_png_gray(str(p)))
    if kind == "gray":
        np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("mode", ["LA", "RGBA", "I;16"])
def test_alpha_and_16bit_match_pil(lib, tmp_path, rng, mode):
    Image = pytest.importorskip("PIL.Image")
    if mode == "I;16":
        arr = rng.integers(0, 65536, (20, 30), dtype=np.uint16)
        im = Image.fromarray(arr)
        want = (arr >> 8).astype(np.uint8)  # libpng's strip_16 keeps it
    else:
        arr = rng.integers(0, 256, (20, 30, len(mode)), dtype=np.uint8)
        im = Image.fromarray(arr, mode)
        want = np.asarray(im.convert("L"))
    p = tmp_path / "a.png"
    im.save(p)
    rc, got = _decode(lib, p)
    assert rc == 0
    np.testing.assert_array_equal(got, want)


def test_rejects_palette_and_corrupt_files(lib, tmp_path, rng):
    Image = pytest.importorskip("PIL.Image")
    pal = tmp_path / "p.png"
    Image.fromarray(rng.integers(0, 256, (8, 8), dtype=np.uint8)).convert(
        "P").save(pal)
    assert _decode(lib, pal)[0] == -2  # unsupported format
    bad = bytearray(encode_png(np.zeros((8, 8), np.uint8)))
    bad[45] ^= 0xFF  # inside IDAT: the chunk's CRC no longer holds
    corrupt = tmp_path / "c.png"
    corrupt.write_bytes(bytes(bad))
    assert _decode(lib, corrupt)[0] == -3  # decode error
    assert _decode(lib, tmp_path / "missing.png")[0] == -1
