"""ctypes binding to the native C++ runtime (native/viso_native.cpp).

The reference's runtime layer is C++ (OpenCV imread in the frame loop,
src/viso.h:81-101); ours is too: a PNG decoder (libpng, or the source's
zlib-only decoder where libpng is missing) plus a threaded in-order
prefetch executor.  This module compiles the library on first use (cached)
and exposes a typed API.  Everything degrades gracefully to the pure-Python
path when g++ or zlib are missing — call ``available()`` to check.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

import numpy as np

from . import build as _build

VN_OK = 0
VN_EOS = 1

_ERRORS = {
    -1: "cannot open file",
    -2: "unsupported image format (not PNG/JPEG)",
    -3: "image decode error",
    -4: "output buffer too small",
    -5: "bad stream handle",
}

_lib = None
_lib_lock = threading.Lock()
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lib_lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _build.build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None  # corrupt/foreign .so: fall back to io/png.py
        try:
            lib.vn_version.restype = ctypes.c_int
            # version gate FIRST: a stale older-ABI .so (e.g. mtimes
            # preserved by rsync -a on a shared FS) must be rejected
            # before touching symbols it may not export — an
            # AttributeError here would otherwise escape available()
            if lib.vn_version() != 2:
                return None
        except AttributeError:
            return None  # pre-versioning .so
        lib.vn_decode_png_gray.restype = ctypes.c_int
        lib.vn_decode_png_gray.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.vn_decode_image_gray.restype = ctypes.c_int
        lib.vn_decode_image_gray.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.vn_png_dims.restype = ctypes.c_int
        lib.vn_png_dims.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.vn_stream_open.restype = ctypes.c_void_p
        lib.vn_stream_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.vn_stream_next.restype = ctypes.c_int
        lib.vn_stream_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.vn_stream_close.restype = None
        lib.vn_stream_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """True if the native library built/loaded on this machine."""
    return _load() is not None


def png_dims(path: str) -> Tuple[int, int]:
    """(height, width) from the PNG header, no pixel decode."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.vn_png_dims(path.encode(), ctypes.byref(h), ctypes.byref(w))
    if rc != VN_OK:
        raise IOError(f"{path}: {_ERRORS.get(rc, rc)}")
    return h.value, w.value


def decode_png_gray(path: str) -> np.ndarray:
    """Decode a PNG to a (H, W) uint8 grayscale array via the C++ decoder."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    hh, ww = png_dims(path)
    out = np.empty((hh, ww), dtype=np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.vn_decode_png_gray(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.size, ctypes.byref(h), ctypes.byref(w))
    if rc != VN_OK:
        raise IOError(f"{path}: {_ERRORS.get(rc, rc)}")
    return out


def decode_image_gray(path: str,
                      max_hw: Tuple[int, int] = (4096, 8192)) -> np.ndarray:
    """Decode a PNG or JPEG (magic-sniffed) to (H, W) uint8 grayscale.

    PNGs take the exact-size path (dims peeked from the header, one
    H*W allocation, no size cap); JPEGs decode into a ``max_hw``-capped
    staging buffer (libjpeg exposes dims only mid-decode)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    try:
        with open(path, "rb") as f:
            magic = f.read(2)
    except OSError:
        raise IOError(f"{path}: {_ERRORS[-1]}")
    if magic[:2] == b"\x89P":
        return decode_png_gray(path)
    cap = max_hw[0] * max_hw[1]
    buf = np.empty(cap, dtype=np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.vn_decode_image_gray(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap, ctypes.byref(h), ctypes.byref(w))
    if rc != VN_OK:
        raise IOError(f"{path}: {_ERRORS.get(rc, rc)}")
    return buf[: h.value * w.value].reshape(h.value, w.value).copy()


class NativeImageStream:
    """In-order prefetching frame stream backed by the C++ thread pool.

    Decode of frame k+1..k+depth overlaps the consumer's work on frame k.
    Iterating yields (H, W) uint8 arrays in exactly path-list order.
    """

    def __init__(self, paths: List[str], threads: int = 4, depth: int = 8,
                 max_hw: Tuple[int, int] = (4096, 8192)):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._n = len(paths)
        arr = (ctypes.c_char_p * self._n)(*[p.encode() for p in paths])
        self._handle = lib.vn_stream_open(arr, self._n, threads, depth)
        if self._n and not self._handle:
            raise RuntimeError("vn_stream_open failed")
        self._cap = max_hw[0] * max_hw[1]
        self._buf = np.empty(self._cap, dtype=np.uint8)

    def next(self) -> Optional[np.ndarray]:
        """Next frame, or None at end of stream.  Raises on decode error."""
        if not self._handle:
            return None
        h, w = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.vn_stream_next(
            self._handle,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._cap, ctypes.byref(h), ctypes.byref(w))
        if rc == VN_EOS:
            return None
        if rc != VN_OK:
            raise IOError(f"stream decode: {_ERRORS.get(rc, rc)}")
        return self._buf[: h.value * w.value].reshape(
            h.value, w.value).copy()

    def __iter__(self):
        while True:
            frame = self.next()
            if frame is None:
                return
            yield frame

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.vn_stream_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
