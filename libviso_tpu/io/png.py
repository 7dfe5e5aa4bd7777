"""Dependency-free 8-bit PNG reader and writer (numpy + zlib).

The fallback decoder when the native runtime (native/viso_native.cpp)
cannot build, and the writer the tools use to lay out
KITTI-format sequences.  Scope: bit depth 8, grayscale (color type 0) or
RGB (color type 2), non-interlaced, all five scanline filters.  Anything
else raises ``ValueError`` naming what it found.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}  # color type -> samples per pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def _filter_rows(raw: np.ndarray, bpp: int, ftypes: np.ndarray) -> np.ndarray:
    """Filter (H, stride) uint8 scanlines, row y with filter ftypes[y];
    every predictor reads RAW bytes, so encoding is vectorized."""
    x = raw.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    preds = np.stack([np.zeros_like(x), left, up, (left + up) // 2,
                      _paeth(left, up, upleft)])
    pred = preds[ftypes, np.arange(x.shape[0])]
    return ((x - pred) % 256).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(img: np.ndarray, filter_type=2, level: int = 6) -> bytes:
    """(H, W) or (H, W, 3) uint8 -> PNG bytes.  ``filter_type`` is one
    scanline filter for every row (default Up, which the reader undoes
    vectorized) or a length-H sequence of them, as adaptive encoders such
    as libpng's write files that mix all five."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        color, bpp = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        color, bpp = 2, 3
    else:
        raise ValueError(f"PNG writer takes (H, W) or (H, W, 3), "
                         f"got {img.shape}")
    h, w = img.shape[:2]
    ftypes = np.broadcast_to(np.asarray(filter_type, np.int64), (h,))
    if ftypes.min() < 0 or ftypes.max() > 4:
        raise ValueError(f"PNG filter types must be 0-4, got {filter_type}")
    rows = _filter_rows(img.reshape(h, w * bpp), bpp, ftypes)
    scan = np.concatenate([ftypes[:, None].astype(np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(scan.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, filter_type=2) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img, filter_type=filter_type))


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters.  None/Sub/Up are vectorized; Average and
    Paeth depend on the reconstructed left neighbour and run per byte."""
    rows = data.reshape(h, stride + 1)
    ftypes = rows[:, 0]
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f, line = int(ftypes[y]), rows[y, 1:]
        if f == 0:
            cur = line.copy()
        elif f == 1:
            lanes = np.zeros((-(-stride // bpp)) * bpp, np.int64)
            lanes[:stride] = line
            cur = (np.cumsum(lanes.reshape(-1, bpp), axis=0)
                   .reshape(-1)[:stride] % 256).astype(np.uint8)
        elif f == 2:
            cur = line + prev  # uint8 wraps mod 256
        elif f in (3, 4):
            cur = _unfilter_sequential(line, prev, bpp, f)
        else:
            raise ValueError(f"bad PNG filter type {f} in row {y}")
        out[y] = cur
        prev = cur
    return out


def _unfilter_sequential(line, prev, bpp, f):
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if f == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def decode_png(buf: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, 3) uint8."""
    if buf[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        kind = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", buf[pos + 8 + n:pos + 12 + n])
        if len(data) != n or zlib.crc32(kind + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"corrupt PNG chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None or not idat:
        raise ValueError("PNG has no IHDR or no IDAT")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, color type {color}, "
            f"interlace {interlace}); only 8-bit non-interlaced gray or "
            "RGB is read")
    bpp = _CHANNELS[color]
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if data.size != h * (w * bpp + 1):
        raise ValueError("PNG image data has the wrong length")
    img = _unfilter(data, h, w * bpp, bpp)
    return img.reshape(h, w) if bpp == 1 else img.reshape(h, w, 3)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def read_png_gray(path: str) -> np.ndarray:
    """(H, W) uint8 luma; RGB converts with ITU-R 601 weights in the same
    fixed point as PIL's ``convert("L")``."""
    img = read_png(path)
    if img.ndim == 2:
        return img
    r, g, b = (img[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)
