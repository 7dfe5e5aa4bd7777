"""KITTI odometry dataset I/O (SURVEY.md C1, C16).

Host-side analogs of the reference's ``loadCalib`` (src/kitti.cpp:23-46),
``savePoses`` (src/kitti.cpp:49-64) and the lazy ``StereoImageGenerator``
(src/viso.h:81-101).  PNG decode runs through the native C++ runtime
(native/viso_native.cpp: libpng, or its own zlib-only decoder where
libpng is missing, + a threaded in-order prefetch executor) so decode
overlaps device compute; when the native library can't build, the
numpy PNG decoder (io/png.py) on a Python thread provides identical
semantics for PNG input.
"""

from __future__ import annotations

import os
import threading
import queue
from typing import Iterator, Optional, Tuple

import numpy as np


def load_calib(path: str):
    """Parse a KITTI ``calib.txt`` into (P1, P2) float64 3x4 matrices.

    The reference reads the first two ``P<n>:`` rows (src/kitti.cpp:30-43);
    for KITTI those are P0 (left gray) and P1 (right gray).
    """
    mats = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or not parts[0].startswith("P"):
                continue
            vals = [float(v) for v in parts[1:13]]
            mats.append(np.array(vals, dtype=np.float64).reshape(3, 4))
            if len(mats) == 2:
                break
    if len(mats) < 2:
        raise ValueError(f"calib file {path!r} has fewer than two P rows")
    return mats[0], mats[1]


def save_poses_kitti(path: str, poses):
    """Write poses in KITTI devkit format: 12 row-major values of the top
    3x4 block per line (src/kitti.cpp:49-64)."""
    poses = np.asarray(poses)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.6e}" for v in T[:3, :4].reshape(-1)))
            f.write("\n")


def load_poses_kitti(path: str) -> np.ndarray:
    """Read a KITTI-format pose file into (T, 4, 4)."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    T = np.tile(np.eye(4), (len(rows), 1, 1))
    T[:, :3, :4] = rows
    return T


def _native():
    """The native C++ decode runtime, or None if it can't build here."""
    try:
        from libviso_tpu import native

        return native if native.available() else None
    except Exception:
        return None


_NATIVE_EXTS = (".png", ".jpg", ".jpeg")


def _read_gray(path: str) -> np.ndarray:
    """(H, W) uint8 — uint8 end-to-end: the device casts; f32 would
    quadruple the transfer."""
    nat = _native()
    if nat is not None and path.lower().endswith(_NATIVE_EXTS):
        return nat.decode_image_gray(path)
    if not path.lower().endswith(".png"):
        raise ValueError(
            f"{path}: without the native runtime (g++ and zlib, plus "
            "libjpeg for JPEG input) only PNG input can be decoded")
    from libviso_tpu.io.png import read_png_gray

    return read_png_gray(path)


def kitti_sequence_paths(kitti_home: str, seq: str):
    """Directory layout of the reference driver (src/kitti.cpp:98-110)."""
    base = os.path.join(kitti_home, "sequences", seq)
    return {
        "calib": os.path.join(base, "calib.txt"),
        "image_0": os.path.join(base, "image_0"),
        "image_1": os.path.join(base, "image_1"),
    }


class StereoImageStream:
    """Lazy stereo pair stream with background read-ahead.

    Mirrors StereoImageGenerator (src/viso.h:81-101): two printf-style
    masks formatted with a frame index, iteration ends at ``end`` or the
    first missing file.  ``prefetch`` decodes ahead on a worker thread so
    host I/O overlaps device compute (the reference is fully synchronous).
    """

    def __init__(self, mask_left: str, mask_right: str, begin: int = 0,
                 end: Optional[int] = None, prefetch: int = 4):
        self.mask_left = mask_left
        self.mask_right = mask_right
        self.begin = begin
        self.end = end
        self.prefetch = prefetch

    def skipped(self, n: int) -> "StereoImageStream":
        """A copy whose iteration starts ``n`` frames later (no decode of
        the skipped frames — used by checkpoint resume)."""
        return StereoImageStream(self.mask_left, self.mask_right,
                                 begin=self.begin + n, end=self.end,
                                 prefetch=self.prefetch)

    def _paths(self):
        """Enumerate existing (left, right) path pairs, reference-style:
        stop at ``end`` or the first missing file (src/viso.h:91-96)."""
        i = self.begin
        while self.end is None or i <= self.end:
            left, right = self.mask_left % i, self.mask_right % i
            if not (os.path.exists(left) and os.path.exists(right)):
                return
            yield left, right
            i += 1

    def _frames(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for left, right in self._paths():
            yield _read_gray(left), _read_gray(right)

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._frames()
            return
        nat = _native()
        if nat is not None:
            pairs = list(self._paths())
            if all(p.lower().endswith(_NATIVE_EXTS)
                   for lr in pairs for p in lr):
                # Native path: one C++ prefetch stream over the interleaved
                # left/right list; workers decode `prefetch` frames ahead.
                flat = [p for lr in pairs for p in lr]
                threads = min(4, os.cpu_count() or 1)
                with nat.NativeImageStream(
                        flat, threads=threads,
                        depth=2 * self.prefetch) as s:
                    for _ in range(len(pairs)):
                        left = s.next()
                        right = s.next()
                        yield left, right
                return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = object()
        failure = []

        def worker():
            # decode errors must reach the consumer: swallowing them here
            # would silently truncate the sequence and the run would
            # report success over a partial trajectory (the native path
            # raises for the same corrupt frame)
            try:
                for item in self._frames():
                    q.put(item)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                failure.append(e)
            finally:
                q.put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is done:
                if failure:
                    raise failure[0]
                return
            yield item


class MonoImageStream:
    """Single-camera analog of StereoImageStream (the reference's
    MonoImageGenerator contract: printf mask, frames from ``begin`` until
    ``end`` or the first missing file, src/calib_sfm.cpp:56-64).  Uses
    the native C++ prefetch decoder (PNG/JPEG) when available, the
    threaded numpy PNG fallback otherwise."""

    def __init__(self, mask: str, begin: int = 0,
                 end: Optional[int] = None, prefetch: int = 4):
        self.mask = mask
        self.begin = begin
        self.end = end
        self.prefetch = prefetch

    def skipped(self, n: int) -> "MonoImageStream":
        return MonoImageStream(self.mask, begin=self.begin + n,
                               end=self.end, prefetch=self.prefetch)

    def _paths(self):
        i = self.begin
        while self.end is None or i <= self.end:
            p = self.mask % i
            if not os.path.exists(p):
                return
            yield p
            i += 1

    def __iter__(self) -> Iterator[np.ndarray]:
        paths = list(self._paths())
        nat = _native()
        if (self.prefetch > 0 and nat is not None
                and all(p.lower().endswith(_NATIVE_EXTS) for p in paths)):
            threads = min(4, os.cpu_count() or 1)
            with nat.NativeImageStream(paths, threads=threads,
                                       depth=self.prefetch) as s:
                for _ in range(len(paths)):
                    yield s.next()
            return
        if self.prefetch <= 0:
            for p in paths:
                yield _read_gray(p)
            return
        # threaded fallback decode — overlaps the consumer exactly as
        # in StereoImageStream; errors reach the consumer, not the log
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = object()
        failure = []

        def worker():
            try:
                for p in paths:
                    q.put(_read_gray(p))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                failure.append(e)
            finally:
                q.put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is done:
                if failure:
                    raise failure[0]
                return
            yield item
