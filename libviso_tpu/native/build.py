"""Build the native runtime shared library on demand.

One g++ invocation, cached by source mtime; no cmake/bazel ceremony for a
single translation unit.  The .so lands next to this file so the package is
self-contained.  A host without libpng gets the source's zlib-only PNG
decoder; failure to build at all is non-fatal — io/kitti.py falls back to
the numpy PNG decoder (io/png.py), which is slower and reads PNG only.
"""

from __future__ import annotations

import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_HERE))
_SRC = os.path.join(_REPO, "native", "viso_native.cpp")
_SO = os.path.join(_HERE, "_viso_native.so")


def so_path() -> str:
    return _SO


def needs_build() -> bool:
    if not os.path.exists(_SRC):
        return False
    if not os.path.exists(_SO):
        return True
    return os.path.getmtime(_SRC) > os.path.getmtime(_SO)


def build(verbose: bool = False) -> str | None:
    """Compile native/viso_native.cpp -> _viso_native.so; None on failure."""
    if not os.path.exists(_SRC):
        return None
    if not needs_build():
        return _SO
    tmp = f"{_SO}.tmp.{os.getpid()}"  # unique per process: concurrent
    # first-use builds (pytest-xdist, multi-host on a shared FS) must not
    # interleave g++ output into one file
    base = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
            _SRC]
    # A host without libjpeg or libpng must not lose the whole native
    # runtime (PNG decode + prefetch) to a library it lacks: retry with
    # the JPEG decoder compiled out (VN_NO_JPEG -> those files report
    # 'unsupported image format'), then with libpng replaced by the
    # source's zlib-only PNG decoder (VN_NO_LIBPNG).
    attempts = [
        base + ["-lpng", "-ljpeg", "-lz", "-o", tmp],
        base + ["-DVN_NO_JPEG", "-lpng", "-lz", "-o", tmp],
        base + ["-DVN_NO_LIBPNG", "-DVN_NO_JPEG", "-lz", "-o", tmp],
    ]
    for cmd in attempts:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:  # no g++ / hang
            if verbose:
                print(f"native build unavailable: {e}", file=sys.stderr)
            return None
        if proc.returncode == 0:
            os.replace(tmp, _SO)
            return _SO
        if verbose:
            print(f"native build failed ({' '.join(cmd[len(base):-2])}):"
                  f"\n{proc.stderr}", file=sys.stderr)
    return None


if __name__ == "__main__":
    out = build(verbose=True)
    print(out or "BUILD FAILED")
    sys.exit(0 if out else 1)
