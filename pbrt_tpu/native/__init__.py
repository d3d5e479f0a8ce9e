"""Native (C++) runtime components, loaded via ctypes.

The library is built from ``bvh_builder.cpp`` at first use, into the
package directory (listed in .gitignore), and rebuilt whenever the source
is newer than the library. Every consumer has a pure numpy fallback, so
the framework works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "bvh_builder.cpp")
_LIB_PATH = os.path.join(_HERE, "libpbrt_native.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _stale() -> bool:
    return (not os.path.exists(_LIB_PATH)
            or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC))


def _compile() -> bool:
    # build under a per-process name, then rename: concurrent test
    # workers never load a half-written library
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
             "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def load() -> "ctypes.CDLL | None":
    """Load (building it if missing or stale) the native library; None
    when it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if _stale() and not _compile():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            lib.bvh_build_sah.restype = ctypes.c_int
            if hasattr(lib, "bvh_build_sbvh"):
                lib.bvh_build_sbvh.restype = ctypes.c_int
            _lib = lib
        except OSError:
            _lib = None
        return _lib
