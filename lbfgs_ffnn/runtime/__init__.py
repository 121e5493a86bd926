"""Native C++ runtime bindings (ctypes).

Builds/loads ``liblbfgs_runtime.so`` providing IDX dataset parsing, one-hot
encoding and CSV history writing — the framework's counterpart of the
reference's native data loader (reference: tests/mnist/mnist_loader.hpp) and
CSV writers (reference: src/unified_optimization.hpp:66-85). Every entry
point has a pure-Python fallback in the callers, so the framework degrades
gracefully when no C++ toolchain is available.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "runtime.cpp"
_SO = _HERE / "liblbfgs_runtime.so"
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    cmd = [
        "g++", "-std=c++20", "-O3", "-fPIC", "-shared", "-pthread",
        str(_SRC), "-o", str(_SO),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib():
    """Load (building on demand) the native runtime; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError:
            return None

        i64 = ctypes.c_int64
        p_i64 = ctypes.POINTER(i64)
        p_f32 = ctypes.POINTER(ctypes.c_float)
        p_f64 = ctypes.POINTER(ctypes.c_double)
        p_u8 = ctypes.POINTER(ctypes.c_uint8)

        lib.idx_query.argtypes = [ctypes.c_char_p, p_i64, p_i64]
        lib.idx_query.restype = ctypes.c_int
        lib.idx_load_images_f32.argtypes = [ctypes.c_char_p, i64, p_f32, p_i64]
        lib.idx_load_images_f32.restype = ctypes.c_int
        lib.idx_load_labels_onehot_f32.argtypes = [
            ctypes.c_char_p, i64, ctypes.c_int, p_f32, p_i64,
        ]
        lib.idx_load_labels_onehot_f32.restype = ctypes.c_int
        lib.idx_load_labels_u8.argtypes = [ctypes.c_char_p, i64, p_u8, p_i64]
        lib.idx_load_labels_u8.restype = ctypes.c_int
        lib.idx_write_u8.argtypes = [ctypes.c_char_p, p_u8, p_i64, ctypes.c_int]
        lib.idx_write_u8.restype = ctypes.c_int
        lib.csv_write_history.argtypes = [
            ctypes.c_char_p, p_f64, p_f64, p_f64, i64, ctypes.c_int,
        ]
        lib.csv_write_history.restype = ctypes.c_int
        lib.streamer_create.argtypes = [
            p_f32, p_f32, i64, i64, i64, i64, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.streamer_create.restype = i64
        lib.streamer_next.argtypes = [i64, p_f32, p_f32, p_i64, p_i64]
        lib.streamer_next.restype = ctypes.c_int
        lib.streamer_destroy.argtypes = [i64]
        lib.streamer_destroy.restype = ctypes.c_int
        _lib = lib
        return _lib
