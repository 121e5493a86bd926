"""IDX (MNIST-family) file IO.

Fast path: the native C++ runtime (lbfgs_ffnn/runtime/runtime.cpp),
which parses, normalizes (/255) and one-hot encodes in one pass — the
counterpart of the reference's C++ loader (reference:
tests/mnist/mnist_loader.hpp:10-99). Fallback: pure numpy big-endian parse.

Images come back batch-major ``(n, rows*cols)`` float32 scaled to [0, 1];
labels one-hot ``(n, num_classes)`` float32.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from lbfgs_ffnn.runtime import get_lib


def _query_numpy(path: str) -> tuple[int, int]:
    with open(path, "rb") as f:
        hdr = f.read(4)
        if hdr[2] != 0x08:
            raise ValueError(f"{path}: unsupported IDX dtype {hdr[2]:#x}")
        ndim = hdr[3]
        dims = np.frombuffer(f.read(4 * ndim), dtype=">u4")
    return int(dims[0]), int(np.prod(dims[1:])) if ndim > 1 else 1


def read_idx_images(path: str | Path, max_items: int = 0) -> np.ndarray:
    """Load images as (n, elems) float32 in [0, 1]."""
    path = str(path)
    lib = get_lib()
    if lib is not None:
        n_items = ctypes.c_int64()
        elems = ctypes.c_int64()
        rc = lib.idx_query(path.encode(), ctypes.byref(n_items), ctypes.byref(elems))
        if rc != 0:
            raise IOError(f"idx_query({path}) failed: {rc}")
        n = min(max_items, n_items.value) if max_items > 0 else n_items.value
        out = np.empty((n, elems.value), dtype=np.float32)
        n_loaded = ctypes.c_int64()
        rc = lib.idx_load_images_f32(
            path.encode(), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(n_loaded),
        )
        if rc != 0:
            raise IOError(f"idx_load_images_f32({path}) failed: {rc}")
        return out[: n_loaded.value]

    # numpy fallback
    with open(path, "rb") as f:
        hdr = f.read(4)
        ndim = hdr[3]
        dims = np.frombuffer(f.read(4 * ndim), dtype=">u4").astype(np.int64)
        n = min(max_items, dims[0]) if max_items > 0 else dims[0]
        elems = int(np.prod(dims[1:])) if ndim > 1 else 1
        raw = np.frombuffer(f.read(int(n) * elems), dtype=np.uint8)
    return (raw.reshape(int(n), elems).astype(np.float32)) / 255.0


def read_idx_labels_onehot(
    path: str | Path, max_items: int = 0, num_classes: int = 10
) -> np.ndarray:
    """Load labels one-hot encoded as (n, num_classes) float32."""
    path = str(path)
    lib = get_lib()
    if lib is not None:
        n_items = ctypes.c_int64()
        elems = ctypes.c_int64()
        rc = lib.idx_query(path.encode(), ctypes.byref(n_items), ctypes.byref(elems))
        if rc != 0:
            raise IOError(f"idx_query({path}) failed: {rc}")
        n = min(max_items, n_items.value) if max_items > 0 else n_items.value
        out = np.empty((n, num_classes), dtype=np.float32)
        n_loaded = ctypes.c_int64()
        rc = lib.idx_load_labels_onehot_f32(
            path.encode(), n, num_classes,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(n_loaded),
        )
        if rc != 0:
            raise IOError(f"idx_load_labels_onehot_f32({path}) failed: {rc}")
        return out[: n_loaded.value]

    labels = read_idx_labels_u8(path, max_items)
    out = np.zeros((labels.shape[0], num_classes), dtype=np.float32)
    out[np.arange(labels.shape[0]), labels] = 1.0
    return out


def read_idx_labels_u8(path: str | Path, max_items: int = 0) -> np.ndarray:
    path = str(path)
    with open(path, "rb") as f:
        hdr = f.read(4)
        ndim = hdr[3]
        dims = np.frombuffer(f.read(4 * ndim), dtype=">u4").astype(np.int64)
        n = min(max_items, dims[0]) if max_items > 0 else dims[0]
        return np.frombuffer(f.read(int(n)), dtype=np.uint8).copy()


def write_idx_u8(path: str | Path, data: np.ndarray) -> None:
    """Write a uint8 array as an IDX file (for synthetic fixtures)."""
    path = str(path)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    lib = get_lib()
    if lib is not None:
        dims = (ctypes.c_int64 * data.ndim)(*data.shape)
        rc = lib.idx_write_u8(
            path.encode(),
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            dims, data.ndim,
        )
        if rc != 0:
            raise IOError(f"idx_write_u8({path}) failed: {rc}")
        return
    with open(path, "wb") as f:
        f.write(bytes([0, 0, 0x08, data.ndim]))
        f.write(np.asarray(data.shape, dtype=">u4").tobytes())
        f.write(data.tobytes())
