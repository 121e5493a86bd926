"""Prefetching minibatch streamer over the native C++ runtime.

A producer thread in ``runtime.cpp`` shuffles (seeded per-epoch
Fisher-Yates — the reference SGD's sampling primitive,
reference: src/minimizer/s_gd.hpp:146-170, lifted to epoch granularity),
gathers batches into a bounded ring of host staging buffers, and overlaps
that host work with the consumer's device steps. Use it to feed a
host-driven training loop when the dataset should not live in HBM whole;
the in-jit samplers in ``solvers/sgd.py``/``slbfgs.py`` remain the
reference-parity path for device-resident data.

Falls back to a pure-Python generator (numpy RNG, no prefetch thread) when
the native library is unavailable — same interface, same properties
(each epoch a full permutation; deterministic under a fixed seed), but a
different permutation stream since the RNGs differ.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Optional

import numpy as np

from lbfgs_ffnn.runtime import get_lib


class BatchStreamer:
    """Endless stream of shuffled (x_batch, y_batch, count, epoch) tuples.

    ``x``/``y`` are row-major float32 arrays of shape (n, xdim)/(n, ydim);
    they must stay alive for the streamer's lifetime (the native side reads
    them in place — no copy of the dataset is made). A trailing batch has
    ``count < batch_size`` unless ``drop_last``; its rows past ``count``
    are stale and must be masked by the consumer.
    """

    def __init__(
        self,
        x: np.ndarray,
        y: np.ndarray,
        batch_size: int,
        seed: int = 123,
        depth: int = 4,
        drop_last: bool = False,
        force_fallback: bool = False,
    ):
        self._x = np.ascontiguousarray(x, dtype=np.float32)
        self._y = np.ascontiguousarray(y, dtype=np.float32)
        if self._x.ndim != 2 or self._y.ndim != 2 or len(self._x) != len(self._y):
            raise ValueError("x, y must be 2-D with matching leading dim")
        self.n = self._x.shape[0]
        self.batch_size = min(batch_size, self.n)
        self.seed = seed
        self.drop_last = drop_last
        self._handle: Optional[int] = None
        self._lib = None if force_fallback else get_lib()
        if self._lib is not None:
            h = self._lib.streamer_create(
                self._x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self._y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.n, self._x.shape[1], self._y.shape[1],
                self.batch_size, seed, depth, int(drop_last),
            )
            if h > 0:
                self._handle = h
            else:
                self._lib = None
        if self._handle is None:
            self._fallback = self._python_stream()
        self.native = self._handle is not None

    def _python_stream(self) -> Iterator[tuple[np.ndarray, np.ndarray, int, int]]:
        rng_seed = self.seed
        epoch = 0
        while True:
            rng = np.random.default_rng((rng_seed, epoch))
            perm = rng.permutation(self.n)
            for off in range(0, self.n, self.batch_size):
                idx = perm[off:off + self.batch_size]
                if len(idx) < self.batch_size and self.drop_last:
                    break
                xb = np.zeros((self.batch_size, self._x.shape[1]), np.float32)
                yb = np.zeros((self.batch_size, self._y.shape[1]), np.float32)
                xb[: len(idx)] = self._x[idx]
                yb[: len(idx)] = self._y[idx]
                yield xb, yb, len(idx), epoch
            epoch += 1

    def next(self) -> tuple[np.ndarray, np.ndarray, int, int]:
        """Blocking pop of the next prefetched batch."""
        if self._handle is None:
            return next(self._fallback)
        xb = np.empty((self.batch_size, self._x.shape[1]), np.float32)
        yb = np.empty((self.batch_size, self._y.shape[1]), np.float32)
        count = ctypes.c_int64(0)
        epoch = ctypes.c_int64(0)
        rc = self._lib.streamer_next(
            self._handle,
            xb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            yb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(count), ctypes.byref(epoch),
        )
        if rc != 0:
            raise RuntimeError(f"streamer_next failed: {rc}")
        c = int(count.value)
        if c < self.batch_size:
            # The native side fills only the first `count` rows; zero the
            # rest so masked consumers never touch uninitialized memory
            # (NaN/Inf garbage survives mask-by-multiplication).
            xb[c:] = 0.0
            yb[c:] = 0.0
        return xb, yb, c, int(epoch.value)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.streamer_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # best-effort; close() is the supported path
        try:
            self.close()
        except Exception:
            pass
