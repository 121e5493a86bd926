"""Runtime diagnostics and timing helpers.

:func:`check_parallelism` is the device analogue of the reference's
``checkParallelism()`` OpenMP/Eigen thread report (reference:
src/common.hpp:45-64): it prints the backend, device inventory, process
topology and default mesh-able device count.

:func:`sync_time` measures wall time of a thunk with a forced device
synchronization via host transfer of a scalar (JAX dispatch is
asynchronous, so an unsynchronized timing measures only the enqueue).
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp


def check_parallelism(verbose: bool = True) -> dict:
    info = {
        "backend": jax.default_backend(),
        "n_devices": jax.device_count(),
        "n_local_devices": jax.local_device_count(),
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "devices": [str(d) for d in jax.devices()],
    }
    if verbose:
        print(
            f"backend={info['backend']} devices={info['n_devices']} "
            f"(local {info['n_local_devices']}), "
            f"process {info['process_index']}/{info['process_count']}"
        )
        for d in info["devices"]:
            print(f"  {d}")
    return info


def sync_time(thunk: Callable[[], object], reps: int = 1) -> tuple[float, object]:
    """Best-of-``reps`` wall time of ``thunk``; the result pytree's first leaf
    is summed and pulled to the host to force completion."""
    best = float("inf")
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = thunk()
        leaves = jax.tree_util.tree_leaves(out)
        if leaves:
            _ = float(jnp.sum(leaves[0].astype(jnp.float32)) if hasattr(leaves[0], "astype") else 0.0)
        best = min(best, time.perf_counter() - t0)
    return best, out
