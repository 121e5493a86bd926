"""Device mesh construction and multi-host runtime init.

The reference has no multi-device story at all — its only parallelism is
OpenMP threads over the sample axis and a single CUDA device (SURVEY.md
§2.6). This framework scales the same sample/batch axis across devices and
hosts: a 1-D ``data`` mesh over all devices, batch-sharded objective
evaluation, replicated solver state, gradient all-reduce over the device
interconnect (NVLink/NCCL on GPUs).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import AxisType, Mesh


def make_mesh(
    n_devices: Optional[int | Sequence[int]] = None,
    axis_name: str | Sequence[str] = "data",
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Device mesh over the first ``prod(n_devices)`` devices.

    1-D by default (``make_mesh(8)`` -> an 8-way ``"data"`` axis). Pass a
    shape tuple and matching axis names for an N-D mesh — e.g.
    ``make_mesh((2, 4), ("data", "model"))`` runs the batch-sharded
    objective over the ``data`` axis and the parameter-sharded solver state
    over the ``model`` axis of the same program (``lbfgs(mesh=,
    shard_axis="model")`` with the aux data sharded ``P("data")``; the
    solver only constrains the model axis, so GSPMD partitions the
    objective over both).

    Axes are ``Auto``-typed: solvers run unchanged and GSPMD propagates the
    batch sharding / inserts the gradient all-reduce. With all devices,
    ``jax.make_mesh`` picks the platform's preferred device order.
    """
    import math

    import numpy as np

    shape = ((n_devices,) if n_devices is None or isinstance(n_devices, int)
             else tuple(n_devices))
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} has {len(shape)} axes but "
                         f"{len(names)} axis names {names}")
    types = (AxisType.Auto,) * len(names)
    if devices is not None:
        devs = list(devices)
        if shape != (None,):
            n = math.prod(shape)
            if len(devs) < n:
                raise ValueError(
                    f"mesh shape {shape} needs {n} devices, got {len(devs)}")
            devs = devs[:n]
        return Mesh(np.asarray(devs).reshape([-1] + list(shape[1:])),
                    names, axis_types=types)
    if shape == (None,):
        shape = (len(jax.devices()),)
    n = math.prod(shape)
    if n > len(jax.devices()):
        raise ValueError(f"requested {n} devices, have {len(jax.devices())}")
    if n == len(jax.devices()):
        return jax.make_mesh(shape, names, axis_types=types)
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                names, axis_types=types)


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host process-group init (``jax.distributed.initialize``).

    Call once per host before any jax computation when running across
    several hosts; a no-op for single-process runs. Arguments default to the
    standard cluster-environment autodetection.

    On the CPU backend, cross-process collectives need an explicit
    implementation — without it each process sees only its own devices and
    ``jax.process_count()`` stays 1. Gloo is enabled here automatically, so
    N plain CPU processes federate into one global device set: the
    "multi-host without hosts" test rig (see
    tests/test_multiprocess.py, which drives a real 2-process sharded
    gradient reduction through this entry point).
    """
    if num_processes is not None and num_processes <= 1:
        return
    # Inspect the configured platform WITHOUT touching the backend —
    # jax.default_backend() would initialize it, which must not happen
    # before jax.distributed.initialize.
    import os

    platforms = str(getattr(jax.config, "jax_platforms", None) or
                    os.environ.get("JAX_PLATFORMS", ""))
    if "cpu" in platforms:
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:
            pass  # older jax: single-process CPU still works
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
