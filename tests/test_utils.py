"""Smoke tests for diagnostics and profiling utilities."""

import glob
import os

import jax
import jax.numpy as jnp

from lbfgs_ffnn.utils.diagnostics import check_parallelism, sync_time
from lbfgs_ffnn.utils.profiling import trace


def test_check_parallelism_reports_devices():
    info = check_parallelism(verbose=False)
    assert info["n_devices"] == 8  # conftest's virtual CPU mesh
    assert info["backend"] == "cpu"
    assert info["process_count"] == 1
    assert len(info["devices"]) == 8


def test_sync_time_returns_elapsed_and_value():
    elapsed, val = sync_time(lambda: jnp.sum(jnp.arange(16.0)), reps=2)
    assert elapsed >= 0.0
    assert float(val) == 120.0


def test_trace_writes_profile(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir) as d:
        _ = jax.jit(lambda v: v * 2.0)(jnp.ones(128)).block_until_ready()
    assert d == logdir
    # the profiler writes a plugins/profile/<ts>/ tree with trace artifacts
    found = glob.glob(os.path.join(logdir, "**", "*.pb"), recursive=True) + \
        glob.glob(os.path.join(logdir, "**", "*.trace.json*"), recursive=True) + \
        glob.glob(os.path.join(logdir, "**", "*.xplane.pb"), recursive=True)
    assert found, f"no trace artifacts under {logdir}"
