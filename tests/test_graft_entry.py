"""Contract tests for __graft_entry__.py.

``entry()`` is compile-checked on one device and ``dryrun_multichip(N)``
runs on N virtual CPU devices; nothing else in the suite imports the
module, so a regression there would otherwise go unnoticed.
"""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

graft = importlib.import_module("__graft_entry__")


def test_entry_compiles_and_runs():
    fn, args = graft.entry()
    loss, grad = jax.jit(fn)(*args)
    assert jnp.isfinite(loss)
    assert grad.shape == args[0].shape
    assert jnp.isfinite(grad).all()


def test_dryrun_multichip_8():
    # conftest forces 8 virtual CPU devices; the dryrun exercises the GSPMD
    # and shard_map data-parallel S-LBFGS paths plus the param-sharded
    # L-BFGS (loop and compact/bf16-ring) and asserts finiteness itself.
    graft.dryrun_multichip(8)


def test_dryrun_multichip_raises_with_too_few_devices():
    """No fallback: asking for more devices than JAX sees is an error, not
    a silent switch of platform."""
    n = len(jax.devices())
    with pytest.raises(RuntimeError, match=f"need {n + 1} devices, have {n}"):
        graft.dryrun_multichip(n + 1)
    assert jax.default_backend() == "cpu"
