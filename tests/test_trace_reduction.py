"""The trace reduction behind scripts/trace_lbfgs.py: interval union,
idle share and gaps, and reading events from a real profiler trace."""

import glob
import os
import sys

import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts"))

import trace_lbfgs as tl  # noqa: E402


@pytest.mark.parametrize("intervals,total", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (5, 12)], 12),          # overlap counted once
    ([(0, 10), (2, 3), (20, 25)], 15),  # nested + disjoint
    ([(20, 25), (0, 10), (10, 12)], 17),  # unsorted, touching
])
def test_union_ns(intervals, total):
    assert tl.union_ns(intervals) == total


def test_reduce_trace_idle_share_and_gaps():
    events = [("a", 0, 40), ("b", 30, 50), ("a", 60, 100)]
    r = tl.reduce_trace(events)
    assert r["window_ns"] == 100 and r["busy_ns"] == 90
    assert r["idle_share"] == pytest.approx(0.1)
    assert r["n_gaps"] == 1 and r["gap_ns_total"] == 10
    assert r["top"][0] == ("a", 80)
    with pytest.raises(ValueError):
        tl.reduce_trace([])


def test_kernel_events_reads_a_profiler_trace(tmp_path):
    f = jax.jit(lambda x: jnp.sin(x) @ x)
    x = jnp.ones((64, 64))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    path = glob.glob(str(tmp_path / "**" / "*.xplane.pb"), recursive=True)[0]
    events, lines = tl.kernel_events(path, plane_prefix="/host:CPU",
                                     line_prefix="")
    assert lines and events
    assert all(e >= s for _, s, e in events)
    assert tl.reduce_trace(events)["busy_ns"] > 0
