"""Profiling: jax.profiler trace wrapper.

The reference's tracing story is wall-clock timestamps per iteration
(std::chrono / cudaEvent, SURVEY.md §5); the deep view here is an XLA
profiler trace (op-level device timeline) readable with
``jax.profiler.ProfileData`` or TensorBoard/XProf.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(logdir: str = "traces"):
    """``with trace('traces'): run()`` captures a device trace (the
    default directory is relative to the working directory)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
