"""Shared solver utilities: jit caching, history recording, and the
measured-chunk driver protocol."""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from lbfgs_ffnn.types import SolveResult


def drive_chunks(run_chunk, state, args, total, counter, done, sync,
                 callback=None, pipeline=True):
    """Shared chunked-execution protocol for every solver's ``*_chunked``
    driver: warm-up compile on a perturbed state (so the timed chunks run
    compiled code only), then run chunks with a host sync per chunk,
    accumulating *measured* cumulative wall time into
    ``time_ms[counter_prev:counter_now]``.

    ``run_chunk(state, *args) -> state``; ``counter(state) -> int`` (the
    iteration/epoch counter, forces the host sync); ``done(state) -> bool``
    (solver-specific early-stop predicate, evaluated after counter);
    ``sync(state) -> scalar jax value`` (pulled as float for the warm-up).
    Pre-existing iterations (resume) keep NaN time entries.

    ``pipeline`` (default): chunk ``k+1`` is dispatched (async) BEFORE the
    host blocks on chunk ``k``'s counter, so the host's sync and dispatch
    at each boundary overlap device compute instead of idling the device.
    The stop decision lags one chunk, so at most one speculative chunk is
    dispatched past convergence — its body no-ops (the bounded while_loop's
    ``not_done`` guard) and its result is discarded. Timing stays honest:
    cumulative wall time from the first dispatch, stamped at each sync.
    """
    leaves = jax.tree_util.tree_leaves(state)
    jax.block_until_ready(leaves)
    warm = jax.tree_util.tree_map(
        lambda a: a * (1.0 + 1e-6) + 1e-7
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating)
        else a,
        state,
    )
    _ = float(sync(run_chunk(warm, *args)))

    # Host-side numpy, NOT a device array: the column is measurement
    # bookkeeping, and a device `.at[a:b].set()` with fresh slice bounds
    # per boundary means a dispatch (and, the first time, a compile)
    # landing INSIDE the next boundary's timed window on the pipelined
    # path.
    time_ms = np.full((total,), np.nan)
    k_prev = counter(state)

    if not pipeline:
        elapsed = 0.0
        while True:
            t0 = time.perf_counter()
            state = run_chunk(state, *args)
            k_now = counter(state)  # host sync per chunk (that's the point)
            elapsed += time.perf_counter() - t0
            time_ms[k_prev:k_now] = elapsed * 1e3
            if callback is not None:
                callback(state, elapsed)
            if k_now == k_prev or k_now >= total or done(state):
                break
            k_prev = k_now
        return state, time_ms

    t0 = time.perf_counter()
    cb_host = 0.0  # accumulated host time spent at boundaries (callbacks +
    # the early-stop probe's host round trip) — excluded from later
    # windows, as the sequential path excludes it (a checkpoint-saving
    # callback must not inflate later chunks' TimeMs; ``done``'s host pull
    # is bookkeeping, not solver work). Conservative: the device may keep
    # running the speculative chunk during this host time, so a long
    # callback can hide some overlapped compute, never add to it.
    cur = run_chunk(state, *args)
    while True:
        nxt = run_chunk(cur, *args)  # speculative: dispatched before the sync
        k_now = counter(cur)         # blocks until chunk k is done on device
        elapsed = time.perf_counter() - t0 - cb_host
        time_ms[k_prev:k_now] = elapsed * 1e3
        th0 = time.perf_counter()
        if callback is not None:
            callback(cur, elapsed)
        stop = k_now == k_prev or k_now >= total or done(cur)
        cb_host += time.perf_counter() - th0
        if stop:
            return cur, time_ms
        k_prev = k_now
        cur = nxt


@functools.lru_cache(maxsize=256)
def cached_jit_solve(builder, problem, opts):
    """Compile-once cache keyed on (solver builder, problem, opts).

    ``problem`` and ``opts`` are hashable NamedTuples; reusing the same
    objects across calls reuses the compiled executable.
    """
    return jax.jit(builder(problem, opts))


def init_metric_history(metric_fn, epochs: int, w0, x, y, *margs):
    """Per-epoch metric storage. ``metric_fn(w, x, y, *margs)`` may return a
    scalar (one metric column, e.g. TrainAcc) or a 1-D vector (several, e.g.
    [TrainAcc, TestAcc]); the shape is resolved abstractly (no evaluation).
    ``margs`` are extra traced operands (e.g. the held-out split) so metric
    data never has to be baked into the executable as a constant."""
    if metric_fn is None:
        return jnp.full((epochs,), jnp.nan, dtype=w0.dtype)
    shape = jax.eval_shape(metric_fn, w0, x, y, *margs).shape
    return jnp.full((epochs,) + shape, jnp.nan, dtype=w0.dtype)


def init_history(max_iters: int, dtype):
    return (
        jnp.full((max_iters,), jnp.nan, dtype=dtype),
        jnp.full((max_iters,), jnp.nan, dtype=dtype),
    )


def record(loss_h, gnorm_h, k, loss, gnorm):
    """Write one (loss, gnorm) row at iteration k — the on-device mirror of
    IterationRecorder::record (reference: src/iteration_recorder.hpp:40-47)."""
    return loss_h.at[k].set(loss), gnorm_h.at[k].set(gnorm)


def finalize(x, k, converged, loss, gnorm, loss_h, gnorm_h, metric_h=None,
             n_fevals=None, n_gevals=None, n_hevals=None,
             n_matvecs=None) -> SolveResult:
    return SolveResult(
        x=x,
        n_iters=k,
        converged=converged,
        final_loss=loss,
        final_gnorm=gnorm,
        loss_history=loss_h,
        gnorm_history=gnorm_h,
        metric_history=metric_h,
        n_fevals=n_fevals,
        n_gevals=n_gevals,
        n_hevals=n_hevals,
        n_matvecs=n_matvecs,
    )


def lean_gate(problem, ls_value_only):
    """Shared lean-trial auto-detection for the Wolfe-based solvers: lean
    when the problem carries a cheap line restriction in either form."""
    if ls_value_only is not None:
        return ls_value_only
    return problem.line_fun is not None or problem.line_prefix is not None


def wolfe_with_counters(problem, opts, x, p, f0, dg0, aux, lean):
    """Run the Wolfe search (lean trials through ``line_fun`` when present)
    and return ``(ls, nf_add, ng_add)`` with the eval-counter increments.
    The accounting: lean = n_trials jvp fevals + one value_and_grad at the
    accepted point (or the caller's re-evaluation on failure); fused = every
    trial is a value_and_grad, plus one more if the search exhausted
    unevaluated."""
    from lbfgs_ffnn.ops.linesearch import wolfe_line_search

    va = (
        problem.line_fun(x, p, aux)
        if (lean and problem.line_fun is not None) else None
    )
    ls = wolfe_line_search(
        problem.value_and_grad, x, p, f0, dg0, aux,
        c1=opts.c1, c2=opts.c2, shrink=opts.ls_shrink,
        max_iters=opts.ls_max_iters,
        value=problem.fun if lean else None,
        value_along=va,
    )
    if lean:
        nf_add, ng_add = ls.n_trials + 1, jnp.int32(1)
    else:
        one_more = jnp.where(ls.evaluated, 0, 1).astype(jnp.int32)
        nf_add = ng_add = ls.n_trials + one_more
    return ls, nf_add, ng_add
