"""Full-batch gradient descent (+ optional momentum or Wolfe line search).

Behavioral union of the reference's two GD implementations:
  * CPU ``GradientDescent``: fixed step or Wolfe search, no momentum
    (reference: src/minimizer/gd.hpp:42-68).
  * CUDA ``CudaGD``: classical momentum ``v <- mu*v - lr*g; x <- x + v``,
    no line search (reference: src/cuda/gd.cuh:73-100).

The whole run is one jitted ``lax.while_loop``; per-iteration loss/gradnorm
history is recorded on-device.
"""

from __future__ import annotations

import functools
import time
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from lbfgs_ffnn.solvers.common import (
    cached_jit_solve, drive_chunks, finalize, init_history, lean_gate,
    record, wolfe_with_counters,
)
from lbfgs_ffnn.types import Problem, SolveResult, prepared_aux


class GDOptions(NamedTuple):
    max_iters: int = 1000
    tol: float = 1e-10
    step_size: float = 1e-2
    momentum: float = 0.0
    use_line_search: bool = True
    ls_max_iters: int = 50
    c1: float = 1e-4
    c2: float = 0.9
    ls_shrink: float = 0.5
    ls_value_only: bool | None = None  # (loss, g·p)-via-jvp trials; None =
                                       # auto: on iff the problem carries a
                                       # line restriction (Problem.line_fun);
                                       # see ops/linesearch.py


class _State(NamedTuple):
    k: jax.Array
    x: jax.Array
    f: jax.Array
    g: jax.Array
    gnorm: jax.Array
    v: jax.Array  # momentum velocity
    loss_h: jax.Array
    gnorm_h: jax.Array
    nf: jax.Array
    ng: jax.Array


def _init_state(problem: Problem, opts: GDOptions, x0, aux) -> _State:
    f0, g0 = problem.value_and_grad(x0, aux)
    loss_h, gnorm_h = init_history(opts.max_iters, x0.dtype)
    return _State(
        k=jnp.int32(0),
        x=x0,
        f=f0,
        g=g0,
        gnorm=jnp.linalg.norm(g0),
        v=jnp.zeros_like(x0),
        loss_h=loss_h,
        gnorm_h=gnorm_h,
        nf=jnp.int32(1),
        ng=jnp.int32(1),
    )


def _not_done(s: _State, opts: GDOptions):
    return (s.k < opts.max_iters) & (s.gnorm >= opts.tol)


def _finalize_state(s: _State, opts: GDOptions) -> SolveResult:
    return finalize(s.x, s.k, s.gnorm < opts.tol, s.f, s.gnorm,
                    s.loss_h, s.gnorm_h, n_fevals=s.nf, n_gevals=s.ng)


def _make_body(problem: Problem, opts: GDOptions):
    lean = lean_gate(problem, opts.ls_value_only)

    def body(s: _State, aux) -> _State:
            ls = None
            if opts.momentum > 0.0:
                v = opts.momentum * s.v - opts.step_size * s.g
                x_new = s.x + v
            else:
                v = s.v
                if opts.use_line_search:
                    dg0 = jnp.vdot(s.g, -s.g)
                    ls, nf_ls, ng_ls = wolfe_with_counters(
                        problem, opts, s.x, -s.g, s.f, dg0, aux, lean
                    )
                    alpha = ls.alpha
                else:
                    alpha = jnp.asarray(opts.step_size, dtype=s.x.dtype)
                x_new = s.x - alpha * s.g
            if ls is None:
                f_new, g_new = problem.value_and_grad(x_new, aux)
                nf_add = ng_add = jnp.int32(1)
            else:
                # Reuse the search's evaluation at the accepted point; only
                # an exhausted (unevaluated) search forces a fresh pass.
                f_new, g_new = lax.cond(
                    ls.evaluated,
                    lambda _: (ls.f_new, ls.g_new),
                    lambda _: problem.value_and_grad(x_new, aux),
                    None,
                )
                nf_add, ng_add = nf_ls, ng_ls
            gnorm_new = jnp.linalg.norm(g_new)
            loss_h, gnorm_h = record(s.loss_h, s.gnorm_h, s.k, f_new, gnorm_new)
            return _State(
                k=s.k + 1, x=x_new, f=f_new, g=g_new, gnorm=gnorm_new,
                v=v, loss_h=loss_h, gnorm_h=gnorm_h,
                nf=s.nf + nf_add, ng=s.ng + ng_add,
            )

    return body


def _build(problem: Problem, opts: GDOptions):
    body = _make_body(problem, opts)

    def solve(x0, aux):
        aux = prepared_aux(problem, aux)
        s0 = _init_state(problem, opts, x0, aux)
        s = lax.while_loop(
            lambda s: _not_done(s, opts), lambda s: body(s, aux), s0
        )
        return _finalize_state(s, opts)

    return solve


def gradient_descent(
    problem: Problem, x0: jax.Array, aux: Any = (), opts: GDOptions | None = None
) -> SolveResult:
    opts = opts or GDOptions()
    return cached_jit_solve(_build, problem, opts)(x0, aux)


@functools.lru_cache(maxsize=256)
def _cached_chunk_fns(problem, opts, chunk: int):
    def init(x0, aux):
        return _init_state(problem, opts, x0, prepared_aux(problem, aux))

    body = _make_body(problem, opts)

    def run_chunk(state, aux):
        # Bounded while_loop, not scan+cond (the cond identity branch
        # copies the whole carry per step — see lbfgs._cached_chunk_fns).
        aux = prepared_aux(problem, aux)
        k_end = state.k + chunk
        return lax.while_loop(
            lambda s: _not_done(s, opts) & (s.k < k_end),
            lambda s: body(s, aux),
            state,
        )

    return jax.jit(init), jax.jit(run_chunk)


def gd_chunked(
    problem: Problem,
    x0,
    aux: Any = (),
    opts: GDOptions | None = None,
    chunk: int = 10,
    callback=None,
    resume_state: _State | None = None,
) -> tuple[SolveResult, jax.Array]:
    """Run GD in jitted ``chunk``-iteration pieces with *measured*
    cumulative wall time per chunk (same protocol as ``lbfgs_chunked``) —
    the honest counterpart of the reference's per-iteration cudaEvent
    timing (reference: src/cuda/gd.cuh:63-98). ``resume_state`` continues
    from a checkpointed chunk state (momentum velocity included); ``x0``
    may be None then. Pre-kill iterations keep NaN time entries."""
    opts = opts or GDOptions()
    if resume_state is None and x0 is None:
        raise ValueError("x0 is required unless resume_state is given")
    init, run_chunk = _cached_chunk_fns(problem, opts, chunk)
    state = resume_state if resume_state is not None else init(x0, aux)
    state, time_ms = drive_chunks(
        run_chunk, state, (aux,), opts.max_iters,
        counter=lambda s: int(s.k),
        done=lambda s: float(s.gnorm) < opts.tol,
        sync=lambda s: s.f,
        callback=callback,
    )
    return _finalize_state(state, opts), time_ms
