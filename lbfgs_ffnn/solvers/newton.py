"""Damped Newton with adaptive Levenberg regularization.

Per iteration: try ``(H + mu*I) p = -g`` with ``mu`` escalating
1e-6 -> 1e6 (x10) until the solve is finite and ``p`` is a descent direction;
fall back to steepest descent otherwise; then Wolfe line search
(reference behavior of src/minimizer/newton.hpp:34-77).

Two Hessian modes:
  * ``hess_mode="dense"`` — the reference's shape: a user (or autodiff)
    ``problem.hess`` materializes H and the damped system is solved directly
    (reference requires an explicit HessFun, src/minimizer/newton.hpp:25).
  * ``hess_mode="hvp_cg"`` — matrix-free Newton-CG: the damped
    system is solved by conjugate gradient where every matvec is one exact
    Hessian-vector product ``jax.jvp`` of the gradient (Problem.hvp), so H
    is never formed — usable at MLP scale where an n^2 Hessian cannot exist.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from lbfgs_ffnn.ops.iterative import cg_counted
from lbfgs_ffnn.solvers.common import (
    cached_jit_solve, finalize, init_history, lean_gate, record,
    wolfe_with_counters,
)
from lbfgs_ffnn.types import Problem, SolveResult, prepared_aux


class NewtonOptions(NamedTuple):
    max_iters: int = 1000
    tol: float = 1e-10
    reg_init: float = 1e-6
    reg_max: float = 1e6
    reg_growth: float = 10.0
    ls_max_iters: int = 50
    c1: float = 1e-4
    c2: float = 0.9
    ls_shrink: float = 0.5
    ls_value_only: bool | None = None  # (loss, g·p)-via-jvp trials; None =
                                       # auto: on iff the problem carries a
                                       # line restriction (Problem.line_fun);
                                       # see ops/linesearch.py
    hess_mode: str = "dense"  # "dense" | "hvp_cg" (matrix-free Newton-CG)
    cg_tol: float = 1e-10
    cg_max_iters: int = 200


class _State(NamedTuple):
    k: jax.Array
    x: jax.Array
    f: jax.Array
    g: jax.Array
    gnorm: jax.Array
    loss_h: jax.Array
    gnorm_h: jax.Array
    nf: jax.Array
    ng: jax.Array
    nh: jax.Array  # HVP count (hvp_cg mode; stays 0 in dense mode)


def _damped_direction(H, g, opts: NewtonOptions):
    n = g.shape[0]
    eye = jnp.eye(n, dtype=H.dtype)

    class _C(NamedTuple):
        mu: jax.Array
        p: jax.Array
        found: jax.Array

    def cond(c: _C):
        return (~c.found) & (c.mu <= opts.reg_max)

    def body(c: _C) -> _C:
        p = jnp.linalg.solve(H + c.mu * eye, -g)
        ok = jnp.all(jnp.isfinite(p)) & (jnp.vdot(p, g) < 0.0)
        return _C(
            mu=jnp.where(ok, c.mu, c.mu * opts.reg_growth),
            p=jnp.where(ok, p, c.p),
            found=ok,
        )

    c0 = _C(
        mu=jnp.asarray(opts.reg_init, dtype=H.dtype),
        p=jnp.zeros_like(g),
        found=jnp.array(False),
    )
    c = lax.while_loop(cond, body, c0)
    # Steepest-descent fallback (reference: src/minimizer/newton.hpp:68-70).
    return jnp.where(c.found, c.p, -g)


def _damped_direction_hvp(problem: Problem, x, g, aux, opts: NewtonOptions):
    """Matrix-free variant: CG on ``(H + mu I) p = -g`` where each matvec is
    one exact HVP (forward-over-reverse jvp) — H is never materialized.
    Same mu escalation / descent gate / steepest-descent fallback policy as
    the dense path. Returns ``(p, n_hvps)`` with the HVP count exact (one
    per CG iteration, summed over damping trials — the counted CG makes the
    matrix-free work observable in SolveResult.n_hevals)."""

    class _C(NamedTuple):
        mu: jax.Array
        p: jax.Array
        found: jax.Array
        nh: jax.Array

    def cond(c: _C):
        return (~c.found) & (c.mu <= opts.reg_max)

    def body(c: _C) -> _C:
        def matvec(v):
            return problem.hvp(x, v, aux) + c.mu * v

        p, nmv = cg_counted(
            matvec, -g, tol=opts.cg_tol, maxiter=opts.cg_max_iters
        )
        ok = jnp.all(jnp.isfinite(p)) & (jnp.vdot(p, g) < 0.0)
        return _C(
            mu=jnp.where(ok, c.mu, c.mu * opts.reg_growth),
            p=jnp.where(ok, p, c.p),
            found=ok,
            nh=c.nh + nmv,
        )

    c0 = _C(
        mu=jnp.asarray(opts.reg_init, dtype=g.dtype),
        p=jnp.zeros_like(g),
        found=jnp.array(False),
        nh=jnp.int32(0),
    )
    c = lax.while_loop(cond, body, c0)
    return jnp.where(c.found, c.p, -g), c.nh


def _build(problem: Problem, opts: NewtonOptions):
    if opts.hess_mode not in ("dense", "hvp_cg"):
        raise ValueError(f"unknown hess_mode {opts.hess_mode!r}")
    if opts.hess_mode == "dense" and problem.hess is None:
        raise ValueError("Newton with hess_mode='dense' requires problem.hess")

    lean = lean_gate(problem, opts.ls_value_only)

    def solve(x0, aux):
        aux = prepared_aux(problem, aux)
        f0, g0 = problem.value_and_grad(x0, aux)
        loss_h, gnorm_h = init_history(opts.max_iters, x0.dtype)
        s0 = _State(
            k=jnp.int32(0), x=x0, f=f0, g=g0, gnorm=jnp.linalg.norm(g0),
            loss_h=loss_h, gnorm_h=gnorm_h, nf=jnp.int32(1), ng=jnp.int32(1),
            nh=jnp.int32(0),
        )

        def cond(s: _State):
            return (s.k < opts.max_iters) & (s.gnorm > opts.tol)

        def body(s: _State) -> _State:
            if opts.hess_mode == "hvp_cg":
                p, nh_add = _damped_direction_hvp(problem, s.x, s.g, aux, opts)
            else:
                H = problem.hess(s.x, aux)
                p = _damped_direction(H, s.g, opts)
                nh_add = jnp.int32(0)
            dg0 = jnp.vdot(s.g, p)
            ls, nf_add, ng_add = wolfe_with_counters(
                problem, opts, s.x, p, s.f, dg0, aux, lean
            )

            def use_ls(_):
                return ls.f_new, ls.g_new

            def reeval(_):
                return problem.value_and_grad(s.x + ls.alpha * p, aux)

            f_new, g_new = lax.cond(ls.evaluated, use_ls, reeval, None)
            x_new = s.x + ls.alpha * p
            gnorm_new = jnp.linalg.norm(g_new)
            loss_h, gnorm_h = record(s.loss_h, s.gnorm_h, s.k, f_new, gnorm_new)
            return _State(
                k=s.k + 1, x=x_new, f=f_new, g=g_new, gnorm=gnorm_new,
                loss_h=loss_h, gnorm_h=gnorm_h,
                nf=s.nf + nf_add, ng=s.ng + ng_add, nh=s.nh + nh_add,
            )

        s = lax.while_loop(cond, body, s0)
        return finalize(s.x, s.k, s.gnorm <= opts.tol, s.f, s.gnorm,
                        s.loss_h, s.gnorm_h, n_fevals=s.nf, n_gevals=s.ng,
                        n_hevals=s.nh)

    return solve


def newton(
    problem: Problem, x0: jax.Array, aux: Any = (), opts: NewtonOptions | None = None
) -> SolveResult:
    opts = opts or NewtonOptions()
    return cached_jit_solve(_build, problem, opts)(x0, aux)
