"""BFGS with a pluggable linear solver and two storage modes.

``storage="dense"`` maintains the full Hessian approximation ``B`` and
solves ``B p = -g`` each iteration with a selectable solver — direct (LU),
conjugate gradient, or GMRES — mirroring the reference's injectable Eigen
solver (LDLT default, ConjugateGradient for sparse, GMRES injected in the
test suite; reference: src/minimizer/bfgs.hpp:11-38, tests/main.cpp:265-269).

``storage="factors"`` is the matrix-free counterpart of the reference's
*sparse-matrix* template instantiation (``BFGS<V, SparseMatrix,
ConjugateGradient>``, src/minimizer/bfgs.hpp:11-14): ``B`` is never
materialized. It is represented in factor form

    B_k v = v + sum_j a_j (y_j . v) y_j - b_j ((B_j s_j) . v) (B_j s_j)

with stacked ``(k, n)`` update vectors, so every matvec is two matmuls
and the linear system is solved matrix-free by CG/GMRES. Memory grows as
O(iters * n) instead of O(n^2) — the regime where a dense ``B`` cannot
exist (the same regime Eigen's sparse+CG instantiation targets). The two
modes produce identical trajectories (same rank-2 update, exactly summed).

Rank-2 update: ``B += y y^T/(y^T s) - (Bs)(Bs)^T/(s^T B s)``
(reference: src/minimizer/bfgs.hpp:76-77). Like the reference, no damping or
skip guards are applied to the update.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from lbfgs_ffnn.ops.iterative import cg_counted, gmres_counted
from lbfgs_ffnn.solvers.common import (
    cached_jit_solve, finalize, init_history, lean_gate, record,
    wolfe_with_counters,
)
from lbfgs_ffnn.types import Problem, SolveResult, prepared_aux


class BFGSOptions(NamedTuple):
    max_iters: int = 1000
    tol: float = 1e-10
    linear_solver: str = "direct"  # "direct" | "cg" | "gmres"
    storage: str = "dense"  # "dense" (materialized B) | "factors"
                            # (matrix-free rank-2 factor stack; requires an
                            # iterative linear_solver, cg or gmres)
    solver_tol: float = 1e-12
    solver_max_iters: int = 10000
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
    B: jax.Array
    loss_h: jax.Array
    gnorm_h: jax.Array
    nf: jax.Array
    ng: jax.Array
    nmv: jax.Array  # Krylov matvec count (0 under the direct solver)


class _Factors(NamedTuple):
    """Matrix-free representation of the BFGS matrix: B = I + sum of the
    rank-2 updates, stored as stacked update vectors. Rows past the current
    iteration are zero (with zero coefficients), so no masking is needed."""

    U: jax.Array  # (cap, n): y_j vectors
    V: jax.Array  # (cap, n): (B_j s_j) vectors
    a: jax.Array  # (cap,): 1 / (y_j^T s_j)
    b: jax.Array  # (cap,): 1 / (s_j^T B_j s_j)


def _factors_empty(cap: int, n: int, dtype) -> _Factors:
    return _Factors(
        U=jnp.zeros((cap, n), dtype=dtype),
        V=jnp.zeros((cap, n), dtype=dtype),
        a=jnp.zeros((cap,), dtype=dtype),
        b=jnp.zeros((cap,), dtype=dtype),
    )


def _factor_matvec(F: _Factors, v: jax.Array) -> jax.Array:
    # Two (cap, n) matmuls, no n^2 anywhere.
    return v + (F.a * (F.U @ v)) @ F.U - (F.b * (F.V @ v)) @ F.V


def _solve_iterative(matvec, rhs, opts: BFGSOptions):
    """Counted Krylov solve: returns ``(solution, n_matvecs)`` so the
    matrix-free work is exact in ``SolveResult.n_matvecs`` (jax.scipy's
    solvers expose no count — see ops/iterative.py)."""
    if opts.linear_solver == "cg":
        return cg_counted(
            matvec, rhs, tol=opts.solver_tol, maxiter=opts.solver_max_iters
        )
    if opts.linear_solver == "gmres":
        return gmres_counted(
            matvec, rhs, tol=opts.solver_tol, maxiter=opts.solver_max_iters
        )
    raise ValueError(f"unknown linear_solver {opts.linear_solver!r}")


def _solve_linear(B, rhs, opts: BFGSOptions):
    if opts.linear_solver == "direct":
        return jnp.linalg.solve(B, rhs), jnp.int32(0)
    return _solve_iterative(lambda u: B @ u, rhs, opts)


def _build(problem: Problem, opts: BFGSOptions):
    if opts.storage not in ("dense", "factors"):
        raise ValueError(f"unknown storage {opts.storage!r}")
    if opts.storage == "factors" and opts.linear_solver == "direct":
        raise ValueError(
            "storage='factors' never materializes B; use an iterative "
            "linear_solver ('cg' or 'gmres'), matching the reference's "
            "sparse+ConjugateGradient instantiation"
        )
    factors = opts.storage == "factors"
    lean = lean_gate(problem, opts.ls_value_only)

    def solve(x0, aux, B0):
        aux = prepared_aux(problem, aux)
        f0, g0 = problem.value_and_grad(x0, aux)
        loss_h, gnorm_h = init_history(opts.max_iters, x0.dtype)
        s0 = _State(
            k=jnp.int32(0), x=x0, f=f0, g=g0, gnorm=jnp.linalg.norm(g0),
            B=B0, loss_h=loss_h, gnorm_h=gnorm_h,
            nf=jnp.int32(1), ng=jnp.int32(1), nmv=jnp.int32(0),
        )

        def cond(s: _State):
            # reference loops while ||g|| > tol (src/minimizer/bfgs.hpp:61)
            return (s.k < opts.max_iters) & (s.gnorm > opts.tol)

        def body(s: _State) -> _State:
            if factors:
                p, nmv_add = _solve_iterative(
                    lambda u: _factor_matvec(s.B, u), -s.g, opts
                )
                # NOT counted: the rank-2 update's B s below. n_matvecs is
                # defined as Krylov operator applications (types.py) and the
                # dense-iterative mode's equally real `s.B @ step` update is
                # outside its solve too — the modes must agree on identical
                # mathematical work.
            else:
                p, nmv_add = _solve_linear(s.B, -s.g, opts)
            dg0 = jnp.vdot(s.g, p)
            ls, nf_add, ng_add = wolfe_with_counters(
                problem, opts, s.x, p, s.f, dg0, aux, lean
            )

            def use_ls(_):
                return ls.f_new, ls.g_new

            def reeval(_):
                return problem.value_and_grad(s.x + ls.alpha * p, aux)

            f_new, g_new = lax.cond(ls.evaluated, use_ls, reeval, None)
            step = ls.alpha * p
            x_new = s.x + step
            y = g_new - s.g
            if factors:
                # Same rank-2 update, appended in factor form: row k holds
                # (y_k, B_k s_k) with coefficients 1/(y^T s), 1/(s^T B s).
                Bs = _factor_matvec(s.B, step)
                B_new = _Factors(
                    U=s.B.U.at[s.k].set(y),
                    V=s.B.V.at[s.k].set(Bs),
                    a=s.B.a.at[s.k].set(1.0 / jnp.vdot(y, step)),
                    b=s.B.b.at[s.k].set(1.0 / jnp.vdot(step, Bs)),
                )
            else:
                Bs = s.B @ step
                B_new = (
                    s.B
                    + jnp.outer(y, y) / jnp.vdot(y, step)
                    - jnp.outer(Bs, Bs) / jnp.vdot(step, Bs)
                )
            gnorm_new = jnp.linalg.norm(g_new)
            loss_h, gnorm_h = record(s.loss_h, s.gnorm_h, s.k, f_new, gnorm_new)
            return _State(
                k=s.k + 1, x=x_new, f=f_new, g=g_new, gnorm=gnorm_new,
                B=B_new, loss_h=loss_h, gnorm_h=gnorm_h,
                nf=s.nf + nf_add, ng=s.ng + ng_add, nmv=s.nmv + nmv_add,
            )

        s = lax.while_loop(cond, body, s0)
        return finalize(s.x, s.k, s.gnorm <= opts.tol, s.f, s.gnorm,
                        s.loss_h, s.gnorm_h, n_fevals=s.nf, n_gevals=s.ng,
                        n_matvecs=s.nmv)

    return solve


def bfgs(
    problem: Problem,
    x0: jax.Array,
    aux: Any = (),
    opts: BFGSOptions | None = None,
    initial_hessian: jax.Array | None = None,
) -> SolveResult:
    opts = opts or BFGSOptions()
    n = x0.shape[0]
    if opts.storage == "factors":
        if initial_hessian is not None:
            raise ValueError("storage='factors' starts from B0 = I; "
                             "initial_hessian is dense-mode only")
        B0 = _factors_empty(opts.max_iters, n, x0.dtype)
    else:
        B0 = initial_hessian if initial_hessian is not None else jnp.eye(n, dtype=x0.dtype)
    return cached_jit_solve(_build, problem, opts)(x0, aux, B0)
