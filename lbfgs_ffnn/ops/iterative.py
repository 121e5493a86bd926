"""Counted matrix-free linear solvers (CG and restarted GMRES).

``jax.scipy.sparse.linalg`` exposes no iteration/matvec counts, which breaks
the repo's exact-eval-counter contract (CLAUDE.md) for the matrix-free solver
modes — Newton-CG spends one Hessian-vector product per CG matvec and
factor-form BFGS one rank-2 factor matvec per Krylov step, none of it
observable. These explicit implementations return ``(solution, n_matvecs)``
with the matvec count carried through the ``lax.while_loop`` so the counters
in :class:`~lbfgs_ffnn.types.SolveResult` are exact.

Mirrors the roles of the reference's injectable Eigen solvers
(ConjugateGradient / injected GMRES, reference: src/minimizer/bfgs.hpp:11-38,
tests/main.cpp:265-269); the algorithms are the textbook ones, written
compiler-first (static shapes, ``while_loop``/``fori_loop``, no dynamic
breakdown exits).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def cg_counted(matvec, b, *, tol: float, maxiter: int):
    """Conjugate gradient on ``A x = b`` from ``x0 = 0``.

    Same convergence test as ``jax.scipy.sparse.linalg.cg`` (squared residual
    vs ``tol^2 * ||b||^2``), but returns ``(x, n_matvecs)`` where
    ``n_matvecs`` counts exactly the ``matvec`` applications in the traced
    program. Starting from zero makes the initial residual ``b`` for free
    (the linear operator maps 0 to 0), so ``n_matvecs`` equals the number of
    CG iterations performed.
    """
    atol2 = jnp.square(jnp.asarray(tol, b.dtype)) * jnp.vdot(b, b).real

    def cond(c):
        _, _, gamma, _, k, live = c
        return live & (gamma > atol2) & (k < maxiter)

    def body(c):
        x, r, gamma, p, k, live = c
        Ap = matvec(p)
        pAp = jnp.vdot(p, Ap).real
        # Breakdown guard (jax.scipy has none): a non-positive or underflowed
        # curvature p^T A p means A is indefinite along p or the iteration has
        # hit float resolution — freeze the iterate instead of dividing to
        # NaN (seen in f32 factor-form BFGS near the optimum).
        ok = pAp > 0.0
        alpha = jnp.where(ok, gamma / jnp.where(ok, pAp, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_new = jnp.vdot(r, r).real
        beta = jnp.where(ok, gamma_new / gamma, 0.0)
        return x, r, gamma_new, r + beta * p, k + 1, ok

    x0 = jnp.zeros_like(b)
    gamma0 = jnp.vdot(b, b).real
    x, _, _, _, k, _ = lax.while_loop(
        cond, body, (x0, b, gamma0, b, jnp.int32(0), jnp.array(True))
    )
    return x, k


def _arnoldi_cycle(matvec, V, restart: int):
    """One fixed-length Arnoldi factorization: fills ``V[1:restart]`` and the
    (restart+1, restart) Hessenberg ``H`` from the unit residual in ``V[0]``.
    Unfilled basis rows are zero, so the full-stack projection ``V @ w``
    yields exact zeros there — no masking needed (batched style: no early
    breakdown exit; a happy breakdown leaves zero columns, handled by the
    least-squares solve)."""
    n = V.shape[1]
    H = jnp.zeros((restart + 1, restart), dtype=V.dtype)

    def body(j, carry):
        V, H = carry
        w = matvec(V[j])
        h = V @ w  # modified-by-stack Gram-Schmidt projection
        w = w - h @ V
        # one re-orthogonalization pass (classical GS is unstable bare)
        h2 = V @ w
        w = w - h2 @ V
        h = h + h2
        nrm = jnp.linalg.norm(w)
        safe = jnp.where(nrm > 0, nrm, 1.0)
        V = V.at[j + 1].set(jnp.where(nrm > 0, w / safe, jnp.zeros(n, V.dtype)))
        H = H.at[:, j].set(h.at[j + 1].set(nrm))
        return V, H

    return lax.fori_loop(0, restart, body, (V, H))


def gmres_counted(matvec, b, *, tol: float, maxiter: int, restart: int = 20):
    """Restarted GMRES(restart) on ``A x = b`` from ``x0 = 0``.

    ``maxiter`` bounds the number of restart cycles (jax.scipy convention);
    each cycle costs ``restart`` matvecs for the Arnoldi basis plus one for
    the true residual at the restart (the initial residual is ``b`` for
    free). Returns ``(x, n_matvecs)`` with the count exact.
    """
    n = b.shape[0]
    restart = min(restart, n)
    bnorm = jnp.linalg.norm(b)
    atol = jnp.asarray(tol, b.dtype) * bnorm

    def ls_update(x, r):
        """One GMRES cycle from residual r: returns the updated iterate."""
        rnorm = jnp.linalg.norm(r)
        safe = jnp.where(rnorm > 0, rnorm, 1.0)
        V = jnp.zeros((restart + 1, n), dtype=b.dtype).at[0].set(r / safe)
        V, H = _arnoldi_cycle(matvec, V, restart)
        beta = jnp.zeros((restart + 1,), dtype=b.dtype).at[0].set(rnorm)
        y, *_ = jnp.linalg.lstsq(H, beta)
        return x + y @ V[:restart]

    def cond(c):
        _, r, k, _ = c
        return (jnp.vdot(r, r).real > atol * atol) & (k < maxiter)

    def body(c):
        x, r, k, nmv = c
        x = ls_update(x, r)
        # true (not recurrence) residual for the restart and the stop test
        r = b - matvec(x)
        return x, r, k + 1, nmv + restart + 1

    x0 = jnp.zeros_like(b)
    x, _, _, nmv = lax.while_loop(cond, body, (x0, b, jnp.int32(0), jnp.int32(0)))
    return x, nmv
