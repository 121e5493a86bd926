"""Classic analytic test objectives: Rosenbrock, Ackley, Rastrigin.

These mirror the reference's deterministic test suite objectives — same
functions, same analytic gradients/Hessians, same start points and
tolerances (reference: tests/main.cpp:15-258) — but are written vectorized
over the parameter axis, and each is also usable with pure autodiff
derivatives (the reference cross-checks the same functions against its
vendored reverse-mode AD in tests/autodiff_tests.cpp).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from lbfgs_ffnn.types import Problem, make_problem

_PI = jnp.pi


# ---------------------------------------------------------------------------
# Rosenbrock:  sum_i 100*(x_{i+1} - x_i^2)^2 + (1 - x_i)^2
# ---------------------------------------------------------------------------

def rosenbrock(w, aux=()):
    a = w[1:] - w[:-1] ** 2
    b = 1.0 - w[:-1]
    return jnp.sum(100.0 * a**2 + b**2)


def rosenbrock_grad(w, aux=()):
    n = w.shape[0]
    g = jnp.zeros_like(w)
    # interior coupling terms
    inner = w[1:] - w[:-1] ** 2
    g = g.at[:-1].add(-2.0 * (1.0 - w[:-1]) - 400.0 * w[:-1] * inner)
    g = g.at[1:].add(200.0 * inner)
    return g


def rosenbrock_hess(w, aux=()):
    n = w.shape[0]
    d = jnp.zeros_like(w)
    d = d.at[:-1].add(2.0 - 400.0 * (w[1:] - 3.0 * w[:-1] ** 2))
    d = d.at[1:].add(200.0)
    off = -400.0 * w[:-1]
    H = jnp.diag(d) + jnp.diag(off, 1) + jnp.diag(off, -1)
    return H


def rosenbrock_problem(analytic: bool = True) -> Problem:
    if analytic:
        return make_problem(rosenbrock, rosenbrock_grad, rosenbrock_hess)
    return make_problem(rosenbrock)


def rosenbrock_start(n: int = 4, dtype=jnp.float64) -> jax.Array:
    """Alternating (-1.2, 1.0) start (reference: tests/main.cpp:137-139)."""
    i = jnp.arange(n)
    return jnp.where(i % 2 == 0, -1.2, 1.0).astype(dtype)


# ---------------------------------------------------------------------------
# Ackley
# ---------------------------------------------------------------------------

def ackley(w, aux=()):
    n = w.shape[0]
    sum1 = jnp.sum(w**2)
    sum2 = jnp.sum(jnp.cos(2.0 * _PI * w))
    return (
        -20.0 * jnp.exp(-0.2 * jnp.sqrt(sum1 / n))
        - jnp.exp(sum2 / n)
        + 20.0
        + jnp.e
    )


def ackley_grad(w, aux=()):
    n = w.shape[0]
    sum1 = jnp.sum(w**2)
    sum2 = jnp.sum(jnp.cos(2.0 * _PI * w))
    e1 = jnp.exp(-0.2 * jnp.sqrt(sum1 / n))
    e2 = jnp.exp(sum2 / n)
    r = jnp.sqrt(sum1 / n)
    g1 = 4.0 * e1 * (w / (n * r))
    g2 = (2.0 * _PI / n) * e2 * jnp.sin(2.0 * _PI * w)
    return g1 + g2


def ackley_problem(analytic: bool = True) -> Problem:
    if analytic:
        # Hessian via autodiff of the analytic gradient (the reference's
        # hand-derived Ackley Hessian at tests/main.cpp:198-240 is the same
        # mathematical object).
        return make_problem(ackley, ackley_grad, jax.hessian(ackley))
    return make_problem(ackley)


def ackley_start(dtype=jnp.float64) -> jax.Array:
    return jnp.array([10.0, -5.0, 1.0], dtype=dtype)


# ---------------------------------------------------------------------------
# Rastrigin:  A*n + sum_i x_i^2 - A*cos(2*pi*x_i)
# ---------------------------------------------------------------------------

_A = 10.0


def rastrigin(w, aux=()):
    n = w.shape[0]
    return _A * n + jnp.sum(w**2 - _A * jnp.cos(2.0 * _PI * w))


def rastrigin_grad(w, aux=()):
    return 2.0 * w + 2.0 * _PI * _A * jnp.sin(2.0 * _PI * w)


def rastrigin_hess(w, aux=()):
    return jnp.diag(2.0 + 4.0 * _PI**2 * _A * jnp.cos(2.0 * _PI * w))


def rastrigin_problem(analytic: bool = True) -> Problem:
    if analytic:
        return make_problem(rastrigin, rastrigin_grad, rastrigin_hess)
    return make_problem(rastrigin)


def rastrigin_start(n: int = 500, dtype=jnp.float64) -> jax.Array:
    """Alternating (+4, -4) start (reference: tests/main.cpp:50-52)."""
    i = jnp.arange(n)
    return jnp.where(i % 2 == 0, 4.0, -4.0).astype(dtype)
