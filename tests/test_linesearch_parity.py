"""Trial-sequence parity: the jitted line searches must produce the exact
alpha sequence of the reference algorithms.

The mirrors below are straight Python transcriptions of the *published
behavior* (reference: src/minimizer/full_batch_minimizer.hpp:126-157 and
src/cuda/lbfgs.cuh:108-147); comparing accepted step lengths on a family of
objectives pins the while_loop implementations to the reference policy.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_ffnn.ops.linesearch import armijo_quad_line_search, wolfe_line_search


def wolfe_mirror(f, grad, x, p, c1=1e-4, c2=0.9, rho=0.5, max_iters=50):
    f_old = f(x)
    g_old = grad(x) @ p
    lo, hi = 0.0, np.inf
    alpha = 1.0
    for _ in range(max_iters):
        x_new = x + alpha * p
        if f(x_new) > f_old + c1 * alpha * g_old:
            hi = alpha
            alpha = rho * (lo + hi)
            continue
        if grad(x_new) @ p < c2 * g_old:
            lo = alpha
            alpha = alpha * 2 if hi == np.inf else rho * (lo + hi)
            continue
        return alpha, True
    return alpha, False


def armijo_mirror(f, grad, x, p, alpha0=1.0, c1=1e-4, rho=0.5, max_iters=20):
    f0 = f(x)
    dg0 = grad(x) @ p
    alpha = alpha0
    for _ in range(max_iters):
        f_new = f(x + alpha * p)
        if f_new <= f0 + c1 * alpha * dg0:
            return alpha, True
        denom = 2.0 * (f_new - f0 - dg0 * alpha)
        use_fallback = True
        if abs(denom) > 1e-20:
            a_new = -(dg0 * alpha * alpha) / denom
            if 0.1 * alpha <= a_new <= 0.9 * alpha:
                alpha_next = a_new
                use_fallback = False
        if use_fallback:
            alpha_next = alpha * rho
        last_eval = alpha
        alpha = alpha_next
    return last_eval, False  # reference keeps the last evaluated trial


# Each objective defined once with xp-generic arithmetic: numpy for the
# Python mirror, jnp inside the traced line search (identical f64 IEEE ops).
def _objectives(xp):
    return {
        "quadratic": (lambda x: 0.5 * xp.sum((x - 1.3) ** 2), lambda x: x - 1.3),
        "quartic": (lambda x: xp.sum(x**4), lambda x: 4 * x**3),
        "narrow": (lambda x: 0.5 * 100 * xp.sum(x**2), lambda x: 100 * x),
        "wide": (lambda x: 0.5 * 1e-3 * xp.sum(x**2), lambda x: 1e-3 * x),
        "exp": (lambda x: xp.sum(xp.exp(x) - x), lambda x: xp.exp(x) - 1.0),
    }


STARTS = {
    "quadratic": np.array([0.0, 0.0]),
    "quartic": np.array([2.0, -1.5]),
    "narrow": np.array([1.0, 1.0]),
    "wide": np.array([5.0, -3.0]),
    "exp": np.array([3.0, -2.0]),
}

NAMES = sorted(STARTS)


def make_vag(name):
    f, grad = _objectives(jnp)[name]

    def vag(w, aux=()):
        return f(w), grad(w)

    return vag


@pytest.mark.parametrize("name", NAMES)
def test_wolfe_alpha_parity(name):
    f, grad = _objectives(np)[name]
    x0 = STARTS[name]
    p = -grad(x0)
    a_ref, ok_ref = wolfe_mirror(f, grad, x0, p)
    vag = make_vag(name)
    xj, pj = jnp.asarray(x0), jnp.asarray(p)
    f0, g0 = vag(xj)
    res = wolfe_line_search(vag, xj, pj, f0, jnp.vdot(g0, pj))
    assert bool(res.ok) == ok_ref, name
    np.testing.assert_allclose(float(res.alpha), a_ref, rtol=1e-12, err_msg=name)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("alpha0", [1.0, 0.1])
def test_armijo_alpha_parity(name, alpha0):
    f, grad = _objectives(np)[name]
    x0 = STARTS[name]
    p = -grad(x0)
    a_ref, ok_ref = armijo_mirror(f, grad, x0, p, alpha0=alpha0)
    vag = make_vag(name)
    xj, pj = jnp.asarray(x0), jnp.asarray(p)
    f0, g0 = vag(xj)
    res = armijo_quad_line_search(vag, xj, pj, f0, jnp.vdot(g0, pj), alpha0=alpha0)
    assert bool(res.ok) == ok_ref, name
    np.testing.assert_allclose(float(res.alpha), a_ref, rtol=1e-12, err_msg=name)
