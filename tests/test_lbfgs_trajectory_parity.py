"""Full-solver trajectory parity: the jitted L-BFGS solvers must reproduce,
iterate for iterate, straight-Python mirrors of the reference algorithms.

The mirrors transcribe the published behavior of the reference CPU solver
(two-loop + Wolfe bisection + first-iter heuristic + curvature gate,
src/minimizer/lbfgs.hpp:38-139 with full_batch_minimizer.hpp:126-157) and
the reference CUDA solver (ring two-loop + descent check + Armijo with
quadratic interpolation + history resets, src/cuda/lbfgs.cuh:90-261).
Matching 30 iterates in f64 to rtol 1e-9 pins the whole solver, not just the
line search, to the reference policy.
"""

import numpy as np
import pytest

from lbfgs_ffnn.objectives.analytic import (
    ackley,
    ackley_grad,
    ackley_problem,
    ackley_start,
    rosenbrock,
    rosenbrock_grad,
    rosenbrock_problem,
    rosenbrock_start,
)
from lbfgs_ffnn.solvers import LBFGSOptions
from lbfgs_ffnn.solvers.lbfgs import _cached_chunk_fns


def np_two_loop(g, s_list, y_list, rho_list):
    if not s_list:
        return -g
    q = g.copy()
    alphas = []
    for s, y, r in zip(reversed(s_list), reversed(y_list), reversed(rho_list)):
        a = r * (s @ q)
        alphas.append(a)
        q = q - a * y
    alphas.reverse()
    gamma = (s_list[-1] @ y_list[-1]) / (y_list[-1] @ y_list[-1])
    z = gamma * q
    for s, y, r, a in zip(s_list, y_list, rho_list, alphas):
        b = r * (y @ z)
        z = z + s * (a - b)
    return -z


def np_wolfe(f, grad, x, p, c1=1e-4, c2=0.9, rho=0.5, iters=50):
    f_old, g_old = f(x), grad(x) @ p
    lo, hi, alpha = 0.0, np.inf, 1.0
    for _ in range(iters):
        if f(x + alpha * p) > f_old + c1 * alpha * g_old:
            hi = alpha
            alpha = rho * (lo + hi)
            continue
        if grad(x + alpha * p) @ p < c2 * g_old:
            lo = alpha
            alpha = alpha * 2 if hi == np.inf else rho * (lo + hi)
            continue
        break
    return alpha


def reference_lbfgs_wolfe(f, grad, x0, m, iters):
    """Mirror of the reference CPU solver loop (lbfgs.hpp:52-97)."""
    s_list, y_list, rho_list = [], [], []
    x = x0.copy()
    g = grad(x)
    traj = []
    for k in range(iters):
        p = np_two_loop(g, s_list, y_list, rho_list)
        alpha = min(1.0, 1.0 / np.linalg.norm(g)) if k == 0 else np_wolfe(f, grad, x, p)
        x_new = x + alpha * p
        s = x_new - x
        g_new = grad(x_new)
        y = g_new - g
        x = x_new
        ys = y @ s
        if ys > 1e-10:
            s_list.append(s)
            y_list.append(y)
            rho_list.append(1.0 / ys)
            if len(s_list) > m:
                s_list.pop(0), y_list.pop(0), rho_list.pop(0)
        g = g_new
        traj.append(x.copy())
    return traj


def reference_lbfgs_armijo(f, grad, x0, m, iters, ls_iters=20, c1=1e-4, rho=0.5):
    """Mirror of the reference CUDA solver loop (cuda/lbfgs.cuh:90-185)."""
    s_list, y_list, rho_list = [], [], []
    x = x0.copy()
    loss, g = f(x), grad(x)
    traj = []
    for k in range(iters):
        p = np_two_loop(g, s_list, y_list, rho_list)
        gp = g @ p
        if gp >= 0:
            p = -g
            gp = -(g @ g)
            s_list, y_list, rho_list = [], [], []
        alpha = min(1.0, 1.0 / np.linalg.norm(g)) if k == 0 else 1.0
        ok = False
        for _ in range(ls_iters):
            x_try = x + alpha * p
            loss_new, g_new = f(x_try), grad(x_try)
            if loss_new <= loss + c1 * alpha * gp:
                ok = True
                break
            denom = 2.0 * (loss_new - loss - gp * alpha)
            a_q = -(gp * alpha * alpha) / denom if abs(denom) > 1e-20 else None
            alpha = a_q if a_q is not None and 0.1 * alpha <= a_q <= 0.9 * alpha else alpha * rho
        if not ok:
            s_list, y_list, rho_list = [], [], []
        s = x_try - x
        y = g_new - g
        x = x_try
        ys = y @ s
        if ys > 1e-10:
            s_list.append(s)
            y_list.append(y)
            rho_list.append(1.0 / ys)
            if len(s_list) > m:
                s_list.pop(0), y_list.pop(0), rho_list.pop(0)
        g, loss = g_new, loss_new
        traj.append(x.copy())
    return traj


def jitted_trajectory(problem, x0, opts, iters):
    """Collect per-iteration iterates from the chunked driver (chunk=1)."""
    init, run_chunk = _cached_chunk_fns(problem, opts, 1)
    state = init(x0, ())
    traj = []
    for _ in range(iters):
        state = run_chunk(state, ())
        traj.append(np.asarray(state.x))
    return traj


CASES = [
    ("rosenbrock", rosenbrock, rosenbrock_grad, rosenbrock_problem(),
     np.asarray(rosenbrock_start(4)), 30),
    ("ackley", ackley, ackley_grad, ackley_problem(),
     np.asarray(ackley_start()), 20),
]


@pytest.mark.parametrize("name,f,g,problem,x0,iters", CASES)
def test_wolfe_flavor_trajectory_parity(name, f, g, problem, x0, iters):
    f_np = lambda x: float(f(x))
    g_np = lambda x: np.asarray(g(x))
    ref = reference_lbfgs_wolfe(f_np, g_np, x0, m=16, iters=iters)
    opts = LBFGSOptions(max_iters=iters, tol=1e-14, m=16)
    ours = jitted_trajectory(problem, x0, opts, iters)
    for k, (a, b) in enumerate(zip(ours, ref)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12,
                                   err_msg=f"{name} iterate {k}")


@pytest.mark.parametrize("name,f,g,problem,x0,iters", CASES)
def test_armijo_flavor_trajectory_parity(name, f, g, problem, x0, iters):
    f_np = lambda x: float(f(x))
    g_np = lambda x: np.asarray(g(x))
    ref = reference_lbfgs_armijo(f_np, g_np, x0, m=16, iters=iters)
    opts = LBFGSOptions(max_iters=iters, tol=1e-14, m=16,
                        line_search="armijo", ls_max_iters=20)
    ours = jitted_trajectory(problem, x0, opts, iters)
    for k, (a, b) in enumerate(zip(ours, ref)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12,
                                   err_msg=f"{name} iterate {k}")
