"""Deterministic-solver convergence gates on the classic test functions.

Mirrors the reference suite's solvers x objectives cross-product and its
convergence tolerances (reference: tests/main.cpp:260-283 — BFGS, LBFGS,
BFGS+GMRES, Newton on Rosenbrock n=4 / Ackley n=3 / Rastrigin n=500), but as
real assertions (the reference's check() macro is compiled out under -DNDEBUG,
so its gates never actually fire in the default build).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_ffnn.objectives.analytic import (
    ackley_problem,
    ackley_start,
    rastrigin_problem,
    rastrigin_start,
    rosenbrock_grad,
    rosenbrock_problem,
    rosenbrock_start,
)
from lbfgs_ffnn.solvers import (
    BFGSOptions,
    GDOptions,
    LBFGSOptions,
    NewtonOptions,
    bfgs,
    gradient_descent,
    lbfgs,
    newton,
)

ROSEN = rosenbrock_problem()
ACKLEY = ackley_problem()
RASTRIGIN = rastrigin_problem()


def run(solver_name, problem, x0, max_iters, tol):
    if solver_name == "lbfgs":
        return lbfgs(problem, x0, opts=LBFGSOptions(max_iters=max_iters, tol=tol, m=16))
    if solver_name == "lbfgs_armijo":
        return lbfgs(
            problem, x0,
            opts=LBFGSOptions(max_iters=max_iters, tol=tol, m=16,
                              line_search="armijo", ls_max_iters=20),
        )
    if solver_name == "bfgs":
        return bfgs(problem, x0, opts=BFGSOptions(max_iters=max_iters, tol=tol))
    if solver_name == "bfgs_gmres":
        return bfgs(
            problem, x0,
            opts=BFGSOptions(max_iters=max_iters, tol=tol, linear_solver="gmres"),
        )
    if solver_name == "bfgs_cg":
        return bfgs(
            problem, x0,
            opts=BFGSOptions(max_iters=max_iters, tol=tol, linear_solver="cg"),
        )
    if solver_name == "newton":
        return newton(problem, x0, opts=NewtonOptions(max_iters=max_iters, tol=tol))
    raise ValueError(solver_name)


SOLVERS = ["lbfgs", "lbfgs_armijo", "bfgs", "bfgs_gmres", "newton"]


@pytest.mark.parametrize("solver", SOLVERS)
def test_rosenbrock(solver):
    """Gate from reference tests/main.cpp:144-155: tol 1e-12, ||g|| <= 1e-10,
    x within 1e-8 of the all-ones minimum."""
    x0 = rosenbrock_start(4)
    res = run(solver, ROSEN, x0, max_iters=4000, tol=1e-12)
    g = rosenbrock_grad(res.x)
    assert float(jnp.linalg.norm(g)) <= 1e-10, f"{solver}: ||g||={jnp.linalg.norm(g)}"
    np.testing.assert_allclose(np.asarray(res.x), np.ones(4), atol=1e-8)


@pytest.mark.parametrize("solver", SOLVERS)
def test_ackley(solver):
    """Gate from reference tests/main.cpp:250-257: tol 1e-10, ||g|| <= 1e-9."""
    x0 = ackley_start()
    res = run(solver, ACKLEY, x0, max_iters=4000, tol=1e-10)
    assert float(res.final_gnorm) <= 1e-9, f"{solver}: ||g||={res.final_gnorm}"


@pytest.mark.parametrize("solver", ["lbfgs", "newton"])
def test_rastrigin_large(solver):
    """Gate from reference tests/main.cpp:57-64: n=500, tol 1e-9, ||g|| <= 1e-8."""
    x0 = rastrigin_start(500)
    res = run(solver, RASTRIGIN, x0, max_iters=5000, tol=1e-9)
    assert float(res.final_gnorm) <= 1e-8, f"{solver}: ||g||={res.final_gnorm}"


def test_bfgs_rastrigin_small():
    """Dense-B BFGS on a smaller Rastrigin (full 500x500 B is exercised by the
    harness benchmarks; keep unit tests quick)."""
    x0 = rastrigin_start(50)
    res = run("bfgs", RASTRIGIN, x0, max_iters=5000, tol=1e-9)
    assert float(res.final_gnorm) <= 1e-8


def test_gd_line_search_rosenbrock_descends():
    x0 = rosenbrock_start(4)
    res = gradient_descent(
        ROSEN, x0, opts=GDOptions(max_iters=200, tol=1e-12, use_line_search=True)
    )
    f0 = float(ROSEN.fun(x0, ()))
    assert float(res.final_loss) < 1e-2 * f0


def test_gd_momentum_runs():
    x0 = rosenbrock_start(4)
    res = gradient_descent(
        ROSEN, x0,
        opts=GDOptions(max_iters=500, tol=1e-12, step_size=1e-3, momentum=0.9,
                       use_line_search=False),
    )
    f0 = float(ROSEN.fun(x0, ()))
    assert float(res.final_loss) < f0


def test_history_is_recorded():
    x0 = rosenbrock_start(4)
    res = lbfgs(ROSEN, x0, opts=LBFGSOptions(max_iters=4000, tol=1e-12, m=16))
    n = int(res.n_iters)
    hist = np.asarray(res.loss_history)
    assert np.all(np.isfinite(hist[:n]))
    assert np.all(np.isnan(hist[n:]))
    # loss decreases overall
    assert hist[n - 1] < hist[0]


def test_autodiff_gradients_match_analytic():
    """The reference cross-checks AD vs analytic derivatives
    (tests/autodiff_tests.cpp); same check via jax.grad."""
    import jax

    for prob_fn, start in [
        (rosenbrock_problem, rosenbrock_start(6)),
        (ackley_problem, ackley_start()),
        (rastrigin_problem, rastrigin_start(20)),
    ]:
        p_analytic = prob_fn(analytic=True)
        p_ad = prob_fn(analytic=False)
        g1 = p_analytic.grad(start, ())
        g2 = p_ad.grad(start, ())
        np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-9, atol=1e-9)


def test_lbfgs_solves_with_autodiff_gradients():
    """Reference autodiff_tests runs the solvers with AD gradients; gate the
    same combination here."""
    prob = rosenbrock_problem(analytic=False)
    res = lbfgs(prob, rosenbrock_start(4), opts=LBFGSOptions(max_iters=4000, tol=1e-12))
    assert float(res.final_gnorm) <= 1e-10


def test_lbfgs_chunked_matches_while_loop():
    """The chunked driver must reproduce the while_loop run exactly and
    return measured cumulative times."""
    from lbfgs_ffnn.solvers.lbfgs import lbfgs_chunked

    x0 = rosenbrock_start(4)
    opts = LBFGSOptions(max_iters=200, tol=1e-12, m=16)
    res_wl = lbfgs(ROSEN, x0, opts=opts)
    chunks_seen = []
    res_ch, time_ms = lbfgs_chunked(
        ROSEN, x0, opts=opts, chunk=16,
        callback=lambda s, e: chunks_seen.append(int(s.k)),
    )
    np.testing.assert_allclose(np.asarray(res_ch.x), np.asarray(res_wl.x), rtol=1e-12)
    assert int(res_ch.n_iters) == int(res_wl.n_iters)
    n = int(res_ch.n_iters)
    t = np.asarray(time_ms)
    assert np.all(np.isfinite(t[:n]))
    assert np.all(np.diff(t[:n]) >= 0)  # cumulative
    assert len(chunks_seen) >= 1


def test_relative_curvature_gate():
    """Scale-invariant curvature gate converges like the absolute one on the
    standard suite (and is the robust f32 option)."""
    x0 = rosenbrock_start(4)
    res = lbfgs(
        ROSEN, x0,
        opts=LBFGSOptions(max_iters=4000, tol=1e-12, m=16, curvature_rel_eps=1e-8),
    )
    assert float(res.final_gnorm) <= 1e-10
