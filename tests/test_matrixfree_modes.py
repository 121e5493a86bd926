"""Matrix-free solver modes: Newton-CG (hvp_cg) and factor-form BFGS.

These are the matrix-free answers to two reference capabilities:
  * the reference's sparse BFGS instantiation ``BFGS<V, SparseMatrix,
    ConjugateGradient>`` (reference: src/minimizer/bfgs.hpp:11-14) — here
    ``BFGSOptions(storage="factors")`` never materializes B and solves with
    CG/GMRES over rank-2 factor matvecs;
  * the reference Newton's explicit HessFun requirement
    (reference: src/minimizer/newton.hpp:25) — here the *default* dense
    ``jax.hessian`` refuses MLP-sized problems and points at
    ``NewtonOptions(hess_mode="hvp_cg")``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_ffnn.objectives.analytic import rosenbrock_problem, rosenbrock_start
from lbfgs_ffnn.solvers import BFGSOptions, NewtonOptions, bfgs, newton
from lbfgs_ffnn.types import DENSE_HESSIAN_LIMIT, make_problem


def test_default_dense_hessian_guard_raises_for_large_n():
    prob = make_problem(lambda w, aux: 0.5 * jnp.vdot(w, w))
    w_big = jnp.zeros(DENSE_HESSIAN_LIMIT + 1)
    with pytest.raises(ValueError, match="hvp_cg"):
        prob.hess(w_big, ())
    # small n still works
    h = prob.hess(jnp.zeros(4), ())
    np.testing.assert_allclose(np.asarray(h), np.eye(4), atol=1e-12)


def test_newton_requires_hess_only_in_dense_mode():
    prob = make_problem(lambda w, aux: 0.5 * jnp.vdot(w, w))._replace(hess=None)
    with pytest.raises(ValueError, match="requires problem.hess"):
        newton(prob, jnp.ones(4), opts=NewtonOptions(max_iters=2))


def test_newton_hvp_cg_matches_dense_on_rosenbrock():
    prob = rosenbrock_problem()
    x0 = rosenbrock_start(4)
    dense = newton(prob, x0, opts=NewtonOptions(max_iters=200, tol=1e-10))
    mf = newton(
        prob, x0,
        opts=NewtonOptions(max_iters=200, tol=1e-10, hess_mode="hvp_cg",
                           cg_tol=1e-14, cg_max_iters=400),
    )
    assert float(mf.final_gnorm) <= 1e-8
    np.testing.assert_allclose(np.asarray(mf.x), np.ones(4), atol=1e-6)
    np.testing.assert_allclose(np.asarray(mf.x), np.asarray(dense.x), atol=1e-6)


def test_newton_hvp_cg_on_mlp_scale_problem():
    """Matrix-free Newton runs where the dense default would refuse: an MLP
    objective whose autodiff Hessian is guarded (hess=None equivalent)."""
    from lbfgs_ffnn.objectives.mlp import mlp_init, mlp_problem, mlp_spec

    spec = mlp_spec([8, 16, 4], ["tanh", "linear"])
    prob = mlp_problem(spec)
    w0 = mlp_init(spec, jax.random.PRNGKey(0), dtype=jnp.float64)
    x = jax.random.normal(jax.random.PRNGKey(1), (32, 8), dtype=jnp.float64)
    y = jax.nn.one_hot(jnp.arange(32) % 4, 4, dtype=jnp.float64)
    f0 = float(prob.fun(w0, (x, y)))
    res = newton(
        prob, w0, aux=(x, y),
        opts=NewtonOptions(max_iters=25, tol=1e-12, hess_mode="hvp_cg"),
    )
    assert float(res.final_loss) < 0.25 * f0
    assert np.isfinite(np.asarray(res.x)).all()


def test_bfgs_factors_matches_dense_trajectory():
    """Factor storage is the same algorithm: identical rank-2 update summed
    exactly, so the trajectory matches the dense-B run."""
    prob = rosenbrock_problem()
    x0 = rosenbrock_start(4)
    dense = bfgs(
        prob, x0, opts=BFGSOptions(max_iters=120, tol=1e-10, linear_solver="cg")
    )
    mf = bfgs(
        prob, x0,
        opts=BFGSOptions(max_iters=120, tol=1e-10, linear_solver="cg",
                         storage="factors"),
    )
    assert int(mf.n_iters) == int(dense.n_iters)
    np.testing.assert_allclose(np.asarray(mf.x), np.asarray(dense.x), rtol=1e-7)
    np.testing.assert_allclose(
        np.asarray(mf.loss_history[: int(mf.n_iters)]),
        np.asarray(dense.loss_history[: int(dense.n_iters)]),
        rtol=1e-6,
    )


def test_bfgs_factors_gmres_converges():
    prob = rosenbrock_problem()
    x0 = rosenbrock_start(4)
    res = bfgs(
        prob, x0,
        opts=BFGSOptions(max_iters=300, tol=1e-10, linear_solver="gmres",
                         storage="factors"),
    )
    np.testing.assert_allclose(np.asarray(res.x), np.ones(4), atol=1e-5)


def test_cg_counted_exact_counts():
    """Counter exactness at both ends: CG on an SPD matrix with k distinct
    eigenvalues converges in exactly k iterations (= k matvecs from x0=0),
    and an unconverged run counts exactly maxiter."""
    from lbfgs_ffnn.ops.iterative import cg_counted

    d = jnp.concatenate([
        jnp.full((20,), 1.0), jnp.full((20,), 3.0), jnp.full((10,), 7.0)
    ])
    b = jnp.arange(1.0, 51.0)
    x, k = cg_counted(lambda v: d * v, b, tol=1e-10, maxiter=100)
    np.testing.assert_allclose(np.asarray(x), np.asarray(b / d), rtol=1e-9)
    assert int(k) == 3
    _, k_cap = cg_counted(lambda v: d * v, b, tol=0.0, maxiter=17)
    assert int(k_cap) == 17


def test_gmres_counted_exact_counts():
    """Each restart cycle costs restart+1 matvecs; an unconverged run with
    maxiter cycles counts exactly maxiter*(restart+1)."""
    from lbfgs_ffnn.ops.iterative import gmres_counted

    rng = np.random.default_rng(0)
    A = jnp.asarray(rng.normal(size=(30, 30)) + 6.0 * np.eye(30))
    b = jnp.asarray(rng.normal(size=(30,)))
    x, nmv = gmres_counted(lambda v: A @ v, b, tol=1e-12, maxiter=50, restart=10)
    np.testing.assert_allclose(np.asarray(A @ x), np.asarray(b), atol=1e-8)
    assert int(nmv) % 11 == 0 and int(nmv) > 0
    _, nmv_cap = gmres_counted(lambda v: A @ v, b, tol=0.0, maxiter=3, restart=10)
    assert int(nmv_cap) == 3 * 11


def test_newton_hvp_cg_counter_exact():
    """On f = 0.5 w^T D w with D = diag having 4 distinct eigenvalues, every
    Newton iteration performs one damping trial whose CG converges in exactly
    4 HVPs, so n_hevals == 4 * n_iters."""
    d = jnp.asarray([1.0, 2.0, 2.0, 4.0, 4.0, 9.0])
    prob = make_problem(lambda w, aux: 0.5 * jnp.vdot(w, d * w))._replace(hess=None)
    res = newton(
        prob, jnp.ones(6),
        opts=NewtonOptions(max_iters=50, tol=1e-10, hess_mode="hvp_cg",
                           cg_tol=1e-12, cg_max_iters=50),
    )
    assert bool(res.converged)
    assert int(res.n_hevals) == 4 * int(res.n_iters)
    # dense mode reports zero HVPs
    dense = newton(
        make_problem(lambda w, aux: 0.5 * jnp.vdot(w, d * w)), jnp.ones(6),
        opts=NewtonOptions(max_iters=50, tol=1e-10),
    )
    assert int(dense.n_hevals) == 0


def test_bfgs_matvec_counters():
    """Krylov matvec accounting: zero under the direct solver; in factors
    mode at least (1 CG step + 1 update matvec) per iteration and bounded by
    the per-iteration cap; dense-cg counts the same linear solves."""
    prob = rosenbrock_problem()
    x0 = rosenbrock_start(4)
    direct = bfgs(prob, x0, opts=BFGSOptions(max_iters=60, tol=1e-10))
    assert int(direct.n_matvecs) == 0
    opts = BFGSOptions(max_iters=60, tol=1e-10, linear_solver="cg",
                       storage="factors", solver_max_iters=200)
    mf = bfgs(prob, x0, opts=opts)
    it = int(mf.n_iters)
    # Krylov applications only — the rank-2 update's B s is deliberately
    # uncounted so factors and dense-iterative agree on identical work.
    assert it <= int(mf.n_matvecs) <= it * 200
    gm = bfgs(prob, x0, opts=opts._replace(linear_solver="gmres"))
    assert int(gm.n_matvecs) >= 2 * int(gm.n_iters)


def test_bfgs_factors_rejects_direct_solver():
    with pytest.raises(ValueError, match="iterative"):
        bfgs(
            rosenbrock_problem(), rosenbrock_start(4),
            opts=BFGSOptions(storage="factors", linear_solver="direct"),
        )
