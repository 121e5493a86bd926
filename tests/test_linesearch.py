"""Line search unit tests."""

import jax
import jax.numpy as jnp
import numpy as np

from lbfgs_ffnn.ops.linesearch import armijo_quad_line_search, wolfe_line_search


def quad_vag(center, scale=1.0):
    def vag(w, aux=()):
        f = 0.5 * scale * jnp.sum((w - center) ** 2)
        g = scale * (w - center)
        return f, g

    return vag


def test_wolfe_satisfies_conditions_on_quadratic():
    c = jnp.array([1.0, -2.0, 3.0])
    vag = quad_vag(c)
    x = jnp.zeros(3)
    f0, g0 = vag(x)
    p = -g0
    dg0 = jnp.vdot(g0, p)
    res = wolfe_line_search(vag, x, p, f0, dg0)
    assert bool(res.ok)
    a = float(res.alpha)
    f_new, g_new = vag(x + a * p)
    # Armijo
    assert float(f_new) <= float(f0) + 1e-4 * a * float(dg0)
    # Curvature
    assert float(jnp.vdot(g_new, p)) >= 0.9 * float(dg0)
    # returned f/g match the accepted point
    np.testing.assert_allclose(float(res.f_new), float(f_new))


def test_wolfe_expands_small_steps():
    """On a wide quadratic, alpha=1 fails curvature and the bracket expands."""
    c = jnp.array([100.0])
    vag = quad_vag(c, scale=0.001)
    x = jnp.zeros(1)
    f0, g0 = vag(x)
    p = -g0
    res = wolfe_line_search(vag, x, p, f0, jnp.vdot(g0, p))
    assert bool(res.ok)
    assert float(res.alpha) > 1.0


def test_armijo_accepts_unit_step_on_nice_quadratic():
    c = jnp.array([0.5, 0.5])
    vag = quad_vag(c)
    x = jnp.zeros(2)
    f0, g0 = vag(x)
    p = -g0
    res = armijo_quad_line_search(vag, x, p, f0, jnp.vdot(g0, p))
    assert bool(res.ok)
    assert float(res.alpha) == 1.0


def test_armijo_backtracks_on_steep_function():
    """Quartic where the full step overshoots badly: alpha must shrink and the
    quadratic-interpolation safeguard must keep it in (0, 1)."""

    def vag(w, aux=()):
        f = jnp.sum(w**4)
        return f, 4.0 * w**3

    x = jnp.array([2.0])
    f0, g0 = vag(x)
    p = -g0  # huge step
    res = armijo_quad_line_search(vag, x, p, f0, jnp.vdot(g0, p))
    assert bool(res.ok)
    assert 0.0 < float(res.alpha) < 1.0
    # the returned evaluation corresponds to the accepted alpha
    f_chk, _ = vag(x + res.alpha * p)
    np.testing.assert_allclose(float(res.f_new), float(f_chk))


def test_wolfe_value_only_matches_fused():
    """jvp-based trials (value=) must reproduce the fused Wolfe search: the
    directional derivative from jvp equals g·p, so accept/expand/bisect
    decisions — and therefore alpha, ok, f/g — are identical (f64)."""

    def val(w, aux=()):
        return jnp.sum(w**4) + 0.1 * jnp.sum(w**2)

    def vag(w, aux=()):
        return val(w), 4.0 * w**3 + 0.2 * w

    # analytic grad differs from autodiff only in rounding; use autodiff for
    # both so the comparison isolates the trial-mode difference
    vag_ad = jax.value_and_grad(val)

    for x0, scale in ((jnp.array([2.0, -1.0]), 1.0), (jnp.array([0.05]), 100.0)):
        f0, g0 = vag_ad(x0)
        p = -scale * g0
        dg0 = jnp.vdot(g0, p)
        fused = wolfe_line_search(lambda w, aux=(): vag_ad(w), x0, p, f0, dg0)
        lean = wolfe_line_search(
            lambda w, aux=(): vag_ad(w), x0, p, f0, dg0, value=val
        )
        assert bool(fused.ok) == bool(lean.ok)
        np.testing.assert_allclose(float(fused.alpha), float(lean.alpha), rtol=1e-12)
        if bool(fused.ok):
            np.testing.assert_allclose(float(fused.f_new), float(lean.f_new), rtol=1e-12)
            np.testing.assert_allclose(
                np.asarray(fused.g_new), np.asarray(lean.g_new), rtol=1e-12
            )


def test_lbfgs_value_only_matches_fused_end_to_end():
    """Full L-BFGS solves with ls_value_only on/off must produce the same
    trajectory for both line-search flavors (small MLP, f64)."""
    from lbfgs_ffnn.objectives.mlp import mlp_init, mlp_problem, mlp_spec
    from lbfgs_ffnn.solvers import LBFGSOptions, lbfgs

    spec = mlp_spec([6, 8, 3], ["relu", "linear"])
    prob = mlp_problem(spec)
    key = jax.random.PRNGKey(0)
    w0 = mlp_init(spec, key, dtype=jnp.float64)
    x = jax.random.normal(jax.random.PRNGKey(1), (32, 6), dtype=jnp.float64)
    y = jax.nn.one_hot(jnp.arange(32) % 3, 3, dtype=jnp.float64)

    for flavor in ("wolfe", "armijo"):
        res = {}
        for lean in (False, True):
            opts = LBFGSOptions(max_iters=30, tol=1e-12, m=5,
                                line_search=flavor, ls_value_only=lean)
            res[lean] = lbfgs(prob, w0, aux=(x, y), opts=opts)
        assert int(res[True].n_iters) == int(res[False].n_iters), flavor
        np.testing.assert_allclose(
            np.asarray(res[True].x), np.asarray(res[False].x),
            rtol=1e-9, err_msg=flavor,
        )
        np.testing.assert_allclose(
            float(res[True].final_loss), float(res[False].final_loss),
            rtol=1e-9, err_msg=flavor,
        )


def test_armijo_value_only_matches_fused():
    """Forward-only trials (value=) must reproduce the fused variant's trial
    sequence exactly: same alpha, same ok, same returned f/g — including on a
    backtracking-heavy quartic and on the accept-at-alpha0 quadratic."""

    def vag(w, aux=()):
        return jnp.sum(w**4), 4.0 * w**3

    def val(w, aux=()):
        return jnp.sum(w**4)

    for x0 in (jnp.array([2.0]), jnp.array([0.1, -0.2])):
        f0, g0 = vag(x0)
        p = -g0
        dg0 = jnp.vdot(g0, p)
        fused = armijo_quad_line_search(vag, x0, p, f0, dg0)
        lean = armijo_quad_line_search(vag, x0, p, f0, dg0, value=val)
        assert bool(fused.ok) == bool(lean.ok)
        np.testing.assert_allclose(float(fused.alpha), float(lean.alpha), rtol=1e-12)
        np.testing.assert_allclose(float(fused.f_new), float(lean.f_new), rtol=1e-12)
        np.testing.assert_allclose(
            np.asarray(fused.g_new), np.asarray(lean.g_new), rtol=1e-12
        )


def test_armijo_value_only_failure_keeps_last_trial():
    def vag(w, aux=()):
        return jnp.sum(w**4), 4.0 * w**3

    x = jnp.array([2.0])
    f0, g0 = vag(x)
    p = -g0
    res = armijo_quad_line_search(
        vag, x, p, f0, jnp.vdot(g0, p), max_iters=1, value=lambda w, aux=(): jnp.sum(w**4)
    )
    assert not bool(res.ok)
    f_chk, g_chk = vag(x + res.alpha * p)
    np.testing.assert_allclose(float(res.f_new), float(f_chk))
    np.testing.assert_allclose(np.asarray(res.g_new), np.asarray(g_chk))


def test_armijo_batched_matches_sequential_backtracking():
    """The batched ladder must accept exactly the alpha a sequential pure
    backtracking loop (no interpolation) would, for several spec_k values
    and both accept-fast and backtrack-heavy cases."""
    from lbfgs_ffnn.ops.linesearch import armijo_batched_line_search

    def val(w, aux=()):
        return jnp.sum(w**4)

    def vag(w, aux=()):
        return val(w), 4.0 * w**3

    c1, shrink, max_iters = 1e-4, 0.5, 20
    for x0 in (np.array([2.0]), np.array([0.1, -0.2]), np.array([5.0, 5.0])):
        xj = jnp.asarray(x0)
        f0, g0 = vag(xj)
        p = -g0
        dg0 = float(jnp.vdot(g0, p))

        # numpy mirror of sequential pure backtracking
        a = 1.0
        ok_ref = False
        for _ in range(max_iters):
            if float(val(xj + a * p)) <= float(f0) + c1 * a * dg0:
                ok_ref = True
                break
            a *= shrink

        for k in (1, 3, 4, 7):
            res = armijo_batched_line_search(
                vag, xj, p, f0, jnp.vdot(g0, p), value=val,
                c1=c1, shrink=shrink, max_iters=max_iters, spec_k=k,
            )
            assert bool(res.ok) == ok_ref, (x0, k)
            if ok_ref:
                np.testing.assert_allclose(float(res.alpha), a, rtol=1e-6)
            f_chk, g_chk = vag(xj + res.alpha * p)
            np.testing.assert_allclose(float(res.f_new), float(f_chk))
            np.testing.assert_allclose(np.asarray(res.g_new), np.asarray(g_chk))


def test_lbfgs_armijo_batched_trains():
    from lbfgs_ffnn.objectives.mlp import mlp_init, mlp_problem, mlp_spec
    from lbfgs_ffnn.solvers import LBFGSOptions, lbfgs

    spec = mlp_spec([6, 8, 3], ["relu", "linear"])
    prob = mlp_problem(spec)
    w0 = mlp_init(spec, jax.random.PRNGKey(0), dtype=jnp.float64)
    x = jax.random.normal(jax.random.PRNGKey(1), (32, 6), dtype=jnp.float64)
    y = jax.nn.one_hot(jnp.arange(32) % 3, 3, dtype=jnp.float64)

    res_b = lbfgs(prob, w0, aux=(x, y),
                  opts=LBFGSOptions(max_iters=40, tol=1e-12, m=5,
                                    line_search="armijo_batched", ls_spec_k=4))
    res_a = lbfgs(prob, w0, aux=(x, y),
                  opts=LBFGSOptions(max_iters=40, tol=1e-12, m=5,
                                    line_search="armijo"))
    # converges to a comparable loss (policies differ, trajectories may too)
    assert float(res_b.final_loss) < 0.1
    assert float(res_b.final_loss) < 3.0 * float(res_a.final_loss) + 1e-6
    # counters present and coherent: >= one candidate + 1 v&g per iteration
    assert int(res_b.n_fevals) >= int(res_b.n_iters) * 2
    assert int(res_b.n_gevals) == int(res_b.n_iters) + 1


def test_eval_counters():
    """SolveResult.n_fevals/n_gevals count objective and gradient passes.
    On a well-scaled quadratic every search accepts its first trial, so the
    counts are exact: init 1/1, then per iteration armijo-lean adds
    (trial + final v&g) = 2 fevals / 1 geval, wolfe-fused adds 1/1."""
    from lbfgs_ffnn.types import make_problem
    from lbfgs_ffnn.solvers import LBFGSOptions, lbfgs

    prob = make_problem(lambda w, aux: 0.5 * jnp.sum((w - 1.0) ** 2))
    x0 = jnp.zeros(4, dtype=jnp.float64)

    res_a = lbfgs(prob, x0, opts=LBFGSOptions(max_iters=10, tol=0.0, m=3,
                                              line_search="armijo"))
    k = int(res_a.n_iters)
    assert int(res_a.n_fevals) == 1 + 2 * k
    assert int(res_a.n_gevals) == 1 + k

    res_w = lbfgs(prob, x0, opts=LBFGSOptions(max_iters=10, tol=0.0, m=3,
                                              line_search="wolfe"))
    k = int(res_w.n_iters)
    assert int(res_w.n_fevals) == 1 + k
    assert int(res_w.n_gevals) == 1 + k

    # Same exact accounting in GD (+LS), BFGS and Newton on the quadratic.
    from lbfgs_ffnn.solvers import (
        BFGSOptions, GDOptions, NewtonOptions, bfgs, gradient_descent, newton,
    )

    for res in (
        gradient_descent(prob, x0, opts=GDOptions(max_iters=10, tol=0.0)),
        bfgs(prob, x0, opts=BFGSOptions(max_iters=10, tol=0.0)),
        newton(prob, x0, opts=NewtonOptions(max_iters=10, tol=0.0)),
    ):
        k = int(res.n_iters)
        assert int(res.n_fevals) == 1 + k, type(res)
        assert int(res.n_gevals) == 1 + k


def test_armijo_failure_keeps_last_trial():
    """If no trial passes (max_iters tiny on a hard function), result carries
    the last *evaluated* alpha with ok=False — the reference CUDA solver keeps
    that trial point and resets history (src/cuda/lbfgs.cuh:142-147)."""

    def vag(w, aux=()):
        return jnp.sum(w**4), 4.0 * w**3

    x = jnp.array([2.0])
    f0, g0 = vag(x)
    p = -g0
    res = armijo_quad_line_search(vag, x, p, f0, jnp.vdot(g0, p), max_iters=1)
    assert not bool(res.ok)
    assert bool(res.evaluated)
    f_chk, _ = vag(x + res.alpha * p)
    np.testing.assert_allclose(float(res.f_new), float(f_chk))
