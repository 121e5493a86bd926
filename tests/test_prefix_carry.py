"""Accept-eval prefix carry (LinePrefix.vag_restrict_carry).

The armijo-family accept evaluation computes the post-step prefix
z1 = A + alpha*B for its own forward (and the relu backward keeps it as a
residual); handing it back through ``LineSearchResult.carry`` lets the
solver reuse it as the next carried prefix, deleting the separate
accept-time A += alpha*B axpy (read A, read B, write A over (batch, d1))
from every iteration. Same arithmetic expression, so the carried value —
and the whole trajectory — is unchanged. No reference counterpart (the
reference has no carried prefix; src/cuda/lbfgs.cuh:118-147 re-runs the
full forward per trial).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_ffnn.objectives.mlp import mlp_init, mlp_problem, mlp_spec
from lbfgs_ffnn.solvers import LBFGSOptions, lbfgs
from lbfgs_ffnn.solvers.lbfgs import lbfgs_chunked
from lbfgs_ffnn.types import LinePrefix, make_problem


def _small(seed=7, n=256, d=16, c=4):
    rng = np.random.default_rng(seed)
    X = jnp.asarray(rng.normal(size=(n, d)), jnp.float32)
    Y = jax.nn.one_hot(jnp.asarray(rng.integers(0, c, n)), c,
                       dtype=jnp.float32)
    spec = mlp_spec([d, 32, c], ["relu", "linear"])
    w0 = mlp_init(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    return spec, w0, X, Y


def _strip_carry(prob):
    return prob._replace(
        line_prefix=prob.line_prefix._replace(vag_restrict_carry=None)
    )


def test_mlp_vag_restrict_carry_values():
    """The carry variant returns the SAME (loss, grad) as vag_restrict plus
    P_new == A + alpha*B bitwise."""
    spec, w, X, Y = _small()
    prob = mlp_problem(spec)
    lp = prob.line_prefix
    p = 0.1 * jax.random.normal(jax.random.PRNGKey(1), w.shape, jnp.float32)
    A = lp.init(w, (X, Y))
    B = lp.direction(p, (X, Y))
    alpha = jnp.float32(0.37)
    f1, g1 = lp.vag_restrict(A, B, w, p, (X, Y))(alpha)
    f2, g2, P_new = lp.vag_restrict_carry(A, B, w, p, (X, Y))(alpha)
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
    np.testing.assert_array_equal(np.asarray(g1), np.asarray(g2))
    np.testing.assert_array_equal(np.asarray(P_new), np.asarray(A + alpha * B))


@pytest.mark.parametrize("line_search", ["armijo", "armijo_batched"])
def test_carry_trajectory_identical(line_search):
    """Reusing the accept eval's prefix must not change the trajectory:
    identical final loss / iterate / counters vs the explicit-axpy path
    (the expression is the same; only the HBM traffic differs)."""
    spec, w0, X, Y = _small(seed=9)
    prob = mlp_problem(spec)
    opts = LBFGSOptions(max_iters=50, tol=1e-12, m=8,
                        line_search=line_search)
    r_on = lbfgs(prob, w0, (X, Y), opts)
    r_off = lbfgs(_strip_carry(prob), w0, (X, Y), opts)
    assert int(r_on.n_fevals) == int(r_off.n_fevals)
    assert int(r_on.n_gevals) == int(r_off.n_gevals)
    np.testing.assert_allclose(float(r_on.final_loss),
                               float(r_off.final_loss), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(r_on.x), np.asarray(r_off.x),
                               rtol=1e-4, atol=1e-6)


def test_carry_actually_used_sentinel():
    """Prove the solver installs ls.carry as the new prefix (not the axpy):
    a custom LinePrefix whose carry variant returns a sentinel (P + 42)
    must surface that sentinel in the carried state."""
    spec, w0, X, Y = _small(seed=11)
    prob = mlp_problem(spec)
    lp = prob.line_prefix

    def carry_sentinel(P, B, w, p, aux, _v=lp.vag_restrict):
        inner = _v(P, B, w, p, aux)

        def call(alpha):
            f, g = inner(alpha)
            return f, g, (P + alpha * B) + 42.0

        return call

    prob_s = prob._replace(
        line_prefix=lp._replace(vag_restrict_carry=carry_sentinel)
    )
    opts = LBFGSOptions(max_iters=2, tol=1e-12, m=4, line_search="armijo")
    seen = []
    lbfgs_chunked(prob_s, w0, (X, Y), opts, chunk=1,
                  callback=lambda s, t: seen.append(s))
    assert seen
    # after 1 iteration the state prefix should be ~42 above the true one
    s1 = seen[0]
    true_prefix = lp.init(s1.x, (X, Y))
    diff = np.asarray(s1.prefix) - np.asarray(true_prefix)
    np.testing.assert_allclose(diff, 42.0, atol=1e-3)


def test_wolfe_keeps_axpy_path():
    """Wolfe ignores the carry variant (its accept eval may not run at the
    final alpha on failure); stripping the carry must leave the wolfe
    trajectory untouched AND both must train."""
    spec, w0, X, Y = _small(seed=13)
    prob = mlp_problem(spec)
    opts = LBFGSOptions(max_iters=30, tol=1e-12, m=8, line_search="wolfe")
    r_on = lbfgs(prob, w0, (X, Y), opts)
    r_off = lbfgs(_strip_carry(prob), w0, (X, Y), opts)
    np.testing.assert_array_equal(np.asarray(r_on.x), np.asarray(r_off.x))


def test_carry_param_sharded():
    """Mesh mode: the padded carry adapter threads P_new through; the
    sharded run matches the unsharded one."""
    from lbfgs_ffnn.parallel.mesh import make_mesh

    spec, w0, X, Y = _small(seed=17)
    prob = mlp_problem(spec)
    opts = LBFGSOptions(max_iters=12, tol=1e-12, m=4, line_search="armijo")
    r1 = lbfgs(prob, w0, (X, Y), opts)
    rm = lbfgs(prob, w0, (X, Y), opts, mesh=make_mesh(axis_name="model"))
    np.testing.assert_allclose(float(rm.final_loss), float(r1.final_loss),
                               rtol=1e-4, atol=1e-7)


def test_carry_with_bf16_prefix_matches_axpy_rounding():
    """carry + prefix_dtype='bfloat16': the carry is cast to storage dtype
    exactly like the axpy's result would be — state prefix stays bf16 and
    the run trains."""
    spec, w0, X, Y = _small(seed=19)
    prob = mlp_problem(spec)
    opts = LBFGSOptions(max_iters=6, tol=1e-12, m=4, line_search="armijo",
                        prefix_dtype="bfloat16", prefix_refresh=0)
    seen = []
    lbfgs_chunked(prob, w0, (X, Y), opts, chunk=3,
                  callback=lambda s, t: seen.append(s))
    assert seen and seen[-1].prefix.dtype == jnp.bfloat16
