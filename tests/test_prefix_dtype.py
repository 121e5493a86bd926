"""bf16 carried line prefix (LBFGSOptions.prefix_dtype / prefix_refresh).

The carried prefix (the MLP's A = x@W1+b1, types.LinePrefix) can be stored
narrow: every trial's (A, B) read, B's write, and the accept-time
A += alpha*B axpy halve their HBM traffic, while all arithmetic stays in
the solver dtype (the combine upcasts in registers). Storage rounding of
the accumulated A random-walks at ~sqrt(steps)*eps, so the solver
re-anchors it every ``prefix_refresh`` iterations by recomputing
A = init(x) exactly inside a lax.cond. No reference counterpart (the
reference has no carried prefix at all; its line-search trials re-run the
full forward, src/cuda/lbfgs.cuh:118-145).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_ffnn.objectives.mlp import mlp_init, mlp_problem, mlp_spec
from lbfgs_ffnn.solvers import LBFGSOptions, lbfgs
from lbfgs_ffnn.solvers.lbfgs import lbfgs_chunked


def _small(seed=7, n=256, d=16, c=4):
    rng = np.random.default_rng(seed)
    X = jnp.asarray(rng.normal(size=(n, d)), jnp.float32)
    Y = jax.nn.one_hot(jnp.asarray(rng.integers(0, c, n)), c,
                       dtype=jnp.float32)
    spec = mlp_spec([d, 32, c], ["relu", "linear"])
    w0 = mlp_init(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    return spec, w0, X, Y


@pytest.mark.parametrize("line_search", ["armijo", "wolfe"])
def test_lbfgs_prefix_dtype_trains(line_search):
    """Solver-level: the bf16 prefix converges to the f32 run's
    neighborhood (storage rounding perturbs trial values at bf16-eps level;
    the periodic exact re-anchor bounds the accumulated drift)."""
    spec, w0, X, Y = _small()
    opts = LBFGSOptions(max_iters=60, m=10, line_search=line_search)
    res_f = lbfgs(mlp_problem(spec), w0, (X, Y), opts)
    res_b = lbfgs(mlp_problem(spec), w0, (X, Y),
                  opts._replace(prefix_dtype="bfloat16"))
    assert float(res_b.final_loss) < 1.2 * float(res_f.final_loss) + 1e-3


def test_prefix_refresh_noop_in_f32():
    """With the prefix in the solver dtype, a refresh recomputes (up to f32
    rounding) exactly the value the exact axpy carried — the trajectory
    must stay in the same neighborhood whether it refreshes or never does."""
    spec, w0, X, Y = _small(seed=9)
    base = LBFGSOptions(max_iters=40, m=8, line_search="armijo")
    r0 = lbfgs(mlp_problem(spec), w0, (X, Y), base)
    r1 = lbfgs(mlp_problem(spec), w0, (X, Y), base._replace(prefix_refresh=3))
    np.testing.assert_allclose(float(r1.final_loss), float(r0.final_loss),
                               rtol=0.2, atol=1e-4)


def test_prefix_refresh_reanchors_exactly():
    """prefix_refresh=1: after every iteration the carried state must hold
    round(init(x_k)) BITWISE — proving the lax.cond actually recomputes the
    prefix from the fresh iterate rather than accumulating axpys."""
    spec, w0, X, Y = _small(seed=11)
    prob = mlp_problem(spec)
    opts = LBFGSOptions(max_iters=6, m=4, line_search="armijo",
                        prefix_dtype="bfloat16", prefix_refresh=1)
    seen = []
    _res, _t = lbfgs_chunked(prob, w0, (X, Y), opts, chunk=2,
                             callback=lambda s, t: seen.append(s))
    assert seen, "callback never fired"
    for s in seen:
        assert s.prefix.dtype == jnp.bfloat16
        expect = prob.line_prefix.init(s.x, (X, Y)).astype(jnp.bfloat16)
        np.testing.assert_array_equal(
            np.asarray(s.prefix, np.float32), np.asarray(expect, np.float32)
        )


def test_prefix_dtype_drift_stays_bounded_without_refresh():
    """prefix_refresh=0 disables the re-anchor: the run must still train
    (drift is a random walk at bf16-eps scale — visible, not fatal, at
    dozens of iterations)."""
    spec, w0, X, Y = _small(seed=13)
    opts = LBFGSOptions(max_iters=40, m=8, line_search="armijo",
                        prefix_dtype="bfloat16", prefix_refresh=0)
    res = lbfgs(mlp_problem(spec), w0, (X, Y), opts)
    f0 = float(mlp_problem(spec).fun(w0, (X, Y)))
    assert float(res.final_loss) < 0.3 * f0


def test_prefix_dtype_counters_unchanged():
    """The refresh is a prefix recompute, not an objective evaluation —
    n_fevals/n_gevals accounting must match the exact-counter policy (one
    vag at accept + counted trials), same as the f32 path's structure."""
    spec, w0, X, Y = _small(seed=15)
    opts = LBFGSOptions(max_iters=25, m=6, line_search="armijo",
                        prefix_dtype="bfloat16", prefix_refresh=4)
    res = lbfgs(mlp_problem(spec), w0, (X, Y), opts)
    k = int(res.n_iters)
    # armijo lean: per iteration >=1 trial + 1 accept vag; +1 each at init
    assert int(res.n_gevals) == k + 1
    assert int(res.n_fevals) >= k + 1


def test_prefix_dtype_param_sharded():
    """Mesh mode: the padded LinePrefix adapters pass the narrow prefix
    through unchanged; the sharded solve trains like the f32 one."""
    from lbfgs_ffnn.parallel.mesh import make_mesh

    mesh8 = make_mesh(axis_name="model")
    spec, w0, X, Y = _small(seed=17)
    opts = LBFGSOptions(max_iters=15, m=4, line_search="armijo",
                        two_loop_impl="compact",
                        pair_dtype="bfloat16", prefix_dtype="bfloat16")
    res_f = lbfgs(mlp_problem(spec), w0, (X, Y),
                  opts._replace(pair_dtype=None, prefix_dtype=None))
    res_b = lbfgs(mlp_problem(spec), w0, (X, Y), opts, mesh=mesh8)
    assert float(res_b.final_loss) < 1.3 * float(res_f.final_loss) + 1e-3


def test_prefix_dtype_chunked_resume(tmp_path):
    """Kill-and-resume with a narrow prefix: the resume path recomputes the
    prefix from the restored iterate AND casts it back to storage dtype
    (a stale or f32-shaped prefix would poison every subsequent trial)."""
    spec, w0, X, Y = _small(seed=19)
    prob = mlp_problem(spec, grad_input_dtype="bfloat16")
    opts = LBFGSOptions(max_iters=30, m=6, line_search="armijo",
                        prefix_dtype="bfloat16")
    snap = {}
    lbfgs_chunked(prob, w0, (X, Y), opts._replace(max_iters=10), chunk=5,
                  callback=lambda s, t: snap.update(s=s))
    res, _ = lbfgs_chunked(prob, None, (X, Y), opts, chunk=5,
                           resume_state=snap["s"])
    full, _ = lbfgs_chunked(prob, w0, (X, Y), opts, chunk=5)
    assert int(res.n_iters) == int(full.n_iters) == 30
    np.testing.assert_allclose(float(res.final_loss),
                               float(full.final_loss), rtol=0.5, atol=1e-3)
