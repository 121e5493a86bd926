"""Out-of-core (host-resident dataset) evaluation: trajectory parity with
the in-HBM solvers.

Gate (VERDICT r2 item 3): L-BFGS and S-LBFGS run with the dataset
artificially capped out of device memory — a ChunkStore serving
device-sized pieces through io_callback — and match the in-HBM f64
trajectories up to chunked-summation rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np

from lbfgs_ffnn.data.datasets import load_mnist
from lbfgs_ffnn.data.outofcore import ChunkStore, outofcore_problem
from lbfgs_ffnn.objectives.mlp import (
    mlp_batch_problem, mlp_init, mlp_problem, mlp_spec,
)
from lbfgs_ffnn.solvers import LBFGSOptions, SLBFGSOptions, lbfgs, slbfgs

SPEC = mlp_spec([784, 16, 10], ["relu", "linear"])
DS = load_mnist(train_size=400, test_size=64)
X = jnp.asarray(DS.train_x, dtype=jnp.float64)
Y = jnp.asarray(DS.train_y, dtype=jnp.float64)
W0 = mlp_init(SPEC, jax.random.PRNGKey(123), dtype=jnp.float64)
# 96 rows per chunk over N=400: 5 chunks, ragged 16-row tail — the device-
# resident slice is < 1/4 of the dataset ("artificially capped out of HBM").
STORE = ChunkStore(np.asarray(X), np.asarray(Y), chunk_rows=96)


def test_outofcore_problem_matches_in_hbm():
    bp = mlp_batch_problem(SPEC)
    prob = outofcore_problem(bp, STORE)
    f_ref, g_ref = bp.value_and_grad(W0, X, Y)
    np.testing.assert_allclose(float(prob.fun(W0, ())), float(f_ref), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(prob.grad(W0, ())), np.asarray(g_ref), rtol=1e-10, atol=1e-14
    )
    f, g = prob.value_and_grad(W0, ())
    np.testing.assert_allclose(float(f), float(f_ref), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-10, atol=1e-14)


def test_outofcore_problem_with_regularizer():
    bp = mlp_batch_problem(SPEC, lam=1e-3)
    prob = outofcore_problem(bp, STORE)
    f_ref, g_ref = bp.value_and_grad(W0, X, Y)
    f, g = prob.value_and_grad(W0, ())
    np.testing.assert_allclose(float(f), float(f_ref), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-10, atol=1e-14)


def test_lbfgs_outofcore_trajectory_parity():
    """Full L-BFGS solve over the host-resident dataset == the in-HBM run
    (fused-trial policy on both sides: the out-of-core problem exposes no
    line restriction)."""
    opts = LBFGSOptions(max_iters=12, tol=1e-14, m=5,
                        prefix_vag=False, ls_value_only=False)
    ref = lbfgs(mlp_problem(SPEC), W0, aux=(X, Y), opts=opts)
    prob = outofcore_problem(mlp_batch_problem(SPEC), STORE)
    res = lbfgs(prob, W0, aux=(), opts=opts)
    assert int(res.n_iters) == int(ref.n_iters) == 12
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x), rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(res.loss_history[:12]), np.asarray(ref.loss_history[:12]),
        rtol=1e-10,
    )
    assert int(res.n_fevals) == int(ref.n_fevals)  # same trial sequence


def test_outofcore_mlp_lean_trials_parity():
    """VERDICT r4 item 6: the out-of-core MLP problem with the carried
    (N, d1) line prefix — every trial device-resident — matches the in-HBM
    lean run's f64 trajectory AND its exact trial accounting (same lean
    policy both sides), for both line-search families."""
    from lbfgs_ffnn.data.outofcore import outofcore_mlp_problem

    for ls in ("armijo", "wolfe"):
        opts = LBFGSOptions(max_iters=12, tol=1e-14, m=5, line_search=ls,
                            prefix_vag=False)
        ref = lbfgs(mlp_problem(SPEC), W0, aux=(X, Y), opts=opts)
        res = lbfgs(outofcore_mlp_problem(SPEC, STORE), W0, aux=(), opts=opts)
        assert int(res.n_iters) == int(ref.n_iters) == 12, ls
        np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                                   rtol=1e-9)
        np.testing.assert_allclose(
            np.asarray(res.loss_history[:12]),
            np.asarray(ref.loss_history[:12]), rtol=1e-10,
        )
        # identical trial sequence and lean accounting (trials + 1 accept
        # value_and_grad per iteration)
        assert int(res.n_fevals) == int(ref.n_fevals), ls
        assert int(res.n_gevals) == int(ref.n_gevals), ls


def test_outofcore_mlp_lean_trials_with_regularizer():
    from lbfgs_ffnn.data.outofcore import outofcore_mlp_problem

    opts = LBFGSOptions(max_iters=8, tol=1e-14, m=4, line_search="armijo",
                        prefix_vag=False)
    ref = lbfgs(mlp_problem(SPEC, lam=1e-3), W0, aux=(X, Y), opts=opts)
    res = lbfgs(outofcore_mlp_problem(SPEC, STORE, lam=1e-3), W0, aux=(),
                opts=opts)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x), rtol=1e-9)
    assert int(res.n_fevals) == int(ref.n_fevals)


def test_slbfgs_outofcore_trajectory_parity():
    """The flagship with the SVRG anchor accumulated over chunks and
    minibatches gathered host-side: identical index streams, trajectory
    matches the in-HBM run."""
    opts = SLBFGSOptions(epochs=3, tol=1e-12, history=4, L=3,
                         batch_size=64, step_size=0.05)
    bp = mlp_batch_problem(SPEC, lam=1e-4)
    ref = slbfgs(bp, W0, X, Y, opts)
    res = slbfgs(bp, W0, None, None, opts, store=STORE)
    assert int(res.n_iters) == int(ref.n_iters)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x), rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(res.loss_history[:3]), np.asarray(ref.loss_history[:3]),
        rtol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(res.gnorm_history[:3]), np.asarray(ref.gnorm_history[:3]),
        rtol=1e-9,
    )


def test_slbfgs_store_guardrails():
    import pytest

    bp = mlp_batch_problem(SPEC)
    with pytest.raises(ValueError, match="x=y=None"):
        slbfgs(bp, W0, X, Y, SLBFGSOptions(epochs=1), store=STORE)
    with pytest.raises(ValueError, match="metric_fn"):
        slbfgs(bp, W0, None, None,
               SLBFGSOptions(epochs=1, metric_fn=lambda w, x, y: 0.0),
               store=STORE)
