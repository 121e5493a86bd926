"""Edge-case coverage: degenerate history sizes, tiny batches, intervals
larger than the epoch, single-sample datasets."""

import jax
import jax.numpy as jnp
import numpy as np

from lbfgs_ffnn.objectives.analytic import rosenbrock_problem, rosenbrock_start
from lbfgs_ffnn.objectives.mlp import mlp_batch_problem, mlp_init, mlp_spec
from lbfgs_ffnn.solvers import (
    LBFGSOptions,
    SGDOptions,
    SLBFGSOptions,
    lbfgs,
    sgd,
    slbfgs,
)

ROSEN = rosenbrock_problem()
SPEC = mlp_spec([8, 6, 3], ["relu", "linear"])


def _data(n=40):
    kx, ky = jax.random.split(jax.random.PRNGKey(0))
    x = jax.random.normal(kx, (n, 8), dtype=jnp.float32)
    y = jax.nn.one_hot(jax.random.randint(ky, (n,), 0, 3), 3, dtype=jnp.float32)
    return x, y


def test_lbfgs_m1_history():
    # m=1 is essentially memoryless: slow on Rosenbrock's valley but must
    # still make deep progress (reaches loss ~1e-13 in 4000 iters).
    res = lbfgs(ROSEN, rosenbrock_start(4), opts=LBFGSOptions(max_iters=4000, tol=1e-12, m=1))
    assert float(res.final_loss) <= 1e-10
    np.testing.assert_allclose(np.asarray(res.x), np.ones(4), atol=1e-5)


def test_lbfgs_max_iters_zero_returns_start():
    x0 = rosenbrock_start(4)
    res = lbfgs(ROSEN, x0, opts=LBFGSOptions(max_iters=0 + 1, tol=1e30))
    # tol already satisfied: no iterations performed
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(x0))
    assert int(res.n_iters) == 0 and bool(res.converged)


def test_sgd_batch_size_one():
    x, y = _data()
    bp = mlp_batch_problem(SPEC)
    w0 = mlp_init(SPEC, jax.random.PRNGKey(1))
    res = sgd(bp, w0, x, y, SGDOptions(epochs=2, batch_size=1, step_size=0.01))
    assert bool(jnp.isfinite(res.final_loss))


def test_slbfgs_L_exceeds_inner_steps():
    """L > m_inner: the curvature update never fires; pure SVRG-SGD."""
    x, y = _data()
    bp = mlp_batch_problem(SPEC)
    w0 = mlp_init(SPEC, jax.random.PRNGKey(2))
    opts = SLBFGSOptions(epochs=3, m_inner=4, L=10, history=5,
                         batch_size=8, step_size=0.05)
    res = slbfgs(bp, w0, x, y, opts)
    assert float(res.final_loss) < float(bp.fun(w0, x, y))


def test_slbfgs_hvp_batch_larger_than_dataset():
    x, y = _data(16)
    bp = mlp_batch_problem(SPEC)
    w0 = mlp_init(SPEC, jax.random.PRNGKey(3))
    opts = SLBFGSOptions(epochs=2, m_inner=6, L=2, history=4,
                         batch_size=8, hvp_batch_size=999, step_size=0.05)
    res = slbfgs(bp, w0, x, y, opts)
    assert bool(jnp.isfinite(res.final_loss))


def test_slbfgs_history_one():
    x, y = _data()
    bp = mlp_batch_problem(SPEC)
    w0 = mlp_init(SPEC, jax.random.PRNGKey(4))
    opts = SLBFGSOptions(epochs=3, m_inner=8, L=2, history=1,
                         batch_size=8, step_size=0.05)
    res = slbfgs(bp, w0, x, y, opts)
    assert float(res.final_loss) < float(bp.fun(w0, x, y))
