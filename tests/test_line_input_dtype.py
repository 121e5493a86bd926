"""line_input_dtype="bfloat16": the prepared narrow input copy feeds the
line-restriction GEMMs (B = x @ W1_p per iteration, A init/refresh,
line_fun).

The products differ from the f32 read's by one bf16 rounding of x; on the
CPU test backend the dot units are true f32, so values shift by exactly one
bf16 rounding of x — these tests pin the structure (prepare created, narrow
read actually used, full-width prefix dtype) and bound the value drift.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_ffnn.objectives.mlp import mlp_init, mlp_problem, mlp_spec
from lbfgs_ffnn.solvers import LBFGSOptions, lbfgs
from lbfgs_ffnn.solvers.lbfgs import lbfgs_chunked
from lbfgs_ffnn.types import prepared_aux


def _setup(d_in=9, d1=6, d_out=3, n=64, seed=0):
    spec = mlp_spec([d_in, d1, d_out], ["relu", "linear"])
    w = mlp_init(spec, jax.random.PRNGKey(seed), dtype=jnp.float32)
    p = 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 1), w.shape,
                                dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(seed + 2), (n, d_in),
                          dtype=jnp.float32)
    y = jax.random.normal(jax.random.PRNGKey(seed + 3), (n, d_out),
                          dtype=jnp.float32)
    return spec, w, p, x, y


def test_line_input_prepare_and_prefix_dtype():
    """prepare builds ONE narrow copy; the prefix stays full width (the
    narrow x upcasts inside the dot, preferred_element_type = param dtype)."""
    spec, w, p, x, y = _setup()
    prob = mlp_problem(spec, line_input_dtype="bfloat16")
    assert prob.prepare is not None
    paux = prepared_aux(prob, (x, y))
    assert len(paux) == 3 and paux[2].dtype == jnp.bfloat16
    lp = prob.line_prefix
    A = lp.init(w, paux)
    B = lp.direction(p, paux)
    assert A.dtype == jnp.float32 and B.dtype == jnp.float32


def test_line_input_values_within_operand_rounding():
    """Trial values through the narrow read match the f32 problem to bf16
    operand-rounding of x."""
    spec, w, p, x, y = _setup()
    prob_f = mlp_problem(spec)
    prob_l = mlp_problem(spec, line_input_dtype="bfloat16")
    paux = prepared_aux(prob_l, (x, y))
    lpf, lpl = prob_f.line_prefix, prob_l.line_prefix
    va_f = lpf.restrict(lpf.init(w, (x, y)), lpf.direction(p, (x, y)),
                        w, p, (x, y))
    va_l = lpl.restrict(lpl.init(w, paux), lpl.direction(p, paux),
                        w, p, paux)
    for alpha in (0.0, 0.5, 1.0):
        np.testing.assert_allclose(float(va_l(jnp.float32(alpha))),
                                   float(va_f(jnp.float32(alpha))),
                                   rtol=2e-2)
    # the oracle: restricting an mlp whose x was bf16-rounded up front
    x_r = x.astype(jnp.bfloat16).astype(jnp.float32)
    va_o = lpf.restrict(lpf.init(w, (x_r, y)), lpf.direction(p, (x_r, y)),
                        w, p, (x_r, y))
    # A/B from the narrow read == A/B from pre-rounded f32 x (the dot
    # upcasts bf16 exactly), so the restriction values agree to f32 ulps.
    np.testing.assert_allclose(float(va_l(jnp.float32(0.7))),
                               float(va_o(jnp.float32(0.7))), rtol=1e-6)


def test_line_input_full_batch_fun_stays_raw():
    """fun/value_and_grad still read raw f32 x — bitwise equal to the
    plain problem (only the restriction GEMMs go narrow)."""
    spec, w, p, x, y = _setup()
    prob_f = mlp_problem(spec)
    prob_l = mlp_problem(spec, line_input_dtype="bfloat16")
    paux = prepared_aux(prob_l, (x, y))
    np.testing.assert_array_equal(np.asarray(prob_l.fun(w, paux)),
                                  np.asarray(prob_f.fun(w, (x, y))))


def test_line_input_solver_trains():
    """Solver-level: converges to the same neighborhood as f32, alone and
    stacked with grad_input + prefix_dtype + bf16 ring."""
    rng = np.random.default_rng(7)
    X = jnp.asarray(rng.normal(size=(256, 16)), jnp.float32)
    Y = jax.nn.one_hot(jnp.asarray(rng.integers(0, 4, 256)), 4,
                       dtype=jnp.float32)
    spec = mlp_spec([16, 32, 4], ["relu", "linear"])
    w0 = mlp_init(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    opts = LBFGSOptions(max_iters=60, m=10)
    res_f = lbfgs(mlp_problem(spec), w0, (X, Y), opts)
    res_l = lbfgs(mlp_problem(spec, line_input_dtype="bfloat16"),
                  w0, (X, Y), opts)
    assert float(res_l.final_loss) < 1.15 * float(res_f.final_loss) + 1e-3
    res_all = lbfgs(
        mlp_problem(spec, line_input_dtype="bfloat16",
                    grad_input_dtype="bfloat16"),
        w0, (X, Y),
        LBFGSOptions(max_iters=60, m=10, line_search="armijo",
                     pair_dtype="bfloat16", prefix_dtype="bfloat16"),
    )
    assert float(res_all.final_loss) < 1.5 * float(res_f.final_loss) + 1e-2


def test_line_input_dtype_mismatch_raises():
    spec = mlp_spec([4, 3, 2], ["relu", "linear"])
    with pytest.raises(ValueError, match="must match"):
        mlp_problem(spec, grad_input_dtype="bfloat16",
                    line_input_dtype="float16")


def test_line_input_caller_aux_not_misread():
    """A plain problem handed a 3-element aux must NOT treat aux[2] as the
    narrow copy (the guard keys on line_input_dtype, not on aux length)."""
    spec, w, p, x, y = _setup()
    prob = mlp_problem(spec)  # no narrow options
    sentinel = jnp.full_like(x, jnp.nan).astype(jnp.bfloat16)
    lp = prob.line_prefix
    A = lp.init(w, (x, y, sentinel))
    assert bool(jnp.all(jnp.isfinite(A)))


def test_line_input_chunked_resume_reinit_uses_prepared_aux():
    """lbfgs_chunked resume re-derives the carried prefix through PREPARED
    aux (the bf16 copy), matching the in-run prefix to f32 ulps — a raw-f32
    re-init would shift every subsequent trial by one operand rounding
    (regression: the re-init once read aux[0] directly)."""
    rng = np.random.default_rng(3)
    X = jnp.asarray(rng.normal(size=(128, 16)), jnp.float32)
    Y = jax.nn.one_hot(jnp.asarray(rng.integers(0, 4, 128)), 4,
                       dtype=jnp.float32)
    spec = mlp_spec([16, 32, 4], ["relu", "linear"])
    w0 = mlp_init(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    opts = LBFGSOptions(max_iters=20, m=5, line_search="armijo", tol=1e-12)
    prob = mlp_problem(spec, line_input_dtype="bfloat16")
    states = []
    res_a, _ = lbfgs_chunked(prob, w0, aux=(X, Y), opts=opts, chunk=5,
                             callback=lambda s, t: states.append(s))
    res_b, _ = lbfgs_chunked(prob, None, aux=(X, Y), opts=opts, chunk=5,
                             resume_state=states[1])
    # f32-ulp agreement (the exact-recompute-vs-carried-drift bound);
    # the raw-f32 re-init regression showed ~1e-4 here.
    assert abs(float(res_a.final_loss) - float(res_b.final_loss)) < 1e-6


def test_line_input_launcher_end_to_end():
    from lbfgs_ffnn.data.datasets import load_mnist
    from lbfgs_ffnn.launcher import Launcher, UnifiedConfig

    ds = load_mnist(train_size=256, test_size=64)
    l = (Launcher("cuda").add_layer(784, 16, "relu")
         .add_layer(16, 10, "linear").build_network().set_data(ds))
    rep = l.train("lbfgs", UnifiedConfig(
        name="LI", max_iters=15, m_param=5, log_interval=1,
        line_input_dtype="bfloat16"), verbose=False)
    assert float(rep.result.final_loss) < 1.0
