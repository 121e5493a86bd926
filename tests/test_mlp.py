"""MLP objective unit tests: shapes, gradients, parity conventions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_ffnn.objectives.mlp import (
    evaluate,
    mlp_apply,
    mlp_batch_problem,
    mlp_init,
    mlp_problem,
    mlp_spec,
)

SPEC = mlp_spec([12, 8, 4], ["relu", "linear"])


def _data(key, n=32, spec=SPEC, dtype=jnp.float32):
    kx, ky = jax.random.split(key)
    x = jax.random.normal(kx, (n, spec.dims[0]), dtype=dtype)
    labels = jax.random.randint(ky, (n,), 0, spec.dims[-1])
    y = jax.nn.one_hot(labels, spec.dims[-1], dtype=dtype)
    return x, y


def test_param_count():
    # (12*8 + 8) + (8*4 + 4) = 104 + 36 = 140
    assert SPEC.n_params == 140
    w = mlp_init(SPEC, jax.random.PRNGKey(0))
    assert w.shape == (140,)


def test_forward_shape_and_determinism():
    w = mlp_init(SPEC, jax.random.PRNGKey(1))
    x, _ = _data(jax.random.PRNGKey(2))
    out = mlp_apply(SPEC, w, x)
    assert out.shape == (32, 4)
    out2 = mlp_apply(SPEC, w, x)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(out2))
    # seeded init is reproducible
    w2 = mlp_init(SPEC, jax.random.PRNGKey(1))
    np.testing.assert_array_equal(np.asarray(w), np.asarray(w2))


def test_bias_init_conventions():
    """CPU reference randomizes biases (network.hpp:64-69); CUDA zeroes them
    (cuda/network.cuh:52-53)."""
    spec = mlp_spec([4, 3], ["linear"])
    w_zero = mlp_init(spec, jax.random.PRNGKey(0), bias_init="zeros")
    b = w_zero[4 * 3 :]
    np.testing.assert_array_equal(np.asarray(b), np.zeros(3, np.float32))
    w_rand = mlp_init(spec, jax.random.PRNGKey(0), bias_init="random")
    assert float(jnp.sum(jnp.abs(w_rand[4 * 3 :]))) > 0


def test_grad_matches_finite_differences():
    spec = mlp_spec([5, 6, 3], ["tanh", "linear"])
    w = mlp_init(spec, jax.random.PRNGKey(3), dtype=jnp.float64)
    x, y = _data(jax.random.PRNGKey(4), n=8, spec=spec, dtype=jnp.float64)
    prob = mlp_problem(spec)
    g = prob.grad(w, (x, y))
    eps = 1e-6
    rng = np.random.default_rng(0)
    for _ in range(10):
        i = rng.integers(0, spec.n_params)
        e = jnp.zeros_like(w).at[i].set(eps)
        fd = (prob.fun(w + e, (x, y)) - prob.fun(w - e, (x, y))) / (2 * eps)
        np.testing.assert_allclose(float(g[i]), float(fd), rtol=1e-5, atol=1e-8)


def test_exact_hvp_matches_fd_hvp():
    """The exact jvp HVP replaces the reference's central-difference HVP
    (s_lbfgs.hpp:88-101); both must agree to FD accuracy."""
    spec = mlp_spec([5, 6, 3], ["tanh", "linear"])
    w = mlp_init(spec, jax.random.PRNGKey(5), dtype=jnp.float64)
    x, y = _data(jax.random.PRNGKey(6), n=16, spec=spec, dtype=jnp.float64)
    bp = mlp_batch_problem(spec, lam=1e-4)
    v = jax.random.normal(jax.random.PRNGKey(7), w.shape, dtype=jnp.float64)
    h_exact = bp.hvp(w, v, x, y)
    h_fd = bp.fd_hvp(w, v, x, y, eps=1e-5)
    np.testing.assert_allclose(np.asarray(h_exact), np.asarray(h_fd), rtol=1e-4, atol=1e-6)


def test_masked_loss_equals_subset_loss():
    spec = mlp_spec([5, 3], ["linear"])
    w = mlp_init(spec, jax.random.PRNGKey(8), dtype=jnp.float64)
    x, y = _data(jax.random.PRNGKey(9), n=10, spec=spec, dtype=jnp.float64)
    bp = mlp_batch_problem(spec)
    mask = jnp.array([1.0] * 6 + [0.0] * 4, dtype=jnp.float64)
    l_masked = bp.fun_masked(w, x, y, mask)
    l_subset = bp.fun(w, x[:6], y[:6])
    np.testing.assert_allclose(float(l_masked), float(l_subset), rtol=1e-12)
    g_masked = bp.grad_masked(w, x, y, mask)
    g_subset = bp.grad(w, x[:6], y[:6])
    np.testing.assert_allclose(np.asarray(g_masked), np.asarray(g_subset), rtol=1e-10)


def test_l2_regularization():
    spec = mlp_spec([5, 3], ["linear"])
    w = mlp_init(spec, jax.random.PRNGKey(10), dtype=jnp.float64)
    x, y = _data(jax.random.PRNGKey(11), n=10, spec=spec, dtype=jnp.float64)
    lam = 1e-3
    bp0 = mlp_batch_problem(spec)
    bp1 = mlp_batch_problem(spec, lam=lam)
    np.testing.assert_allclose(
        float(bp1.fun(w, x, y)),
        float(bp0.fun(w, x, y)) + 0.5 * lam * float(jnp.vdot(w, w)),
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(bp1.grad(w, x, y)),
        np.asarray(bp0.grad(w, x, y) + lam * w),
        rtol=1e-10, atol=1e-12,
    )


def test_evaluate_reports_accuracy_and_mse():
    spec = mlp_spec([4, 2], ["linear"])
    # identity-ish weights so argmax is predictable
    # W is (in=4, out=2) row-major: W[0,0] -> flat 0, W[1,1] -> flat 3
    w = jnp.zeros(spec.n_params).at[0].set(1.0).at[3].set(1.0)
    x = jnp.array([[3.0, 0, 0, 0], [0, 3.0, 0, 0]])
    y = jnp.array([[1.0, 0.0], [0.0, 1.0]])
    out = evaluate(spec, w, x, y)
    assert out["accuracy"] == 100.0
    assert out["n"] == 2


def test_bf16_compute_mode_close_to_f32():
    """bf16 matmul operands with f32 accumulation: loss/grad within bf16
    tolerance of the f32 path, and training still converges."""
    spec = mlp_spec([16, 8, 4], ["relu", "linear"])
    w = mlp_init(spec, jax.random.PRNGKey(20), dtype=jnp.float32)
    x, y = _data(jax.random.PRNGKey(21), n=32, spec=spec, dtype=jnp.float32)
    p32 = mlp_problem(spec)
    pbf = mlp_problem(spec, compute_dtype=jnp.bfloat16)
    l32 = float(p32.fun(w, (x, y)))
    lbf = float(pbf.fun(w, (x, y)))
    assert abs(l32 - lbf) / max(abs(l32), 1e-6) < 0.05
    g32 = p32.grad(w, (x, y))
    gbf = pbf.grad(w, (x, y))
    assert gbf.dtype == g32.dtype == jnp.float32
    cos = float(jnp.vdot(g32, gbf) / (jnp.linalg.norm(g32) * jnp.linalg.norm(gbf)))
    assert cos > 0.99


def test_mlp_line_fun_matches_full_objective():
    """The affine-first-layer line restriction must agree with
    fun(w + alpha*p) for several alphas (f64: tight; the trick is exact up
    to rounding)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from lbfgs_ffnn.objectives.mlp import mlp_init, mlp_problem, mlp_spec

    for lam in (0.0, 1e-4):
        spec = mlp_spec([7, 5, 3], ["relu", "linear"])
        prob = mlp_problem(spec, lam=lam)
        key = jax.random.PRNGKey(0)
        w = mlp_init(spec, key, dtype=jnp.float64)
        p = jax.random.normal(jax.random.PRNGKey(1), w.shape, dtype=jnp.float64)
        x = jax.random.normal(jax.random.PRNGKey(2), (16, 7), dtype=jnp.float64)
        y = jax.random.normal(jax.random.PRNGKey(3), (16, 3), dtype=jnp.float64)
        restriction = prob.line_fun(w, p, (x, y))
        for alpha in (0.0, 1.0, 0.37, 2.5):
            a = jnp.float64(alpha)
            np.testing.assert_allclose(
                float(restriction(a)), float(prob.fun(w + a * p, (x, y))),
                rtol=1e-12,
            )
        # directional derivative via jvp of the restriction == g . p
        f, df = jax.jvp(restriction, (jnp.float64(0.2),), (jnp.float64(1.0),))
        g = prob.grad(w + 0.2 * p, (x, y))
        np.testing.assert_allclose(float(df), float(jnp.vdot(g, p)), rtol=1e-10)

    # single-layer network exercises the rest_spec=None branch
    spec1 = mlp_problem(mlp_spec([4, 2], ["linear"]))
    w1 = mlp_init(mlp_spec([4, 2], ["linear"]), jax.random.PRNGKey(0), dtype=jnp.float64)
    p1 = jax.random.normal(jax.random.PRNGKey(4), w1.shape, dtype=jnp.float64)
    x1 = jax.random.normal(jax.random.PRNGKey(5), (8, 4), dtype=jnp.float64)
    y1 = jax.random.normal(jax.random.PRNGKey(6), (8, 2), dtype=jnp.float64)
    r1 = spec1.line_fun(w1, p1, (x1, y1))
    np.testing.assert_allclose(
        float(r1(jnp.float64(0.7))), float(spec1.fun(w1 + 0.7 * p1, (x1, y1))),
        rtol=1e-12,
    )


def test_mlp_line_prefix_matches_line_fun_and_objective():
    """The carried-prefix protocol (init/direction/restrict) must agree with
    the per-call line_fun and the full objective, including after a
    simulated accepted step P += alpha*B (the solver-side update)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from lbfgs_ffnn.objectives.mlp import mlp_init, mlp_problem, mlp_spec

    spec = mlp_spec([7, 5, 3], ["relu", "linear"])
    prob = mlp_problem(spec)
    lp = prob.line_prefix
    assert lp is not None
    w = mlp_init(spec, jax.random.PRNGKey(0), dtype=jnp.float64)
    p = jax.random.normal(jax.random.PRNGKey(1), w.shape, dtype=jnp.float64)
    aux = (
        jax.random.normal(jax.random.PRNGKey(2), (16, 7), dtype=jnp.float64),
        jax.random.normal(jax.random.PRNGKey(3), (16, 3), dtype=jnp.float64),
    )
    P = lp.init(w, aux)
    B = lp.direction(p, aux)
    va = lp.restrict(P, B, w, p, aux)
    for a in (0.0, 1.0, 0.37):
        np.testing.assert_allclose(
            float(va(jnp.float64(a))), float(prob.fun(w + a * p, aux)), rtol=1e-12
        )
        np.testing.assert_allclose(
            float(va(jnp.float64(a))),
            float(prob.line_fun(w, p, aux)(jnp.float64(a))), rtol=1e-12,
        )

    # simulate accepting alpha: w' = w + alpha*p, P' = P + alpha*B; a new
    # direction q restricted at P' must equal the objective at w' + b*q
    alpha = 0.6
    w2 = w + alpha * p
    P2 = jax.tree_util.tree_map(lambda x_, b_: x_ + alpha * b_, P, B)
    q = jax.random.normal(jax.random.PRNGKey(4), w.shape, dtype=jnp.float64)
    Bq = lp.direction(q, aux)
    va2 = lp.restrict(P2, Bq, w2, q, aux)
    for b in (0.25, 1.0):
        np.testing.assert_allclose(
            float(va2(jnp.float64(b))), float(prob.fun(w2 + b * q, aux)),
            rtol=1e-12,
        )


def test_mlp_problem_remat_grads_match():
    """remat=True must give the same loss and gradient (activations are
    recomputed, not stored — numerics identical up to reassociation)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from lbfgs_ffnn.objectives.mlp import mlp_init, mlp_problem, mlp_spec

    spec = mlp_spec([7, 6, 3], ["tanh", "linear"])
    plain = mlp_problem(spec)
    rem = mlp_problem(spec, remat=True)
    w = mlp_init(spec, jax.random.PRNGKey(0), dtype=jnp.float64)
    aux = (
        jax.random.normal(jax.random.PRNGKey(1), (16, 7), dtype=jnp.float64),
        jax.random.normal(jax.random.PRNGKey(2), (16, 3), dtype=jnp.float64),
    )
    f0, g0 = plain.value_and_grad(w, aux)
    f1, g1 = rem.value_and_grad(w, aux)
    np.testing.assert_allclose(float(f0), float(f1), rtol=1e-14)
    np.testing.assert_allclose(np.asarray(g0), np.asarray(g1), rtol=1e-12)


def test_mlp_vag_restrict_matches_autodiff():
    """The prefix-based value_and_grad (manual first-layer VJP) must equal
    jax.value_and_grad at w + alpha*p exactly (f64)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from lbfgs_ffnn.objectives.mlp import mlp_init, mlp_problem, mlp_spec

    for dims, acts, lam in (
        ([7, 5, 3], ["relu", "linear"], 0.0),
        ([7, 6, 4, 2], ["tanh", "sigmoid", "linear"], 1e-4),
        ([4, 2], ["linear"], 0.0),  # single layer: rest_spec=None branch
    ):
        spec = mlp_spec(dims, acts)
        prob = mlp_problem(spec, lam=lam)
        lp = prob.line_prefix
        w = mlp_init(spec, jax.random.PRNGKey(0), dtype=jnp.float64)
        p = jax.random.normal(jax.random.PRNGKey(1), w.shape, dtype=jnp.float64)
        aux = (
            jax.random.normal(jax.random.PRNGKey(2), (12, dims[0]), dtype=jnp.float64),
            jax.random.normal(jax.random.PRNGKey(3), (12, dims[-1]), dtype=jnp.float64),
        )
        vag = lp.vag_restrict(lp.init(w, aux), lp.direction(p, aux), w, p, aux)
        for a in (0.0, 0.37, 1.0):
            f_ref, g_ref = prob.value_and_grad(w + a * p, aux)
            f, g = vag(jnp.float64(a))
            np.testing.assert_allclose(float(f), float(f_ref), rtol=1e-13)
            np.testing.assert_allclose(
                np.asarray(g), np.asarray(g_ref), rtol=1e-11, atol=1e-14
            )


def test_mlp_remat_problem_has_no_vag_restrict():
    """remat=True must not attach vag_restrict (its backward stores the
    rest-layer activations, defeating the memory guarantee)."""
    from lbfgs_ffnn.objectives.mlp import mlp_problem, mlp_spec

    spec = mlp_spec([7, 5, 3], ["relu", "linear"])
    assert mlp_problem(spec).line_prefix.vag_restrict is not None
    assert mlp_problem(spec, remat=True).line_prefix.vag_restrict is None


def test_mlp_grad_input_dtype():
    """grad_input_dtype='bfloat16': Problem.prepare builds the narrow input
    copy once; vag_restrict's dW1 uses it (gradient within bf16 operand-
    rounding of the f32 one) while every forward/loss value stays EXACTLY
    the f32 path's (only the backward's input read is narrowed)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from lbfgs_ffnn.objectives.mlp import mlp_init, mlp_problem, mlp_spec
    from lbfgs_ffnn.types import prepared_aux

    spec = mlp_spec([9, 6, 3], ["relu", "linear"])
    prob_f = mlp_problem(spec)
    prob_b = mlp_problem(spec, grad_input_dtype="bfloat16")
    assert prob_f.prepare is None and prob_b.prepare is not None

    w = mlp_init(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    p = 0.1 * jax.random.normal(jax.random.PRNGKey(1), w.shape, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(2), (32, 9), dtype=jnp.float32)
    y = jax.random.normal(jax.random.PRNGKey(3), (32, 3), dtype=jnp.float32)
    aux = (x, y)
    paux = prepared_aux(prob_b, aux)
    assert len(paux) == 3 and paux[2].dtype == jnp.bfloat16

    # forward and trial values: bitwise-identical to the f32 problem
    np.testing.assert_array_equal(
        np.asarray(prob_b.fun(w, paux)), np.asarray(prob_f.fun(w, aux))
    )
    lpf, lpb = prob_f.line_prefix, prob_b.line_prefix
    va_f = lpf.restrict(lpf.init(w, aux), lpf.direction(p, aux), w, p, aux)
    va_b = lpb.restrict(lpb.init(w, paux), lpb.direction(p, paux), w, p, paux)
    np.testing.assert_array_equal(np.asarray(va_b(0.5)), np.asarray(va_f(0.5)))

    # accept-point gradient: dW1 from the bf16 copy, everything else exact
    vag_f = lpf.vag_restrict(lpf.init(w, aux), lpf.direction(p, aux), w, p, aux)
    vag_b = lpb.vag_restrict(lpb.init(w, paux), lpb.direction(p, paux), w, p, paux)
    f_f, g_f = vag_f(jnp.float32(0.5))
    f_b, g_b = vag_b(jnp.float32(0.5))
    np.testing.assert_array_equal(np.asarray(f_b), np.asarray(f_f))
    n1 = 9 * 6  # first-layer weight block: bf16 operand rounding only
    np.testing.assert_allclose(np.asarray(g_b[:n1]), np.asarray(g_f[:n1]),
                               rtol=2e-2, atol=2e-3)
    # bias + rest layers: untouched by the narrow read
    np.testing.assert_array_equal(np.asarray(g_b[n1:]), np.asarray(g_f[n1:]))


def test_lbfgs_grad_input_dtype_trains():
    """Solver-level: lbfgs with the narrow backward input read converges to
    the same neighborhood as the f32 run (the option perturbs only dW1 at
    operand-rounding level; line-search values are bitwise f32)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from lbfgs_ffnn.objectives.mlp import mlp_init, mlp_problem, mlp_spec
    from lbfgs_ffnn.solvers import LBFGSOptions, lbfgs

    rng = np.random.default_rng(7)
    X = jnp.asarray(rng.normal(size=(256, 16)), jnp.float32)
    Y = jax.nn.one_hot(jnp.asarray(rng.integers(0, 4, 256)), 4,
                       dtype=jnp.float32)
    spec = mlp_spec([16, 32, 4], ["relu", "linear"])
    w0 = mlp_init(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    opts = LBFGSOptions(max_iters=60, m=10)
    res_f = lbfgs(mlp_problem(spec), w0, (X, Y), opts)
    res_b = lbfgs(mlp_problem(spec, grad_input_dtype="bfloat16"), w0, (X, Y), opts)
    assert float(res_b.final_loss) < 1.15 * float(res_f.final_loss) + 1e-3
