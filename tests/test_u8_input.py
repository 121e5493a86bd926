"""uint8 pixel-quantized input copy: ``*_input_dtype="uint8"`` stores
round(x*255) as uint8 — a QUARTER of the f32 HBM read — and every consumer
GEMM computes dot(xq, .) * (1/255) with the int->float upcast exact
(integers <= 255 are exact in bf16 and f32).

For data exactly on the k/255 pixel grid (MNIST/Fashion), the u8 path's
products are mathematically x@W up to f32 rounding-order differences; these
tests pin the prepare contents, the 1/255 epilogue scaling in every
consumer, gradient parity, and solver-level convergence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_ffnn.objectives.mlp import mlp_init, mlp_problem, mlp_spec
from lbfgs_ffnn.solvers import LBFGSOptions, lbfgs
from lbfgs_ffnn.types import prepared_aux


def _pixel_setup(d_in=9, d1=6, d_out=3, n=64, seed=0):
    """Inputs exactly on the k/255 grid, like a real image dataset."""
    spec = mlp_spec([d_in, d1, d_out], ["relu", "linear"])
    w = mlp_init(spec, jax.random.PRNGKey(seed), dtype=jnp.float32)
    p = 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 1), w.shape,
                                dtype=jnp.float32)
    pix = jax.random.randint(jax.random.PRNGKey(seed + 2), (n, d_in), 0, 256)
    x = (pix.astype(jnp.float32) / 255.0).astype(jnp.float32)
    y = jax.random.normal(jax.random.PRNGKey(seed + 3), (n, d_out),
                          dtype=jnp.float32)
    return spec, w, p, x, y, pix


def test_u8_prepare_contents_and_prefix_dtype():
    """prepare stores exactly the original pixel integers; the prefix comes
    out full width (param dtype) with the 1/255 scale already applied."""
    spec, w, p, x, y, pix = _pixel_setup()
    prob = mlp_problem(spec, line_input_dtype="uint8",
                       grad_input_dtype="uint8")
    paux = prepared_aux(prob, (x, y))
    assert paux[2].dtype == jnp.uint8
    np.testing.assert_array_equal(np.asarray(paux[2]),
                                  np.asarray(pix, dtype=np.uint8))
    A = prob.line_prefix.init(w, paux)
    assert A.dtype == jnp.float32


def test_u8_restriction_matches_f32_values():
    """Trial values through the u8 read match the raw-f32 problem to f32
    rounding (the scale rides the dot output; operands are exact ints)."""
    spec, w, p, x, y, _ = _pixel_setup()
    prob_f = mlp_problem(spec)
    prob_q = mlp_problem(spec, line_input_dtype="uint8")
    paux = prepared_aux(prob_q, (x, y))
    lpf, lpq = prob_f.line_prefix, prob_q.line_prefix
    va_f = lpf.restrict(lpf.init(w, (x, y)), lpf.direction(p, (x, y)),
                        w, p, (x, y))
    va_q = lpq.restrict(lpq.init(w, paux), lpq.direction(p, paux),
                        w, p, paux)
    for alpha in (0.0, 0.5, 1.0):
        np.testing.assert_allclose(float(va_q(jnp.float32(alpha))),
                                   float(va_f(jnp.float32(alpha))),
                                   rtol=1e-5)


def test_u8_gradient_parity():
    """vag_restrict's manually assembled first-layer gradient through the
    u8 read matches the autodiff gradient of the raw problem."""
    spec, w, p, x, y, _ = _pixel_setup()
    prob_f = mlp_problem(spec)
    prob_q = mlp_problem(spec, grad_input_dtype="uint8")
    paux = prepared_aux(prob_q, (x, y))
    lpq = prob_q.line_prefix
    A = lpq.init(w, paux)
    B = lpq.direction(p, paux)
    f_q, g_q = lpq.vag_restrict(A, B, w, p, paux)(jnp.float32(0.3))
    g_f = jax.grad(prob_f.fun)(w + 0.3 * p, (x, y))
    np.testing.assert_allclose(np.asarray(g_q), np.asarray(g_f),
                               rtol=2e-4, atol=1e-7)


def test_u8_offgrid_inputs_quantize_with_clip():
    """Inputs off the pixel grid clip to [0,1] and round to the grid — an
    explicit, documented lossy opt-in (never uint8 wraparound)."""
    spec = mlp_spec([4, 3, 2], ["relu", "linear"])
    prob = mlp_problem(spec, line_input_dtype="uint8")
    x = jnp.array([[-0.5, 0.004, 0.999, 1.7]], jnp.float32)
    y = jnp.zeros((1, 2), jnp.float32)
    paux = prepared_aux(prob, (x, y))
    np.testing.assert_array_equal(np.asarray(paux[2]),
                                  np.array([[0, 1, 255, 255]], np.uint8))


def test_u8_non_uint8_integer_rejected():
    spec = mlp_spec([4, 3, 2], ["relu", "linear"])
    with pytest.raises(ValueError, match="uint8"):
        mlp_problem(spec, line_input_dtype="int8")


def test_u8_solver_trains_and_stacks_with_bf16_prefix_ring():
    spec, w, p, x, y, _ = _pixel_setup(d_in=16, d1=32, d_out=4, n=256)
    opts = LBFGSOptions(max_iters=60, m=10, line_search="armijo")
    res_f = lbfgs(mlp_problem(spec), w, (x, y), opts)
    res_q = lbfgs(
        mlp_problem(spec, line_input_dtype="uint8",
                    grad_input_dtype="uint8"),
        w, (x, y),
        opts._replace(pair_dtype="bfloat16", prefix_dtype="bfloat16"),
    )
    assert float(res_q.final_loss) < 1.5 * float(res_f.final_loss) + 1e-2


def test_u8_fun_input_bitwise_on_grid_and_grad_parity():
    """fun_input_dtype="uint8": on-grid pixels make the quantized full
    objective agree with raw f32 to the ulp (CPU: exact int upcast, one
    rescale); the autodiff gradient through the narrow read matches too."""
    spec, w, p, x, y, _ = _pixel_setup()
    pf = mlp_problem(spec, lam=1e-4)
    pq = mlp_problem(spec, lam=1e-4, fun_input_dtype="uint8")
    paux = prepared_aux(pq, (x, y))
    np.testing.assert_allclose(float(pq.fun(w, paux)),
                               float(pf.fun(w, (x, y))), rtol=1e-6)
    gq = jax.grad(pq.fun)(w, paux)
    gf = jax.grad(pf.fun)(w, (x, y))
    np.testing.assert_allclose(np.asarray(gq), np.asarray(gf),
                               rtol=2e-4, atol=1e-7)
    # un-prepared 2-tuple aux falls back to the raw read, bitwise f32
    np.testing.assert_array_equal(np.asarray(pq.fun(w, (x, y))),
                                  np.asarray(pf.fun(w, (x, y))))


def test_u8_fun_input_remat_gradient():
    """remat composes with the narrow full objective (checkpointed backward
    recomputes through the same quantized read)."""
    spec, w, p, x, y, _ = _pixel_setup()
    pq = mlp_problem(spec, fun_input_dtype="uint8")
    pr = mlp_problem(spec, fun_input_dtype="uint8", remat=True)
    paux = prepared_aux(pq, (x, y))
    gq = jax.grad(pq.fun)(w, paux)
    gr = jax.grad(pr.fun)(w, prepared_aux(pr, (x, y)))
    np.testing.assert_allclose(np.asarray(gr), np.asarray(gq),
                               rtol=1e-6, atol=1e-8)


def test_u8_fun_input_gd_trains():
    from lbfgs_ffnn.solvers import GDOptions, gradient_descent

    spec, w, p, x, y, _ = _pixel_setup(d_in=16, d1=32, d_out=4, n=256)
    opts = GDOptions(max_iters=120, step_size=0.05, momentum=0.9,
                     tol=1e-12, use_line_search=False)
    res_f = gradient_descent(mlp_problem(spec), w, aux=(x, y), opts=opts)
    res_q = gradient_descent(mlp_problem(spec, fun_input_dtype="uint8"),
                             w, aux=(x, y), opts=opts)
    np.testing.assert_allclose(float(res_q.final_loss),
                               float(res_f.final_loss), rtol=1e-4)


def test_u8_fun_line_dtype_mismatch_raises():
    spec = mlp_spec([4, 3, 2], ["relu", "linear"])
    with pytest.raises(ValueError, match="must match"):
        mlp_problem(spec, line_input_dtype="bfloat16",
                    fun_input_dtype="uint8")


def test_u8_launcher_end_to_end():
    from lbfgs_ffnn.data.datasets import load_mnist
    from lbfgs_ffnn.launcher import Launcher, UnifiedConfig

    ds = load_mnist(train_size=256, test_size=64)
    l = (Launcher("cuda").add_layer(784, 16, "relu")
         .add_layer(16, 10, "linear").build_network().set_data(ds))
    rep = l.train("lbfgs", UnifiedConfig(
        name="U8", max_iters=15, m_param=5, log_interval=1,
        line_input_dtype="uint8", grad_input_dtype="uint8"), verbose=False)
    assert float(rep.result.final_loss) < 1.0


# ---------------- batch problem (stochastic solvers) ----------------------


def test_u8_batch_problem_value_and_grad_parity():
    """The batch problem fed a pixel-quantized batch agrees with the raw
    f32 batch to f32 rounding: the quant-aware mlp_apply upcasts inside the
    first dot and rescales its output epilogue."""
    from lbfgs_ffnn.objectives.mlp import mlp_batch_problem, quantize_pixels

    spec, w, p, x, y, pix = _pixel_setup()
    bp = mlp_batch_problem(spec, lam=1e-4)
    xq = quantize_pixels(x)
    np.testing.assert_array_equal(np.asarray(xq), np.asarray(pix, np.uint8))
    f_f, g_f = bp.value_and_grad(w, x, y)
    f_q, g_q = bp.value_and_grad(w, xq, y)
    np.testing.assert_allclose(float(f_q), float(f_f), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g_q), np.asarray(g_f),
                               rtol=2e-4, atol=1e-7)


def test_u8_batch_problem_masked_ragged_tail():
    """fun_masked/grad_masked through u8 batches: zeroed masked rows stay
    exact (integer zeros) and match the f32 masked path."""
    from lbfgs_ffnn.objectives.mlp import mlp_batch_problem, quantize_pixels

    spec, w, p, x, y, _ = _pixel_setup(n=8)
    bp = mlp_batch_problem(spec)
    mask = jnp.array([1, 1, 1, 1, 1, 0, 0, 0], jnp.float32)
    xq = quantize_pixels(x)
    f_f = bp.fun_masked(w, x, y, mask)
    f_q = bp.fun_masked(w, xq, y, mask)
    np.testing.assert_allclose(float(f_q), float(f_f), rtol=1e-6)
    g_f = bp.grad_masked(w, x, y, mask)
    g_q = bp.grad_masked(w, xq, y, mask)
    np.testing.assert_allclose(np.asarray(g_q), np.asarray(g_f),
                               rtol=2e-4, atol=1e-7)


def test_mlp_apply_rejects_non_uint8_integers():
    """Only uint8 carries the round(x*255) convention; other integer inputs
    (raw counts, labels in the wrong slot) must fail loudly instead of
    being silently divided by 255."""
    from lbfgs_ffnn.objectives.mlp import mlp_apply

    spec = mlp_spec([4, 3, 2], ["relu", "linear"])
    w = mlp_init(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    x_i32 = jnp.ones((2, 4), jnp.int32)
    with pytest.raises(ValueError, match="uint8"):
        mlp_apply(spec, w, x_i32)


def test_u8_sgd_launcher_end_to_end():
    """SGD with fun_input_dtype='uint8': the launcher hands the solver the
    quantized input (per-step batch reads AND the per-epoch full record at
    quarter width); the run must track the f32 run's loss closely on
    on-grid data and record per-epoch accuracy."""
    from lbfgs_ffnn.data.datasets import load_mnist
    from lbfgs_ffnn.launcher import Launcher, UnifiedConfig

    ds = load_mnist(train_size=512, test_size=64)
    l = (Launcher("cuda").add_layer(784, 16, "relu")
         .add_layer(16, 10, "linear").build_network().set_data(ds))
    cfg = dict(max_iters=8, tolerance=0.0, learning_rate=0.01,
               batch_size=128, log_interval=1, lr_decay=0.8,
               lr_decay_rate=4, record_accuracy=True, write_csv=False)
    rep_f = l.train("sgd", UnifiedConfig(name="S_f32", **cfg), verbose=False)
    rep_q = l.train("sgd", UnifiedConfig(name="S_u8", fun_input_dtype="uint8",
                                         **cfg), verbose=False)
    assert rep_q.result.metric_history is not None
    np.testing.assert_allclose(float(rep_q.result.final_loss),
                               float(rep_f.result.final_loss), rtol=1e-3)
    # invalid narrow dtype for the stochastic path is rejected up front
    with pytest.raises(ValueError, match="uint8"):
        l.train("sgd", UnifiedConfig(name="S_bad",
                                     fun_input_dtype="bfloat16", **cfg),
                verbose=False)
    # S-LBFGS is not wired for the narrow input — reject rather than
    # silently running full-f32 while the config claims a u8 read
    with pytest.raises(ValueError, match="slbfgs"):
        l.train("slbfgs", UnifiedConfig(name="SL_bad",
                                        fun_input_dtype="uint8", **cfg),
                verbose=False)
