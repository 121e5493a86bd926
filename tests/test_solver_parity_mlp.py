"""Full-solver trajectory parity on MLP training data, f64, for EVERY
solver family — straight-Python mirrors of the reference algorithms driven
by the same objective oracles (VERDICT round 1, item 3).

The mirrors transcribe the reference's published solver logic:
  * GD momentum      — src/cuda/gd.cuh:73-100
  * SGD sequential   — src/cuda/sgd.cuh:88-145 (slices, momentum, decay,
                       epoch-weighted loss, relative-improvement stop)
  * S-LBFGS          — src/minimizer/s_lbfgs.hpp:166-290 (SVRG anchor,
                       variance-reduced inner steps, every-L HVP curvature
                       pairs with the clamped-gamma two-loop, random anchor
                       reset excluding the newest iterate)
  * L-BFGS wolfe/armijo — src/minimizer/lbfgs.hpp:38-139 /
                       src/cuda/lbfgs.cuh:90-261 (mirrors shared with
                       tests/test_lbfgs_trajectory_parity.py, here on MLP
                       data instead of analytic objectives)

Loss/gradient/HVP evaluations inside the mirrors call the same jitted
objective primitives the solvers use, so the comparison isolates *solver
policy* (loop structure, line search, history management, sampling
schedule). Stochastic mirrors draw indices from the identical
``jax.random.fold_in`` stream — the sampling *schedule* (per-(epoch, step)
keys, without-replacement permutation, anchor-reset draw) is the mirrored
behavior; the underlying bit generator is shared, since the reference's
mt19937 stream is not reproducible outside C++.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_ffnn.ops.sampling import sample_without_replacement
from lbfgs_ffnn.objectives.mlp import (
    mlp_batch_problem, mlp_init, mlp_problem, mlp_spec,
)
from lbfgs_ffnn.solvers import (
    GDOptions, LBFGSOptions, SGDOptions, SLBFGSOptions,
    gradient_descent, lbfgs, sgd, slbfgs,
)
from tests.test_lbfgs_trajectory_parity import (
    np_two_loop, reference_lbfgs_armijo, reference_lbfgs_wolfe,
)

SPEC = mlp_spec([16, 12, 4], ["tanh", "linear"])
N = 96
W0 = np.asarray(mlp_init(SPEC, jax.random.PRNGKey(2), dtype=jnp.float64))
X = jax.random.normal(jax.random.PRNGKey(3), (N, 16), dtype=jnp.float64)
Y = jax.nn.one_hot(jnp.arange(N) % 4, 4, dtype=jnp.float64)
PROB = mlp_problem(SPEC)
BP = mlp_batch_problem(SPEC, lam=1e-4)  # reference S-LBFGS training L2


def f_np(w):
    return float(PROB.fun(jnp.asarray(w), (X, Y)))


def g_np(w):
    return np.asarray(PROB.grad(jnp.asarray(w), (X, Y)))


def _lbfgs_trajectory(opts, iters):
    from lbfgs_ffnn.solvers.lbfgs import _cached_chunk_fns

    init, run_chunk = _cached_chunk_fns(PROB, opts, 1)
    state = init(jnp.asarray(W0), (X, Y))
    traj = []
    for _ in range(iters):
        state = run_chunk(state, (X, Y))
        traj.append(np.asarray(state.x))
    return traj


def test_lbfgs_wolfe_trajectory_parity_mlp():
    iters = 25
    ref = reference_lbfgs_wolfe(f_np, g_np, W0.copy(), m=10, iters=iters)
    opts = LBFGSOptions(max_iters=iters, tol=1e-14, m=10,
                        ls_value_only=False, prefix_vag=False)
    ours = _lbfgs_trajectory(opts, iters)
    for k, (a, b) in enumerate(zip(ours, ref)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12,
                                   err_msg=f"wolfe iterate {k}")


def test_lbfgs_armijo_trajectory_parity_mlp():
    iters = 25
    ref = reference_lbfgs_armijo(f_np, g_np, W0.copy(), m=10, iters=iters)
    opts = LBFGSOptions(max_iters=iters, tol=1e-14, m=10,
                        line_search="armijo", ls_max_iters=20,
                        ls_value_only=False, prefix_vag=False)
    ours = _lbfgs_trajectory(opts, iters)
    for k, (a, b) in enumerate(zip(ours, ref)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12,
                                   err_msg=f"armijo iterate {k}")


# ---------------------------------------------------------------------------
# GD with momentum (reference: src/cuda/gd.cuh:73-100)
# ---------------------------------------------------------------------------


def reference_gd_momentum(grad, x0, lr, mu, iters):
    x, v = x0.copy(), np.zeros_like(x0)
    g = grad(x)
    traj = []
    for _ in range(iters):
        v = mu * v - lr * g           # gd.cuh:78-79
        x = x + v                     # gd.cuh:80
        g = grad(x)
        traj.append(x.copy())
    return traj


def test_gd_momentum_trajectory_parity_mlp():
    iters = 30
    ref = reference_gd_momentum(g_np, W0.copy(), lr=0.05, mu=0.9, iters=iters)
    res = gradient_descent(
        PROB, jnp.asarray(W0), aux=(X, Y),
        opts=GDOptions(max_iters=iters, tol=1e-14, step_size=0.05,
                       momentum=0.9, use_line_search=False),
    )
    np.testing.assert_allclose(np.asarray(res.x), ref[-1], rtol=1e-9, atol=1e-12)
    # per-iteration loss history pins the whole trajectory, not just the end
    ref_losses = [f_np(w) for w in ref]
    np.testing.assert_allclose(
        np.asarray(res.loss_history[:iters]), ref_losses, rtol=1e-9
    )


# ---------------------------------------------------------------------------
# SGD sequential (reference: src/cuda/sgd.cuh:88-145)
# ---------------------------------------------------------------------------


def _batch_grad_np(w, lo, hi):
    xb, yb = X[lo:hi], Y[lo:hi]
    return np.asarray(BP_PLAIN.grad(jnp.asarray(w), xb, yb))


def _batch_loss_np(w, lo, hi):
    return float(BP_PLAIN.fun(jnp.asarray(w), X[lo:hi], Y[lo:hi]))


BP_PLAIN = mlp_batch_problem(SPEC)  # SGD strategy uses no L2


def reference_sgd_sequential(w0, lr0, mu, b, epochs, decay, decay_step, tol):
    """Mirror of CudaSGD::stochastic_solve: contiguous slices by offset
    (sgd.cuh:103-107 — the trailing slice is simply smaller), momentum
    (:112-116), step decay every decay_step epochs (:97-99), epoch loss =
    sample-weighted mean of batch losses (:88-94), relative-improvement
    stop (:126-131)."""
    w, v = w0.copy(), np.zeros_like(w0)
    lr = lr0
    prev_loss = np.inf
    traj, stopped = [], False
    for e in range(epochs):
        if decay_step > 0 and e > 0 and e % decay_step == 0:
            lr = lr * decay
        total = 0.0
        for lo in range(0, N, b):
            hi = min(lo + b, N)
            g = _batch_grad_np(w, lo, hi)
            loss = _batch_loss_np(w, lo, hi)
            if mu > 0:
                v = mu * v - lr * g
                w = w + v
            else:
                w = w - lr * g
            total += loss * (hi - lo)
        epoch_loss = total / N
        traj.append(w.copy())
        if tol > 0 and np.isfinite(prev_loss):
            if abs(prev_loss - epoch_loss) / max(1.0, abs(prev_loss)) < tol:
                stopped = True
                traj_len = e + 1
                break
        prev_loss = epoch_loss
    return traj, stopped


@pytest.mark.parametrize("b", [32, 40])  # 40: N % b != 0 (ragged tail)
def test_sgd_sequential_trajectory_parity_mlp(b):
    epochs = 20
    ref_traj, _ = reference_sgd_sequential(
        W0.copy(), lr0=0.05, mu=0.9, b=b, epochs=epochs,
        decay=0.8, decay_step=7, tol=0.0,
    )
    res = sgd(
        BP_PLAIN, jnp.asarray(W0), X, Y,
        SGDOptions(epochs=epochs, batch_size=b, step_size=0.05, momentum=0.9,
                   sampling="sequential", lr_decay=0.8, lr_decay_step=7,
                   tol=0.0, record_full=True),
    )
    assert int(res.n_iters) == epochs
    np.testing.assert_allclose(np.asarray(res.x), ref_traj[-1],
                               rtol=1e-9, atol=1e-12)
    ref_losses = [f_np(w) for w in ref_traj]
    np.testing.assert_allclose(
        np.asarray(res.loss_history[:epochs]), ref_losses, rtol=1e-9
    )


def test_sgd_sequential_loss_matches_mirror_losswise():
    """The mirror's SGD mini-batch loss sequence (mean per slice) equals the
    jitted masked-gather path's epoch loss — pins the masked ragged-tail
    arithmetic to the reference's smaller-final-slice semantics."""
    b, epochs = 40, 6
    w, v = W0.copy(), np.zeros_like(W0)
    lr = 0.05
    epoch_losses = []
    for e in range(epochs):
        total = 0.0
        for lo in range(0, N, b):
            hi = min(lo + b, N)
            total += _batch_loss_np(w, lo, hi) * (hi - lo)
            g = _batch_grad_np(w, lo, hi)
            v = 0.9 * v - lr * g
            w = w + v
        epoch_losses.append(total / N)
    res = sgd(
        BP_PLAIN, jnp.asarray(W0), X, Y,
        SGDOptions(epochs=epochs, batch_size=b, step_size=0.05, momentum=0.9,
                   sampling="sequential", tol=0.0, record_full=False),
    )
    np.testing.assert_allclose(
        np.asarray(res.loss_history[:epochs]), epoch_losses, rtol=1e-9
    )


# ---------------------------------------------------------------------------
# S-LBFGS (reference: src/minimizer/s_lbfgs.hpp:166-290)
# ---------------------------------------------------------------------------


def np_two_loop_clamped(v, s_list, y_list, rho_list):
    """Stochastic-variant two-loop: gamma -> 1 when |y^T y| ~ 0, clamped to
    [1e-6, 1e6] (s_lbfgs.hpp:106-136)."""
    if not s_list:
        return v
    q = v.copy()
    alphas = []
    for s, y, r in zip(reversed(s_list), reversed(y_list), reversed(rho_list)):
        a = r * (s @ q)
        alphas.append(a)
        q = q - a * y
    alphas.reverse()
    yy = y_list[-1] @ y_list[-1]
    gamma = 1.0 if abs(yy) < 1e-12 else (s_list[-1] @ y_list[-1]) / yy
    gamma = min(max(gamma, 1e-6), 1e6)
    z = gamma * q
    for s, y, r, a in zip(s_list, y_list, rho_list, alphas):
        b = r * (y @ z)
        z = z + s * (a - b)
    return z


def reference_slbfgs(w0, opts: SLBFGSOptions, epochs):
    """Mirror of SLBFGS::stochastic_solve — same index stream as the jitted
    solver (fold_in per (epoch, step), permutation-without-replacement,
    anchor draw excluding the newest iterate)."""
    b = min(opts.batch_size, N)
    m_inner = opts.m_inner if opts.m_inner > 0 else max(N // b, 1)
    b_h = opts.hvp_batch_size if opts.hvp_batch_size > 0 else max(b // 2, 1)
    cap = opts.L + 1

    sampler = opts.sampler

    def grad_at(w, idx):
        xb, yb = jnp.take(X, idx, axis=0), jnp.take(Y, idx, axis=0)
        return np.asarray(BP.grad(jnp.asarray(w), xb, yb))

    def hvp_at(u, s_vec, idx):
        xh, yh = jnp.take(X, idx, axis=0), jnp.take(Y, idx, axis=0)
        return np.asarray(BP.hvp(jnp.asarray(u), jnp.asarray(s_vec), xh, yh))

    key = jax.random.PRNGKey(opts.seed)
    w_anchor = w0.copy()
    s_list, y_list, rho_list = [], [], []
    u_prev, has_u = None, False
    traj = []
    for e in range(epochs):
        k_epoch = jax.random.fold_in(key, e)
        mu = np.asarray(BP.grad(jnp.asarray(w_anchor), X, Y))
        if np.linalg.norm(mu) < opts.tol:
            break
        wr = [w_anchor.copy()]  # w_history seeded with the anchor
        wt = w_anchor.copy()
        for t in range(m_inner):
            k_t = jax.random.fold_in(k_epoch, t)
            idx = np.asarray(sample_without_replacement(
                jax.random.fold_in(k_t, 0), N, b, sampler))
            v = grad_at(wt, idx) - grad_at(w_anchor, idx) + mu
            d = np_two_loop_clamped(v, s_list, y_list, rho_list)
            wt = wt - opts.step_size * d
            wr.append(wt.copy())
            if len(wr) > cap:
                wr.pop(0)
            if t > 0 and t % opts.L == 0:
                u = np.mean(wr, axis=0)
                if has_u:
                    s_vec = u - u_prev
                    idx_h = np.asarray(sample_without_replacement(
                        jax.random.fold_in(k_t, 1), N, b_h, sampler))
                    yv = hvp_at(u, s_vec, idx_h)
                    ys = yv @ s_vec
                    if abs(ys) > opts.curvature_eps:
                        s_list.append(s_vec)
                        y_list.append(yv)
                        rho_list.append(1.0 / ys)
                        if len(s_list) > opts.history:
                            s_list.pop(0), y_list.pop(0), rho_list.pop(0)
                u_prev, has_u = u, True
        # anchor reset to a random recent iterate, excluding the newest
        # (s_lbfgs.hpp:265-270: pick_i(0, size-2))
        k_r = jax.random.fold_in(k_epoch, 2**20)
        j = int(jax.random.randint(k_r, (), 0, max(len(wr) - 1, 1)))
        w_anchor = wr[j].copy() if len(wr) >= 2 else wt.copy()
        traj.append(w_anchor.copy())
    return traj


def test_slbfgs_trajectory_parity_mlp():
    epochs = 20
    opts = SLBFGSOptions(epochs=epochs, tol=1e-14, history=5, L=3,
                         batch_size=24, step_size=0.05)
    ref = reference_slbfgs(W0.copy(), opts, epochs)
    assert len(ref) == epochs

    from lbfgs_ffnn.solvers.slbfgs import _cached_chunk_fns

    init, run_chunk = _cached_chunk_fns(BP, opts, N, None, "data", 1)
    state = init(jnp.asarray(W0), X, Y)
    for e in range(epochs):
        state = run_chunk(state, X, Y)
        np.testing.assert_allclose(
            np.asarray(state.w), ref[e], rtol=1e-9, atol=1e-12,
            err_msg=f"S-LBFGS anchor after epoch {e}",
        )
    # final-loss agreement on the full objective
    np.testing.assert_allclose(
        float(BP.fun(state.w, X, Y)), float(BP.fun(jnp.asarray(ref[-1]), X, Y)),
        rtol=1e-9,
    )
