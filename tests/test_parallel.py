"""Data-parallel tests on the virtual 8-device CPU mesh.

Gate: distributed evaluation is numerically identical (up to reduction
order) to single-device evaluation, and whole solvers run unchanged on
sharded operands (GSPMD) and on explicit shard_map-wrapped problems.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_ffnn.data.datasets import load_mnist
from lbfgs_ffnn.objectives.mlp import mlp_batch_problem, mlp_init, mlp_problem, mlp_spec
from lbfgs_ffnn.parallel import (
    data_parallel_batch_problem,
    data_parallel_problem,
    make_mesh,
    replicate,
    shard_batch,
)
from lbfgs_ffnn.solvers import (
    LBFGSOptions,
    SGDOptions,
    SLBFGSOptions,
    lbfgs,
    sgd,
    slbfgs,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multi-device (virtual CPU farm)"
)

SPEC = mlp_spec([784, 32, 10], ["relu", "linear"])
DS = load_mnist(train_size=512, test_size=128)
X = jnp.asarray(DS.train_x)
Y = jnp.asarray(DS.train_y)
W0 = mlp_init(SPEC, jax.random.PRNGKey(123), dtype=jnp.float32)


def test_mesh_construction():
    mesh = make_mesh()
    assert mesh.shape["data"] == len(jax.devices())
    mesh4 = make_mesh(4)
    assert mesh4.shape["data"] == 4


def test_mesh_explicit_devices_validated():
    # An explicit device list shorter than prod(shape) must raise, not
    # silently build a smaller mesh (a (2, 4) request on 4 devices would
    # otherwise come out (1, 4) — data parallelism quietly gone).
    mesh24 = make_mesh((2, 4), ("data", "model"), devices=jax.devices())
    assert mesh24.shape == {"data": 2, "model": 4}
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh((2, 4), ("data", "model"), devices=jax.devices()[:4])


def test_shard_map_problem_matches_single_device():
    mesh = make_mesh()
    bp = mlp_batch_problem(SPEC)
    dp = data_parallel_batch_problem(bp, mesh)
    xs, ys = shard_batch(mesh, X, Y)
    w = replicate(mesh, W0)

    np.testing.assert_allclose(
        float(dp.fun(w, xs, ys)), float(bp.fun(W0, X, Y)), rtol=1e-6
    )
    g_dp = dp.grad(w, xs, ys)
    g_ref = bp.grad(W0, X, Y)
    np.testing.assert_allclose(np.asarray(g_dp), np.asarray(g_ref), rtol=1e-4, atol=1e-6)
    v_dp, g2 = dp.value_and_grad(w, xs, ys)
    np.testing.assert_allclose(float(v_dp), float(bp.fun(W0, X, Y)), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g2), np.asarray(g_ref), rtol=1e-4, atol=1e-6)


def test_shard_map_masked_matches():
    mesh = make_mesh()
    bp = mlp_batch_problem(SPEC)
    dp = data_parallel_batch_problem(bp, mesh)
    mask = (jnp.arange(X.shape[0]) < 300).astype(X.dtype)
    xs, ys, ms = shard_batch(mesh, X, Y, mask)
    w = replicate(mesh, W0)
    np.testing.assert_allclose(
        float(dp.fun_masked(w, xs, ys, ms)),
        float(bp.fun_masked(W0, X, Y, mask)),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(dp.grad_masked(w, xs, ys, ms)),
        np.asarray(bp.grad_masked(W0, X, Y, mask)),
        rtol=1e-4, atol=1e-6,
    )


def test_shard_map_masked_nan_padding():
    """Masked-out rows may hold NaN padding (types.py rule): the sharded
    masked loss/grad must use `where`, not multiply, or the psum is
    poisoned. Regression for the round-2 `ls * mask` hazard."""
    mesh = make_mesh()
    bp = mlp_batch_problem(SPEC)
    dp = data_parallel_batch_problem(bp, mesh)
    mask = (jnp.arange(X.shape[0]) < 300).astype(X.dtype)
    x_poison = jnp.where(mask[:, None] > 0, X, jnp.nan)
    y_poison = jnp.where(mask[:, None] > 0, Y, jnp.nan)
    xs, ys, ms = shard_batch(mesh, x_poison, y_poison, mask)
    w = replicate(mesh, W0)
    want = float(bp.fun_masked(W0, X, Y, mask))  # clean-data oracle
    # Single-device masked evaluators are NaN-proof...
    got_bp = float(bp.fun_masked(W0, x_poison, y_poison, mask))
    np.testing.assert_allclose(got_bp, want, rtol=1e-6)
    g_bp = np.asarray(bp.grad_masked(W0, x_poison, y_poison, mask))
    assert np.all(np.isfinite(g_bp))
    np.testing.assert_allclose(
        g_bp, np.asarray(bp.grad_masked(W0, X, Y, mask)), rtol=1e-5, atol=1e-7
    )
    # ...and so is the shard_map path.
    got = float(dp.fun_masked(w, xs, ys, ms))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    g = np.asarray(dp.grad_masked(w, xs, ys, ms))
    assert np.all(np.isfinite(g))
    np.testing.assert_allclose(g, g_bp, rtol=1e-4, atol=1e-6)


def test_full_batch_problem_shard_map():
    mesh = make_mesh()
    prob = mlp_problem(SPEC)
    dp = data_parallel_problem(prob, mesh)
    xs, ys = shard_batch(mesh, X, Y)
    w = replicate(mesh, W0)
    np.testing.assert_allclose(
        float(dp.fun(w, (xs, ys))), float(prob.fun(W0, (X, Y))), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(dp.grad(w, (xs, ys))),
        np.asarray(prob.grad(W0, (X, Y))),
        rtol=1e-4, atol=1e-6,
    )


def test_lbfgs_on_gspmd_sharded_data():
    """Solver runs unchanged with sharded operands: XLA partitions the batch
    GEMMs and inserts the gradient all-reduce."""
    mesh = make_mesh()
    prob = mlp_problem(SPEC)
    xs, ys = shard_batch(mesh, X, Y)
    opts = LBFGSOptions(max_iters=5, tol=1e-8, m=5)
    res_dp = lbfgs(prob, W0, aux=(xs, ys), opts=opts)
    res_1d = lbfgs(prob, W0, aux=(X, Y), opts=opts)
    np.testing.assert_allclose(
        float(res_dp.final_loss), float(res_1d.final_loss), rtol=1e-4
    )


def test_lbfgs_on_shard_map_problem():
    mesh = make_mesh()
    prob = mlp_problem(SPEC)
    dp = data_parallel_problem(prob, mesh)
    xs, ys = shard_batch(mesh, X, Y)
    w = replicate(mesh, W0)
    opts = LBFGSOptions(max_iters=5, tol=1e-8, m=5)
    res_dp = lbfgs(dp, w, aux=(xs, ys), opts=opts)
    res_1d = lbfgs(prob, W0, aux=(X, Y), opts=opts)
    np.testing.assert_allclose(
        float(res_dp.final_loss), float(res_1d.final_loss), rtol=1e-4
    )


def test_slbfgs_on_gspmd_sharded_data():
    mesh = make_mesh()
    bp = mlp_batch_problem(SPEC, lam=1e-4)
    xs, ys = shard_batch(mesh, X, Y)
    w = replicate(mesh, W0)
    opts = SLBFGSOptions(epochs=2, history=5, L=3, batch_size=64, step_size=0.05)
    res = slbfgs(bp, w, xs, ys, opts)
    res_1d = slbfgs(bp, W0, X, Y, opts)
    # identical sampling (seeded fold_in) -> same trajectory up to reduction order
    np.testing.assert_allclose(
        float(res.final_loss), float(res_1d.final_loss), rtol=1e-3
    )


def test_sgd_on_gspmd_sharded_data():
    mesh = make_mesh()
    bp = mlp_batch_problem(SPEC)
    xs, ys = shard_batch(mesh, X, Y)
    opts = SGDOptions(epochs=3, batch_size=64, step_size=0.05)
    res = sgd(bp, W0, xs, ys, opts)
    res_1d = sgd(bp, W0, X, Y, opts)
    np.testing.assert_allclose(
        float(res.final_loss), float(res_1d.final_loss), rtol=1e-3
    )


def test_slbfgs_explicit_sharded_mode():
    """Distributed S-LBFGS: per-device local sampling + one psum per
    evaluation. The SVRG full gradient is sampling-independent, so the
    converged-immediately gnorm must match the direct path exactly; a real
    run must train."""
    mesh = make_mesh()
    bp = mlp_batch_problem(SPEC, lam=1e-4)
    xs, ys = shard_batch(mesh, X, Y)
    w = replicate(mesh, W0)

    # full-gradient parity via immediate convergence (tol=inf)
    opts_conv = SLBFGSOptions(epochs=3, tol=1e9, batch_size=64)
    r_dp = slbfgs(bp, w, xs, ys, opts_conv, mesh=mesh)
    r_1d = slbfgs(bp, W0, X, Y, opts_conv)
    np.testing.assert_allclose(float(r_dp.final_gnorm), float(r_1d.final_gnorm), rtol=1e-5)

    # real training run
    opts = SLBFGSOptions(epochs=5, tol=1e-8, history=5, L=3,
                         batch_size=64, step_size=0.05)
    res = slbfgs(bp, w, xs, ys, opts, mesh=mesh)
    f0 = float(bp.fun(W0, X, Y))
    assert float(res.final_loss) < 0.6 * f0
    assert bool(jnp.isfinite(res.x).all())


def test_slbfgs_sharded_deterministic():
    mesh = make_mesh()
    bp = mlp_batch_problem(SPEC)
    xs, ys = shard_batch(mesh, X, Y)
    w = replicate(mesh, W0)
    opts = SLBFGSOptions(epochs=2, history=4, L=2, batch_size=64, step_size=0.05)
    r1 = slbfgs(bp, w, xs, ys, opts, mesh=mesh)
    r2 = slbfgs(bp, w, xs, ys, opts, mesh=mesh)
    np.testing.assert_array_equal(np.asarray(r1.x), np.asarray(r2.x))


def test_two_loop_param_sharded_matches_single_device():
    """Parameter-axis sharded two-loop: partial dots + psum over the mesh
    reproduce the single-device recursion exactly (up to reduction order)."""
    from lbfgs_ffnn.ops.two_loop import (
        empty_history_state, ring_push, two_loop, two_loop_sharded,
    )
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(0)
    n, m, k = 4096, 6, 9  # n == n_pad (multiple of 1024), wraps the ring
    hist = empty_history_state(m, n, jnp.float64)
    for _ in range(k):
        s = rng.normal(size=n)
        yv = rng.normal(size=n) + 0.5 * s
        if s @ yv <= 1e-3:
            continue
        s_j, y_j = jnp.asarray(s), jnp.asarray(yv)
        hist = ring_push(hist, s_j, y_j, 1.0 / jnp.vdot(y_j, s_j), jnp.array(True))
    v = jnp.asarray(rng.normal(size=n))

    r_single = two_loop(v, hist)

    mesh = make_mesh(axis_name="param")
    col = NamedSharding(mesh, P(None, "param", None))
    vecsh = NamedSharding(mesh, P("param"))
    hist_sh = hist._replace(
        S=jax.device_put(hist.S, col), Y=jax.device_put(hist.Y, col),
    )
    v_sh = jax.device_put(v, vecsh)
    r_sharded = two_loop_sharded(v_sh, hist_sh, mesh, "param")
    np.testing.assert_allclose(
        np.asarray(r_sharded), np.asarray(r_single), rtol=1e-12, atol=1e-12
    )


def test_lbfgs_param_sharded_full_solver_parity():
    """The §2.6 parameter-axis ambition end-to-end: lbfgs(mesh=...) runs the
    FULL solver with parameter-sharded iterate/gradient/(S,Y) ring and
    psum-reduced two-loop dots, and its f64 trajectory matches the
    single-device run (VERDICT round 1, item 2)."""
    spec = mlp_spec([12, 16, 4], ["tanh", "linear"])
    prob = mlp_problem(spec)
    w0 = mlp_init(spec, jax.random.PRNGKey(5), dtype=jnp.float64)
    x = jax.random.normal(jax.random.PRNGKey(6), (64, 12), dtype=jnp.float64)
    y = jax.nn.one_hot(jnp.arange(64) % 4, 4, dtype=jnp.float64)
    opts = LBFGSOptions(max_iters=15, tol=1e-14, m=6, line_search="armijo",
                        prefix_vag=False, ls_value_only=False)

    ref = lbfgs(prob, w0, aux=(x, y), opts=opts)
    mesh = make_mesh(axis_name="model")
    res = lbfgs(prob, w0, aux=(x, y), opts=opts, mesh=mesh)

    assert int(res.n_iters) == int(ref.n_iters) == 15
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(res.loss_history[:15]), np.asarray(ref.loss_history[:15]),
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(res.gnorm_history[:15]), np.asarray(ref.gnorm_history[:15]),
        rtol=1e-10,
    )
    assert int(res.n_fevals) == int(ref.n_fevals)  # same trial sequence


def test_lbfgs_param_sharded_wolfe_f32():
    """Same parity under the Wolfe (CPU-reference) policy in f32 — the
    production dtype — with the looser float tolerance."""
    spec = mlp_spec([12, 16, 4], ["relu", "linear"])
    prob = mlp_problem(spec)
    w0 = mlp_init(spec, jax.random.PRNGKey(7), dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(8), (64, 12), dtype=jnp.float32)
    y = jax.nn.one_hot(jnp.arange(64) % 4, 4, dtype=jnp.float32)
    opts = LBFGSOptions(max_iters=10, tol=1e-12, m=4, line_search="wolfe",
                        prefix_vag=False, ls_value_only=False)

    ref = lbfgs(prob, w0, aux=(x, y), opts=opts)
    mesh = make_mesh(axis_name="model")
    res = lbfgs(prob, w0, aux=(x, y), opts=opts, mesh=mesh)
    assert int(res.n_iters) == int(ref.n_iters)
    # f32: the psum reduction order differs from the flat vdot, and that
    # rounding compounds through 10 line-searched iterations — parity is
    # trajectory-level (same decisions, close iterates), not bitwise.
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(
        float(res.final_loss), float(ref.final_loss), rtol=1e-4
    )
    assert int(res.n_fevals) == int(ref.n_fevals)


def test_slbfgs_global_sampling_trajectory_matches_single_device():
    """Layout-invariant explicit S-LBFGS (VERDICT round 1, item 6): with
    sampling='global' the replicated key draws the exact batches of the
    1-device run, so the multi-device *trajectory* (per-epoch full loss and
    gradient norm) matches — not just the final loss. f64 so the only
    differences are psum reduction order."""
    spec = mlp_spec([16, 12, 4], ["tanh", "linear"])
    bp = mlp_batch_problem(spec, lam=1e-4)
    w0 = mlp_init(spec, jax.random.PRNGKey(3), dtype=jnp.float64)
    n = 256
    x = jax.random.normal(jax.random.PRNGKey(4), (n, 16), dtype=jnp.float64)
    y = jax.nn.one_hot(jnp.arange(n) % 4, 4, dtype=jnp.float64)

    opts = SLBFGSOptions(epochs=4, tol=1e-12, history=5, L=3,
                         batch_size=32, step_size=0.05, sampling="global")
    r_1d = slbfgs(bp, w0, x, y, opts._replace(sampling="local"))

    mesh = make_mesh()
    xs, ys = shard_batch(mesh, x, y)
    w = replicate(mesh, w0)
    r_dp = slbfgs(bp, w, xs, ys, opts, mesh=mesh)

    assert int(r_dp.n_iters) == int(r_1d.n_iters) == 4
    np.testing.assert_allclose(np.asarray(r_dp.x), np.asarray(r_1d.x), rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(r_dp.loss_history[:4]), np.asarray(r_1d.loss_history[:4]),
        rtol=1e-9,
    )
    np.testing.assert_allclose(
        np.asarray(r_dp.gnorm_history[:4]), np.asarray(r_1d.gnorm_history[:4]),
        rtol=1e-9,
    )


def test_slbfgs_chunked_mesh_mode_matches_whileloop():
    """The chunked driver composes with the explicit-sharded mode: same
    trajectory as the mesh while_loop run, measured time per epoch."""
    from lbfgs_ffnn.solvers.slbfgs import slbfgs_chunked

    mesh = make_mesh()
    bp = mlp_batch_problem(SPEC, lam=1e-4)
    xs, ys = shard_batch(mesh, X, Y)
    w = replicate(mesh, W0)
    opts = SLBFGSOptions(epochs=4, tol=1e-12, history=4, L=2,
                         batch_size=64, step_size=0.05, sampling="global")
    ref = slbfgs(bp, w, xs, ys, opts, mesh=mesh)
    res, tms = slbfgs_chunked(bp, w, xs, ys, opts, chunk=2, mesh=mesh)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))
    assert np.isfinite(np.asarray(tms)[:4]).all()


def test_lbfgs_param_sharded_keeps_line_restriction():
    """The mesh mode wraps line_fun/line_prefix through the padding
    adapters — default (lean + carried prefix) options match the
    single-device run instead of silently degrading to full-objective
    trials (round-2 self-review finding)."""
    spec = mlp_spec([12, 16, 4], ["tanh", "linear"])
    prob = mlp_problem(spec)
    assert prob.line_prefix is not None
    w0 = mlp_init(spec, jax.random.PRNGKey(9), dtype=jnp.float64)
    x = jax.random.normal(jax.random.PRNGKey(10), (64, 12), dtype=jnp.float64)
    y = jax.nn.one_hot(jnp.arange(64) % 4, 4, dtype=jnp.float64)
    opts = LBFGSOptions(max_iters=12, tol=1e-14, m=5)  # defaults: lean+prefix

    ref = lbfgs(prob, w0, aux=(x, y), opts=opts)
    mesh = make_mesh(axis_name="model")
    res = lbfgs(prob, w0, aux=(x, y), opts=opts, mesh=mesh)
    assert int(res.n_iters) == int(ref.n_iters)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x), rtol=1e-9)
    # same trial counts: the lean jvp-trial path ran under the mesh too
    assert int(res.n_fevals) == int(ref.n_fevals)
    assert int(res.n_gevals) == int(ref.n_gevals)


def test_lbfgs_param_sharded_divisibility_guard():
    """Configs whose tile-row count doesn't split over the mesh fail with
    the intended clean error, not a shard_map trace error."""
    mesh = make_mesh(3, axis_name="model") if len(jax.devices()) >= 3 else None
    if mesh is None:
        pytest.skip("needs >=3 devices")
    prob = mlp_problem(mlp_spec([12, 16, 4], ["tanh", "linear"]))
    w0 = mlp_init(mlp_spec([12, 16, 4], ["tanh", "linear"]), jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 12))
    y = jax.nn.one_hot(jnp.arange(8) % 4, 4)
    with pytest.raises(ValueError, match="tile-row count"):
        lbfgs(prob, w0, aux=(x, y), opts=LBFGSOptions(max_iters=2), mesh=mesh)


def test_lbfgs_param_sharded_chunked_checkpoint_resume(tmp_path):
    """VERDICT r2 item 4: the param-sharded solver can be measured-timed and
    kill-and-resumed — lbfgs_chunked(mesh=...) runs the identical sharded
    body in chunks, the sharded RingState round-trips through Orbax, and the
    restored state resumes onto a FRESH mesh (the checkpoint is layout-free;
    the body's sharding constraints re-shard it)."""
    from lbfgs_ffnn.checkpoint import restore_checkpoint, save_checkpoint
    from lbfgs_ffnn.solvers.lbfgs import LBFGSOptions, lbfgs_chunked

    spec = mlp_spec([12, 16, 4], ["tanh", "linear"])
    prob = mlp_problem(spec)
    w0 = mlp_init(spec, jax.random.PRNGKey(5), dtype=jnp.float64)
    x = jax.random.normal(jax.random.PRNGKey(6), (64, 12), dtype=jnp.float64)
    y = jax.nn.one_hot(jnp.arange(64) % 4, 4, dtype=jnp.float64)
    n = int(w0.shape[0])
    opts = LBFGSOptions(max_iters=20, tol=1e-14, m=6, line_search="armijo",
                        prefix_vag=False, ls_value_only=False)
    mesh = make_mesh(axis_name="model")

    # chunked mesh run == whole-solve mesh run (identical body)
    ref = lbfgs(prob, w0, aux=(x, y), opts=opts, mesh=mesh)
    res_full, tms_full = lbfgs_chunked(
        prob, w0, aux=(x, y), opts=opts, chunk=5, mesh=mesh
    )
    np.testing.assert_array_equal(np.asarray(res_full.x), np.asarray(ref.x))
    assert np.isfinite(np.asarray(tms_full)[: int(res_full.n_iters)]).all()

    saved = {}

    def save_at_10(state, elapsed):
        if int(state.k) == 10 and not saved:
            save_checkpoint(tmp_path / "mid", state)
            saved["template"] = jax.tree_util.tree_map(
                lambda a: np.zeros(a.shape, a.dtype), state
            )

    lbfgs_chunked(prob, w0, aux=(x, y), opts=opts, chunk=5, mesh=mesh,
                  callback=save_at_10)
    assert saved, "checkpoint callback never fired"

    restored = restore_checkpoint(tmp_path / "mid", saved["template"])
    assert int(restored.k) == 10
    # the padded, sharded ring survived the round trip: (m, rows, 128)
    assert restored.hist.S.shape == (6, 8, 128)

    # fresh mesh object (the realistic restart: a new process, new Mesh)
    fresh_mesh = make_mesh(axis_name="model")
    res_resumed, tms = lbfgs_chunked(
        prob, None, aux=(x, y), opts=opts, chunk=5, mesh=fresh_mesh,
        resume_state=restored, n_params=n,
    )
    np.testing.assert_array_equal(np.asarray(res_resumed.x), np.asarray(res_full.x))
    assert int(res_resumed.n_iters) == int(res_full.n_iters)
    tms = np.asarray(tms)
    assert np.isnan(tms[:10]).all()  # pre-kill iterations: not measured here
    assert np.isfinite(tms[10: int(res_resumed.n_iters)]).all()


def _filled_gram_ring(n, m, k, dtype=jnp.float64, seed=0):
    from lbfgs_ffnn.ops.two_loop import gram_empty, gram_push

    rng = np.random.default_rng(seed)
    gr = gram_empty(m, n, dtype)
    for _ in range(k):
        s = rng.normal(size=n)
        yv = rng.normal(size=n) + 0.5 * s
        if s @ yv <= 1e-3:
            continue
        s_j, y_j = jnp.asarray(s, dtype), jnp.asarray(yv, dtype)
        gr = gram_push(gr, s_j, y_j, 1.0 / jnp.vdot(y_j, s_j), jnp.array(True))
    return gr


def test_two_loop_sharded_compact_matches_loop():
    """Collective-lean compact direction (maintained Gram): matches the
    scalar-psum sharded recursion and the single-device loop form in f64,
    across fill levels, wrap-around and both gamma policies."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from lbfgs_ffnn.ops.two_loop import (
        two_loop, two_loop_sharded, two_loop_sharded_compact,
    )

    mesh = make_mesh(axis_name="param")
    col = NamedSharding(mesh, P(None, "param", None))
    vecsh = NamedSharding(mesh, P("param"))
    rng = np.random.default_rng(1)
    n, m = 4096, 6
    # jit once per (fn, gamma policy): identical shapes across fill levels,
    # so the 3 k-values reuse 4 compiles instead of retracing eagerly.
    compact_j = {
        cg: jax.jit(lambda v, gr, _cg=cg: two_loop_sharded_compact(
            v, gr, mesh, "param", clamp_gamma=_cg))
        for cg in (False, True)
    }
    sharded_j = {
        cg: jax.jit(lambda v, ring, _cg=cg: two_loop_sharded(
            v, ring, mesh, "param", clamp_gamma=_cg))
        for cg in (False, True)
    }
    for k in (0, 2, 9):  # empty, partial, wrapped
        gr = _filled_gram_ring(n, m, k, seed=k)
        v = jnp.asarray(rng.normal(size=n))
        r_loop = two_loop(v, gr.ring)
        gr_sh = gr._replace(ring=gr.ring._replace(
            S=jax.device_put(gr.ring.S, col), Y=jax.device_put(gr.ring.Y, col),
        ))
        v_sh = jax.device_put(v, vecsh)
        for cg in (False, True):
            r_c = compact_j[cg](v_sh, gr_sh)
            r_s = sharded_j[cg](v_sh, gr_sh.ring)
            np.testing.assert_allclose(
                np.asarray(r_c), np.asarray(r_s), rtol=1e-10, atol=1e-10
            )
            if not cg:
                np.testing.assert_allclose(
                    np.asarray(r_c), np.asarray(r_loop), rtol=1e-10, atol=1e-10
                )


def _psum_eqns(jaxpr, in_loop=False):
    """``(total, loop_nested)`` collective-eqn counts, recursively. A psum
    inside a while/scan body executes once per trip — the loop form's ~4m
    scalar collectives show up as loop-nested eqns."""
    tot = nested = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if "psum" in name or "all_reduce" in name or "all_gather" in name:
            tot += 1
            nested += int(in_loop)
        child_in_loop = in_loop or name in ("while", "scan")
        for v in eqn.params.values():
            for it in v if isinstance(v, (list, tuple)) else [v]:
                j = getattr(it, "jaxpr", None)
                if j is None and hasattr(it, "eqns"):
                    j = it
                if j is not None and hasattr(j, "eqns"):
                    t, l = _psum_eqns(j, child_in_loop)
                    tot += t
                    nested += l
    return tot, nested


def test_two_loop_sharded_compact_collective_count():
    """VERDICT r2 item 8's done-gate: <= 4 collectives per direction in the
    compact form (actual: 2 — the c and d m-vector psums, both OUTSIDE any
    loop so the executed count equals the eqn count), vs the loop form whose
    per-pair dots psum inside the recursion loops (~2m+2 executed)."""
    from lbfgs_ffnn.ops.two_loop import (
        two_loop_sharded, two_loop_sharded_compact,
    )

    mesh = make_mesh(axis_name="param")
    n, m = 4096, 6
    gr = _filled_gram_ring(n, m, 4)
    v = jnp.zeros((n,), jnp.float64)

    jx_c = jax.make_jaxpr(
        lambda v, gr: two_loop_sharded_compact(v, gr, mesh, "param")
    )(v, gr)
    total_c, nested_c = _psum_eqns(jx_c.jaxpr)
    assert total_c <= 4, f"compact form has {total_c} collective eqns"
    assert nested_c == 0, "compact-form collectives must not sit inside loops"
    assert total_c >= 2  # c and d psums are really there

    jx_s = jax.make_jaxpr(
        lambda v, h: two_loop_sharded(v, h, mesh, "param")
    )(v, gr.ring)
    total_s, nested_s = _psum_eqns(jx_s.jaxpr)
    assert nested_s >= 2  # the form being replaced psums inside the loops


def test_lbfgs_param_sharded_compact_full_solver_parity():
    """lbfgs(mesh=..., two_loop_impl='compact'): the GramRing-carrying
    solver matches the scalar-psum mesh solver and the single-device run."""
    spec = mlp_spec([12, 16, 4], ["tanh", "linear"])
    prob = mlp_problem(spec)
    w0 = mlp_init(spec, jax.random.PRNGKey(5), dtype=jnp.float64)
    x = jax.random.normal(jax.random.PRNGKey(6), (64, 12), dtype=jnp.float64)
    y = jax.nn.one_hot(jnp.arange(64) % 4, 4, dtype=jnp.float64)
    opts = LBFGSOptions(max_iters=15, tol=1e-14, m=6, line_search="armijo",
                        prefix_vag=False, ls_value_only=False)
    mesh = make_mesh(axis_name="model")

    ref = lbfgs(prob, w0, aux=(x, y), opts=opts, mesh=mesh)
    res = lbfgs(prob, w0, aux=(x, y),
                opts=opts._replace(two_loop_impl="compact"), mesh=mesh)
    assert int(res.n_iters) == int(ref.n_iters)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x), rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(res.loss_history[:15]), np.asarray(ref.loss_history[:15]),
        rtol=1e-9,
    )
    assert int(res.n_fevals) == int(ref.n_fevals)  # same trial sequence

def test_two_loop_param_sharded_bf16_ring():
    """bf16 ring rows under the parameter-sharded recursion: each shard's
    partial dot promotes its bf16 rows against the f32 working shard BEFORE
    the psum, so cross-device accumulation is f32 — the sharded direction
    matches the single-device bf16-ring direction up to reduction order."""
    from lbfgs_ffnn.ops.two_loop import (
        empty_history_state, ring_push, two_loop, two_loop_sharded,
    )
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(1)
    n, m, k = 4096, 6, 9  # multiple of 2048 (the bf16 tile row alignment)
    hist = empty_history_state(m, n, jnp.float32, pair_dtype="bfloat16")
    assert hist.S.dtype == jnp.bfloat16
    assert hist.rho.dtype == jnp.float32
    for _ in range(k):
        s = rng.normal(size=n)
        yv = rng.normal(size=n) + 0.5 * s
        if s @ yv <= 1e-3:
            continue
        s_j = jnp.asarray(s, dtype=jnp.float32)
        y_j = jnp.asarray(yv, dtype=jnp.float32)
        hist = ring_push(hist, s_j, y_j, 1.0 / jnp.vdot(y_j, s_j),
                         jnp.array(True))
    v = jnp.asarray(rng.normal(size=n), dtype=jnp.float32)

    r_single = two_loop(v, hist)

    mesh = make_mesh(axis_name="param")
    col = NamedSharding(mesh, P(None, "param", None))
    vecsh = NamedSharding(mesh, P("param"))
    hist_sh = hist._replace(
        S=jax.device_put(hist.S, col), Y=jax.device_put(hist.Y, col),
    )
    v_sh = jax.device_put(v, vecsh)
    r_sharded = two_loop_sharded(v_sh, hist_sh, mesh, "param")
    assert r_sharded.dtype == jnp.float32
    # Same bf16 stored rows on both sides; only the f32 partial-sum order
    # differs between the flat vdot and the 8-shard psum.
    np.testing.assert_allclose(
        np.asarray(r_sharded), np.asarray(r_single), rtol=2e-5, atol=2e-5
    )


@pytest.mark.parametrize("impl", ["xla", "compact"])
def test_lbfgs_param_sharded_bf16_ring_full_solver(impl):
    """lbfgs(mesh=..., pair_dtype='bfloat16') end-to-end: the narrow ring is
    sharded on its tile-row axis (rows padded to the 16x128 bf16 tile) and
    the trajectory tracks the single-device bf16-ring run (f32 psum order is
    the only difference)."""
    spec = mlp_spec([12, 16, 4], ["relu", "linear"])
    prob = mlp_problem(spec)
    w0 = mlp_init(spec, jax.random.PRNGKey(7), dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(8), (64, 12), dtype=jnp.float32)
    y = jax.nn.one_hot(jnp.arange(64) % 4, 4, dtype=jnp.float32)
    opts = LBFGSOptions(max_iters=10, tol=1e-12, m=4, line_search="wolfe",
                        prefix_vag=False, ls_value_only=False,
                        pair_dtype="bfloat16", two_loop_impl=impl)

    ref = lbfgs(prob, w0, aux=(x, y),
                opts=opts._replace(two_loop_impl="xla"))
    mesh = make_mesh(axis_name="model")
    res = lbfgs(prob, w0, aux=(x, y), opts=opts, mesh=mesh)
    assert int(res.n_iters) == int(ref.n_iters)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(
        float(res.final_loss), float(ref.final_loss), rtol=1e-3
    )


def test_lbfgs_dp_tp_2d_mesh():
    """Combined data+model parallelism on ONE 2-D mesh: the dataset is
    sharded over the ``data`` axis while the solver state (iterate,
    gradient, curvature ring) is sharded over the ``model`` axis. The
    solver only constrains the model axis, so GSPMD partitions the
    objective over both — the batch-sharded gradient's all-reduce rides
    the data axis, the two-loop's partial dots psum over the model axis.
    f64 trajectory matches the single-device run."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices for a (2, 4) mesh")

    mesh = make_mesh((2, 4), ("data", "model"))
    assert dict(mesh.shape) == {"data": 2, "model": 4}

    spec = mlp_spec([12, 16, 4], ["tanh", "linear"])
    prob = mlp_problem(spec)
    w0 = mlp_init(spec, jax.random.PRNGKey(5), dtype=jnp.float64)
    x = jax.random.normal(jax.random.PRNGKey(6), (64, 12), dtype=jnp.float64)
    y = jax.nn.one_hot(jnp.arange(64) % 4, 4, dtype=jnp.float64)
    opts = LBFGSOptions(max_iters=12, tol=1e-14, m=6, line_search="armijo",
                        prefix_vag=False, ls_value_only=False)

    ref = lbfgs(prob, w0, aux=(x, y), opts=opts)
    xs = jax.device_put(x, NamedSharding(mesh, P("data")))
    ys = jax.device_put(y, NamedSharding(mesh, P("data")))
    res = lbfgs(prob, w0, aux=(xs, ys), opts=opts, mesh=mesh,
                shard_axis="model")

    assert int(res.n_iters) == int(ref.n_iters) == 12
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-10)
    np.testing.assert_allclose(
        np.asarray(res.loss_history[:12]), np.asarray(ref.loss_history[:12]),
        rtol=1e-10,
    )
    assert int(res.n_fevals) == int(ref.n_fevals)  # same trial sequence

    # The collective-lean compact direction, bf16 ring, and bf16 backward
    # input read all compose with the 2-D mesh (production f32 policies).
    res2 = lbfgs(
        mlp_problem(spec, grad_input_dtype="bfloat16"),
        w0.astype(jnp.float32),
        aux=(xs.astype(jnp.float32), ys.astype(jnp.float32)),
        opts=opts._replace(max_iters=5, two_loop_impl="compact",
                           pair_dtype="bfloat16"),
        mesh=mesh, shard_axis="model",
    )
    assert int(res2.n_iters) == 5
    assert bool(jnp.isfinite(res2.x).all())
    assert float(res2.final_loss) < float(prob.fun(w0.astype(jnp.float32),
                                                   (xs.astype(jnp.float32),
                                                    ys.astype(jnp.float32))))


def test_lbfgs_dp_tp_chunked_resume(tmp_path):
    """The long-run story on the 2-D mesh: lbfgs_chunked runs the identical
    dp x tp body in measured chunks, and a mid-run checkpoint resumes onto
    a FRESH 2-D mesh bitwise."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lbfgs_ffnn.checkpoint import restore_checkpoint, save_checkpoint
    from lbfgs_ffnn.solvers.lbfgs import lbfgs_chunked

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices for a (2, 4) mesh")

    spec = mlp_spec([12, 16, 4], ["tanh", "linear"])
    prob = mlp_problem(spec)
    w0 = mlp_init(spec, jax.random.PRNGKey(5), dtype=jnp.float64)
    x = jax.random.normal(jax.random.PRNGKey(6), (64, 12), dtype=jnp.float64)
    y = jax.nn.one_hot(jnp.arange(64) % 4, 4, dtype=jnp.float64)
    opts = LBFGSOptions(max_iters=12, tol=1e-14, m=6, line_search="armijo",
                        prefix_vag=False, ls_value_only=False)

    mesh = make_mesh((2, 4), ("data", "model"))
    xs = jax.device_put(x, NamedSharding(mesh, P("data")))
    ys = jax.device_put(y, NamedSharding(mesh, P("data")))

    res_full, _ = lbfgs_chunked(prob, w0, aux=(xs, ys), opts=opts, chunk=4,
                                mesh=mesh)
    ref = lbfgs(prob, w0, aux=(xs, ys), opts=opts, mesh=mesh)
    np.testing.assert_array_equal(np.asarray(res_full.x), np.asarray(ref.x))

    saved = {}

    def save_at_8(state, elapsed):
        if int(state.k) == 8 and not saved:
            save_checkpoint(tmp_path / "mid2d", state)
            saved["template"] = jax.tree_util.tree_map(
                lambda a: np.zeros(a.shape, a.dtype), state
            )

    lbfgs_chunked(prob, w0, aux=(xs, ys), opts=opts, chunk=4, mesh=mesh,
                  callback=save_at_8)
    assert saved, "checkpoint callback never fired"
    restored = restore_checkpoint(tmp_path / "mid2d", saved["template"])
    assert int(restored.k) == 8

    fresh = make_mesh((2, 4), ("data", "model"))
    xs2 = jax.device_put(x, NamedSharding(fresh, P("data")))
    ys2 = jax.device_put(y, NamedSharding(fresh, P("data")))
    res_resumed, _ = lbfgs_chunked(
        prob, None, aux=(xs2, ys2), opts=opts, chunk=4, mesh=fresh,
        resume_state=restored, n_params=int(w0.shape[0]),
    )
    np.testing.assert_array_equal(np.asarray(res_resumed.x),
                                  np.asarray(res_full.x))
    assert int(res_resumed.n_iters) == int(res_full.n_iters)
