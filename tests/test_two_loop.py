"""Property tests for the two-loop recursion and ring buffer.

The reference has no such tests; SURVEY.md §4 calls for validating the
two-loop against a dense inverse-Hessian oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_ffnn.ops.two_loop import (
    empty_history_state,
    ring_push,
    ring_reset,
    two_loop,
)


def dense_inverse_hessian(S, Y, n):
    """Oracle: explicit BFGS inverse-Hessian built from (s, y) pairs,
    H_{k+1} = (I - rho s y^T) H_k (I - rho y s^T) + rho s s^T, with
    H_0 = gamma I from the newest pair."""
    pairs = list(zip(S, Y))
    s_last, y_last = pairs[-1]
    gamma = float(s_last @ y_last) / float(y_last @ y_last)
    H = gamma * np.eye(n)
    for s, y in pairs:
        rho = 1.0 / float(y @ s)
        V = np.eye(n) - rho * np.outer(s, y)
        H = V @ H @ V.T + rho * np.outer(s, s)
    return H


def push_pairs(hist, pairs):
    for s, y in pairs:
        rho = 1.0 / jnp.vdot(y, s)
        hist = ring_push(hist, s, y, rho, jnp.array(True))
    return hist


@pytest.mark.parametrize("n,m,k", [(8, 5, 3), (8, 5, 5), (16, 4, 9)])
def test_two_loop_matches_dense_oracle(n, m, k):
    """two_loop(H, g) == dense-H @ g for any fill level, including a wrapped
    ring (k > m keeps only the newest m pairs)."""
    rng = np.random.default_rng(0)
    pairs = []
    while len(pairs) < k:
        s = rng.normal(size=n)
        y = rng.normal(size=n) + 0.5 * s  # bias towards y^T s > 0
        if s @ y > 1e-3:
            pairs.append((s, y))

    hist = empty_history_state(m, n, jnp.float64)
    hist = push_pairs(hist, [(jnp.asarray(s), jnp.asarray(y)) for s, y in pairs])

    g = jnp.asarray(rng.normal(size=n))
    r = two_loop(g, hist)

    H = dense_inverse_hessian(*zip(*pairs[-m:]), n) if k >= m else dense_inverse_hessian(
        *zip(*pairs), n
    )
    np.testing.assert_allclose(np.asarray(r), H @ np.asarray(g), rtol=1e-10, atol=1e-12)


def test_two_loop_empty_history_is_identity():
    hist = empty_history_state(4, 6, jnp.float64)
    g = jnp.arange(6.0)
    np.testing.assert_allclose(np.asarray(two_loop(g, hist)), np.asarray(g))


def test_ring_push_overwrites_oldest():
    n, m = 3, 2
    hist = empty_history_state(m, n, jnp.float64)
    vecs = [jnp.full((n,), float(i + 1)) for i in range(3)]
    for v in vecs:
        hist = ring_push(hist, v, v, jnp.vdot(v, v), jnp.array(True))
    assert int(hist.count) == m
    # slots now hold vecs[2] (head wrapped) and vecs[1]
    vals = sorted(float(hist.S[i, 0, 0]) for i in range(m))
    assert vals == [2.0, 3.0]


def test_ring_push_rejected_pair_is_noop():
    hist = empty_history_state(2, 3, jnp.float64)
    v = jnp.ones((3,))
    hist2 = ring_push(hist, v, v, jnp.asarray(1.0), jnp.array(False))
    assert int(hist2.count) == 0
    np.testing.assert_array_equal(np.asarray(hist2.S), np.asarray(hist.S))


def test_ring_reset():
    hist = empty_history_state(2, 3, jnp.float64)
    v = jnp.ones((3,))
    hist = ring_push(hist, v, v, jnp.asarray(1.0), jnp.array(True))
    hist = ring_reset(hist, jnp.array(True))
    assert int(hist.count) == 0 and int(hist.head) == 0


def test_gamma_clamp_guard():
    """clamp_gamma mode: tiny y^T y -> gamma = 1 (reference s_lbfgs.hpp:119-127)."""
    n, m = 4, 2
    hist = empty_history_state(m, n, jnp.float64)
    s = jnp.ones((n,))
    y = jnp.full((n,), 1e-10)
    hist = ring_push(hist, s, y, 1.0 / jnp.vdot(y, s), jnp.array(True))
    g = jnp.ones((n,))
    r = two_loop(g, hist, clamp_gamma=True)
    assert bool(jnp.all(jnp.isfinite(r)))


def test_compact_matches_loop_form():
    """The GEMM-form compact recursion computes
    the same H_k @ v as the loop form across fills, wrap-around and both
    gamma policies."""
    from lbfgs_ffnn.ops.two_loop import two_loop_compact

    rng = np.random.default_rng(3)
    for n, m, k in [(300, 5, 0), (300, 5, 3), (300, 5, 5), (300, 4, 9),
                    (1500, 8, 6)]:
        hist = empty_history_state(m, n, jnp.float64)
        for _ in range(k):
            s = rng.normal(size=n)
            y = rng.normal(size=n) + 0.5 * s
            if s @ y <= 1e-3:
                continue
            s_j, y_j = jnp.asarray(s), jnp.asarray(y)
            hist = ring_push(hist, s_j, y_j, 1.0 / jnp.vdot(y_j, s_j),
                             jnp.array(True))
        v = jnp.asarray(rng.normal(size=n))
        for cg in (False, True):
            np.testing.assert_allclose(
                np.asarray(two_loop_compact(v, hist, clamp_gamma=cg)),
                np.asarray(two_loop(v, hist, clamp_gamma=cg)),
                rtol=1e-11, atol=1e-11,
            )


def test_gram_push_maintains_exact_gram():
    """GramRing's incremental M == the fresh S.Y^T Gram (physical slots)
    through fills, wrap-around, and a rejected push; yy likewise."""
    from lbfgs_ffnn.ops.two_loop import GramRing, gram_empty, gram_push

    rng = np.random.default_rng(11)
    n, m = 300, 4
    gr = gram_empty(m, n, jnp.float64)
    pushes = 0
    for t in range(9):
        s = rng.normal(size=n)
        y = rng.normal(size=n) + 0.5 * s
        accept = t != 3  # one rejected push must be a Gram no-op
        gr = gram_push(
            gr, jnp.asarray(s), jnp.asarray(y),
            1.0 / jnp.vdot(jnp.asarray(y), jnp.asarray(s)), jnp.array(accept)
        )
        pushes += accept
        # fresh Gram over the PHYSICAL slots (invalid slots are zero rows,
        # so their fresh entries are 0; M holds garbage there — mask both)
        S2 = np.asarray(gr.ring.S.reshape(m, -1))
        Y2 = np.asarray(gr.ring.Y.reshape(m, -1))
        fresh = S2 @ Y2.T
        cnt = int(gr.ring.count)
        head = int(gr.ring.head)
        valid_phys = [(head - cnt + li) % m for li in range(cnt)]
        got = np.asarray(gr.M)
        for i in valid_phys:
            for j in valid_phys:
                np.testing.assert_allclose(got[i, j], fresh[i, j], rtol=1e-12)
            np.testing.assert_allclose(
                float(gr.yy[i]), float(Y2[i] @ Y2[i]), rtol=1e-12
            )
    assert int(gr.ring.count) == m and pushes > m  # wrapped


def _random_history(m, n, k, seed=0, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    hist = empty_history_state(m, n, dtype)
    pushed = 0
    while pushed < k:
        s = rng.normal(size=n)
        y = rng.normal(size=n) + 0.5 * s
        if s @ y > 1e-3:
            s_j = jnp.asarray(s, dtype=dtype)
            y_j = jnp.asarray(y, dtype=dtype)
            hist = ring_push(hist, s_j, y_j, 1.0 / jnp.vdot(y_j, s_j),
                             jnp.array(True))
            pushed += 1
    return hist


@pytest.mark.parametrize("impl", ["xla", "compact"])
@pytest.mark.parametrize("m,k,n,tol", [
    (6, 4, 200_000, 5e-4),   # partly filled ring
    (6, 9, 200_000, 5e-4),   # wrapped ring
    (3, 2, 525_312, 1e-3),   # half a million parameters
])
def test_two_loop_f32_matches_f64_oracle_at_scale(impl, m, k, n, tol):
    """Both f32 forms of the direction against the same recursion run in
    float64, at parameter counts where the f32 reductions accumulate real
    rounding error (dots of magnitude ~sqrt(n))."""
    from lbfgs_ffnn.ops.two_loop import two_loop_compact

    fn = {"xla": two_loop, "compact": two_loop_compact}[impl]
    hist = _random_history(m, n, k, seed=m + k)
    v = jnp.asarray(np.random.default_rng(3).normal(size=n), dtype=jnp.float32)
    hist64 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64) if a.dtype == jnp.float32 else a, hist
    )
    oracle = np.asarray(two_loop(v.astype(jnp.float64), hist64))
    r = np.asarray(fn(v, hist))
    assert r.dtype == np.float32
    np.testing.assert_allclose(r, oracle, atol=tol, rtol=tol)


@pytest.mark.parametrize("impl", ["xla", "compact"])
def test_bf16_pair_ring_matches_f32_ring(impl):
    """pair_dtype="bfloat16" ring: every implementation must (a) agree with
    the f32-ring result at bf16 rounding tolerance, and (b) agree with the
    loop form running on the SAME bf16 ring to f32 round-off — the rounding
    happens once, at the push, not per-implementation."""
    from lbfgs_ffnn.ops.two_loop import two_loop_compact

    m, n, k = 5, 3000, 4
    rng = np.random.default_rng(11)
    h16 = empty_history_state(m, n, jnp.float32, pair_dtype=jnp.bfloat16)
    hf = empty_history_state(m, n, jnp.float32)
    assert h16.S.dtype == jnp.bfloat16 and h16.rho.dtype == jnp.float32
    assert h16.S.shape[1] % 16 == 0  # rows padded to the bf16 alignment
    for _ in range(k):
        s = rng.normal(size=n)
        y = rng.normal(size=n) + 0.5 * s
        sj = jnp.asarray(s, jnp.float32)
        yj = jnp.asarray(y, jnp.float32)
        rho = 1.0 / jnp.vdot(yj, sj)
        h16 = ring_push(h16, sj, yj, rho, jnp.array(True))
        hf = ring_push(hf, sj, yj, rho, jnp.array(True))
    v = jnp.asarray(rng.normal(size=n), jnp.float32)
    r_f32 = np.asarray(two_loop(v, hf))
    fn = {"xla": two_loop, "compact": two_loop_compact}[impl]
    r = np.asarray(fn(v, h16))
    assert r.dtype == np.float32  # arithmetic stays in the solver dtype
    scale = np.abs(r_f32).max()
    assert np.abs(r - r_f32).max() / scale < 5e-3      # bf16 storage rounding
    r16_ref = np.asarray(two_loop(v, h16))
    assert np.abs(r - r16_ref).max() / scale < 5e-5    # same-ring consistency


def test_lbfgs_pair_dtype_option():
    """Solver-level bf16 ring: converges like the f32 ring on a small MLP,
    the carried history really is bf16, and the mesh mode runs it too."""
    from lbfgs_ffnn.objectives.mlp import mlp_init, mlp_problem, mlp_spec
    from lbfgs_ffnn.solvers.lbfgs import LBFGSOptions, lbfgs

    rng = np.random.default_rng(5)
    X = jnp.asarray(rng.normal(size=(256, 16)), jnp.float32)
    Y = jax.nn.one_hot(jnp.asarray(rng.integers(0, 4, 256)), 4,
                       dtype=jnp.float32)
    spec = mlp_spec([16, 32, 4], ["relu", "linear"])
    prob = mlp_problem(spec)
    w0 = mlp_init(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    res_f = lbfgs(prob, w0, (X, Y), LBFGSOptions(max_iters=60, m=10))
    res_b = lbfgs(prob, w0, (X, Y),
                  LBFGSOptions(max_iters=60, m=10, pair_dtype="bfloat16"))
    assert float(res_b.final_loss) < 1.10 * float(res_f.final_loss) + 1e-3

    from jax.sharding import Mesh

    # Mesh mode accepts the narrow ring too (rows padded to the bf16
    # alignment, partial dots promote before the psum so accumulation stays
    # f32) — multi-device trajectory parity is pinned in
    # tests/test_parallel.py::test_lbfgs_param_sharded_bf16_ring_full_solver.
    mesh = Mesh(np.array(jax.devices()[:1]), ("model",))
    res_m = lbfgs(prob, w0, (X, Y),
                  LBFGSOptions(max_iters=3, pair_dtype="bfloat16"), mesh=mesh)
    assert int(res_m.n_iters) == 3


@pytest.mark.parametrize("solver", ["lbfgs", "lbfgs_mesh", "slbfgs"])
def test_unknown_two_loop_impl_is_rejected(solver):
    """Only the loop and compact forms exist; any other name (e.g. the
    retired fused-kernel option) raises instead of silently picking one."""
    from jax.sharding import Mesh

    from lbfgs_ffnn.objectives.mlp import (
        mlp_batch_problem, mlp_init, mlp_problem, mlp_spec,
    )
    from lbfgs_ffnn.solvers import LBFGSOptions, SLBFGSOptions, lbfgs, slbfgs

    spec = mlp_spec([4, 3, 2], ["relu", "linear"])
    w0 = mlp_init(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    X = jnp.ones((8, 4), jnp.float32)
    Y = jnp.zeros((8, 2), jnp.float32)
    with pytest.raises(ValueError, match="two_loop_impl"):
        if solver == "slbfgs":
            slbfgs(mlp_batch_problem(spec), w0, X, Y,
                   SLBFGSOptions(epochs=1, batch_size=4, two_loop_impl="pallas"))
        else:
            mesh = (Mesh(np.array(jax.devices()[:1]), ("model",))
                    if solver == "lbfgs_mesh" else None)
            lbfgs(mlp_problem(spec), w0, (X, Y),
                  LBFGSOptions(max_iters=2, two_loop_impl="pallas"), mesh=mesh)
