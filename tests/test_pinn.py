"""PINN objective tests: derivative correctness against closed forms, and
small training runs (the reference trains Burgers with L-BFGS m=100 and
validates the oscillator against sin(x), tests/burgers/*, enzyme_test2.cpp)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_ffnn.objectives.mlp import mlp_apply, mlp_spec
from lbfgs_ffnn.objectives.pinn import (
    BURGERS_NU,
    burgers_points,
    burgers_problem,
    burgers_residual,
    default_burgers_spec,
    default_oscillator_spec,
    oscillator_points,
    oscillator_problem,
    pinn_init,
)
from lbfgs_ffnn.solvers import LBFGSOptions, lbfgs


def test_pinn_init_xavier_bounds():
    spec = default_burgers_spec()
    w = pinn_init(spec, jax.random.PRNGKey(0), dtype=jnp.float64)
    assert w.shape == (spec.n_params,)
    limit0 = math.sqrt(6.0 / (2 + 20))
    first = np.asarray(w[: 2 * 20 + 20])
    assert np.abs(first).max() <= limit0 + 1e-12
    assert np.abs(first).max() > 0.5 * limit0  # actually fills the range


def test_burgers_residual_derivatives_vs_fd():
    """jvp-composed u_t, u_x, u_xx agree with finite differences of the net."""
    spec = default_burgers_spec(width=8)
    w = pinn_init(spec, jax.random.PRNGKey(1), dtype=jnp.float64)
    xt = jnp.asarray([[0.3, 0.4], [-0.5, 0.9]], dtype=jnp.float64)
    r = burgers_residual(spec, w, xt)

    def u(pt):
        return float(mlp_apply(spec, w, pt.reshape(1, 2))[0, 0])

    eps = 1e-6
    for k in range(xt.shape[0]):
        p = np.asarray(xt[k])
        ux = (u(jnp.asarray(p + [eps, 0])) - u(jnp.asarray(p - [eps, 0]))) / (2 * eps)
        ut = (u(jnp.asarray(p + [0, eps])) - u(jnp.asarray(p - [0, eps]))) / (2 * eps)
        uxx = (
            u(jnp.asarray(p + [eps, 0])) - 2 * u(jnp.asarray(p)) + u(jnp.asarray(p - [eps, 0]))
        ) / eps**2
        expected = ut + u(jnp.asarray(p)) * ux - BURGERS_NU * uxx
        np.testing.assert_allclose(float(r[k]), expected, rtol=1e-4, atol=1e-6)


def test_burgers_points_shapes_match_reference_grids():
    pts = burgers_points()
    assert pts.ic_xt.shape[0] == 2001   # x in [-1,1] step .001
    assert pts.bc_xt.shape[0] == 402    # 2 walls x 201 times
    assert pts.col_xt.shape[0] == 201 * 51
    np.testing.assert_allclose(
        np.asarray(pts.ic_target), np.sin(np.pi * np.asarray(pts.ic_xt[:, 0])),
        rtol=1e-5, atol=1e-6,
    )


def test_burgers_training_reduces_loss():
    """Short L-BFGS run on a coarse grid must cut the loss substantially."""
    spec = default_burgers_spec(width=10)
    prob = burgers_problem(spec)
    pts = burgers_points(dx=0.05, dt=0.1, int_dx=0.1, int_dt=0.2, dtype=jnp.float64)
    w0 = pinn_init(spec, jax.random.PRNGKey(2), dtype=jnp.float64)
    f0 = float(prob.fun(w0, pts))
    res = lbfgs(prob, w0, aux=pts, opts=LBFGSOptions(max_iters=150, tol=1e-12, m=20))
    assert float(res.final_loss) < 0.05 * f0


def test_oscillator_learns_sin():
    """Train u''+u=0, u(0)=0, u'(0)=1 and validate against sin(x) — the
    reference gate (enzyme_test2.cpp:87-94)."""
    spec = default_oscillator_spec(width=12)
    prob = oscillator_problem(spec)
    xs = oscillator_points(48, x_max=math.pi, dtype=jnp.float64)
    w0 = pinn_init(spec, jax.random.PRNGKey(3), dtype=jnp.float64)
    res = lbfgs(prob, w0, aux=xs, opts=LBFGSOptions(max_iters=400, tol=1e-12, m=30))
    u = mlp_apply(spec, res.x, xs)[:, 0]
    err = float(jnp.max(jnp.abs(u - jnp.sin(xs[:, 0]))))
    assert err < 0.05, f"max |u - sin| = {err}"


def test_burgers_data_parallel_matches_single_device():
    """Data-parallel Burgers objective (the reference's one genuine
    parallelism axis: OpenMP over collocation points with a critical-section
    gradient reduction, tests/burgers/test_burgers_parallel.cpp:171-208)
    sharded over the 8-virtual-device mesh: loss and gradient match the
    single-device objective, and a short f64 L-BFGS trajectory stays on the
    single-device trajectory."""
    from lbfgs_ffnn.objectives.pinn import (
        pad_burgers_points, shard_burgers_points,
    )
    from lbfgs_ffnn.parallel import make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs multi-device (virtual CPU farm)")
    mesh = make_mesh(axis_name="data")
    n_dev = mesh.devices.size

    spec = default_burgers_spec(width=10)
    prob = burgers_problem(spec)
    dp_prob = burgers_problem(spec, mesh=mesh)
    # coarse ragged grids: none of the three sets divides 8 evenly
    pts = burgers_points(dx=0.05, dt=0.1, int_dx=0.1, int_dt=0.2,
                         dtype=jnp.float64)
    assert pts.ic_xt.shape[0] % n_dev != 0  # padding actually exercised
    mpts = shard_burgers_points(mesh, pad_burgers_points(pts, n_dev))
    w0 = pinn_init(spec, jax.random.PRNGKey(2), dtype=jnp.float64)

    f_ref, g_ref = prob.value_and_grad(w0, pts)
    f_dp, g_dp = dp_prob.value_and_grad(w0, mpts)
    np.testing.assert_allclose(float(f_dp), float(f_ref), rtol=1e-13)
    np.testing.assert_allclose(np.asarray(g_dp), np.asarray(g_ref),
                               rtol=1e-10, atol=1e-13)

    opts = LBFGSOptions(max_iters=25, tol=1e-12, m=10)
    res_ref = lbfgs(prob, w0, aux=pts, opts=opts)
    res_dp = lbfgs(dp_prob, w0, aux=mpts, opts=opts)
    np.testing.assert_allclose(np.asarray(res_dp.x), np.asarray(res_ref.x),
                               rtol=1e-8, atol=1e-10)
    assert int(res_dp.n_fevals) == int(res_ref.n_fevals)


def test_fd_oracle_sanity():
    """The FD Burgers reference solution: IC reproduced, BCs held, and the
    solution decays (viscosity) while steepening near x=0."""
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    from burgers_fd import solve_burgers_fd

    x, snaps = solve_burgers_fd(nx=401, snapshot_times=(0.0, 0.5))
    np.testing.assert_allclose(snaps[0.0], np.sin(np.pi * x), atol=1e-12)
    u_half = snaps[0.5]
    assert abs(u_half[0]) < 1e-12 and abs(u_half[-1]) < 1e-12
    assert np.abs(u_half).max() < 1.0  # decayed from the IC amplitude
    assert np.abs(u_half).max() > 0.3  # but not trivially zero


def test_residual_formulations_agree():
    """vmap (default) and batched jvp formulations are the same math."""
    spec = default_burgers_spec(width=8)
    w = pinn_init(spec, jax.random.PRNGKey(5), dtype=jnp.float64)
    xt = jnp.asarray(np.random.default_rng(1).uniform(-1, 1, (37, 2)), jnp.float64)
    r_v = burgers_residual(spec, w, xt, formulation="vmap")
    r_b = burgers_residual(spec, w, xt, formulation="batched")
    np.testing.assert_allclose(np.asarray(r_v), np.asarray(r_b), rtol=1e-10, atol=1e-12)


def test_pinn_objectives_trace_highest_precision_matmuls():
    """The PINN losses must trace their dots at HIGHEST matmul precision:
    A default-precision f32 dot may use bf16/TF32 multiplies, which poison the
    forward-over-forward u_xx derivatives badly enough that f32 L-BFGS
    stalls ~20x above the f64 loss (measured; see objectives/pinn.py
    docstring). This pins the fix at the jaxpr level so it cannot silently
    regress."""
    import jax
    from jax import lax
    from lbfgs_ffnn.objectives.pinn import (
        burgers_points, burgers_problem, oscillator_points, oscillator_problem,
    )

    def dot_precisions(fun, *args):
        precs = []

        def walk(jaxpr):
            for eqn in jaxpr.eqns:
                if eqn.primitive.name == "dot_general":
                    precs.append(eqn.params.get("precision"))
                for v in eqn.params.values():
                    if hasattr(v, "jaxpr"):  # nested (pjit/custom_jvp...)
                        walk(v.jaxpr)
                    elif isinstance(v, (list, tuple)):
                        for vi in v:
                            if hasattr(vi, "jaxpr"):
                                walk(vi.jaxpr)

        walk(jax.make_jaxpr(fun)(*args).jaxpr)
        return precs

    prob = burgers_problem()
    pts = burgers_points(dx=0.1, dt=0.2, int_dx=0.25, int_dt=0.5, dtype=jnp.float32)
    w = pinn_init(default_burgers_spec(), jax.random.PRNGKey(0))
    precs = dot_precisions(lambda w: prob.value_and_grad(w, pts), w)
    assert precs, "no dot_general found in the traced PINN value_and_grad"
    assert all(
        p == (lax.Precision.HIGHEST, lax.Precision.HIGHEST) for p in precs
    ), f"non-HIGHEST dots in the PINN objective: {set(precs)}"

    oprob = oscillator_problem()
    xs = oscillator_points(8)
    w2 = pinn_init(default_oscillator_spec(), jax.random.PRNGKey(1))
    precs2 = dot_precisions(lambda w: oprob.grad(w, xs), w2)
    assert precs2 and all(
        p == (lax.Precision.HIGHEST, lax.Precision.HIGHEST) for p in precs2
    )
