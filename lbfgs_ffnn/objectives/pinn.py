"""Physics-informed network objectives: 1D viscous Burgers and a harmonic
oscillator ODE.

The reference computes PDE derivatives with Enzyme LLVM-plugin AD — forward
JVPs for u_t/u_x and forward-over-forward for u_xx, per collocation point
inside an OpenMP loop (reference: tests/burgers/test_burgers_parallel.cpp:
43-63, 131-210), and nested reverse-mode for the oscillator's u''
(reference: tests/enzyme_test2.cpp:22-40). Here the same compositions are
``jax.jvp`` (and jvp-of-jvp) applied to the *batched* network, so every
derivative is one vectorized forward pass instead of a per-point
scalar loop; the loss gradient is one ``jax.grad`` over the whole weighted
objective.

Network conventions match the reference PINN: tanh MLP, Xavier-uniform init
``U(-sqrt(6/(in+out)), +sqrt(6/(in+out)))`` (reference:
src/enzyme/pinn_network.hpp:74-92 — unseeded there; seeded here).

**Matmul precision (load-bearing).** An accelerator's *default* f32 dot
may round its operands (to bf16, or to TF32's 10-bit mantissa on a GPU's
tensor cores). For MLP classification that is harmless, but PINN losses
differentiate the network twice — forward-over-forward jvp for u_xx — and
a short multiply mantissa poisons those second derivatives enough that an
f32 L-BFGS run stalls far above the f64 loss while exhausting its
line-search budget every iteration (3000-iter coarse Burgers once stalled
at 0.238 vs f64's 0.0118, ~85 Wolfe trials/iter). The PINN objectives
therefore trace all their matmuls under
``jax.default_matmul_precision("highest")`` (full-f32 products; AD
transposes inherit the primal dots' precision) — with it the same f32 run
reached 0.0027 (below f64's final loss) at ~2 trials/iter. The network is
20 wide, so full precision costs little; the option ``precision=``
exposes the knob regardless.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from lbfgs_ffnn.objectives.mlp import MLPSpec, mlp_apply, mlp_apply_single, mlp_spec
from lbfgs_ffnn.types import Problem, make_problem, zero_masked_rows


def pinn_init(spec: MLPSpec, key: jax.Array, dtype=jnp.float32) -> jax.Array:
    """Xavier-uniform init over the flat parameter vector."""
    parts = []
    keys = jax.random.split(key, spec.n_layers)
    for li, (w_off, b_off, d_in, d_out) in enumerate(spec.layer_slices()):
        limit = math.sqrt(6.0 / (d_in + d_out))
        parts.append(
            jax.random.uniform(
                keys[li], (d_in * d_out + d_out,),
                minval=-limit, maxval=limit, dtype=dtype,
            )
        )
    return jnp.concatenate(parts)


# ---------------------------------------------------------------------------
# Burgers: u_t + u*u_x = nu*u_xx,  u(x,0)=-? (ref: u(x,0)=sin(pi x)),
# u(+-1,t)=0,  nu = 0.01/pi
# ---------------------------------------------------------------------------

BURGERS_NU = 0.01 / math.pi


class BurgersPoints(NamedTuple):
    ic_xt: jax.Array       # (n_ic, 2)
    ic_target: jax.Array   # (n_ic,)
    bc_xt: jax.Array       # (n_bc, 2)
    col_xt: jax.Array      # (n_col, 2)


def burgers_points(
    dx: float = 0.001, dt: float = 0.005,
    int_dx: float = 0.01, int_dt: float = 0.02,
    dtype=jnp.float32,
) -> BurgersPoints:
    """Grids matching the reference runner
    (tests/burgers/test_burgers_parallel.cpp:97-115): IC on x in [-1,1] at
    t=0 with target sin(pi x); BC at x=+-1 over t in [0,1]; collocation on
    the int_dx x int_dt lattice."""
    xs_ic = np.arange(-1.0, 1.0 + dx / 2, dx)
    ic_xt = np.stack([xs_ic, np.zeros_like(xs_ic)], axis=1)
    ic_target = np.sin(np.pi * xs_ic)

    ts = np.arange(0.0, 1.0 + dt / 2, dt)
    bc_left = np.stack([-np.ones_like(ts), ts], axis=1)
    bc_right = np.stack([np.ones_like(ts), ts], axis=1)
    bc_xt = np.concatenate([bc_left, bc_right], axis=0)

    xs = np.arange(-1.0, 1.0 + int_dx / 2, int_dx)
    tc = np.arange(0.0, 1.0 + int_dt / 2, int_dt)
    gx, gt = np.meshgrid(xs, tc, indexing="ij")
    col_xt = np.stack([gx.ravel(), gt.ravel()], axis=1)

    return BurgersPoints(
        ic_xt=jnp.asarray(ic_xt, dtype=dtype),
        ic_target=jnp.asarray(ic_target, dtype=dtype),
        bc_xt=jnp.asarray(bc_xt, dtype=dtype),
        col_xt=jnp.asarray(col_xt, dtype=dtype),
    )


def default_burgers_spec(width: int = 20) -> MLPSpec:
    """2-20-20-20-1 tanh net (reference: test_burgers_parallel.cpp:25-29)."""
    return mlp_spec([2, width, width, width, 1], ["tanh", "tanh", "tanh", "linear"])


def _u(spec: MLPSpec, w: jax.Array, xt: jax.Array) -> jax.Array:
    return mlp_apply(spec, w, xt)[:, 0]


def burgers_residual(
    spec: MLPSpec, w: jax.Array, xt: jax.Array, nu: float = BURGERS_NU,
    formulation: str = "vmap",
) -> jax.Array:
    """PDE residual u_t + u*u_x - nu*u_xx at each point.

    Default ``"vmap"`` formulation: per-point scalar derivatives (jvp and
    forward-over-forward jvp — the exact composition of the reference's
    __enzyme_fwddiff calls, test_burgers_parallel.cpp:43-63) vectorized
    with ``jax.vmap``; XLA re-batches the tiny GEMMs. The ``"batched"``
    formulation pushes whole point-batches through jvp directly — it is
    mathematically identical. Its gradient once crashed an accelerator
    compiler at >~500 collocation points inside a solver loop, so
    ``"vmap"`` stayed the default; which of the two is faster on a GPU is
    not measured yet, and ``"batched"`` serves as a cross-check.
    """
    if formulation == "batched":
        n = xt.shape[0]
        ex = jnp.tile(jnp.asarray([[1.0, 0.0]], dtype=xt.dtype), (n, 1))
        et = jnp.tile(jnp.asarray([[0.0, 1.0]], dtype=xt.dtype), (n, 1))

        def u_fn(pts):
            return _u(spec, w, pts)

        u, u_x = jax.jvp(u_fn, (xt,), (ex,))
        _, u_t = jax.jvp(u_fn, (xt,), (et,))

        def u_x_fn(pts):
            return jax.jvp(
                u_fn, (pts,),
                (jnp.ones_like(pts) * jnp.asarray([1.0, 0.0], dtype=pts.dtype),),
            )[1]

        _, u_xx = jax.jvp(u_x_fn, (xt,), (ex,))
        return u_t + u * u_x - nu * u_xx

    def u1(pt):
        return mlp_apply_single(spec, w, pt)[0]

    def per_point(pt):
        ex = jnp.asarray([1.0, 0.0], dtype=pt.dtype)
        et = jnp.asarray([0.0, 1.0], dtype=pt.dtype)
        u, u_x = jax.jvp(u1, (pt,), (ex,))
        _, u_t = jax.jvp(u1, (pt,), (et,))

        def u_x_fn(q):
            return jax.jvp(u1, (q,), (ex,))[1]

        _, u_xx = jax.jvp(u_x_fn, (pt,), (ex,))
        return u_t + u * u_x - nu * u_xx

    return jax.vmap(per_point)(xt)


class MaskedBurgersPoints(NamedTuple):
    """Burgers point sets zero-padded to a common multiple with 0/1 row
    masks — the fixed-shape form the data-parallel objective shards over a
    device mesh (each of the four sets is ragged; padding makes every
    device's shard equal-size so psum-of-local-sums is the exact global
    sum)."""

    ic_xt: jax.Array       # (n_ic_pad, 2)
    ic_target: jax.Array   # (n_ic_pad,)
    ic_mask: jax.Array     # (n_ic_pad,)
    bc_xt: jax.Array       # (n_bc_pad, 2)
    bc_mask: jax.Array     # (n_bc_pad,)
    col_xt: jax.Array      # (n_col_pad, 2)
    col_mask: jax.Array    # (n_col_pad,)


def pad_burgers_points(pts: BurgersPoints, n_shards: int) -> MaskedBurgersPoints:
    """Zero-pad each point set to a multiple of ``n_shards`` with row masks.

    Padding rows are zeros (never NaN): together with the masked-mean
    discipline in the data-parallel loss this keeps both the forward and
    the VJP clean (see types.zero_masked_rows)."""

    def pad1(a, n_pad):
        return jnp.pad(a, ((0, n_pad),) + ((0, 0),) * (a.ndim - 1))

    def padded(a):
        n = a.shape[0]
        n_pad = (-n) % n_shards
        mask = jnp.concatenate([
            jnp.ones((n,), dtype=a.dtype), jnp.zeros((n_pad,), dtype=a.dtype)
        ])
        return pad1(a, n_pad), mask

    ic_xt, ic_mask = padded(pts.ic_xt)
    ic_target = jnp.pad(pts.ic_target, (0, ic_xt.shape[0] - pts.ic_target.shape[0]))
    bc_xt, bc_mask = padded(pts.bc_xt)
    col_xt, col_mask = padded(pts.col_xt)
    return MaskedBurgersPoints(
        ic_xt=ic_xt, ic_target=ic_target, ic_mask=ic_mask,
        bc_xt=bc_xt, bc_mask=bc_mask, col_xt=col_xt, col_mask=col_mask,
    )


def shard_burgers_points(mesh, mpts: MaskedBurgersPoints, axis_name: str = "data"):
    """Place every padded array with its point axis sharded over the mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(axis_name))
    return MaskedBurgersPoints(
        *(jax.device_put(a, sharding) for a in mpts)
    )


def burgers_problem(
    spec: MLPSpec | None = None,
    w_ic: float = 20.0,
    w_bc: float = 20.0,
    w_pde: float = 1.0,
    nu: float = BURGERS_NU,
    precision: str = "highest",
    mesh=None,
    axis_name: str = "data",
) -> Problem:
    """Weighted IC/BC/PDE mean-squared loss
    (reference: test_burgers_parallel.cpp:127-161).

    ``precision`` sets the matmul precision the loss (and everything AD
    derives from it) is traced under — "highest" is required for f32
    convergence (see the module docstring).

    With ``mesh`` given, the returned problem is **data-parallel over the
    collocation/IC/BC point axes** — the multi-device generalization of the
    reference's OpenMP loop over points with a critical-section gradient
    reduction (reference: tests/burgers/test_burgers_parallel.cpp:171-208).
    ``aux`` must then be a :class:`MaskedBurgersPoints` (from
    :func:`pad_burgers_points`, ideally placed with
    :func:`shard_burgers_points`); each device evaluates its point shards
    and the three weighted mean residual terms are ``psum``-reduced; the
    weight-cotangent all-reduce is inserted by shard_map's transpose.
    Solver state (weights, curvature ring, line search) stays replicated.
    """
    spec = spec or default_burgers_spec()

    if mesh is None:
        def fun(w, aux):
            pts: BurgersPoints = aux
            with jax.default_matmul_precision(precision):
                u_ic = _u(spec, w, pts.ic_xt)
                loss_ic = jnp.mean((u_ic - pts.ic_target) ** 2)
                u_bc = _u(spec, w, pts.bc_xt)
                loss_bc = jnp.mean(u_bc**2)
                r = burgers_residual(spec, w, pts.col_xt, nu)
                loss_pde = jnp.mean(r**2)
                return w_ic * loss_ic + w_bc * loss_bc + w_pde * loss_pde

        return make_problem(fun)

    from jax.sharding import PartitionSpec as P

    axis = axis_name

    def local(w, ic_xt, ic_t, ic_m, bc_xt, bc_m, col_xt, col_m):
        # Masked means with the padded rows zeroed BEFORE the network sees
        # them (zero cotangent times a NaN activation is NaN — same
        # discipline as parallel/shard.py fun_masked_local). psum of local
        # masked sums over equal-size shards is the exact global sum; the
        # divisor is the true (unpadded) point count.
        ic_xt = zero_masked_rows(ic_m, ic_xt)
        bc_xt = zero_masked_rows(bc_m, bc_xt)
        col_xt = zero_masked_rows(col_m, col_xt)
        u_ic = _u(spec, w, ic_xt)
        s_ic = jnp.sum(jnp.where(ic_m > 0, (u_ic - ic_t) ** 2, 0.0))
        u_bc = _u(spec, w, bc_xt)
        s_bc = jnp.sum(jnp.where(bc_m > 0, u_bc**2, 0.0))
        r = burgers_residual(spec, w, col_xt, nu)
        s_pde = jnp.sum(jnp.where(col_m > 0, r**2, 0.0))
        # ONE psum of the stacked partial sums + mask counts instead of six
        # scalar collectives — this sits on the line-search hot path (every
        # trial evaluates the loss). Elementwise psum of the stack is the
        # same additions in the same order, so values are bit-identical.
        sums = jax.lax.psum(
            jnp.stack([s_ic, jnp.sum(ic_m), s_bc, jnp.sum(bc_m),
                       s_pde, jnp.sum(col_m)]), axis)
        return (w_ic * sums[0] / sums[1] + w_bc * sums[2] / sums[3]
                + w_pde * sums[4] / sums[5])

    def fun(w, aux):
        mp: MaskedBurgersPoints = aux
        with jax.default_matmul_precision(precision):
            # check_vma=False: the residual's vmapped jvp-of-jvp creates
            # unvarying tangent constants (the e_x/e_t seed vectors) that
            # feed dot_generals against device-varying activations, which
            # the strict varying-manual-axes checker rejects even though
            # the program is valid. Disabling the check keeps the exact
            # same collectives; loss/grad equality with the single-device
            # objective is pinned in tests/test_pinn.py.
            return jax.shard_map(
                local, mesh=mesh,
                in_specs=(P(),) + (P(axis),) * 7, out_specs=P(),
                check_vma=False,
            )(w, *mp)

    return make_problem(fun)


# ---------------------------------------------------------------------------
# Harmonic oscillator ODE: u'' + u = 0, u(0)=0, u'(0)=1  =>  u = sin(x)
# (reference: tests/enzyme_test2.cpp)
# ---------------------------------------------------------------------------

def default_oscillator_spec(width: int = 16) -> MLPSpec:
    return mlp_spec([1, width, width, 1], ["tanh", "tanh", "linear"])


def oscillator_problem(
    spec: MLPSpec | None = None,
    w_ode: float = 1.0,
    w_bc: float = 1.0,
    precision: str = "highest",
) -> Problem:
    """ODE residual + initial conditions, with u'' from jvp-of-jvp (the
    reference nests reverse-mode Enzyme for the same second derivative,
    enzyme_test2.cpp:22-40). ``precision``: see the module docstring."""
    spec = spec or default_oscillator_spec()

    def fun(w, aux):
        xs = aux  # (n, 1) collocation points

        with jax.default_matmul_precision(precision):
            def u1(pt):
                return mlp_apply_single(spec, w, pt)[0]

            def per_point(pt):
                one = jnp.ones_like(pt)
                u, du = jax.jvp(u1, (pt,), (one,))

                def du_fn(q):
                    return jax.jvp(u1, (q,), (jnp.ones_like(q),))[1]

                _, ddu = jax.jvp(du_fn, (pt,), (one,))
                return u, ddu

            u, ddu = jax.vmap(per_point)(xs)
            ode = jnp.mean((ddu + u) ** 2)

            x0 = jnp.zeros((1,), dtype=xs.dtype)
            u0, du0 = jax.jvp(u1, (x0,), (jnp.ones_like(x0),))
            bc = u0**2 + (du0 - 1.0) ** 2
            return w_ode * ode + w_bc * bc

    return make_problem(fun)


def oscillator_points(n: int = 64, x_max: float = math.pi, dtype=jnp.float32) -> jax.Array:
    return jnp.linspace(0.0, x_max, n, dtype=dtype).reshape(-1, 1)
