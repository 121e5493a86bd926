"""Burgers PINN trainer — the reference's tests/burgers/test_burgers_parallel.cpp
experiment: 2-20-20-20-1 tanh net, weighted IC(20)/BC(20)/PDE(1) loss,
L-BFGS m=100, then an extrapolation CSV at t = 0, 0.5, 1.0 (interpolation)
and t = 1.5 (extrapolation) in the reference's x,t,u,type format.

Usage: python experiments/run_burgers.py [--iters 5000] [--coarse]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import argparse
import time

parser = argparse.ArgumentParser()
parser.add_argument("--iters", type=int, default=5000)
parser.add_argument("--coarse", action="store_true", help="coarser grids for a quick run")
parser.add_argument("--f64", action="store_true")
parser.add_argument("--curvature", choices=["grad_diff", "hvp"], default="grad_diff",
                    help="L-BFGS curvature pairs. grad_diff (default) is the "
                         "reference policy and reaches the best loss now that "
                         "the PINN matmuls run at full f32 precision; hvp "
                         "(exact H*s) needs ~6x fewer line-search trials at a "
                         "slightly higher final loss")
parser.add_argument("--warm-alpha", action="store_true",
                    help="warm-started line-search initial step "
                         "(ls_alpha_init='warm'): resume each Wolfe search "
                         "at min(1, 8*alpha_prev) instead of alpha0=1 — "
                         "candidate for the PINN plateau's trial burn "
                         "(PERF.md)")
parser.add_argument("--out", default="burgers_test_extrapolation.csv")
args = parser.parse_args()

import jax  # noqa: E402

from lbfgs_ffnn.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
if args.f64:
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from lbfgs_ffnn.objectives.mlp import mlp_apply  # noqa: E402
from lbfgs_ffnn.objectives.pinn import (  # noqa: E402
    burgers_points, burgers_problem, default_burgers_spec, pinn_init,
)
from lbfgs_ffnn.solvers import LBFGSOptions, lbfgs  # noqa: E402

dtype = jnp.float64 if args.f64 else jnp.float32
spec = default_burgers_spec()
prob = burgers_problem(spec)
if args.coarse:
    pts = burgers_points(dx=0.01, dt=0.02, int_dx=0.04, int_dt=0.08, dtype=dtype)
else:
    pts = burgers_points(dtype=dtype)
print(f"PDE Points: {pts.col_xt.shape[0]}")

w0 = pinn_init(spec, jax.random.PRNGKey(123), dtype=dtype)
# f32 runs use the scale-invariant curvature gate (the absolute 1e-10 gate
# under-rejects noisy f32 pairs near the plateau; measured loss 0.38 -> 0.23
# on the full grid).
rel = 0.0 if args.f64 else 1e-6
curv = args.curvature
# ls_value_only: the PINN plateau exhausts many Wolfe trials per iteration;
# jvp trials are cheaper there than fused value_and_grad trials.
opts = LBFGSOptions(max_iters=args.iters, tol=1e-10, m=100, ls_max_iters=100,
                    curvature_rel_eps=rel, ls_value_only=True,
                    curvature_pairs=curv,
                    ls_alpha_init="warm" if args.warm_alpha else "fixed")

# No warm-up solve: it would double long runs, in which compilation is a
# negligible slice of the wall time.
t0 = time.perf_counter()
res = lbfgs(prob, w0, aux=pts, opts=opts)
loss = float(res.final_loss)
print(f"Training Time (incl. compile): {time.perf_counter() - t0:.1f}s  "
      f"iters={int(res.n_iters)} loss={loss:.6g} ||g||={float(res.final_gnorm):.3g} "
      f"nf={int(res.n_fevals)} ng={int(res.n_gevals)}")

with open(args.out, "w") as f:
    f.write("x,t,u,type\n")
    xs = jnp.arange(-1.0, 1.0 + 0.01, 0.02, dtype=dtype)
    for t, typ in [(0.0, 0), (0.5, 0), (1.0, 0), (1.5, 2)]:
        xt = jnp.stack([xs, jnp.full_like(xs, t)], axis=1)
        with jax.default_matmul_precision("highest"):
            u = mlp_apply(spec, res.x, xt)[:, 0]
        for xi, ui in zip(xs, u):
            f.write(f"{float(xi)},{t},{float(ui)},{typ}\n")
print(f"wrote {args.out}")
