"""Harmonic-oscillator PINN runner — the reference's tests/enzyme_test2.cpp
experiment: 1-20-20-1 tanh net, ODE u'' + u = 0 with u(0)=0, u'(0)=1 on
x in [0, 6.28] (step 0.1), solved with L-BFGS (max 2000 iters, tol 1e-6),
then validated against the closed form sin(x) at x = 0..3.14 step 0.5
(enzyme_test2.cpp:70-95 — the reference only PRINTS Max Error; the 0.05
pass/fail threshold applied here is this repo's own gate, shared with
tests/test_pinn.py::test_oscillator_learns_sin).

Design note: the reference sums squared residuals over the 63 collocation
points (enzyme_test2.cpp:59-63); ``oscillator_problem`` uses the mean, so
this runner passes ``w_ode = n_points`` to reproduce the reference's exact
loss surface. Second derivatives come from jvp-of-jvp instead of nested
reverse-mode Enzyme (enzyme_test2.cpp:22-40) — same values, vectorized.

Usage: python experiments/run_oscillator.py [--iters 2000] [--f64]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

from lbfgs_ffnn.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import argparse
import time

parser = argparse.ArgumentParser()
parser.add_argument("--iters", type=int, default=2000)
parser.add_argument("--tol", type=float, default=1e-6)
parser.add_argument("--m", type=int, default=16,
                    help="L-BFGS history (reference CPU default, lbfgs.hpp:142)")
parser.add_argument("--width", type=int, default=20)
parser.add_argument("--f64", action="store_true")
parser.add_argument("--seed", type=int, default=123,
                    help="init seed (the reference PINN init is UNSEEDED — "
                         "pinn_network.hpp:76 uses std::random_device — so "
                         "run-to-run parity is with the framework itself)")
parser.add_argument("--no-warmup", action="store_true",
                    help="skip the compile warm-up solve (the timed number "
                         "then includes XLA compilation)")
parser.add_argument("--reps", type=int, default=3,
                    help="timed fresh-seed executions; ms/iter is the min "
                         "per-rep value. "
                         "Ignored with --no-warmup (single timed solve).")
args = parser.parse_args()

if args.f64:
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from lbfgs_ffnn.objectives.mlp import mlp_apply, mlp_spec  # noqa: E402
from lbfgs_ffnn.objectives.pinn import (  # noqa: E402
    oscillator_problem, pinn_init,
)
from lbfgs_ffnn.solvers import LBFGSOptions, lbfgs  # noqa: E402

dtype = jnp.float64 if args.f64 else jnp.float32
spec = mlp_spec([1, args.width, args.width, 1], ["tanh", "tanh", "linear"])
print("=== Harmonic-oscillator PINN (u'' + u = 0) ===")
print(f"Total Params: {spec.n_params}")

# x = 0, 0.1, ..., 6.2 (the reference's accumulating 0.1 step stops at 6.28,
# enzyme_test2.cpp:76)
xs = jnp.arange(0.0, 6.28, 0.1, dtype=dtype).reshape(-1, 1)
prob = oscillator_problem(spec, w_ode=float(xs.shape[0]), w_bc=1.0)
w0 = pinn_init(spec, jax.random.PRNGKey(args.seed), dtype=dtype)

opts = LBFGSOptions(max_iters=args.iters, tol=args.tol, m=args.m)


def timed_solve(w):
    t0 = time.perf_counter()
    r = lbfgs(prob, w, aux=xs, opts=opts)
    _ = float(r.final_loss)  # waits for the device
    return time.perf_counter() - t0, r


if args.no_warmup:
    elapsed, res = timed_solve(w0)  # includes XLA compilation
    ms_iter = 1e3 * elapsed / max(int(res.n_iters), 1)
else:
    # Compile on a perturbed input first (a different init seed), then
    # time fresh-seed executions synced by pulling a scalar; quote the min
    # per-rep ms/iter over --reps executions. The primary seed's solve
    # supplies the validated weights.
    w_warm = pinn_init(spec, jax.random.PRNGKey(args.seed + 1), dtype=dtype)
    _ = float(lbfgs(prob, w_warm, aux=xs, opts=opts).final_loss)
    elapsed, res = timed_solve(w0)
    ms_iter = 1e3 * elapsed / max(int(res.n_iters), 1)
    for k in range(max(args.reps, 1) - 1):
        wk = pinn_init(spec, jax.random.PRNGKey(args.seed + 2 + k),
                       dtype=dtype)
        tk, rk = timed_solve(wk)
        ms_iter = min(ms_iter, 1e3 * tk / max(int(rk.n_iters), 1))
final_loss = float(res.final_loss)
n = int(res.n_iters)
print(f"L-BFGS: iters={n} loss={final_loss:.6e} "
      f"gnorm={float(res.final_gnorm):.3e} time={elapsed:.2f}s "
      f"({ms_iter:.3f} ms/iter min over {1 if args.no_warmup else args.reps} "
      f"fresh-seed reps)")

print("\nValidation:")
xv = jnp.arange(0.0, 3.14, 0.5, dtype=dtype).reshape(-1, 1)
pred = np.asarray(mlp_apply(spec, res.x, xv)[:, 0])
exact = np.sin(np.asarray(xv[:, 0]))
for x, p, e in zip(np.asarray(xv[:, 0]), pred, exact):
    print(f"x={x:.2f} Pred={p:.6f} Exact={e:.6f}")
max_err = float(np.max(np.abs(pred - exact)))
print(f"Max Error: {max_err:.6e}")
if max_err > 0.05:
    # The reference prints Max Error without a threshold; 0.05 is this
    # repo's gate (tests/test_pinn.py::test_oscillator_learns_sin).
    print("WARNING: max |u - sin| above this repo's 0.05 gate",
          file=sys.stderr)
    sys.exit(1)
