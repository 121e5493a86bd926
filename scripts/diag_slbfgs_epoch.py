"""Production S-LBFGS epoch cost decomposition (slope protocol).

diag_stochastic_step.py measures the inner-step REPLICA on the N=5000
b=256 headline config; 19 such steps need not add up to the production
epoch. This script slopes the PRODUCTION solver (epochs K1 vs K2) under
option knockouts to locate the difference:
recorder off, sampler choice, two-loop impl, m_inner scaling.

Usage: python scripts/diag_slbfgs_epoch.py   (GPU; JAX_PLATFORMS=cpu for a smoke run)
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

from lbfgs_ffnn.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import argparse
import time

import jax.numpy as jnp

from lbfgs_ffnn.data.datasets import load_mnist
from lbfgs_ffnn.objectives.mlp import mlp_batch_problem, mlp_init, mlp_spec
from lbfgs_ffnn.solvers import SLBFGSOptions, slbfgs

parser = argparse.ArgumentParser()
parser.add_argument("--train-size", type=int, default=5000)
parser.add_argument("--e1", type=int, default=60)
parser.add_argument("--e2", type=int, default=180)
parser.add_argument("--reps", type=int, default=3)
parser.add_argument("--only", default="", help="substring filter on probe names")
args = parser.parse_args()

print(f"backend={jax.default_backend()} e1={args.e1} e2={args.e2}")

spec = mlp_spec([784, 128, 10], ["relu", "linear"])
prob = mlp_batch_problem(spec, lam=1e-4)
w0 = mlp_init(spec, jax.random.PRNGKey(123), dtype=jnp.float32)
ds = load_mnist(train_size=args.train_size, test_size=16)
x, y = jnp.asarray(ds.train_x, jnp.float32), jnp.asarray(ds.train_y, jnp.float32)

BASE = dict(tol=1e-12, history=10, L=10, batch_size=256, hvp_batch_size=128,
            step_size=0.02, two_loop_impl="xla")


def epoch_slope(name, **kw):
    times = {}
    for E in (args.e1, args.e2):
        opts = SLBFGSOptions(epochs=E, **{**BASE, **kw})

        def run(w):
            return slbfgs(prob, w, x, y, opts=opts)

        float(run(w0 * (1.0 + 1e-6)).final_loss)
        best = float("inf")
        for r in range(args.reps):
            w = w0 * (1.0 + 1e-7 * (r + 1))
            t0 = time.perf_counter()
            _ = float(run(w).final_loss)
            best = min(best, time.perf_counter() - t0)
        times[E] = best
    ms = (times[args.e2] - times[args.e1]) / (args.e2 - args.e1) * 1e3
    print(f"{name:34s} {ms:8.3f} ms/epoch")
    return ms


def maybe(name, **kw):
    if args.only and args.only not in name:
        return None
    return epoch_slope(name, **kw)


base = maybe("production (headline opts)")
nor = maybe("record_full=False", record_full=False)
sort = maybe("sampler=sort", sampler="sort")
xla = maybe("two_loop=xla", two_loop_impl="xla")
L0 = maybe("L=1000 (no curvature updates)", L=1000)
fd = maybe("hvp_mode=fd", hvp_mode="fd")
m57 = maybe("m_inner=57", m_inner=57)
m19 = maybe("m_inner=19 (explicit default)", m_inner=19)
# scan_unroll: unrolls the L-step vr_step scan bodies (bit-identical
# trajectories; tests/test_stochastic.py) — does less scan loop machinery
# pay at the measured per-step cost?
u2 = maybe("unroll=2", scan_unroll=2)
u5 = maybe("unroll=5 (L/2)", scan_unroll=5)

if base is not None and nor is not None:
    print(f"\nrecorder cost/epoch: {base - nor:.3f} ms")
if m57 is not None and m19 is not None:
    print(f"marginal inner-step cost (m_inner 19->57): {(m57 - m19) / 38 * 1e3:.1f} us")
    print(f"implied fixed per-epoch cost: {m19 - (m57 - m19) / 38 * 19:.3f} ms")
