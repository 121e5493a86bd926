"""Data-parallel scaling efficiency report.

Measures iterations/s of the full-batch L-BFGS step and of an S-LBFGS epoch
at mesh sizes 1, 2, 4, ... up to the available device count, with the
dataset sharded over the mesh and solver state replicated — the
scaling-efficiency deliverable from BASELINE.json. On a CPU machine run
with JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 to
exercise the mechanism; on a multi-GPU host it reports real scaling.

Usage: python experiments/run_scaling.py [--train-size 65536] [--iters 50]
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
from lbfgs_ffnn.objectives.mlp import mlp_batch_problem, mlp_init, mlp_problem, mlp_spec
from lbfgs_ffnn.parallel import make_mesh, replicate, shard_batch
from lbfgs_ffnn.solvers import LBFGSOptions, SLBFGSOptions, lbfgs, slbfgs
from lbfgs_ffnn.utils.diagnostics import check_parallelism

parser = argparse.ArgumentParser()
parser.add_argument("--train-size", type=int, default=65536)
parser.add_argument("--iters", type=int, default=50)
parser.add_argument("--epochs", type=int, default=5)
args = parser.parse_args()

check_parallelism()
if jax.default_backend() == "cpu":
    print("NOTE: virtual CPU devices share one physical machine — this run "
          "validates the sharding/collective mechanism, not real scaling; "
          "efficiency numbers are meaningful on accelerators only.")
n_dev_total = jax.device_count()
sizes = [d for d in (1, 2, 4, 8, 16, 32, 64) if d <= n_dev_total]

ds = load_mnist(train_size=args.train_size, test_size=1024)
x_full = jnp.asarray(ds.train_x)
y_full = jnp.asarray(ds.train_y)
spec = mlp_spec([784, 128, 10], ["relu", "linear"])
prob = mlp_problem(spec)
bp = mlp_batch_problem(spec, lam=1e-4)


def timed(run, w0s):
    run(w0s[0])  # compile
    best = float("inf")
    for w0 in w0s[1:]:
        t0 = time.perf_counter()
        r = run(w0)
        _ = float(r.final_loss)
        best = min(best, time.perf_counter() - t0)
    return best, int(r.n_iters)


results = []
for nd in sizes:
    mesh = make_mesh(nd)
    n = (args.train_size // nd) * nd
    xs, ys = shard_batch(mesh, x_full[:n], y_full[:n])
    w0s = [
        replicate(mesh, mlp_init(spec, jax.random.PRNGKey(123 + i), dtype=jnp.float32))
        for i in range(3)
    ]

    lb_opts = LBFGSOptions(max_iters=args.iters, tol=1e-12, m=10,
                           line_search="armijo", ls_max_iters=20)
    t_lb, it_lb = timed(lambda w: lbfgs(prob, w, aux=(xs, ys), opts=lb_opts), w0s)

    sl_opts = SLBFGSOptions(epochs=args.epochs, tol=1e-12, history=10, L=10,
                            batch_size=max(256, nd), step_size=0.02)
    t_sl, it_sl = timed(lambda w: slbfgs(bp, w, xs, ys, sl_opts), w0s)

    results.append((nd, it_lb / t_lb, it_sl / t_sl))
    print(f"devices={nd:3d}: L-BFGS {it_lb / t_lb:9.2f} it/s | "
          f"S-LBFGS {it_sl / t_sl:7.2f} epochs/s")

base_lb, base_sl = results[0][1], results[0][2]
print("\nscaling efficiency (vs 1 device, fixed global problem size):")
for nd, r_lb, r_sl in results:
    print(f"  devices={nd:3d}: L-BFGS {r_lb / base_lb:5.2f}x "
          f"(eff {r_lb / base_lb / nd * 100:5.1f}%) | "
          f"S-LBFGS {r_sl / base_sl:5.2f}x (eff {r_sl / base_sl / nd * 100:5.1f}%)")
