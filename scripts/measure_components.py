"""Component breakdown of an L-BFGS iteration (slope protocol).

One dispatch of a sub-millisecond component is dominated by launch and
host-sync cost, so a naive micro-timing reports that overhead, not
compute. Every number here is a SLOPE: each probe is a jitted program chaining K data-
dependent repetitions of one component; it runs at two K values and reports
(t_K2 - t_K1) / (K2 - K1) — the per-repetition marginal cost with the
fixed dispatch and sync overhead differenced out. An axpy-only probe
calibrates the protocol (must come out ~0).

Components probed (the production L-BFGS iteration's terms, see PERF.md):
  vag            full value_and_grad (forward + backward)
  vag_restrict   accept-point (loss, grad) from the carried prefix
  trial          one lean line-search trial (loss-only restriction)
  prefix_B       the new direction's first-layer matmul B = x @ W1_p
  prefix_axpy    the accept-time A += alpha*B prefix update
  two_loop       one direction computation from a full curvature ring
  solve          whole-solver slope via max_iters K1/K2 (chunk-free)

Options mirror the solver policies under study: --m, --pair-dtype
(bf16 curvature ring), --grad-input (bf16 backward input read),
--prefix-dtype (bf16 carried line prefix; A/B storage for the restrict/
vag_restrict/B/axpy probes and the whole-solve), --compute-dtype. Run on
the GPU; JAX_PLATFORMS=cpu gives a smoke run.

Usage:
  python scripts/measure_components.py --deep --m 100
  python scripts/measure_components.py --deep --m 100 --pair-dtype bfloat16 \
      --grad-input bfloat16
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
from jax import lax

parser = argparse.ArgumentParser()
parser.add_argument("--deep", action="store_true",
                    help="784-256-128-64-10 (default: 784-128-10)")
parser.add_argument("--dataset", choices=["mnist", "fashion"], default="fashion")
parser.add_argument("--train-size", type=int, default=60000)
parser.add_argument("--m", type=int, default=100)
parser.add_argument("--pair-dtype", default=None)
parser.add_argument("--grad-input", default=None)
parser.add_argument("--line-input", default=None)
parser.add_argument("--fun-input", default=None)
parser.add_argument("--prefix-dtype", default=None)
parser.add_argument("--compute-dtype", default=None)
parser.add_argument("--two-loop", default="xla", choices=["xla", "compact"])
parser.add_argument("--k", type=int, nargs=2, default=[20, 200],
                    metavar=("K1", "K2"))
parser.add_argument("--reps", type=int, default=3)
parser.add_argument("--solve-iters", type=int, nargs=2, default=[100, 400],
                    help="K1 K2 for the whole-solve slope")
args = parser.parse_args()

from lbfgs_ffnn.data.datasets import load_fashion_mnist, load_mnist  # noqa: E402
from lbfgs_ffnn.objectives.mlp import mlp_init, mlp_problem, mlp_spec  # noqa: E402
from lbfgs_ffnn.ops.two_loop import (  # noqa: E402
    empty_history_state, ring_push,
)
from lbfgs_ffnn.solvers import LBFGSOptions, lbfgs  # noqa: E402
from lbfgs_ffnn.types import prepared_aux  # noqa: E402

dims = [784, 256, 128, 64, 10] if args.deep else [784, 128, 10]
acts = ["relu"] * (len(dims) - 2) + ["linear"]
spec = mlp_spec(dims, acts)
prob = mlp_problem(spec, compute_dtype=args.compute_dtype,
                   grad_input_dtype=args.grad_input,
                   line_input_dtype=args.line_input,
                   fun_input_dtype=args.fun_input)
loader = load_mnist if args.dataset == "mnist" else load_fashion_mnist
ds = loader(train_size=args.train_size, test_size=0)
x = jnp.asarray(ds.train_x)
y = jnp.asarray(ds.train_y)
w = mlp_init(spec, jax.random.PRNGKey(123), dtype=jnp.float32,
             bias_init="zeros")
n = int(w.shape[0])
aux = (x, y)
paux = prepared_aux(prob, aux)
lp = prob.line_prefix

print(f"# n={n} params, N={x.shape[0]} samples, m={args.m}, "
      f"two_loop={args.two_loop}, pair_dtype={args.pair_dtype}, "
      f"grad_input={args.grad_input}, line_input={args.line_input}, "
      f"fun_input={args.fun_input}, "
      f"prefix_dtype={args.prefix_dtype}, "
      f"compute_dtype={args.compute_dtype}",
      flush=True)


def pcast(P):
    """Prefix-storage cast matching solvers.lbfgs._prefix_cast."""
    if args.prefix_dtype is None:
        return P
    return P.astype(jnp.dtype(args.prefix_dtype))


def slope(name, make_fn, k1, k2, scale_us=1e6):
    """Marginal cost per repetition: jit(make_fn(K)) at two K values."""
    fns = {k: jax.jit(make_fn(k)) for k in (k1, k2)}
    seeds = jax.random.split(jax.random.PRNGKey(0), args.reps + 1)
    # warm-up compile (perturbed input so the remote cache can't serve it)
    for k in (k1, k2):
        _ = float(fns[k](w * (1.0 + 1e-6)))
    best = {k: float("inf") for k in (k1, k2)}
    for r in range(args.reps):
        wr = w * (1.0 + 1e-6 * jax.random.uniform(seeds[r]))
        wr.block_until_ready()
        for k in (k1, k2):
            t0 = time.perf_counter()
            _ = float(fns[k](wr))  # host scalar pull = real sync
            best[k] = min(best[k], time.perf_counter() - t0)
    per = (best[k2] - best[k1]) / (k2 - k1)
    print(f"{name:14s} {per * scale_us:10.1f} us/rep   "
          f"(t{k1}={best[k1] * 1e3:.1f} ms, t{k2}={best[k2] * 1e3:.1f} ms)",
          flush=True)
    return per


k1, k2 = args.k

# Calibration: a pure axpy chain must slope to ~0 (it is latency-bound,
# not bandwidth-bound, at n <= a few MB).
def make_axpy(K):
    def run(w0):
        def body(i, v):
            return v + 1e-12 * v
        return jnp.sum(lax.fori_loop(0, K, body, w0))
    return run


# Full value_and_grad, chained through the iterate.
def make_vag(K):
    def run(w0):
        def body(i, v):
            f, g = prob.value_and_grad(v, paux)
            return v - 1e-9 * g
        return jnp.sum(lax.fori_loop(0, K, body, w0))
    return run


# Accept-point (loss, grad) from the carried prefix.
def make_vagr(K):
    def run(w0):
        A = pcast(lp.init(w0, paux))
        p0 = w0 * 1e-3
        B = pcast(lp.direction(p0, paux))
        vag = lp.vag_restrict(A, B, w0, p0, paux)

        def body(i, c):
            a, acc = c
            f, g = vag(a)
            return a + 1e-12 * f, acc + 1e-9 * jnp.sum(g)
        a, acc = lax.fori_loop(0, K, body, (jnp.float32(0.1), jnp.float32(0.0)))
        return a + acc
    return run


# One lean trial: loss along the restriction.
def make_trial(K):
    def run(w0):
        A = pcast(lp.init(w0, paux))
        p0 = w0 * 1e-3
        B = pcast(lp.direction(p0, paux))
        va = lp.restrict(A, B, w0, p0, paux)

        def body(i, a):
            return a * 0.5 + 1e-12 * va(a)
        return lax.fori_loop(0, K, body, jnp.float32(1.0))
    return run


# The new direction's prefix matmul B.
def make_B(K):
    def run(w0):
        def body(i, p):
            Bm = pcast(lp.direction(p, paux))
            return p + 1e-12 * jnp.mean(Bm).astype(p.dtype) * p
        return jnp.sum(lax.fori_loop(0, K, body, w0 * 1e-3))
    return run


# The accept-time prefix update A += alpha*B (read A+B, write A; under
# --prefix-dtype the sum rounds back to storage). DIAGNOSTIC: on the
# armijo paths the production solver no longer pays this — the accept
# eval's carry (LinePrefix.vag_restrict_carry) replaced the axpy; this
# probe quantifies exactly what that deletion saves (wolfe still pays it).
def make_prefix_axpy(K):
    def run(w0):
        A = pcast(lp.init(w0, paux))
        B = pcast(lp.direction(w0 * 1e-3, paux))

        def body(i, c):
            A, a = c
            a = a * -0.999  # data-dependent alpha, keeps A bounded
            return (A + a * B).astype(A.dtype), a
        A, a = lax.fori_loop(0, K, body, (A, jnp.float32(1e-3)))
        return jnp.sum(A.astype(jnp.float32)) + a
    return run


# Direction from a full ring.
def make_two_loop(K):
    if args.two_loop == "compact":
        from lbfgs_ffnn.ops.two_loop import two_loop_compact as tl
    else:
        from lbfgs_ffnn.ops.two_loop import two_loop as tl

    def run(w0):
        hist = empty_history_state(args.m, n, jnp.float32,
                                   pair_dtype=args.pair_dtype)

        def fill(i, h):
            key = jax.random.fold_in(jax.random.PRNGKey(1), i)
            s = jax.random.normal(key, (n,), jnp.float32)
            yv = s + 0.1 * jax.random.normal(jax.random.fold_in(key, 1),
                                             (n,), jnp.float32)
            return ring_push(h, s, yv, 1.0 / jnp.vdot(yv, s), jnp.array(True))
        hist = lax.fori_loop(0, args.m, fill, hist)

        def body(i, g):
            d = tl(g, hist)
            return g + 1e-9 * d
        return jnp.sum(lax.fori_loop(0, K, body, w0))
    return run


slope("axpy-only", make_axpy, k1 * 10, k2 * 10)
slope("vag", make_vag, k1, k2)
if lp is not None and lp.vag_restrict is not None:
    slope("vag_restrict", make_vagr, k1, k2)
    slope("trial", make_trial, k1, k2)
    slope("prefix_B", make_B, k1, k2)
    slope("prefix_axpy", make_prefix_axpy, k1, k2)
slope("two_loop", make_two_loop, k1, k2)


# Whole-solve slope via max_iters (no chunk boundaries, tol=0 so neither
# K stops early).
s1, s2 = args.solve_iters
opts = {
    k: LBFGSOptions(max_iters=k, tol=0.0, m=args.m, line_search="armijo",
                    two_loop_impl=args.two_loop,
                    pair_dtype=args.pair_dtype,
                    prefix_dtype=args.prefix_dtype)
    for k in (s1, s2)
}


def run_solve(k, w0):
    return lbfgs(prob, w0, aux, opts[k])


for k in (s1, s2):
    _ = float(run_solve(k, w * (1.0 + 1e-6)).final_loss)
best = {s1: float("inf"), s2: float("inf")}
seeds = jax.random.split(jax.random.PRNGKey(9), args.reps)
for r in range(args.reps):
    wr = w * (1.0 + 1e-6 * jax.random.uniform(seeds[r]))
    wr.block_until_ready()
    for k in (s1, s2):
        t0 = time.perf_counter()
        _ = float(run_solve(k, wr).final_loss)
        best[k] = min(best[k], time.perf_counter() - t0)
per = (best[s2] - best[s1]) / (s2 - s1)
print(f"{'solve':14s} {per * 1e6:10.1f} us/iter  "
      f"(t{s1}={best[s1] * 1e3:.1f} ms, t{s2}={best[s2] * 1e3:.1f} ms)",
      flush=True)
