"""Dispatch-free cost breakdown of the stochastic solvers' inner step.

The SGD sequential epoch (MNIST 60k, b=256) and the S-LBFGS inner step
both run well above their memory-traffic floors, and "scan machinery" was
blamed for the gap without a measurement. This script isolates the terms.

Protocol: every number is a SLOPE between two chain lengths,
(t_K2 - t_K1) / (K2 - K1), with fresh perturbed inputs per rep, host-sync
by pulling a scalar, min over reps; an axpy-only probe calibrates (~0).
Probes mirror the production bodies in solvers/sgd.py (sequential /
random minibatch steps, reference src/cuda/sgd.cuh:100-124 and
src/minimizer/s_gd.hpp:63-137) and solvers/slbfgs.py (inner scan,
reference src/minimizer/s_lbfgs.hpp:211-264); candidate replacements
(dynamic_slice batch instead of row gather) sit next to what they would
replace.

Usage (GPU):
  python scripts/diag_stochastic_step.py                # all probes
  python scripts/diag_stochastic_step.py --probe seq    # substring filter
  JAX_PLATFORMS=cpu python scripts/diag_stochastic_step.py --k1 20 --k2 60
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

from lbfgs_ffnn.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import argparse
import functools
import time

import jax.numpy as jnp
from jax import lax

from lbfgs_ffnn.data.datasets import load_fashion_mnist, load_mnist
from lbfgs_ffnn.objectives.mlp import mlp_batch_problem, mlp_init, mlp_spec
from lbfgs_ffnn.ops.sampling import sample_without_replacement
from lbfgs_ffnn.ops.two_loop import empty_history_state, ring_push

parser = argparse.ArgumentParser()
parser.add_argument("--train-size", type=int, default=60000)
parser.add_argument("--sl-size", type=int, default=5000,
                    help="S-LBFGS probe dataset size (headline config)")
parser.add_argument("--dataset", choices=["mnist", "fashion"],
                    default="fashion")
parser.add_argument("--batch", type=int, default=256)
parser.add_argument("--k1", type=int, default=500)
parser.add_argument("--k2", type=int, default=1500)
parser.add_argument("--reps", type=int, default=3)
parser.add_argument("--probe", default="", help="substring filter")
args = parser.parse_args()

backend = jax.default_backend()
print(f"backend={backend} k1={args.k1} k2={args.k2} reps={args.reps}")

spec = mlp_spec([784, 128, 10], ["relu", "linear"])
prob = mlp_batch_problem(spec, lam=0.0)
w0 = mlp_init(spec, jax.random.PRNGKey(123), dtype=jnp.float32)
n = w0.shape[0]

loader = load_mnist if args.dataset == "mnist" else load_fashion_mnist
ds = loader(train_size=args.train_size, test_size=10000)
x, y = jnp.asarray(ds.train_x, jnp.float32), jnp.asarray(ds.train_y, jnp.float32)
N, b = x.shape[0], args.batch
m_steps = -(-N // b)  # sequential epoch length (ceil)
lr, mu = 0.01, 0.9
key = jax.random.PRNGKey(7)

# Zero-padded copy for the dynamic_slice candidate: masked evaluators
# already zero masked rows, so zero padding is trajectory-identical.
pad = m_steps * b - N
x_pad = jnp.pad(x, ((0, pad), (0, 0)))
y_pad = jnp.pad(y, ((0, pad), (0, 0)))

# S-LBFGS-scale data (headline: N=5000)
xs_, ys_ = x[: args.sl_size], y[: args.sl_size]
N_sl = xs_.shape[0]

from lbfgs_ffnn.ops.two_loop import two_loop  # noqa: E402


def direction(v, hist):
    return two_loop(v, hist, clamp_gamma=True)


def full_ring(m=10):
    hist = empty_history_state(m, n, jnp.float32)
    k = jax.random.PRNGKey(3)
    for i in range(m):
        s_vec = jax.random.normal(jax.random.fold_in(k, 2 * i), (n,)) * 1e-3
        yv = s_vec * (1.5 + 0.1 * i)
        hist = ring_push(hist, s_vec, yv, 1.0 / jnp.vdot(yv, s_vec),
                         jnp.array(True))
    return hist


HIST = full_ring()
CAP = 11  # S-LBFGS iterate ring (L+1)


def slope(name, make_body, init_carry, out_of):
    """make_body: () -> body(carry, t); carry chains the dependence."""
    times = {}
    for K in (args.k1, args.k2):
        @jax.jit
        def run(w, K=K):
            carry = init_carry(w)
            carry, _ = lax.scan(make_body(), carry, jnp.arange(K))
            return out_of(carry)

        float(run(w0 * (1.0 + 1e-6)))  # compile + warm
        best = float("inf")
        for r in range(args.reps):
            w = w0 * (1.0 + 1e-7 * (r + 1))
            t0 = time.perf_counter()
            _ = float(run(w))
            best = min(best, time.perf_counter() - t0)
        times[K] = best
    us = (times[args.k2] - times[args.k1]) / (args.k2 - args.k1) * 1e6
    print(f"{name:24s} {us:9.2f} us/step   (t{args.k1}={times[args.k1]*1e3:.1f} ms, "
          f"t{args.k2}={times[args.k2]*1e3:.1f} ms)")
    return us


def wv_init(w):
    return (w, jnp.zeros_like(w))


def wv_out(c):
    return c[0].sum()


PROBES = {}


def probe(name):
    def deco(f):
        PROBES[name] = f
        return f
    return deco


# ---------------- SGD (sequential, the MNIST/Fashion gpu-style config) ---


@probe("axpy_only")
def _():
    def body(c, t):
        w, v = c
        return (w - 1e-12 * w, v), None
    return body, wv_init, wv_out


@probe("vag_fixed_nomask")
def _():
    xb, yb = x[:b], y[:b]

    def body(c, t):
        w, v = c
        g = prob.grad(w, xb, yb)
        vn = mu * v - lr * g
        return (w + vn, vn), None
    return body, wv_init, wv_out


@probe("vag_fixed_masked")
def _():
    xb, yb = x[:b], y[:b]
    mask = jnp.ones((b,), jnp.float32)

    def body(c, t):
        w, v = c
        _, g = jax.value_and_grad(prob.fun_masked)(w, xb, yb, mask)
        vn = mu * v - lr * g
        return (w + vn, vn), None
    return body, wv_init, wv_out


@probe("seq_take")
def _():
    """Production sequential step: row-gather by clipped indices."""
    def body(c, t):
        w, v = c
        pos = (t % m_steps) * b + jnp.arange(b)
        mask = (pos < N).astype(w.dtype)
        idx = jnp.minimum(pos, N - 1)
        xb, yb = jnp.take(x, idx, axis=0), jnp.take(y, idx, axis=0)
        _, g = jax.value_and_grad(prob.fun_masked)(w, xb, yb, mask)
        vn = mu * v - lr * g
        return (w + vn, vn), None
    return body, wv_init, wv_out


@probe("seq_dynslice")
def _():
    """Candidate: contiguous dynamic_slice from the zero-padded copy."""
    def body(c, t):
        w, v = c
        start = (t % m_steps) * b
        pos = start + jnp.arange(b)
        mask = (pos < N).astype(w.dtype)
        xb = lax.dynamic_slice_in_dim(x_pad, start, b, axis=0)
        yb = lax.dynamic_slice_in_dim(y_pad, start, b, axis=0)
        _, g = jax.value_and_grad(prob.fun_masked)(w, xb, yb, mask)
        vn = mu * v - lr * g
        return (w + vn, vn), None
    return body, wv_init, wv_out


@probe("gather_only")
def _():
    def body(c, t):
        w, v = c
        pos = (t % m_steps) * b + jnp.arange(b)
        idx = jnp.minimum(pos, N - 1)
        xb = jnp.take(x, idx, axis=0)
        return (w + 1e-20 * xb.sum(), v), None
    return body, wv_init, wv_out


@probe("slice_only")
def _():
    def body(c, t):
        w, v = c
        start = (t % m_steps) * b
        xb = lax.dynamic_slice_in_dim(x_pad, start, b, axis=0)
        return (w + 1e-20 * xb.sum(), v), None
    return body, wv_init, wv_out


@probe("sample_topk_60k")
def _():
    def body(c, t):
        w, v = c
        idx = sample_without_replacement(jax.random.fold_in(key, t), N, b)
        return (w + 1e-20 * idx.sum().astype(w.dtype), v), None
    return body, wv_init, wv_out


@probe("sample_topk_5k")
def _():
    def body(c, t):
        w, v = c
        idx = sample_without_replacement(jax.random.fold_in(key, t), N_sl, b)
        return (w + 1e-20 * idx.sum().astype(w.dtype), v), None
    return body, wv_init, wv_out


@probe("rand_step")
def _():
    """Production random-sampling step (CPU-ref SGD): draw + gather + grad."""
    def body(c, t):
        w, v = c
        idx = sample_without_replacement(jax.random.fold_in(key, t), N, b)
        xb, yb = jnp.take(x, idx, axis=0), jnp.take(y, idx, axis=0)
        g = prob.grad(w, xb, yb)
        vn = mu * v - lr * g
        return (w + vn, vn), None
    return body, wv_init, wv_out


# ---------------- S-LBFGS inner step (N=5000 headline config) ------------


def _fixed_idx(t, size, N_src):
    # Deterministic scattered indices: gather cost of a random draw without
    # paying a per-step sampler inside the probe (production draws all
    # batches up front via the vmapped epoch_batch_idx).
    return (t * 7919 + jnp.arange(size) * 193) % N_src


@probe("sl_grads2")
def _():
    """The vmapped double gradient (iterate + anchor) at one batch."""
    def body(c, t):
        w, v = c
        idx = _fixed_idx(t, b, N_sl)
        xb, yb = jnp.take(xs_, idx, axis=0), jnp.take(ys_, idx, axis=0)
        g2 = jax.vmap(lambda wi: prob.grad(wi, xb, yb))(jnp.stack([w, w0]))
        vt = g2[0] - g2[1]
        return (w - lr * vt, v), None
    return body, wv_init, wv_out


@probe("sl_dir_m10")
def _():
    def body(c, t):
        w, v = c
        d = direction(w * 1e-3, HIST)
        return (w - lr * d, v), None
    return body, wv_init, wv_out


@probe("sl_vrpush")
def _():
    def init(w):
        buf = jnp.zeros((CAP, n), jnp.float32)
        return (w, buf, jnp.int32(0))

    def body(c, t):
        w, buf, head = c
        buf = buf.at[head].set(w)
        return (w * (1.0 + 1e-12), buf, (head + 1) % CAP), None
    return body, init, lambda c: c[0].sum()


@probe("sl_ringpush_masked")
def _():
    """Unconditional masked curvature-ring push (accept=False every step)."""
    def init(w):
        return (w, HIST)

    def body(c, t):
        w, hist = c
        z = jnp.zeros_like(w)
        hist = ring_push(hist, z, z, jnp.zeros((), w.dtype), jnp.array(False))
        return (w * (1.0 + 1e-12), hist), None
    return body, init, lambda c: c[0].sum()


@probe("sl_cond_skip")
def _():
    """The double-cond machinery with both branches trivial."""
    def init(w):
        return (w, w, jnp.array(False))

    def body(c, t):
        w, u_prev, has_u = c
        do_update = (t > 0) & (t % 10 == 0)

        def curv(a):
            up, hu = a
            z = jnp.zeros_like(w)
            return z, z, jnp.zeros((), w.dtype), jnp.array(False), w, jnp.array(True)

        def skip(a):
            up, hu = a
            z = jnp.zeros_like(w)
            return z, z, jnp.zeros((), w.dtype), jnp.array(False), up, hu

        s_vec, yv, rho, acc, u_prev, has_u = lax.cond(do_update, curv, skip,
                                                      (u_prev, has_u))
        return (w + 1e-20 * s_vec.sum(), u_prev, has_u), None
    return body, init, lambda c: c[0].sum()


@probe("sl_hvp_b128")
def _():
    def body(c, t):
        w, v = c
        idx = _fixed_idx(t, 128, N_sl)
        xh, yh = jnp.take(xs_, idx, axis=0), jnp.take(ys_, idx, axis=0)
        yv = prob.hvp(w, w * 1e-3, xh, yh)
        return (w + 1e-12 * yv, v), None
    return body, wv_init, wv_out


@probe("sl_inner_full")
def _():
    """Full production inner-step replica: double grad + direction + update
    + iterate-ring push + cond(skip) + masked ring push."""
    def init(w):
        buf = jnp.zeros((CAP, n), jnp.float32)
        return (w, HIST, buf, jnp.int32(0), w, jnp.array(False))

    def body(c, t):
        w, hist, buf, head, u_prev, has_u = c
        idx = _fixed_idx(t, b, N_sl)
        xb, yb = jnp.take(xs_, idx, axis=0), jnp.take(ys_, idx, axis=0)
        g2 = jax.vmap(lambda wi: prob.grad(wi, xb, yb))(jnp.stack([w, w0]))
        vt = g2[0] - g2[1] + 1e-6 * w
        d = direction(vt, hist)
        w = w - lr * d
        buf = buf.at[head].set(w)
        head = (head + 1) % CAP
        do_update = (t > 0) & (t % 10 == 0)

        def curv(a):
            up, hu = a
            z = jnp.zeros_like(w)
            return z, z, jnp.zeros((), w.dtype), jnp.array(False), w, jnp.array(True)

        def skip(a):
            up, hu = a
            z = jnp.zeros_like(w)
            return z, z, jnp.zeros((), w.dtype), jnp.array(False), up, hu

        s_vec, yv, rho, acc, u_prev, has_u = lax.cond(do_update, curv, skip,
                                                      (u_prev, has_u))
        hist = ring_push(hist, s_vec, yv, rho, acc & do_update)
        return (w, hist, buf, head, u_prev, has_u), None
    return body, init, lambda c: c[0].sum()


@probe("sl_vmapdraw19")
def _():
    """The per-epoch vmapped batch draw (epoch_batch_idx), per scan step:
    19 without-replacement draws from N=5000 — divide the printed number
    by 19 for the per-draw cost inside the vmap."""
    def body(c, t):
        w, v = c
        keys = jax.vmap(
            lambda i: jax.random.fold_in(jax.random.fold_in(key, t * 1000 + i), 0)
        )(jnp.arange(19))
        idx_all = jax.vmap(lambda k: sample_without_replacement(k, N_sl, b))(keys)
        return (w + 1e-20 * idx_all.sum().astype(w.dtype), v), None
    return body, wv_init, wv_out


@probe("sl_inner_realcond")
def _():
    """sl_inner_full plus the REAL curvature branch contents (iterate-ring
    mean + b_H HVP + gates inside the nested cond, ring captured), plus the
    constant mu add — the full production inner body minus only the
    per-epoch sampling."""
    mu_vec = jax.random.normal(key, (n,), jnp.float32) * 1e-3

    def init(w):
        buf = jnp.zeros((CAP, n), jnp.float32)
        return (w, HIST, buf, jnp.int32(0), jnp.int32(0), w, jnp.array(False))

    def body(c, t):
        w, hist, buf, head, cnt, u_prev, has_u = c
        idx = _fixed_idx(t, b, N_sl)
        xb, yb = jnp.take(xs_, idx, axis=0), jnp.take(ys_, idx, axis=0)
        g2 = jax.vmap(lambda wi: prob.grad(wi, xb, yb))(jnp.stack([w, w0]))
        vt = g2[0] - g2[1] + mu_vec
        d = direction(vt, hist)
        w = w - lr * d
        buf = buf.at[head].set(w)
        head = (head + 1) % CAP
        cnt = jnp.minimum(cnt + 1, CAP)
        do_update = (t > 0) & (t % 10 == 0)

        def curv(a):
            up, hu = a
            j = jnp.arange(CAP)
            li = (j - (head - cnt)) % CAP
            mask = (li < cnt).astype(buf.dtype)
            u = (mask @ buf) / jnp.maximum(cnt, 1).astype(buf.dtype)

            def with_pair(_):
                s_vec = u - up
                idxh = _fixed_idx(t, 128, N_sl)
                xh, yh = jnp.take(xs_, idxh, axis=0), jnp.take(ys_, idxh, axis=0)
                yv = prob.hvp(u, s_vec, xh, yh)
                ys = jnp.vdot(yv, s_vec)
                accept = jnp.abs(ys) > 1e-10
                rho = jnp.where(accept, 1.0 / jnp.where(ys == 0, 1.0, ys), 0.0)
                return s_vec, yv, rho, accept

            def no_pair(_):
                z = jnp.zeros_like(w)
                return z, z, jnp.zeros((), w.dtype), jnp.array(False)

            s_vec, yv, rho, accept = lax.cond(hu, with_pair, no_pair, None)
            return s_vec, yv, rho, accept, u, jnp.array(True)

        def skip(a):
            up, hu = a
            z = jnp.zeros_like(w)
            return z, z, jnp.zeros((), w.dtype), jnp.array(False), up, hu

        s_vec, yv, rho, acc, u_prev, has_u = lax.cond(do_update, curv, skip,
                                                      (u_prev, has_u))
        hist = ring_push(hist, s_vec, yv, rho, acc & do_update)
        return (w, hist, buf, head, cnt, u_prev, has_u), None
    return body, init, lambda c: c[0].sum()


@probe("sl_inner_flatcond")
def _():
    """Candidate restructure: the iterate-ring mean hoisted out of the cond
    (one unconditional (cap,n) GEMV per step, so the ring is never a branch
    capture) and the nested has_u cond flattened into ONE cond that only
    computes the HVP pair; u_prev/has_u updated by n-sized where."""
    mu_vec = jax.random.normal(key, (n,), jnp.float32) * 1e-3

    def init(w):
        buf = jnp.zeros((CAP, n), jnp.float32)
        return (w, HIST, buf, jnp.int32(0), jnp.int32(0), w, jnp.array(False))

    def body(c, t):
        w, hist, buf, head, cnt, u_prev, has_u = c
        idx = _fixed_idx(t, b, N_sl)
        xb, yb = jnp.take(xs_, idx, axis=0), jnp.take(ys_, idx, axis=0)
        g2 = jax.vmap(lambda wi: prob.grad(wi, xb, yb))(jnp.stack([w, w0]))
        vt = g2[0] - g2[1] + mu_vec
        d = direction(vt, hist)
        w = w - lr * d
        buf = buf.at[head].set(w)
        head = (head + 1) % CAP
        cnt = jnp.minimum(cnt + 1, CAP)
        do_update = (t > 0) & (t % 10 == 0)

        # hoisted mean (unconditional)
        j = jnp.arange(CAP)
        li = (j - (head - cnt)) % CAP
        mask = (li < cnt).astype(buf.dtype)
        u = (mask @ buf) / jnp.maximum(cnt, 1).astype(buf.dtype)

        do_pair = do_update & has_u

        def with_pair(_):
            s_vec = u - u_prev
            idxh = _fixed_idx(t, 128, N_sl)
            xh, yh = jnp.take(xs_, idxh, axis=0), jnp.take(ys_, idxh, axis=0)
            yv = prob.hvp(u, s_vec, xh, yh)
            ys = jnp.vdot(yv, s_vec)
            accept = jnp.abs(ys) > 1e-10
            rho = jnp.where(accept, 1.0 / jnp.where(ys == 0, 1.0, ys), 0.0)
            return s_vec, yv, rho, accept

        def no_pair(_):
            z = jnp.zeros_like(w)
            return z, z, jnp.zeros((), w.dtype), jnp.array(False)

        s_vec, yv, rho, acc = lax.cond(do_pair, with_pair, no_pair, None)
        u_prev = jnp.where(do_update, u, u_prev)
        has_u = has_u | do_update
        hist = ring_push(hist, s_vec, yv, rho, acc & do_pair)
        return (w, hist, buf, head, cnt, u_prev, has_u), None
    return body, init, lambda c: c[0].sum()


results = {}
for name, make in PROBES.items():
    if args.probe and args.probe not in name:
        continue
    body_f, init_f, out_f = make()
    results[name] = slope(name, lambda body_f=body_f: body_f, init_f, out_f)

if "seq_take" in results and "seq_dynslice" in results:
    print(f"\nsequential gather -> dynamic_slice saving: "
          f"{results['seq_take'] - results['seq_dynslice']:.2f} us/step "
          f"x {m_steps} steps/epoch")


# ---------------- whole-epoch slope: the production SGD solver -----------
# A whole-run SGD timing divides a ~21-epoch run's wall time by 21, so the
# fixed dispatch and sync cost is smeared over the column. This probe
# runs the REAL solver (sgd(), sequential +
# momentum + decay + per-epoch full-batch record + accuracy metric) at two
# epoch counts with tol=0 (so neither stops early) and reports the slope —
# the marginal ms/epoch, directly comparable to the reference's
# per-epoch cudaEvent timing (src/cuda/sgd.cuh:79-86).
def sgd_epoch_slope(record_acc: bool, u8: bool = False, unroll: int = 1):
    from lbfgs_ffnn.solvers.sgd import SGDOptions, sgd
    from lbfgs_ffnn.objectives.mlp import quantize_pixels

    x_in = quantize_pixels(x) if u8 else x

    if record_acc:
        from lbfgs_ffnn.objectives.mlp import mlp_apply

        def acc1(w, xa, ya):
            pred = jnp.argmax(mlp_apply(spec, w, xa), axis=1)
            return jnp.mean((pred == jnp.argmax(ya, axis=1)).astype(w.dtype)) * 100.0

        def metric(w, xa, ya, tx, ty):
            return jnp.stack([acc1(w, xa, ya), acc1(w, tx, ty)])
        margs = (jnp.asarray(ds.test_x, jnp.float32),
                 jnp.asarray(ds.test_y, jnp.float32))
    else:
        metric, margs = None, ()
    e1, e2 = 20, 60
    opt = {e: SGDOptions(epochs=e, batch_size=b, step_size=0.01, momentum=0.9,
                         sampling="sequential", lr_decay=0.8, lr_decay_step=40,
                         tol=0.0, metric_fn=metric, scan_unroll=unroll)
           for e in (e1, e2)}
    for e in (e1, e2):
        _ = float(sgd(prob, w0 * (1.0 + 1e-6), x_in, y, opt[e],
                      metric_args=margs).final_loss)
    best = {e1: float("inf"), e2: float("inf")}
    for r in range(args.reps):
        w = w0 * (1.0 + 1e-7 * (r + 1))
        w.block_until_ready()
        for e in (e1, e2):
            t0 = time.perf_counter()
            _ = float(sgd(prob, w, x_in, y, opt[e],
                          metric_args=margs).final_loss)
            best[e] = min(best[e], time.perf_counter() - t0)
    per = (best[e2] - best[e1]) / (e2 - e1)
    tag = (("acc" if record_acc else "noacc") + ("+u8" if u8 else "")
           + (f"+unroll{unroll}" if unroll != 1 else ""))
    print(f"sgd_epoch[{tag}]  {per * 1e3:9.3f} ms/epoch  "
          f"(t{e1}={best[e1] * 1e3:.1f} ms, t{e2}={best[e2] * 1e3:.1f} ms)")
    return per


if not args.probe or args.probe in "sgd_epoch":
    sgd_epoch_slope(record_acc=False)
    sgd_epoch_slope(record_acc=True)
    sgd_epoch_slope(record_acc=True, u8=True)

# scan_unroll on the sequential epoch scan (bit-identical trajectories;
# tests/test_stochastic.py): does less scan loop machinery pay at the
# measured per-step cost?
if args.probe and args.probe in "sgd_unroll":
    for u in (1, 2, 4):
        sgd_epoch_slope(record_acc=False, unroll=u)
