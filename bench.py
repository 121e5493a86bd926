"""Headline benchmark: MNIST 784-128-10 full-batch L-BFGS m=10, ms/iteration.

Apples-to-apples with the reference CUDA backend's headline number — the
same model (784-128-10 ReLU/Linear, ~101,770 params), same loss
(0.5*||out-y||^2/N), same solver family and history size, same 60,000-sample
training set size — which costs 7.20 ms/iter on the reference's GPU
(BASELINE.md: scripts/gpu_mnist_784_128_10_s1000/MNIST_LBFGS_m10_history.csv).

Prints exactly one JSON line:
  {"metric": ..., "value": <ms/iter>, "unit": "ms/iter", "vs_baseline": <x>,
   "device": {"platform": ..., "kind": ..., "count": ...}}
where vs_baseline = reference_ms / our_ms (>1 means faster than reference).

Supplementary numbers (S-LBFGS ms/epoch, deep-net ms/iter, two-loop us per
direction in loop and compact form) go to stderr. Every phase must succeed;
a failure exits nonzero. Runs only on a GPU.

Timing: the solve is one XLA program; each config is compiled by a warm-up
run, then timed over fresh initial weights on the host clock, with the
device synchronized by pulling the scalar loss to the host.

  python bench.py                 # full run
  BENCH_QUICK=1 python bench.py   # N=6000, 20 iterations
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

QUICK = bool(os.environ.get("BENCH_QUICK"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def time_solve(run, w0s):
    """Min wall time over fresh-weight executions, synced via host scalar."""
    # warm-up compiles
    r = run(w0s[0])
    _ = float(r.final_loss)
    best = float("inf")
    iters = None
    for w0 in w0s[1:]:
        t0 = time.perf_counter()
        r = run(w0)
        _ = float(r.final_loss)  # waits for the device
        best = min(best, time.perf_counter() - t0)
        iters = int(r.n_iters)
    return best, iters, r


def two_loop_us(fn, m, n, K1, K2, seed=0):
    """Device time of one ``fn(v, hist)`` direction (us) at history size
    ``m`` and ``n`` parameters, from the slope of a K-step dependent chain
    at two K: (t_K2 - t_K1) / (K2 - K1) cancels the fixed dispatch and
    sync cost of the call."""
    import numpy as np
    from jax import lax

    from lbfgs_ffnn.ops.two_loop import empty_history_state, ring_push

    rng = np.random.default_rng(seed)
    hist = empty_history_state(m, n, jnp.float32)
    push = jax.jit(ring_push)
    for _ in range(m):
        s = jnp.asarray(rng.normal(size=n), jnp.float32)
        yv = jnp.asarray(rng.normal(size=n) + 0.5 * np.asarray(s), jnp.float32)
        hist = push(hist, s, yv, 1.0 / jnp.vdot(yv, s), jnp.array(True))

    def timed_at(K):
        def many(v, hist):
            def bd(i, acc):
                return acc + 1e-6 * fn(acc, hist)
            return jnp.sum(lax.fori_loop(0, K, bd, v))

        c = jax.jit(many).lower(jnp.zeros(n, jnp.float32), hist).compile()
        vs = [jnp.asarray(rng.normal(size=n), jnp.float32) for _ in range(4)]
        _ = float(c(vs[0], hist))
        ts = []
        for v in vs[1:]:
            t0 = time.perf_counter()
            _ = float(c(v, hist))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    return (timed_at(K2) - timed_at(K1)) / (K2 - K1) * 1e6


def main():
    backend = jax.default_backend()
    if backend != "gpu":
        log(f"bench.py measures the GPU; JAX runs on {backend!r}")
        sys.exit(2)
    from lbfgs_ffnn.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    d = jax.devices()[0]
    ms_per_iter = run()
    baseline_ms = 7.20  # reference cuBLAS L-BFGS m=10 ms/iter (BASELINE.md)
    print(json.dumps({
        "metric": "MNIST 784-128-10 full-batch L-BFGS m=10 step time",
        "value": round(ms_per_iter, 4),
        "unit": "ms/iter",
        "vs_baseline": round(baseline_ms / ms_per_iter, 3),
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
    }))


def run() -> float:
    """All phases; returns the headline ms/iter."""
    from lbfgs_ffnn.data.datasets import load_mnist
    from lbfgs_ffnn.objectives.mlp import (
        evaluate, mlp_batch_problem, mlp_init, mlp_problem, mlp_spec,
    )
    from lbfgs_ffnn.solvers import (
        LBFGSOptions, SLBFGSOptions, lbfgs, slbfgs,
    )

    log(f"backend={jax.default_backend()} devices={jax.devices()}")

    # 1000 iterations to match the reference CSV run length (BASELINE.md).
    n_train = 6000 if QUICK else 60000
    iters = 20 if QUICK else 1000
    ds = load_mnist(train_size=n_train, test_size=10000)
    x = jnp.asarray(ds.train_x)
    y = jnp.asarray(ds.train_y)
    spec = mlp_spec([784, 128, 10], ["relu", "linear"])
    prob = mlp_problem(spec)

    w0s = [
        mlp_init(spec, jax.random.PRNGKey(123 + i), dtype=jnp.float32)
        for i in range(4 if not QUICK else 2)
    ]

    # ---- headline: full-batch L-BFGS m=10, the reference CUDA line-search
    # policy (sequential Armijo with quadratic interpolation — exact
    # trial-sequence parity with src/cuda/lbfgs.cuh). Trials run as lean
    # forwards through the carried first-layer line prefix
    # (Problem.line_prefix: A lives in solver state, A += alpha*B per step).
    # Configs timed: plain f32, and the narrow HBM-traffic stacks (bf16 or
    # u8 input copy for the restriction/backward GEMMs + bf16 carried
    # prefix + bf16 curvature ring — arithmetic stays f32 everywhere). A
    # bf16 input read rounds the operand, so its loss and gradient differ
    # from the f32 read's. The faster config becomes the headline ONLY if
    # it passes a quality parity gate against f32 (final loss within 2%,
    # train accuracy within 0.3 points) — the gate is evaluated fresh every
    # run, so the headline can never adopt a traffic optimization that
    # costs convergence.
    # tol 1e-12 so the run goes the full iteration budget. ----
    opts = LBFGSOptions(
        max_iters=iters, tol=1e-12, m=10, line_search="armijo",
        ls_max_iters=20, two_loop_impl="xla",
    )
    prob_bf16 = mlp_problem(spec, grad_input_dtype="bfloat16",
                            line_input_dtype="bfloat16")
    opts_bf16 = opts._replace(pair_dtype="bfloat16", prefix_dtype="bfloat16")
    # u8 stack: the benchmark inputs are 8-bit pixel data (every entry is
    # exactly k/255), so the prepared input copy can be stored as uint8 —
    # quartering the raw-input HBM read; int->float upcast is exact and the
    # 1/255 rescale rides the dot epilogue (PERF.md).
    prob_u8 = mlp_problem(spec, grad_input_dtype="uint8",
                          line_input_dtype="uint8", fun_input_dtype="uint8")

    # warm-started line search (ls_alpha_init="warm"): near the plateau the
    # accepted step sits orders of magnitude below 1, and the reference's
    # fixed alpha0=1 restart re-pays the whole shrink ladder every iteration
    # (12-14 trials/iter counted); warm-starting at min(1, 8*alpha_prev)
    # cuts that to ~3 (PERF.md). Gated like every other
    # candidate: adopted only if final loss/accuracy hold parity with f32.
    opts_warm = opts_bf16._replace(ls_alpha_init="warm", ls_alpha_growth=8.0)
    # u8-warm-nr: refresh machinery removed entirely (prefix_refresh=0),
    # which drops the refresh cond from the program. Without
    # re-anchoring, the stored bf16 prefix
    # drifts at ~sqrt(iters)*eps_bf16, so the gate below judges this config
    # (like every config) by the EXACT final loss recomputed with the plain
    # f32 objective at the returned iterate — the drifted in-solver loss is
    # never what is compared.
    opts_warm_nr = opts_warm._replace(prefix_refresh=0)

    exact_loss = jax.jit(lambda w: prob.fun(w, (x, y)))

    headline = {}
    for tag, hprob, hopts in (("f32", prob, opts),
                              ("bf16-traffic", prob_bf16, opts_bf16),
                              ("u8-traffic", prob_u8, opts_bf16),
                              ("u8-warm", prob_u8, opts_warm),
                              ("u8-warm-nr", prob_u8, opts_warm_nr)):
        def run_lbfgs(w0, hprob=hprob, hopts=hopts):
            return lbfgs(hprob, w0, aux=(x, y), opts=hopts)

        wall, n_iters, res = time_solve(run_lbfgs, w0s)
        acc = evaluate(spec, res.x, x, y)["accuracy"]
        headline[tag] = (wall * 1e3 / max(n_iters, 1),
                         float(exact_loss(res.x)), float(acc))
        log(
            f"L-BFGS m=10 N={n_train} [{tag}]: {n_iters} iters in "
            f"{wall:.3f}s -> {headline[tag][0]:.3f} ms/iter, final loss "
            f"{headline[tag][1]:.5g} (exact f32 eval), train acc {acc:.2f}%"
        )

    ms_f, loss_f, acc_f = headline["f32"]
    ms_per_iter, chosen = ms_f, "f32"
    for tag in ("bf16-traffic", "u8-traffic", "u8-warm", "u8-warm-nr"):
        ms_t, loss_t, acc_t = headline[tag]
        parity = loss_t <= loss_f * 1.02 + 1e-6 and acc_t >= acc_f - 0.3
        log(f"{tag} parity gate {'PASSED' if parity else 'FAILED'}: "
            f"loss {loss_t:.5g} vs {loss_f:.5g}, "
            f"acc {acc_t:.2f} vs {acc_f:.2f}")
        if parity and ms_t < ms_per_iter:
            ms_per_iter, chosen = ms_t, tag
    log(f"headline config: {chosen}")

    # ---- supplementary: S-LBFGS epoch cost (reference CPU: 214.7 ms/epoch
    # at N=5000, b=256) ----
    n_sl = 5000
    xs, ys = x[:n_sl], y[:n_sl]
    bp = mlp_batch_problem(spec, lam=1e-4)
    sl_opts = SLBFGSOptions(
        epochs=4 if QUICK else 100, tol=1e-12, history=10, L=10,
        batch_size=256, hvp_batch_size=128, step_size=0.02,
    )

    def run_sl(w0):
        return slbfgs(bp, w0, xs, ys, sl_opts)

    wall_sl, ep, res_sl = time_solve(run_sl, w0s[:3])
    log(
        f"S-LBFGS N={n_sl} b=256: {ep} epochs in {wall_sl:.3f}s -> "
        f"{wall_sl * 1e3 / max(ep, 1):.2f} ms/epoch "
        f"(reference CPU: 214.7 ms/epoch), loss {float(res_sl.final_loss):.5g}"
    )

    # ---- supplementary: deep-net L-BFGS m=100 (reference
    # main_gpu_deep.cpp / BASELINE.md: 19.4 ms/iter on the 784-256-128-64-10
    # Fashion net), f32 vs the bf16 curvature ring + narrow backward-input
    # read (forward/loss/trials stay exactly f32) ----
    from lbfgs_ffnn.data.datasets import load_fashion_mnist

    dsd = load_fashion_mnist(train_size=n_train, test_size=10000)
    xd, yd = jnp.asarray(dsd.train_x), jnp.asarray(dsd.train_y)
    dspec = mlp_spec([784, 256, 128, 64, 10],
                     ["relu", "relu", "relu", "linear"])
    dw0s = [mlp_init(dspec, jax.random.PRNGKey(7 + i), dtype=jnp.float32)
            for i in range(2 if QUICK else 3)]
    dbase = LBFGSOptions(max_iters=iters, tol=1e-12, m=100,
                         line_search="armijo", ls_max_iters=20,
                         two_loop_impl="xla")
    # Three configs: reference-parity f32, the full u8 traffic stack (u8
    # input copy for the restriction/backward GEMMs + bf16 carried prefix +
    # bf16 ring), and that stack with the warm line-search start.
    dprob_u8 = mlp_problem(dspec, grad_input_dtype="uint8",
                           line_input_dtype="uint8")
    dopts_u8 = dbase._replace(pair_dtype="bfloat16",
                              prefix_dtype="bfloat16")
    for tag, dprob, dopts in (
        ("f32", mlp_problem(dspec), dbase),
        ("u8 traffic stack", dprob_u8, dopts_u8),
        ("u8 + warm alpha", dprob_u8,
         dopts_u8._replace(ls_alpha_init="warm", ls_alpha_growth=8.0)),
    ):
        def run_deep(w0, dprob=dprob, dopts=dopts):
            return lbfgs(dprob, w0, aux=(xd, yd), opts=dopts)

        wd, nd, rd = time_solve(run_deep, dw0s)
        log(
            f"deep 784-256-128-64-10 L-BFGS m=100 [{tag}] N={n_train}: "
            f"{nd} iters in {wd:.3f}s -> {wd * 1e3 / max(nd, 1):.3f} "
            f"ms/iter (reference GPU: 19.4 ms/iter), "
            f"loss {float(rd.final_loss):.5g}"
        )

    # ---- supplementary: two-loop direction, loop form vs compact GEMV
    # form, at the shallow and the deep net's parameter counts (us/call) ----
    from lbfgs_ffnn.ops.two_loop import two_loop, two_loop_compact

    K1, K2 = (25, 125) if QUICK else (50, 350)
    for n in (spec.n_params, dspec.n_params):
        for m in (10, 100):
            us_x = two_loop_us(two_loop, m, n, K1, K2)
            us_c = two_loop_us(two_loop_compact, m, n, K1, K2)
            log(f"two-loop m={m} n={n}: loop form {us_x:.1f} us | "
                f"compact {us_c:.1f} us")

    return ms_per_iter


if __name__ == "__main__":
    main()
