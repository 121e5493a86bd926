"""Start-up check of the training path on one GPU (or, with --four-gpus, of
the mesh paths on four).

    python chip_smoke.py              # one GPU
    python chip_smoke.py --four-gpus  # the four mesh paths, each against
                                      # the same run on one GPU

Phases, each of which fails the run (nonzero exit, no result line):

1. Device: JAX must run on a GPU. The card's ``nvidia-smi`` name and power
   limit are printed.
2. Correctness at the benchmark widths, against float64 NumPy written in
   this file: the 784-128-10 MLP's loss and gradient at N = 60,000 under
   ``"highest"`` and under the default matmul precision (TF32 may be
   used), and both two-loop forms (``two_loop``, ``two_loop_compact``) at
   m = 10 and m = 100, n = 101,770, under ``"highest"``.
3. Main path through the public entry points: 20 L-BFGS iterations of the
   ``bench.py`` f32 configuration through ``Launcher``, 5 iterations of the
   deep 784-256-128-64-10 net at m = 100, 2 S-LBFGS epochs at N = 5,000 and
   5 Burgers-PINN iterations. Each loss must be finite and below its start.

The last line of stdout is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lbfgs_ffnn.data.datasets import load_fashion_mnist, load_mnist  # noqa: E402
from lbfgs_ffnn.launcher import Launcher, UnifiedConfig  # noqa: E402
from lbfgs_ffnn.objectives.mlp import (  # noqa: E402
    mlp_batch_problem, mlp_init, mlp_problem, mlp_spec,
)
from lbfgs_ffnn.ops.two_loop import (  # noqa: E402
    empty_history_state, ring_push, two_loop, two_loop_compact,
)
from lbfgs_ffnn.solvers import (  # noqa: E402
    LBFGSOptions, SLBFGSOptions, lbfgs, slbfgs,
)
from lbfgs_ffnn.utils.compile_cache import enable_compile_cache  # noqa: E402

SHALLOW = ([784, 128, 10], ["relu", "linear"])
DEEP = ([784, 256, 128, 64, 10], ["relu", "relu", "relu", "linear"])
# The bench.py f32 headline configuration (reference CUDA policy).
BENCH_LBFGS = dict(tol=1e-12, line_search="armijo", ls_max_iters=20)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# float64 references (independent of the package's code)
# ---------------------------------------------------------------------------

_ACT = {
    "relu": (lambda z: np.maximum(z, 0.0), lambda z: (z > 0).astype(z.dtype)),
    "linear": (lambda z: z, lambda z: np.ones_like(z)),
    "tanh": (np.tanh, lambda z: 1.0 - np.tanh(z) ** 2),
}


def ref_mlp_loss_grad(dims, acts, w, x, y):
    """0.5 * ||mlp(x) - y||^2 / N and its gradient, in float64, over the
    flat [W1 (row-major in x out), b1, W2, b2, ...] parameter layout."""
    w, x, y = (np.asarray(a, np.float64) for a in (w, x, y))
    layers, off = [], 0
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        W = w[off:off + d_in * d_out].reshape(d_in, d_out)
        b = w[off + d_in * d_out:off + d_in * d_out + d_out]
        layers.append((W, b))
        off += d_in * d_out + d_out
    hs, zs = [x], []
    for (W, b), a in zip(layers, acts):
        zs.append(hs[-1] @ W + b)
        hs.append(_ACT[a][0](zs[-1]))
    n = x.shape[0]
    diff = hs[-1] - y
    loss = 0.5 * np.sum(diff * diff) / n
    grads = []
    d = diff / n
    for i in reversed(range(len(layers))):
        dz = d * _ACT[acts[i]][1](zs[i])
        grads.append((hs[i].T @ dz).ravel())
        grads[-1] = np.concatenate([grads[-1], dz.sum(axis=0)])
        d = dz @ layers[i][0].T
    return loss, np.concatenate(grads[::-1])


def ref_two_loop(S, Y, v):
    """H_k @ v by the two-loop recursion in float64; rows of S, Y are the
    curvature pairs oldest first, H_0 = (s.y / y.y) I of the newest."""
    S, Y, v = (np.asarray(a, np.float64) for a in (S, Y, v))
    k = S.shape[0]
    if k == 0:
        return v.copy()
    rho = 1.0 / np.einsum("in,in->i", S, Y)
    q, alpha = v.copy(), np.zeros(k)
    for i in reversed(range(k)):
        alpha[i] = rho[i] * (S[i] @ q)
        q -= alpha[i] * Y[i]
    r = (S[-1] @ Y[-1]) / (Y[-1] @ Y[-1]) * q
    for i in range(k):
        r += (alpha[i] - rho[i] * (Y[i] @ r)) * S[i]
    return r


def rel_err(got, ref):
    """max |got - ref| / max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def curvature_pairs(k, n, seed):
    """``k`` (s, y) pairs of a well-conditioned quadratic (y = D s + noise,
    diag D in [0.5, 2]), float32, oldest first."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.5, 2.0, size=n)
    S = rng.standard_normal((k, n))
    Y = d * S + 0.01 * rng.standard_normal((k, n))
    return S.astype(np.float32), Y.astype(np.float32)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


class Checks:
    """Collects comparisons; every one is printed beside its tolerance."""

    def __init__(self):
        self.failed = []

    def __call__(self, name, err, tol, precision):
        ok = bool(np.isfinite(err)) and err <= tol
        log(f"  {'ok  ' if ok else 'FAIL'} {name}: max rel err {err:.3e} "
            f"<= tol {tol:.0e} (precision={precision})")
        if not ok:
            self.failed.append(name)


def check_mlp(check, n_train, dims=SHALLOW, seed=0):
    spec = mlp_spec(*dims)
    ds = load_mnist(train_size=n_train, test_size=1)
    x, y = jnp.asarray(ds.train_x), jnp.asarray(ds.train_y)
    w = mlp_init(spec, jax.random.PRNGKey(seed), dtype=jnp.float32)
    ref_f, ref_g = ref_mlp_loss_grad(spec.dims, spec.activations, w, ds.train_x,
                                     ds.train_y)
    prob = mlp_problem(spec)
    for precision, tol in (("highest", 1e-5), ("default", 2e-3)):
        with jax.default_matmul_precision(precision):
            f, g = jax.jit(lambda w, a: prob.value_and_grad(w, a))(w, (x, y))
        tag = f"MLP {'-'.join(map(str, spec.dims))} N={n_train}"
        check(f"{tag} loss", rel_err(f, ref_f), tol, precision)
        check(f"{tag} grad", rel_err(g, ref_g), tol, precision)


def check_two_loop(check, n, ms=(10, 100), seed=1):
    push = jax.jit(ring_push)
    for m in ms:
        k = m + 3  # wraps the ring
        S, Y = curvature_pairs(k, n, seed + m)
        hist = empty_history_state(m, n, jnp.float32)
        for s, yv in zip(S, Y):
            s, yv = jnp.asarray(s), jnp.asarray(yv)
            hist = push(hist, s, yv, 1.0 / jnp.vdot(yv, s), jnp.array(True))
        v = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
        ref = ref_two_loop(S[-m:], Y[-m:], v)
        for name, fn in (("two_loop", two_loop), ("two_loop_compact", two_loop_compact)):
            with jax.default_matmul_precision("highest"):
                r = jax.jit(fn)(jnp.asarray(v), hist)
            check(f"{name} m={m} n={n}", rel_err(r, ref), 1e-4, "highest")


def _assert_descends(name, f0, res, wall_s=None, unit="iter"):
    f1 = float(res.final_loss)
    n = int(res.n_iters)
    rate = f"  {wall_s * 1e3 / max(n, 1):.3f} ms/{unit}" if wall_s else ""
    log(f"  {name}: {n} {unit}s, loss {f0:.6g} -> {f1:.6g}{rate}")
    if not (math.isfinite(f1) and f1 < f0):
        raise AssertionError(f"{name}: loss did not go down ({f0} -> {f1})")


def _mnist_launcher(ds, dims, style="cuda"):
    la = Launcher(style)
    for d_in, d_out, act in zip(dims[0][:-1], dims[0][1:], dims[1]):
        la.add_layer(d_in, d_out, act)
    return la.build_network(seed=123).set_data(ds)


def main_path(n_train=60000, n_sl=5000, lbfgs_iters=20, deep_iters=5,
              sl_epochs=2, pinn_iters=5, burgers_grid=None):
    from lbfgs_ffnn.objectives.mlp import mlp_loss
    from lbfgs_ffnn.objectives.pinn import (
        burgers_points, burgers_problem, default_burgers_spec, pinn_init,
    )

    loss_at = jax.jit(mlp_loss, static_argnums=(0, 4))

    # L-BFGS m=10, the bench.py f32 configuration, through Launcher.
    ds = load_mnist(train_size=n_train, test_size=10000)
    la = _mnist_launcher(ds, SHALLOW)
    x, y = la._x, la._y
    f0 = float(loss_at(la.spec, la.weights, x, y, 0.0))
    cfg = UnifiedConfig(name="smoke_lbfgs", max_iters=lbfgs_iters, tolerance=1e-12,
                        m_param=10, reset_params=False, write_csv=False)
    rep = la.train("lbfgs", cfg)
    _assert_descends(f"L-BFGS m=10 784-128-10 N={n_train}", f0, rep.result,
                     rep.wall_time_s)
    opts = LBFGSOptions(max_iters=lbfgs_iters, m=10, **BENCH_LBFGS)
    prob = mlp_problem(la.spec)
    w0 = mlp_init(la.spec, jax.random.PRNGKey(0))
    compiled = jax.jit(lambda w, a: lbfgs(prob, w, a, opts)).lower(w0, (x, y)).compile()
    log(f"  L-BFGS solve memory_analysis: {compiled.memory_analysis()}")

    # Deep net, m=100 (ring of 2 x 100 x n floats).
    dsd = load_fashion_mnist(train_size=n_train, test_size=16)
    la = _mnist_launcher(dsd, DEEP)
    f0 = float(loss_at(la.spec, la.weights, la._x, la._y, 0.0))
    cfg = UnifiedConfig(name="smoke_deep", max_iters=deep_iters, tolerance=1e-12,
                        m_param=100, reset_params=False, write_csv=False)
    rep = la.train("lbfgs", cfg)
    _assert_descends(f"L-BFGS m=100 784-256-128-64-10 N={n_train}", f0,
                     rep.result, rep.wall_time_s)

    # S-LBFGS, reference CPU configuration (b=256, M=10, L=10, b_H=128).
    la = _mnist_launcher(load_mnist(train_size=n_sl, test_size=16), SHALLOW,
                         style="cpu")
    f0 = float(loss_at(la.spec, la.weights, la._x, la._y, 1e-4))
    cfg = UnifiedConfig(name="smoke_slbfgs", max_iters=sl_epochs, tolerance=1e-12,
                        learning_rate=0.02, batch_size=256, m_param=10,
                        L_param=10, b_H_param=128, reset_params=False,
                        write_csv=False)
    rep = la.train("slbfgs", cfg)
    _assert_descends(f"S-LBFGS N={n_sl} b=256", f0, rep.result, rep.wall_time_s,
                     unit="epoch")

    # Burgers PINN, the experiments/run_burgers.py solver configuration.
    spec = default_burgers_spec()
    pprob = burgers_problem(spec)
    pts = burgers_points(**(burgers_grid or {}))
    w0 = pinn_init(spec, jax.random.PRNGKey(123), dtype=jnp.float32)
    f0 = float(jax.jit(pprob.fun)(w0, pts))
    popts = LBFGSOptions(max_iters=pinn_iters, tol=1e-10, m=100, ls_max_iters=100,
                         curvature_rel_eps=1e-6, ls_value_only=True)
    t0 = time.perf_counter()
    res = lbfgs(pprob, w0, aux=pts, opts=popts)
    float(res.final_loss)
    _assert_descends(f"Burgers PINN n={spec.n_params} collocation="
                     f"{pts.col_xt.shape[0]} (incl. compile)", f0, res,
                     time.perf_counter() - t0)


def four_gpu_paths(check, devices, n_train=60000, lbfgs_iters=10, deep_iters=5,
                   sl_epochs=2, sl_batch=256):
    """The mesh paths on ``devices`` (four), each compared with the same
    run on one device. The mesh runs go first, so the per-device peak
    memory read after them shows whether work landed on one device only."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lbfgs_ffnn.parallel import make_mesh, replicate, shard_batch

    nd = len(devices)
    spec, dspec = mlp_spec(*SHALLOW), mlp_spec(*DEEP)
    ds = load_mnist(train_size=n_train, test_size=1)
    dsd = load_fashion_mnist(train_size=n_train, test_size=1)
    w0 = np.asarray(mlp_init(spec, jax.random.PRNGKey(1)))
    dw0 = np.asarray(mlp_init(dspec, jax.random.PRNGKey(2)))
    prob, dprob = mlp_problem(spec), mlp_problem(dspec)
    bp = mlp_batch_problem(spec, lam=1e-4)
    opts = LBFGSOptions(max_iters=lbfgs_iters, m=10, **BENCH_LBFGS)
    dopts = LBFGSOptions(max_iters=deep_iters, m=100, **BENCH_LBFGS)
    sl_opts = SLBFGSOptions(epochs=sl_epochs, tol=1e-12, history=10, L=10,
                            batch_size=sl_batch, hvp_batch_size=sl_batch // 2,
                            step_size=0.02, sampling="global")

    mesh_dp = make_mesh(nd, "data", devices=devices)
    mesh_tp = make_mesh(nd, "model", devices=devices)
    mesh_2d = make_mesh((2, nd // 2), ("data", "model"), devices=devices)
    runs = {}
    with jax.default_matmul_precision("highest"):
        xs, ys = shard_batch(mesh_dp, ds.train_x, ds.train_y)
        t0 = time.perf_counter()
        runs["GSPMD data-parallel L-BFGS m=10"] = lbfgs(
            prob, replicate(mesh_dp, w0), aux=(xs, ys), opts=opts)
        runs["shard_map S-LBFGS sampling=global"] = slbfgs(
            bp, replicate(mesh_dp, w0), xs, ys, sl_opts, mesh=mesh_dp)
        xr, yr = replicate(mesh_tp, (dsd.train_x, dsd.train_y))
        runs["param-sharded L-BFGS m=100 deep"] = lbfgs(
            dprob, replicate(mesh_tp, dw0), aux=(xr, yr), opts=dopts, mesh=mesh_tp)
        x2, y2 = (jax.device_put(a, NamedSharding(mesh_2d, P("data")))
                  for a in (ds.train_x, ds.train_y))
        runs["2x2 (data, model) mesh L-BFGS m=10"] = lbfgs(
            prob, replicate(mesh_2d, w0), aux=(x2, y2), opts=opts, mesh=mesh_2d)
        jax.block_until_ready(runs)
        log(f"  mesh runs done in {time.perf_counter() - t0:.1f}s (incl. compile)")
        for name, r in runs.items():
            log(f"  {name}: result on {len(r.x.sharding.device_set)} devices")
        del xs, ys, xr, yr, x2, y2
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in devices]
        if None not in peaks:
            log("  peak bytes in use per device after the mesh runs: "
                + ", ".join(f"{d.id}: {p / 2**20:.1f} MiB" for d, p in zip(devices, peaks)))
            check("peak memory spread (1 - min/max over devices)",
                  1.0 - min(peaks) / max(peaks), 0.5, "n/a")

        one = jax.sharding.SingleDeviceSharding(devices[0])
        x1, y1 = jax.device_put((ds.train_x, ds.train_y), one)
        r_lb = lbfgs(prob, jax.device_put(w0, one), aux=(x1, y1), opts=opts)
        r_sl = slbfgs(bp, jax.device_put(w0, one), x1, y1,
                      sl_opts._replace(sampling="local"))
        xd1, yd1 = jax.device_put((dsd.train_x, dsd.train_y), one)
        r_dp = lbfgs(dprob, jax.device_put(dw0, one), aux=(xd1, yd1), opts=dopts)
    refs = {"GSPMD data-parallel L-BFGS m=10": r_lb,
            "shard_map S-LBFGS sampling=global": r_sl,
            "param-sharded L-BFGS m=100 deep": r_dp,
            "2x2 (data, model) mesh L-BFGS m=10": r_lb}
    for name, r in runs.items():
        ref = refs[name]
        log(f"  {name}: {int(r.n_iters)} iters, loss {float(r.final_loss):.7g} "
            f"vs one device {float(ref.final_loss):.7g}")
        if int(r.n_iters) != int(ref.n_iters):
            check(f"{name} iteration count", float("inf"), 0.0, "highest")
        check(f"{name} final loss vs one device",
              rel_err(r.final_loss, ref.final_loss), 1e-3, "highest")
        check(f"{name} iterate vs one device", rel_err(r.x, ref.x), 1e-2,
              "highest")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-GPU mesh paths and their one-GPU "
                         "comparisons")
    args = ap.parse_args(argv)

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: JAX runs on {backend!r}, not on a GPU", file=sys.stderr)
        return 2
    devices = jax.devices()
    need = 4 if args.four_gpus else 1
    if len(devices) < need:
        print(f"chip_smoke: need {need} GPUs, JAX sees {len(devices)}",
              file=sys.stderr)
        return 2
    devices = devices[:need]
    log(f"card (nvidia-smi name, power.limit): {nvidia_smi()}")
    log(f"jax {jax.__version__}: {[d.device_kind for d in devices]}")
    log(f"compile cache: {enable_compile_cache()}")

    t_start = time.perf_counter()
    check = Checks()
    if args.four_gpus:
        log("[four GPUs] mesh paths vs one GPU")
        four_gpu_paths(check, devices)
    else:
        log("[correctness] float64 NumPy references at the benchmark widths")
        check_mlp(check, 60000)
        check_two_loop(check, mlp_spec(*SHALLOW).n_params)
        log("[main path] training through the public entry points")
        main_path()
    if check.failed:
        print(f"chip_smoke: failed: {check.failed}", file=sys.stderr)
        return 1
    log(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
