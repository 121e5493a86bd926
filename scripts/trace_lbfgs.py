"""Device busy and idle share of the L-BFGS solve loop, from one trace.

Runs the bench.py f32 headline configuration (MNIST 784-128-10,
N = 60,000, m = 10, reference CUDA line-search policy) for ``--iters``
iterations three times: a warm-up solve (compiles), an untraced timed
solve, and one solve under ``jax.profiler.trace``. Then reduces the trace:

* busy = union of the kernel intervals on the device's stream lines
  (``/device:GPU:0`` plane, lines named ``Stream ...``; the module and op
  summary lines are excluded because they span whole executions);
* window = the traced solve's device span (first kernel start to last
  kernel end); idle share = 1 - busy / window;
* the top kernels by summed device time, and the gaps between kernels.

  python scripts/trace_lbfgs.py [--iters 200] [--out traces/lbfgs]
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def union_ns(intervals):
    """Total length covered by ``(start, end)`` intervals (overlaps once)."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def kernel_events(path, plane_prefix="/device:GPU:0", line_prefix="Stream"):
    """[(name, start_ns, end_ns)] of the kernels on one device plane, and
    the plane's line names with event counts (for inspection)."""
    import jax

    pd = jax.profiler.ProfileData.from_file(path)
    events, lines = [], []
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines.append((line.name, len(evs)))
            if line.name.startswith(line_prefix):
                events += [(e.name, e.start_ns, e.end_ns) for e in evs]
    return events, lines


def reduce_trace(events):
    """Busy/idle share over the kernels' own span, plus gap statistics."""
    if not events:
        raise ValueError("no kernel events on the device plane")
    start = min(s for _, s, _ in events)
    end = max(e for _, _, e in events)
    busy = union_ns([(s, e) for _, s, e in events])
    ordered = sorted((s, e) for _, s, e in events)
    gaps, reach = [], ordered[0][1]
    for s, e in ordered[1:]:
        if s > reach:
            gaps.append(s - reach)
        reach = max(reach, e)
    per_kernel = collections.Counter()
    for name, s, e in events:
        per_kernel[name] += e - s
    return {
        "window_ns": end - start, "busy_ns": busy,
        "idle_share": 1.0 - busy / max(end - start, 1),
        "n_kernels": len(events), "n_gaps": len(gaps),
        "gap_ns_total": sum(gaps),
        "gap_ns_median": sorted(gaps)[len(gaps) // 2] if gaps else 0,
        "top": per_kernel.most_common(12),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--out", default="traces/lbfgs")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from lbfgs_ffnn.data.datasets import load_mnist
    from lbfgs_ffnn.objectives.mlp import mlp_init, mlp_problem, mlp_spec
    from lbfgs_ffnn.solvers import LBFGSOptions, lbfgs
    from lbfgs_ffnn.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ds = load_mnist(train_size=60000, test_size=1)
    x, y = jnp.asarray(ds.train_x), jnp.asarray(ds.train_y)
    spec = mlp_spec([784, 128, 10], ["relu", "linear"])
    prob = mlp_problem(spec)
    opts = LBFGSOptions(max_iters=args.iters, tol=1e-12, m=10,
                        line_search="armijo", ls_max_iters=20)
    w0s = [mlp_init(spec, jax.random.PRNGKey(123 + i)) for i in range(3)]

    float(lbfgs(prob, w0s[0], aux=(x, y), opts=opts).final_loss)
    t0 = time.perf_counter()
    res = lbfgs(prob, w0s[1], aux=(x, y), opts=opts)
    float(res.final_loss)
    wall = time.perf_counter() - t0
    n = int(res.n_iters)
    print(f"untraced: {n} iters, {wall * 1e3 / n:.4f} ms/iter, "
          f"{int(res.n_fevals) / n:.2f} fevals/iter")

    with jax.profiler.trace(args.out):
        t0 = time.perf_counter()
        float(lbfgs(prob, w0s[2], aux=(x, y), opts=opts).final_loss)
        traced_wall = time.perf_counter() - t0
    path = sorted(glob.glob(os.path.join(args.out, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    events, lines = kernel_events(path)
    print(f"trace {path}")
    print(f"device plane lines: {lines}")
    r = reduce_trace(events)
    print(f"traced solve: host {traced_wall * 1e3:.3f} ms, device span "
          f"{r['window_ns'] / 1e6:.3f} ms, busy {r['busy_ns'] / 1e6:.3f} ms, "
          f"idle share {r['idle_share']:.4f}")
    print(f"kernels {r['n_kernels']} ({r['n_kernels'] / n:.1f}/iter), gaps "
          f"{r['n_gaps']}, gap total {r['gap_ns_total'] / 1e6:.3f} ms, median "
          f"gap {r['gap_ns_median'] / 1e3:.2f} us")
    for name, ns in r["top"]:
        print(f"  {ns / 1e6:9.3f} ms  {ns / 1e3 / n:8.2f} us/iter  {name[:90]}")


if __name__ == "__main__":
    main()
