"""MNIST experiment runner — the reference's tests/mnist/main-{cpu,gpu}.cpp
configurations.

Style "cpu" (reference main-cpu.cpp: 5,000 train samples):
  GD(mom .9) -> SGD(b=256, lr .03) -> S-LBFGS(b=256, M=10, L=10, b_H=128,
  lr .02) -> L-BFGS(m=20), 1000 iters/epochs each.
Style "cuda" (reference main-gpu.cpp: 60,000 samples):
  GD(mom .9) -> SGD(b=256, decay .8/40) -> L-BFGS m=10 -> L-BFGS m=100.

Usage:
  python experiments/run_mnist.py --style cuda --iters 1000
  python experiments/run_mnist.py --style cpu --train-size 5000

JAX picks the device (set JAX_PLATFORMS=cpu for a CPU run).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import argparse

parser = argparse.ArgumentParser()
parser.add_argument("--style", choices=["cpu", "cuda"], default="cuda")
parser.add_argument("--train-size", type=int, default=None)
parser.add_argument("--iters", type=int, default=1000)
parser.add_argument("--dataset", choices=["mnist", "fashion"], default="mnist")
parser.add_argument("--deep", action="store_true",
                    help="784-256-128-64-10 (reference main_gpu_deep.cpp)")
parser.add_argument("--two-loop", choices=["xla", "compact"], default="xla",
                    help="two-loop direction: loop form (xla) or the compact "
                         "GEMV form")
parser.add_argument("--batched-ls", action="store_true",
                    help="add L-BFGS runs with the speculative batched "
                         "Armijo ladder (pure backtracking, slightly "
                         "better loss; since the carried line prefix, the "
                         "reference policy is the faster one)")
parser.add_argument("--bf16-ring", action="store_true",
                    help="add L-BFGS runs storing the curvature ring in "
                         "bfloat16 (half the ring HBM traffic; recursion "
                         "arithmetic stays f32 — no reference "
                         "counterpart)")
parser.add_argument("--bf16-grad-input", action="store_true",
                    help="add L-BFGS runs reading the input matrix at half "
                         "width (bf16) in the accept-point dW1 GEMM only — "
                         "forward/loss/line-search trials stay exactly f32 "
                         "(no reference counterpart)")
parser.add_argument("--bf16-prefix", action="store_true",
                    help="add L-BFGS variants storing the carried line "
                         "prefix (A = x@W1+b1 and per-iteration B) in bf16 "
                         "— halves the trial/accept prefix HBM traffic; "
                         "arithmetic stays f32 with an exact re-anchor "
                         "every 16 iterations")
parser.add_argument("--bf16-line-input", action="store_true",
                    help="add L-BFGS runs feeding the bf16 input copy to "
                         "the line-restriction GEMMs (B = x@W1_p per iter, "
                         "A init/refresh) — halves B's dominant input read "
                         "at the cost of one bf16 rounding of x")
parser.add_argument("--bf16-all", action="store_true",
                    help="add L-BFGS runs stacking every bf16 traffic "
                         "lever: ring + grad-input + line-input + carried "
                         "prefix storage")
parser.add_argument("--u8-input", action="store_true",
                    help="add L-BFGS runs reading a uint8 pixel-quantized "
                         "input copy in the restriction/backward GEMMs "
                         "(quarter the f32 read; exact for k/255 pixel "
                         "data, 1/255 scale fused into the dot epilogue)")
parser.add_argument("--u8-all", action="store_true",
                    help="add L-BFGS runs stacking the u8 input copy with "
                         "the bf16 ring + carried prefix storage")
parser.add_argument("--warm-alpha", action="store_true",
                    help="add L-BFGS runs with the warm-started line-search "
                         "initial step (ls_alpha_init='warm': resume at "
                         "min(1, 8*previous step) instead of alpha0=1 — "
                         "cuts plateau backtracking from ~13 to ~3 "
                         "trials/iter; no reference counterpart), both alone and "
                         "stacked on the u8 traffic configuration")
parser.add_argument("--bf16-compute", action="store_true",
                    help="add L-BFGS runs evaluating the objective with "
                         "bf16 matmul operands (f32 accumulation/params/"
                         "loss; no reference counterpart)")
parser.add_argument("--record-accuracy", action="store_true",
                    help="per-epoch TrainAcc+TestAcc columns for the "
                         "stochastic solvers (rendered by plot_results.py, "
                         "reference: scripts/plot_results.py:107-127)")
parser.add_argument("--only", type=str, default="",
                    help="run only configs whose name contains this "
                         "substring (regenerate single variant rows "
                         "without re-timing a whole artifact directory)")
parser.add_argument("--seeds", type=int, default=1,
                    help=">1: run every configured run at N init seeds "
                         "(config.seed, config.seed+1, ...) and write a "
                         "multiseed_summary.json with per-seed measured "
                         "ms/iter + final loss and the median/min/max — "
                         "the Armijo trial-count lottery moves single "
                         "draws +-25%% (PERF.md), so "
                         "committed table rows report the median (min-max) "
                         "across seeds. The first seed writes the history "
                         "CSV; all seeds share each config's compiled "
                         "executable (the seed only changes w0 values)")
parser.add_argument("--timed-chunks", type=int, default=0,
                    help=">0: run every solver in K-iteration chunks with "
                         "measured (not synthesized) cumulative TimeMs; "
                         "-1: auto (max(50, max_iters//5) — few host syncs; "
                         "the 50-iteration floor keeps short runs to at most "
                         "a handful of chunks)")
args = parser.parse_args()

import jax  # noqa: E402

from lbfgs_ffnn.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from lbfgs_ffnn.data.datasets import load_fashion_mnist, load_mnist  # noqa: E402
from lbfgs_ffnn.launcher import Launcher, UnifiedConfig  # noqa: E402

train_size = args.train_size or (5000 if args.style == "cpu" else 60000)
loader = load_mnist if args.dataset == "mnist" else load_fashion_mnist
ds = loader(train_size=train_size, test_size=10000)
if ds.synthetic_images or ds.synthetic_labels:
    print("NOTE: no IDX files given; training on the seeded synthetic "
          "stream (published class counts, class-structured images).")

name = args.dataset.upper()
launcher = Launcher(backend_style=args.style)
if args.deep:
    launcher.add_layer(784, 256, "relu").add_layer(256, 128, "relu")
    launcher.add_layer(128, 64, "relu").add_layer(64, 10, "linear")
else:
    launcher.add_layer(784, 128, "relu").add_layer(128, 10, "linear")
launcher.build_network().set_data(ds)

two_loop = args.two_loop

if args.style == "cpu":
    runs = [
        ("gd", UnifiedConfig(name=f"{name}_Unified_GD", max_iters=args.iters,
                             tolerance=1e-4, learning_rate=0.01, momentum=0.9,
                             log_interval=1)),
        ("sgd", UnifiedConfig(name=f"{name}_SGD", max_iters=args.iters,
                              tolerance=1e-4, learning_rate=0.03, batch_size=256,
                              log_interval=5)),
        ("slbfgs", UnifiedConfig(name=f"{name}_SLBFGS", max_iters=args.iters,
                                 tolerance=1e-4, learning_rate=0.02, batch_size=256,
                                 m_param=10, L_param=10, b_H_param=128,
                                 log_interval=1, two_loop_impl=two_loop)),
        ("lbfgs", UnifiedConfig(name=f"{name}_LBFGS", max_iters=args.iters,
                                tolerance=1e-4, m_param=20, log_interval=1,
                                two_loop_impl=two_loop)),
    ]
else:
    runs = [
        ("gd", UnifiedConfig(name=f"{name}_GD", max_iters=args.iters,
                             tolerance=1e-3, learning_rate=0.02, momentum=0.9,
                             log_interval=1)),
        ("sgd", UnifiedConfig(name=f"{name}_SGD", max_iters=args.iters,
                              tolerance=1e-3, learning_rate=0.01, batch_size=256,
                              log_interval=5, lr_decay=0.80, lr_decay_rate=40)),
        ("lbfgs", UnifiedConfig(name=f"{name}_LBFGS_m10", max_iters=args.iters,
                                tolerance=1e-3, m_param=10, log_interval=1,
                                two_loop_impl=two_loop)),
        ("lbfgs", UnifiedConfig(name=f"{name}_LBFGS_m100", max_iters=args.iters,
                                tolerance=1e-3, m_param=100, log_interval=1,
                                two_loop_impl=two_loop)),
    ]

# Optional L-BFGS policy variants (flag, name suffix, UnifiedConfig kwargs).
# --bf16-all is literally the union of the four bf16 traffic levers.
_BF16_ALL = dict(pair_dtype="bfloat16", grad_input_dtype="bfloat16",
                 line_input_dtype="bfloat16", prefix_dtype="bfloat16")
for enabled, suffix, extra in [
    (args.bf16_ring, "bf16ring", dict(pair_dtype="bfloat16")),
    (args.bf16_grad_input, "bf16gradin", dict(grad_input_dtype="bfloat16")),
    (args.bf16_prefix, "bf16prefix", dict(prefix_dtype="bfloat16")),
    (args.bf16_line_input, "bf16lineinput",
     dict(line_input_dtype="bfloat16")),
    (args.bf16_all, "bf16all", _BF16_ALL),
    (args.u8_input, "u8input", dict(line_input_dtype="uint8",
                                    grad_input_dtype="uint8",
                                    fun_input_dtype="uint8")),
    (args.u8_all, "u8all", dict(line_input_dtype="uint8",
                                grad_input_dtype="uint8",
                                fun_input_dtype="uint8",
                                pair_dtype="bfloat16",
                                prefix_dtype="bfloat16")),
    (args.bf16_compute, "bf16compute", dict(compute_dtype="bfloat16")),
    (args.batched_ls, "batchedLS", dict(line_search="armijo_batched")),
    (args.warm_alpha, "warmalpha", dict(ls_alpha_init="warm")),
    (args.warm_alpha, "u8warm", dict(line_input_dtype="uint8",
                                     grad_input_dtype="uint8",
                                     fun_input_dtype="uint8",
                                     pair_dtype="bfloat16",
                                     prefix_dtype="bfloat16",
                                     ls_alpha_init="warm")),
]:
    if not enabled:
        continue
    for m in (10, 100):
        runs.append(("lbfgs", UnifiedConfig(
            name=f"{name}_LBFGS_m{m}_{suffix}", max_iters=args.iters,
            tolerance=1e-3 if args.style == "cuda" else 1e-4, m_param=m,
            log_interval=1, two_loop_impl=two_loop, **extra)))

# GD's iteration is one value_and_grad — fun_input_dtype IS its lever
# (the two x reads are essentially its whole per-iteration HBM traffic).
if args.u8_input or args.u8_all:
    runs.append(("gd", UnifiedConfig(
        name=f"{name}_GD_u8input", max_iters=args.iters, tolerance=1e-3,
        learning_rate=0.02, momentum=0.9, log_interval=1,
        fun_input_dtype="uint8")))
    if args.style == "cuda":
        # SGD's epoch is likewise input-read-bound: the 234 per-step batch
        # slices plus the per-epoch full-dataset record all read x, so the
        # u8 copy quarters the epoch's dominant HBM term (launcher passes
        # the quantized input straight to the solver; objectives/mlp.py).
        runs.append(("sgd", UnifiedConfig(
            name=f"{name}_SGD_u8input", max_iters=args.iters, tolerance=1e-3,
            learning_rate=0.01, batch_size=256, log_interval=5,
            lr_decay=0.80, lr_decay_rate=40, fun_input_dtype="uint8")))

if args.only:
    runs = [(s, c) for s, c in runs if args.only in c.name]
    if not runs:
        parser.error(f"--only {args.only!r} matches no configured run")

meta_runs = []
multiseed: dict[str, dict] = {}
for solver, cfg in runs:
    if args.record_accuracy and solver in ("sgd", "slbfgs"):
        cfg.record_accuracy = True
    if args.timed_chunks > 0:
        cfg.timed_chunks = args.timed_chunks
    elif args.timed_chunks == -1:
        # SGD epochs are ms-scale and the cuda-style run stops on relative
        # improvement after ~20 epochs, so every chunk-boundary sync would
        # be a visible share of the measured column. One whole-run chunk
        # pays exactly one: the bounded while_loop stops device-side at the
        # tol epoch and the single sync stamps the cumulative time (the
        # per-epoch MARGINAL cost is measured separately by
        # scripts/diag_stochastic_step.py's sgd_epoch slope).
        cfg.timed_chunks = cfg.max_iters if solver == "sgd" else max(50, cfg.max_iters // 5)
    seeds = [cfg.seed + k for k in range(max(args.seeds, 1))]
    per_seed = {"seeds": seeds, "ms_per_iter": [], "final_loss": [],
                "n_iters": [], "solver": solver}
    for k, s in enumerate(seeds):
        cfg.seed = s
        cfg.write_csv = (k == 0)  # the first seed is the artifact draw
        print(f"Running {cfg.name} ({solver}, seed={s})...")
        report = launcher.train(solver, cfg)
        launcher.test()
        n = max(int(report.result.n_iters), 1)
        if cfg.timed_chunks > 0:
            ms = float(report.history.time_ms[n - 1]) / n
        else:
            ms = report.wall_time_s * 1e3 / n
        per_seed["ms_per_iter"].append(round(ms, 4))
        per_seed["final_loss"].append(float(report.result.final_loss))
        per_seed["n_iters"].append(n)
    ms_sorted = sorted(per_seed["ms_per_iter"])
    per_seed["ms_per_iter_median"] = round(
        ms_sorted[len(ms_sorted) // 2] if len(ms_sorted) % 2
        else (ms_sorted[len(ms_sorted) // 2 - 1]
              + ms_sorted[len(ms_sorted) // 2]) / 2, 4)
    per_seed["ms_per_iter_min"] = ms_sorted[0]
    per_seed["ms_per_iter_max"] = ms_sorted[-1]
    # Record even single-seed runs when a summary exists: a --seeds 1
    # partial regen must OVERWRITE the stale multiseed row for the configs
    # it re-ran (leaving it would desynchronize the committed median
    # tables from the committed CSVs), degrading that row to a 1-draw
    # entry that honestly says seeds=[...].
    if len(seeds) > 1 or os.path.exists("multiseed_summary.json"):
        multiseed[cfg.name] = per_seed
    meta_runs.append({"name": cfg.name, "solver": solver,
                      "max_iters": cfg.max_iters,
                      "timed_chunks": cfg.timed_chunks,
                      "seeds": seeds})


def _write_multiseed():
    """Per-config multi-seed spread next to the history CSVs: the committed
    README tables quote median (min-max) ms/iter from here, not a single
    lottery draw. Merges across partial (--only) regenerations."""
    import json
    path = "multiseed_summary.json"
    merged = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                merged = json.load(f)
        except Exception:
            merged = {}
    merged.update(multiseed)
    with open(path, "w") as f:
        json.dump(merged, f, indent=2, sort_keys=True)
        f.write("\n")


if multiseed:
    _write_multiseed()


def _write_run_meta():
    """Provenance + TimeMs-semantics note next to the history CSVs.

    The CSV format itself mirrors the reference's
    (src/utils/recorder.hpp: Iteration,Loss,GradNorm,TimeMs columns) and
    cannot carry comments, so the measurement granularity lives here:
    with timed_chunks=K, TimeMs is the measured cumulative wall time at
    chunk boundaries — all K rows of a chunk share that boundary's
    timestamp (step-shaped, honest; never synthesized per-row)."""
    import json
    import subprocess
    import time as _time
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        commit = subprocess.run(
            ["git", "-C", repo, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10).stdout.strip() or None
    except Exception:
        commit = None
    dev = jax.devices()[0]
    meta = {
        "cmd": "python " + " ".join(sys.argv),
        "git_commit": commit,
        "date_utc": _time.strftime("%Y-%m-%d %H:%M:%S", _time.gmtime()),
        "backend": jax.default_backend(),
        "device": f"{dev.platform}:{getattr(dev, 'device_kind', '?')}",
        "two_loop_impl": two_loop,
        "train_size": train_size,
        "synthetic_images": bool(ds.synthetic_images),
        "synthetic_labels": bool(ds.synthetic_labels),
        "timems_semantics": (
            "Cumulative wall time MEASURED at chunk boundaries (pipelined "
            "chunk driver: next chunk dispatched before syncing the current "
            "one, so boundary round-trips overlap device compute); the "
            "timed_chunks rows within a chunk share one timestamp. "
            "timed_chunks=0 means TimeMs is the single whole-solve wall "
            "time on the last row."),
        "runs": meta_runs,
    }
    if args.only and os.path.exists("run_meta.json"):
        # Partial regeneration: merge into the existing provenance instead
        # of clobbering the full directory's run list.
        try:
            with open("run_meta.json") as f:
                old = json.load(f)
            merged = {r["name"]: r for r in old.get("runs", [])}
            merged.update({r["name"]: r for r in meta_runs})
            meta["runs"] = list(merged.values())
            meta["cmd"] = old.get("cmd", meta["cmd"]) + f" ;; {meta['cmd']}"
        except Exception:
            pass
    with open("run_meta.json", "w") as f:
        json.dump(meta, f, indent=2)
        f.write("\n")


_write_run_meta()
