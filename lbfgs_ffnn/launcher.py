"""Unified training API: config + launcher.

Parity layer over the solvers, mirroring the reference's UnifiedConfig /
UnifiedLauncher / UnifiedOptimizer strategy surface
(reference: src/unified_optimization.hpp:26-48, src/unified_launcher.hpp):
``add_layer -> build_network -> set_data -> train(solver, config) -> test()``.

Backend styles select solver flavor the way the reference's Backend template
tag does (reference: src/network_wrapper.hpp:20-22):
  * ``"cpu"``  — Wolfe line search for L-BFGS, random minibatch sampling for
    SGD, random biases at init, no momentum in SGD.
  * ``"cuda"`` — Armijo+interpolation line search, sequential batch slices,
    momentum/decay in SGD, zero biases at init.
Either style runs on any JAX device; they only change algorithmic policy.

Timing: the solve is AOT-compiled first (``jit(...).lower().compile()``
equivalent via a warm-up call) so reported wall time excludes compilation —
the analogue of the reference timing compute, not CUDA context setup.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from lbfgs_ffnn.data.datasets import Dataset
from lbfgs_ffnn.objectives.mlp import (
    MLPSpec,
    evaluate,
    mlp_apply,
    mlp_batch_problem,
    mlp_init,
    mlp_problem,
    mlp_spec,
)
from lbfgs_ffnn.recorder import History, history_from_result, write_history_csv
from lbfgs_ffnn.solvers import (
    GDOptions,
    LBFGSOptions,
    SGDOptions,
    SLBFGSOptions,
    gradient_descent,
    lbfgs,
    sgd,
    slbfgs,
)
from lbfgs_ffnn.types import SolveResult


@dataclasses.dataclass
class UnifiedConfig:
    """Field-for-field mirror of the reference's UnifiedConfig
    (reference: src/unified_optimization.hpp:26-48)."""

    name: str = "Experiment"
    max_iters: int = 100
    tolerance: float = 1e-4
    learning_rate: float = 0.01
    momentum: float = 0.0
    lr_decay: float = 0.0
    lr_decay_rate: int = 1
    batch_size: int = 128
    m_param: int = 10
    L_param: int = 10
    b_H_param: int = 0
    log_interval: int = 10
    reset_params: bool = True
    seed: int = 123
    # Extensions beyond the reference
    lam: float = 0.0             # L2 used by the S-LBFGS strategy (ref: 1e-4)
    two_loop_impl: str = "xla"   # "xla" (loop form) | "compact"
    write_csv: bool = True
    timed_chunks: int = 0        # >0: L-BFGS runs in K-iter chunks with
                                 # measured cumulative TimeMs per chunk
    record_accuracy: bool = False  # per-epoch TrainAcc column (sgd/slbfgs)
    line_search: str = ""        # L-BFGS override: "" = backend style
                                 # (cpu->wolfe, cuda->armijo);
                                 # "armijo_batched" = spec_k-candidate
                                 # speculative ladder (no reference
                                 # counterpart)
    ls_spec_k: int = 8           # candidates per batched forward
    pair_dtype: Optional[str] = None  # L-BFGS/S-LBFGS curvature-ring
                                 # storage dtype override
                                 # ("bfloat16" halves the curvature ring's
                                 # HBM footprint + two-loop streaming
                                 # traffic; recursion arithmetic stays f32)
    compute_dtype: Optional[str] = None  # objective matmul operand dtype
                                 # ("bfloat16" feeds the matmuls bf16 operands
                                 # with f32 accumulation — ~2x matmul
                                 # throughput; params/activations/loss stay
                                 # f32. See objectives/mlp.py::mlp_apply)
    prefix_dtype: Optional[str] = None  # L-BFGS carried line-prefix storage
                                 # dtype ("bfloat16" halves the per-trial
                                 # (A, B) reads, B's write, and the accept
                                 # A += alpha*B axpy; arithmetic stays f32
                                 # and the prefix is re-anchored exactly
                                 # every 16 iterations — see
                                 # solvers.lbfgs.LBFGSOptions.prefix_dtype)
    grad_input_dtype: Optional[str] = None  # accept-point dW1 input-read
                                 # dtype ("bfloat16": one persistent narrow
                                 # copy of x feeds the backward's x^T dz1
                                 # GEMM — half the dominant HBM read per
                                 # L-BFGS iteration; forward/loss/trials
                                 # stay exactly f32. objectives/mlp.py)
    line_input_dtype: Optional[str] = None  # line-restriction GEMM input-
                                 # read dtype ("bfloat16": the same narrow
                                 # copy feeds B = x@W1_p each iteration +
                                 # A init/refresh — halves B's dominant
                                 # (batch, in_dim) read at the cost of one
                                 # bf16 rounding of x. mlp.py)
    fun_input_dtype: Optional[str] = None  # full-objective first-layer
                                 # input-read dtype — the narrow copy feeds
                                 # the forward z1 = x@W1 and its backward
                                 # dW1 = x^T dz1 (the whole per-iteration
                                 # cost of GD at benchmark shapes). All
                                 # *_input_dtype values must match; "uint8"
                                 # = pixel quantization (mlp.py)
    ls_alpha_init: str = "fixed"  # L-BFGS line-search initial step policy:
                                 # "fixed" = alpha0=1 every iteration (the
                                 # reference policy); "warm" = resume at
                                 # min(1, ls_alpha_growth * previous step)
                                 # — cuts plateau backtracking from ~13 to
                                 # ~3 trials/iter (no reference counterpart, see
                                 # solvers.lbfgs.LBFGSOptions.ls_alpha_init)
    ls_alpha_growth: float = 8.0  # "warm": per-iteration growth toward 1


@dataclasses.dataclass
class TrainReport:
    result: SolveResult
    history: History
    wall_time_s: float
    csv_path: Optional[str]
    train_eval: dict

    @property
    def ms_per_iter(self) -> float:
        n = max(int(self.result.n_iters), 1)
        return self.wall_time_s * 1e3 / n


class Launcher:
    """MLP training launcher (reference: src/unified_launcher.hpp)."""

    def __init__(self, backend_style: str = "cpu", dtype=jnp.float32):
        if backend_style not in ("cpu", "cuda"):
            raise ValueError(backend_style)
        self.backend_style = backend_style
        self.dtype = dtype
        self._dims: list[int] = []
        self._acts: list[str] = []
        self.spec: Optional[MLPSpec] = None
        self.weights: Optional[jax.Array] = None
        self.dataset: Optional[Dataset] = None
        self._x = self._y = self._tx = self._ty = None

    # -- network assembly ---------------------------------------------------
    def add_layer(self, d_in: int, d_out: int, activation: str) -> "Launcher":
        if not self._dims:
            self._dims = [d_in]
        elif self._dims[-1] != d_in:
            raise ValueError(f"layer input {d_in} != previous output {self._dims[-1]}")
        self._dims.append(d_out)
        self._acts.append(activation)
        return self

    def build_network(self, seed: int = 123) -> "Launcher":
        self.spec = mlp_spec(self._dims, self._acts)
        self._prob_cache = {}
        self._bind_params(seed)
        return self

    def _get_problem(self, compute_dtype: Optional[str] = None,
                     grad_input_dtype: Optional[str] = None,
                     line_input_dtype: Optional[str] = None,
                     fun_input_dtype: Optional[str] = None):
        # One Problem object per launcher per compute policy: solver jit
        # caches key on it, so warm-up and timed runs share the executable.
        key = ("full", compute_dtype, grad_input_dtype, line_input_dtype,
               fun_input_dtype)
        if key not in self._prob_cache:
            self._prob_cache[key] = mlp_problem(
                self.spec, compute_dtype=compute_dtype,
                grad_input_dtype=grad_input_dtype,
                line_input_dtype=line_input_dtype,
                fun_input_dtype=fun_input_dtype,
            )
        return self._prob_cache[key]

    def _get_batch_problem(self, lam: float, compute_dtype: Optional[str] = None):
        # One problem per (lam, compute policy): the u8 input path needs no
        # problem-side switch (mlp_apply adapts to the batch dtype, and the
        # u8 operands give a distinct jit cache entry by aval anyway).
        key = ("batch", lam, compute_dtype)
        if key not in self._prob_cache:
            self._prob_cache[key] = mlp_batch_problem(
                self.spec, lam=lam, compute_dtype=compute_dtype
            )
        return self._prob_cache[key]

    def _stochastic_x(self, c: UnifiedConfig):
        """Training input as the stochastic solvers should read it:
        ``fun_input_dtype="uint8"`` hands them the pixel-quantized copy
        (quarter the per-step batch read AND the per-epoch full-dataset
        recording read; exact for k/255 pixel data — objectives/mlp.py).
        Cached so the chunked drivers' repeat calls reuse one device copy."""
        if c.fun_input_dtype is None:
            return self._x
        if jnp.dtype(c.fun_input_dtype) != jnp.dtype(jnp.uint8):
            raise ValueError(
                f"stochastic solvers support fun_input_dtype=None or 'uint8',"
                f" got {c.fun_input_dtype!r}")
        if "xq" not in self._prob_cache:
            from lbfgs_ffnn.objectives.mlp import quantize_pixels
            self._prob_cache["xq"] = quantize_pixels(self._x)
        return self._prob_cache["xq"]

    def _bind_params(self, seed: int) -> None:
        bias = "random" if self.backend_style == "cpu" else "zeros"
        self.weights = mlp_init(
            self.spec, jax.random.PRNGKey(seed), dtype=self.dtype, bias_init=bias
        )

    def set_data(self, dataset: Dataset) -> "Launcher":
        self.dataset = dataset
        self._x = jnp.asarray(dataset.train_x, dtype=self.dtype)
        self._y = jnp.asarray(dataset.train_y, dtype=self.dtype)
        self._tx = jnp.asarray(dataset.test_x, dtype=self.dtype)
        self._ty = jnp.asarray(dataset.test_y, dtype=self.dtype)
        # The accuracy metric's *shape* (1 vs 2 columns) depends on whether
        # a test split exists; the data itself is a traced operand now, but
        # the cached fn must still not survive a swap that changes that.
        if hasattr(self, "_prob_cache"):
            self._prob_cache.pop("acc", None)
            self._prob_cache.pop("xq", None)
        return self

    # -- training -----------------------------------------------------------
    def train(self, solver: str, config: UnifiedConfig, verbose: bool = True) -> TrainReport:
        if self.spec is None or self._x is None:
            raise RuntimeError("build_network() and set_data() first")
        if config.reset_params:
            # (reference: src/unified_launcher.hpp:49-53)
            self._bind_params(config.seed)

        measured_ms = None
        if config.timed_chunks > 0:
            # Chunked drivers for EVERY solver: jitted K-iteration (or
            # K-epoch) pieces with measured cumulative wall time, so no
            # committed TimeMs column is ever synthesized.
            from lbfgs_ffnn.solvers.gd import gd_chunked
            from lbfgs_ffnn.solvers.lbfgs import lbfgs_chunked
            from lbfgs_ffnn.solvers.sgd import sgd_chunked
            from lbfgs_ffnn.solvers.slbfgs import slbfgs_chunked

            K = config.timed_chunks
            N = int(self._x.shape[0])
            t0 = time.perf_counter()
            if solver == "lbfgs":
                result, time_ms = lbfgs_chunked(
                    self._get_problem(config.compute_dtype,
                                      config.grad_input_dtype,
                                      config.line_input_dtype,
                                      config.fun_input_dtype), self.weights,
                    aux=(self._x, self._y), opts=self._lbfgs_opts(config),
                    chunk=K,
                )
            elif solver == "slbfgs":
                result, time_ms = slbfgs_chunked(
                    self._get_batch_problem(config.lam if config.lam > 0 else 1e-4,
                                            config.compute_dtype),
                    self.weights, self._x, self._y,
                    self._slbfgs_opts(config, N), chunk=K,
                    metric_args=self._metric_args(config),
                )
            elif solver == "sgd":
                result, time_ms = sgd_chunked(
                    self._get_batch_problem(0.0, config.compute_dtype),
                    self.weights,
                    self._stochastic_x(config), self._y,
                    self._sgd_opts(config), chunk=K,
                    metric_args=self._metric_args(config),
                )
            elif solver == "gd":
                result, time_ms = gd_chunked(
                    self._get_problem(config.compute_dtype,
                                      config.grad_input_dtype,
                                      config.line_input_dtype,
                                      config.fun_input_dtype), self.weights,
                    aux=(self._x, self._y), opts=self._gd_opts(config),
                    chunk=K,
                )
            else:
                raise ValueError(f"unknown solver {solver!r}")
            wall = time.perf_counter() - t0
            measured_ms = time_ms
        else:
            # Warm-up with *perturbed* weights compiles the executable; the
            # timed call then measures execution only.
            true_w = self.weights
            self.weights = true_w * (1.0 + 1e-6) + 1e-7
            warm = self._make_run(solver, config)()
            _ = float(warm.final_loss)
            self.weights = true_w
            run = self._make_run(solver, config)
            t0 = time.perf_counter()
            result = run()
            _ = float(result.final_loss)  # waits for the device
            wall = time.perf_counter() - t0

        self.weights = result.x
        history = history_from_result(result, wall)
        if measured_ms is not None:
            n = int(result.n_iters)
            history.time_ms[:] = np.asarray(measured_ms[:n], dtype=np.float64)
        csv_path = None
        if config.write_csv:
            csv_path = f"{config.name}_history.csv"
            extra = None
            if result.metric_history is not None:
                n = int(result.n_iters)
                mh = np.asarray(result.metric_history[:n])
                if mh.ndim == 2:  # [TrainAcc, TestAcc] columns
                    extra = {"TrainAcc": mh[:, 0], "TestAcc": mh[:, 1]}
                else:
                    extra = {"TrainAcc": mh}
            write_history_csv(csv_path, history, config.log_interval, extra)

        train_eval = evaluate(self.spec, self.weights, self._x, self._y)
        if verbose:
            n_it = max(int(result.n_iters), 1)
            if measured_ms is not None:
                # Wall includes the warm-up compile; the measured column is
                # the honest per-iteration cost — print that one.
                t_s = float(history.time_ms[n_it - 1]) / 1e3
                t_note = f"measured={t_s:.3f}s ({t_s * 1e3 / n_it:.3f} ms/iter)"
            else:
                t_note = f"time={wall:.3f}s ({wall * 1e3 / n_it:.3f} ms/iter)"
            print(
                f"[{config.name}] {solver}: iters={int(result.n_iters)} "
                f"loss={float(result.final_loss):.6g} "
                f"gnorm={float(result.final_gnorm):.4g} "
                f"{t_note} "
                f"train_acc={train_eval['accuracy']:.2f}%"
            )
        return TrainReport(result, history, wall, csv_path, train_eval)

    def _accuracy_metric(self):
        """Per-epoch accuracy metric: [TrainAcc, TestAcc] when a held-out
        split exists (the reference plot tooling's optional panels,
        reference: scripts/plot_results.py:107-127), else TrainAcc alone.
        Returns ``(metric_fn, metric_args)``: the test split rides into the
        jitted solve as the ``metric_args`` traced operands — like the train
        split — so it is never baked into the executable (or the per-
        (problem, opts) jit cache entries) as a multi-MB constant."""
        if "acc" not in self._prob_cache:
            spec = self.spec

            def acc1(w, x, y):
                pred = jnp.argmax(mlp_apply(spec, w, x), axis=1)
                return jnp.mean((pred == jnp.argmax(y, axis=1)).astype(w.dtype)) * 100.0

            if self._tx is not None and int(self._tx.shape[0]) > 0:
                def acc(w, x, y, tx, ty):
                    return jnp.stack([acc1(w, x, y), acc1(w, tx, ty)])
            else:
                acc = acc1
            self._prob_cache["acc"] = acc
        fn = self._prob_cache["acc"]
        margs = ()
        if self._tx is not None and int(self._tx.shape[0]) > 0:
            margs = (self._tx, self._ty)
        return fn, margs

    def _lbfgs_opts(self, c: UnifiedConfig) -> LBFGSOptions:
        cuda = self.backend_style == "cuda"
        ls = c.line_search or ("armijo" if cuda else "wolfe")
        # Trial budget follows the selected policy, not the backend style:
        # wolfe = 50 (reference CPU, full_batch_minimizer.hpp), armijo = 20
        # (reference CUDA, minimizer_base.cuh), batched ladder = 24 (3 rounds
        # of 8).
        budgets = {"wolfe": 50, "armijo": 20, "armijo_batched": 24}
        if ls not in budgets:
            raise ValueError(
                f"unknown line_search {ls!r}; expected one of {sorted(budgets)}"
            )
        ls_max = budgets[ls]
        return LBFGSOptions(
            max_iters=c.max_iters, tol=c.tolerance,
            m=c.m_param if c.m_param > 0 else 10,
            line_search=ls,
            ls_max_iters=ls_max,
            ls_spec_k=c.ls_spec_k,
            two_loop_impl=c.two_loop_impl,
            pair_dtype=c.pair_dtype,
            prefix_dtype=c.prefix_dtype,
            ls_alpha_init=c.ls_alpha_init,
            ls_alpha_growth=c.ls_alpha_growth,
        )

    def _gd_opts(self, c: UnifiedConfig) -> GDOptions:
        # UnifiedGD_CPU disables line search (unified_optimization.hpp:177);
        # CudaGD adds momentum (cuda/gd.cuh:78-88).
        return GDOptions(
            max_iters=c.max_iters, tol=c.tolerance, step_size=c.learning_rate,
            momentum=c.momentum, use_line_search=False,
        )

    def _sgd_opts(self, c: UnifiedConfig) -> SGDOptions:
        cuda = self.backend_style == "cuda"
        return SGDOptions(
            metric_fn=self._accuracy_metric()[0] if c.record_accuracy else None,
            epochs=c.max_iters, batch_size=c.batch_size,
            step_size=c.learning_rate,
            momentum=c.momentum if cuda else 0.0,
            sampling="sequential" if cuda else "random",
            lr_decay=c.lr_decay if c.lr_decay > 0 else 1.0,
            lr_decay_step=c.lr_decay_rate if c.lr_decay > 0 else 0,
            tol=c.tolerance if cuda else 0.0,
            seed=c.seed,
        )

    def _slbfgs_opts(self, c: UnifiedConfig, N: int) -> SLBFGSOptions:
        # Reference strategy defaults: lambda=1e-4 L2, b_H = batch/2,
        # m_inner = N/batch (unified_optimization.hpp:314-405).
        if c.fun_input_dtype is not None:
            # Not wired for S-LBFGS (the HVP path through quantized batches
            # is untested) — reject rather than silently run full-f32 while
            # the config claims a narrow read.
            raise ValueError(
                "fun_input_dtype is not supported for slbfgs (only sgd/gd/"
                f"lbfgs); got {c.fun_input_dtype!r}")
        return SLBFGSOptions(
            metric_fn=self._accuracy_metric()[0] if c.record_accuracy else None,
            epochs=c.max_iters, tol=c.tolerance,
            m_inner=max(N // c.batch_size, 1),
            history=c.m_param, L=c.L_param, batch_size=c.batch_size,
            hvp_batch_size=c.b_H_param if c.b_H_param > 0 else c.batch_size // 2,
            step_size=c.learning_rate, seed=c.seed,
            two_loop_impl=c.two_loop_impl,
            pair_dtype=c.pair_dtype,
        )

    def _metric_args(self, c: UnifiedConfig) -> tuple:
        """Traced operands for the accuracy metric (the held-out split),
        empty when accuracy recording is off."""
        if not c.record_accuracy:
            return ()
        return self._accuracy_metric()[1]

    def _make_run(self, solver: str, c: UnifiedConfig):
        cuda = self.backend_style == "cuda"
        x, y, w0 = self._x, self._y, self.weights
        N = int(x.shape[0])

        if solver == "gd":
            prob = self._get_problem(c.compute_dtype, c.grad_input_dtype,
                                     c.line_input_dtype,
                                     c.fun_input_dtype)
            opts = self._gd_opts(c)
            return lambda: gradient_descent(prob, w0, aux=(x, y), opts=opts)

        if solver == "lbfgs":
            prob = self._get_problem(c.compute_dtype, c.grad_input_dtype,
                                     c.line_input_dtype,
                                     c.fun_input_dtype)
            opts = self._lbfgs_opts(c)
            return lambda: lbfgs(prob, w0, aux=(x, y), opts=opts)

        if solver == "sgd":
            bp = self._get_batch_problem(0.0, c.compute_dtype)
            opts = self._sgd_opts(c)
            margs = self._metric_args(c)
            xs = self._stochastic_x(c)
            return lambda: sgd(bp, w0, xs, y, opts, metric_args=margs)

        if solver == "slbfgs":
            lam = c.lam if c.lam > 0 else 1e-4
            bp = self._get_batch_problem(lam, c.compute_dtype)
            opts = self._slbfgs_opts(c, N)
            margs = self._metric_args(c)
            return lambda: slbfgs(bp, w0, x, y, opts, metric_args=margs)

        raise ValueError(f"unknown solver {solver!r}")

    # -- evaluation ----------------------------------------------------------
    def test(self, verbose: bool = True) -> dict:
        """Evaluate on the held-out split (reference: Network::test /
        UnifiedLauncher::evaluate)."""
        out = evaluate(self.spec, self.weights, self._tx, self._ty)
        if verbose:
            print(
                f"=== Test Results ===\nSamples: {out['n']}\n"
                f"Accuracy: {out['accuracy']:.4g}% ({out['correct']}/{out['n']})\n"
                f"Total MSE: {out['total_mse']:.6g}\n===================="
            )
        return out
