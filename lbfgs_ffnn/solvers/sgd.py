"""Minibatch SGD — whole training run as one jitted program.

Behavioral union of the reference's two SGD implementations:
  * CPU ``StochasticGradientDescent``: epoch = ``m = N // b`` minibatches
    sampled *without replacement* (partial Fisher-Yates) with a fresh draw
    per step; plain steps; per-epoch full loss + full gradient recording
    (reference: src/minimizer/s_gd.hpp:63-137,146-170).
  * CUDA ``CudaSGD``: *sequential contiguous* batch slices, classical
    momentum, step-wise lr decay, relative-improvement stopping on the epoch
    loss (reference: src/cuda/sgd.cuh:50-153).

An epoch is a ``lax.scan`` over minibatch steps; batch sampling uses
``jax.random.fold_in`` per (epoch, step) so runs are seed-stable and
layout-independent. In sequential mode the trailing ragged batch runs as
one straight-line step at its true static shape after the scan over the
full batches (segmented epoch — no per-step masking, PERF.md).
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from lbfgs_ffnn.ops.sampling import sample_without_replacement
from lbfgs_ffnn.solvers.common import (
    cached_jit_solve, drive_chunks, finalize, init_history,
    init_metric_history, record,
)
from lbfgs_ffnn.types import BatchProblem, SolveResult


class SGDOptions(NamedTuple):
    epochs: int = 1000
    batch_size: int = 128
    step_size: float = 0.01
    momentum: float = 0.0
    sampling: str = "random"  # "random" (CPU-ref) | "sequential" (CUDA-ref)
    lr_decay: float = 1.0
    lr_decay_step: int = 0
    tol: float = 0.0  # >0 enables relative-improvement stopping (CUDA-ref)
    seed: int = 123
    record_full: bool = True  # per-epoch full-batch loss/gradnorm recording
    sampler: str = "topk"     # "random" sampling's without-replacement
                              # draw: "topk" | "sort" (see ops/sampling.py)
    scan_unroll: int = 1      # lax.scan unroll for the per-step epoch scan
                              # (same math/trajectory; trades program size
                              # for less scan loop machinery — measured in
                              # scripts/diag_stochastic_step.py sgd_epoch)
    metric_fn: object = None  # optional (w, x, y, *metric_args) -> scalar
                              # or (k,) vector of metrics, recorded per
                              # epoch (e.g. train accuracy; reference plot
                              # tooling shows TrainAcc columns when present).
                              # Extra data (e.g. the test split) arrives via
                              # the solver's metric_args operand, NOT as a
                              # closure constant baked into the executable.


class _State(NamedTuple):
    epoch: jax.Array
    w: jax.Array
    v: jax.Array
    lr: jax.Array
    prev_loss: jax.Array
    stop: jax.Array
    loss_h: jax.Array
    gnorm_h: jax.Array
    metric_h: jax.Array


def _init_state(opts: SGDOptions, w0, x, y, margs=()) -> _State:
    loss_h, gnorm_h = init_history(opts.epochs, w0.dtype)
    return _State(
        epoch=jnp.int32(0),
        w=w0,
        v=jnp.zeros_like(w0),
        lr=jnp.asarray(opts.step_size, dtype=w0.dtype),
        prev_loss=jnp.asarray(jnp.inf, dtype=w0.dtype),
        stop=jnp.array(False),
        loss_h=loss_h,
        gnorm_h=gnorm_h,
        metric_h=init_metric_history(opts.metric_fn, opts.epochs, w0, x, y, *margs),
    )


def _not_done(s: _State, opts: SGDOptions):
    return (s.epoch < opts.epochs) & ~s.stop


def _make_parts(problem: BatchProblem, opts: SGDOptions, N: int):
    b = min(opts.batch_size, N)
    if opts.sampling == "random":
        m = max(N // b, 1)
    elif opts.sampling == "sequential":
        m = -(-N // b)  # ceil
    else:
        raise ValueError(f"unknown sampling {opts.sampling!r}")

    def make_body(x, y, margs=()):
        key = jax.random.PRNGKey(opts.seed)
        # Sequential mode: the epoch is m_full full contiguous batches plus
        # (at most) one ragged tail. Splitting the tail OUT of the scan —
        # the segmented-epoch medicine proven on S-LBFGS (PERF.md
        # round 4) — lets every scanned step slice x directly and evaluate
        # UNMASKED (no per-step (b, d) zero_masked_rows copy, no mask
        # generation), and the tail runs once in straight-line code at its
        # TRUE static shape, so neither a mask nor a padded x/y copy exists
        # anywhere. Same math as the old all-masked scan: a full batch's
        # masked loss was sum(ls)/sum(mask) over the same b rows that
        # `fun` averages, and the tail's was the mean over its rem rows
        # (f64 mirror parity pinned in tests/test_solver_parity_mlp.py).
        m_full = N // b if opts.sampling == "sequential" else 0
        rem = N - m_full * b if opts.sampling == "sequential" else 0

        def update(w, v, lr, g):
            if opts.momentum > 0.0:
                v = opts.momentum * v - lr * g
                return w + v, v
            return w - lr * g, v

        def body(s: _State) -> _State:
            # Step-wise lr decay before the epoch (reference: src/cuda/sgd.cuh:97-99).
            lr = s.lr
            if opts.lr_decay_step > 0:
                do_decay = (s.epoch > 0) & (s.epoch % opts.lr_decay_step == 0)
                lr = jnp.where(do_decay, lr * opts.lr_decay, lr)

            def minibatch_random(carry, t_and_idx):
                w, v = carry
                _, idx = t_and_idx
                xb, yb = jnp.take(x, idx, axis=0), jnp.take(y, idx, axis=0)
                # value_and_grad, not grad: the forward already computes the
                # batch loss, and the epoch loss must be real — a zero here
                # made record_full=False histories all-zero and tripped the
                # relative-improvement stop at epoch 2 (|0-0| < tol).
                loss, g = problem.value_and_grad(w, xb, yb)
                w, v = update(w, v, lr, g)
                return (w, v), loss * b

            def minibatch_sequential(carry, t):
                # Full batches only (the ragged tail runs straight-line
                # below): a contiguous dynamic_slice that fuses into the
                # batch GEMM's input read, evaluated UNMASKED.
                w, v = carry
                xb = lax.dynamic_slice_in_dim(x, t * b, b, axis=0)
                yb = lax.dynamic_slice_in_dim(y, t * b, b, axis=0)
                loss, g = problem.value_and_grad(w, xb, yb)
                w, v = update(w, v, lr, g)
                return (w, v), loss * b

            ts = jnp.arange(m)
            if opts.sampling == "random":
                # Draw the whole epoch's batches up front: one vmapped
                # without-replacement selection over the per-step keys
                # instead of a top-k inside every scan step (the same
                # optimization as S-LBFGS's epoch_batch_idx; compare the
                # two with scripts/diag_stochastic_step.py). Keys are
                # derived exactly as the per-step path derived them, so the
                # index stream (and the trajectory) is bit-identical.
                keys = jax.vmap(
                    lambda t: jax.random.fold_in(key, s.epoch * m + t)
                )(ts)
                idx_all = jax.vmap(
                    lambda k: sample_without_replacement(k, N, b, opts.sampler)
                )(keys)
                (w, v), losses = lax.scan(
                    minibatch_random, (s.w, s.v), (ts, idx_all),
                    unroll=opts.scan_unroll,
                )
                # Batch-weighted mean over the m*b samples actually visited
                # this epoch (random mode draws m = N//b full batches, so the
                # ragged tail is never touched; reference CPU SGD likewise,
                # src/minimizer/s_gd.hpp:95-106).
                epoch_loss = jnp.sum(losses) / (m * b)
            else:
                (w, v), losses = lax.scan(
                    minibatch_sequential, (s.w, s.v), jnp.arange(m_full),
                    unroll=opts.scan_unroll,
                )
                wsum = jnp.sum(losses)
                if rem:
                    # The ragged tail, once, at its TRUE static shape —
                    # no mask, no padded copy (rem is compile-time).
                    loss, g = problem.value_and_grad(w, x[m_full * b:],
                                                     y[m_full * b:])
                    w, v = update(w, v, lr, g)
                    wsum = wsum + loss * rem
                epoch_loss = wsum / N  # batch-weighted mean (CUDA-ref)

            # Recorder: full-dataset loss + gradient norm per epoch
            # (reference: src/minimizer/s_gd.hpp:108-131, src/cuda/sgd.cuh:134-145).
            if opts.record_full:
                full_loss, full_g = problem.value_and_grad(w, x, y)
                gnorm = jnp.linalg.norm(full_g)
            else:
                full_loss, gnorm = epoch_loss, jnp.asarray(jnp.nan, dtype=w.dtype)
            loss_h, gnorm_h = record(s.loss_h, s.gnorm_h, s.epoch, full_loss, gnorm)
            metric_h = s.metric_h
            if opts.metric_fn is not None:
                metric_h = metric_h.at[s.epoch].set(opts.metric_fn(w, x, y, *margs))

            # Relative-improvement stopping (reference: src/cuda/sgd.cuh:126-131).
            stop = s.stop
            if opts.tol > 0.0:
                denom = jnp.maximum(jnp.ones_like(epoch_loss), jnp.abs(s.prev_loss))
                rel = jnp.abs(s.prev_loss - epoch_loss) / denom
                stop = jnp.isfinite(s.prev_loss) & (rel < opts.tol)

            return _State(
                epoch=s.epoch + 1, w=w, v=v, lr=lr, prev_loss=epoch_loss,
                stop=stop, loss_h=loss_h, gnorm_h=gnorm_h, metric_h=metric_h,
            )

        return body

    return make_body


def _finalize_state(s: _State, opts: SGDOptions) -> SolveResult:
    last = jnp.maximum(s.epoch - 1, 0)
    return finalize(
        s.w, s.epoch, s.stop, s.loss_h[last], s.gnorm_h[last],
        s.loss_h, s.gnorm_h,
        s.metric_h if opts.metric_fn is not None else None,
    )


def _build(problem: BatchProblem, opts: SGDOptions, N: int):
    make_body = _make_parts(problem, opts, N)

    def solve(w0, x, y, margs=()):
        body = make_body(x, y, margs)
        s = lax.while_loop(
            lambda s: _not_done(s, opts), body, _init_state(opts, w0, x, y, margs)
        )
        return _finalize_state(s, opts)

    return solve


@functools.lru_cache(maxsize=256)
def _cached_chunk_fns(problem, opts, N, chunk: int):
    make_body = _make_parts(problem, opts, N)

    def init(w0, x, y, margs=()):
        return _init_state(opts, w0, x, y, margs)

    def run_chunk(state, x, y, margs=()):
        # Bounded while_loop, not scan+cond (the cond identity branch
        # copies the whole carry per epoch — see lbfgs._cached_chunk_fns).
        body = make_body(x, y, margs)
        e_end = state.epoch + chunk
        return lax.while_loop(
            lambda s: _not_done(s, opts) & (s.epoch < e_end), body, state
        )

    return jax.jit(init), jax.jit(run_chunk)


def sgd_chunked(
    problem: BatchProblem,
    w0,
    x,
    y,
    opts: SGDOptions | None = None,
    chunk: int = 10,
    callback=None,
    resume_state: _State | None = None,
    metric_args: tuple = (),
) -> tuple[SolveResult, jax.Array]:
    """Run SGD in jitted ``chunk``-epoch pieces with *measured* cumulative
    per-epoch wall time (same protocol as ``slbfgs_chunked``) — the honest
    counterpart of the reference's per-epoch cudaEvent/chrono timing
    (reference: src/cuda/sgd.cuh:79-86, src/minimizer/s_gd.hpp:95-131).
    ``resume_state`` continues from a checkpointed chunk state (momentum,
    decayed lr, stopping state included); ``w0`` may be None then."""
    opts = opts or SGDOptions()
    if resume_state is None and w0 is None:
        raise ValueError("w0 is required unless resume_state is given")
    init, run_chunk = _cached_chunk_fns(problem, opts, int(x.shape[0]), chunk)
    state = (resume_state if resume_state is not None
             else init(w0, x, y, metric_args))
    state, time_ms = drive_chunks(
        run_chunk, state, (x, y, metric_args), opts.epochs,
        counter=lambda s: int(s.epoch),
        done=lambda s: bool(s.stop),
        sync=lambda s: s.prev_loss,
        callback=callback,
    )
    return _finalize_state(state, opts), time_ms


def sgd(
    problem: BatchProblem,
    w0: jax.Array,
    x: jax.Array,
    y: jax.Array,
    opts: SGDOptions | None = None,
    metric_args: tuple = (),
) -> SolveResult:
    opts = opts or SGDOptions()
    return cached_jit_solve_sgd(problem, opts, int(x.shape[0]))(
        w0, x, y, tuple(metric_args)
    )


import functools  # noqa: E402


@functools.lru_cache(maxsize=256)
def cached_jit_solve_sgd(problem, opts, N):
    return jax.jit(_build(problem, opts, N))


# ---------------------------------------------------------------------------
# Streaming driver: host-fed minibatches from the native prefetch pipeline
# ---------------------------------------------------------------------------


def sgd_streaming(
    problem: BatchProblem,
    w0: jax.Array,
    streamer,
    opts: SGDOptions | None = None,
    steps_per_epoch: int | None = None,
    full_eval_fn=None,
) -> SolveResult:
    """Minibatch SGD fed by a :class:`runtime.streamer.BatchStreamer`.

    The device-resident ``sgd`` above keeps the whole dataset in HBM and
    compiles the full run into one program — the fastest path and the
    reference-parity one. This driver instead pulls host-staged batches from
    the native prefetch thread (shuffle + gather overlap the previous step's
    device work) and runs one jitted update per batch: the configuration for
    datasets that should not (or cannot) live in HBM whole.

    Stops after ``opts.epochs`` epochs of the stream. By default the loss
    history records the per-batch loss at each epoch's final step and the
    gradient-norm history stays NaN — the data may not fit on device. Pass
    ``full_eval_fn(w) -> (loss, gnorm)`` to record a *full-dataset* loss and
    gradient norm at every epoch boundary instead, matching the reference's
    per-epoch recorder (reference: src/minimizer/s_gd.hpp:108-131) — e.g.
    built from ``data.outofcore.outofcore_problem`` so the evaluation
    streams the same host-resident dataset in chunks::

        prob = outofcore_problem(bp, store)
        def full_eval(w):
            f, g = prob.value_and_grad(w, ())
            return f, jnp.linalg.norm(g)

    which makes the streaming path emit a reference-comparable history CSV.
    """
    opts = opts or SGDOptions()

    @jax.jit
    def step(w, v, lr, xb, yb, mask):
        loss, g = jax.value_and_grad(problem.fun_masked)(w, xb, yb, mask)
        v_new = opts.momentum * v - lr * g
        return w + v_new, v_new, loss

    w = jnp.asarray(w0)
    if opts.epochs <= 0:
        zero_h = jnp.zeros((0,), dtype=w.dtype)
        return SolveResult(
            x=w, n_iters=jnp.int32(0), converged=jnp.array(False),
            final_loss=jnp.asarray(jnp.nan, dtype=w.dtype),
            final_gnorm=jnp.asarray(jnp.nan, dtype=w.dtype),
            loss_history=zero_h, gnorm_history=zero_h,
        )
    v = jnp.zeros_like(w)
    lr = jnp.asarray(opts.step_size, dtype=w.dtype)
    b = streamer.batch_size
    loss_h = jnp.full((opts.epochs,), jnp.nan, dtype=w.dtype)
    gnorm_h = jnp.full((opts.epochs,), jnp.nan, dtype=w.dtype)
    last_loss = jnp.asarray(jnp.nan, dtype=w.dtype)
    cur_epoch = 0
    last_trained = None  # (xb, yb, mask) of the last step taken
    while True:
        xb, yb, count, epoch = streamer.next()
        if epoch != cur_epoch:
            # The streamer labels every batch with its source epoch — the
            # authoritative boundary for both drop_last modes.
            if full_eval_fn is not None:
                ef, eg = full_eval_fn(w)
                loss_h = loss_h.at[cur_epoch].set(ef)
                gnorm_h = gnorm_h.at[cur_epoch].set(eg)
                last_loss = jnp.asarray(ef, dtype=w.dtype)
            else:
                loss_h = loss_h.at[cur_epoch].set(last_loss)
            cur_epoch = epoch
            if opts.lr_decay_step > 0 and epoch % opts.lr_decay_step == 0:
                lr = lr * opts.lr_decay
            if epoch >= opts.epochs:
                break
        mask = (jnp.arange(b) < count).astype(w.dtype)
        xb_j, yb_j = jnp.asarray(xb), jnp.asarray(yb)
        w, v, last_loss = step(w, v, lr, xb_j, yb_j, mask)
        last_trained = (xb_j, yb_j, mask)
    if full_eval_fn is not None:
        gnorm = gnorm_h[opts.epochs - 1]
    else:
        xb_j, yb_j, mask = last_trained
        gnorm = jnp.linalg.norm(problem.grad_masked(w, xb_j, yb_j, mask))
    return SolveResult(
        x=w, n_iters=jnp.int32(opts.epochs), converged=jnp.array(False),
        final_loss=last_loss, final_gnorm=gnorm,
        loss_history=loss_h, gnorm_history=gnorm_h,
    )
