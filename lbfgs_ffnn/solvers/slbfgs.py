"""Stochastic L-BFGS (Moritz et al. 2016) — SVRG variance-reduced gradients
with decoupled stable curvature pairs from Hessian-vector products.

Behavioral mirror of the reference CPU flagship
(reference: src/minimizer/s_lbfgs.hpp:166-290):

  * Outer epoch: full gradient ``mu = grad F(w~)`` as the SVRG anchor; stop
    when ``||mu|| < tol``.
  * Inner loop (``m_inner`` steps): sample batch; variance-reduced gradient
    ``v_t = grad_S(w_t) - grad_S(w~) + mu`` (same batch for both, which is
    what makes SVRG variance-reduced); direction from the two-loop recursion
    with clamped gamma; fixed-step update; iterate pushed into a ring of the
    last ``L+1`` iterates.
  * Every ``L`` steps: averaged iterate ``u``; ``s = u - u_prev``;
    ``y = H(u) s`` on a ``b_H`` batch; pair accepted iff ``|y^T s| > 1e-10``.
  * Epoch end: anchor reset to a uniformly random recent inner iterate.

Differences from the reference: the HVP is an exact ``jax.jvp`` of the batch gradient
(the reference uses central finite differences, s_lbfgs.hpp:88-101 — an
``"fd"`` mode is kept for parity testing); the entire run — outer while_loop,
inner scan, curvature conds — is one XLA program with no host round-trips;
batch sampling derives per-(epoch, step) keys with ``jax.random.fold_in``.

**Distributed mode** (``mesh=...``): the reference restricts S-LBFGS to one
CPU (a CUDA build is a static_assert error,
src/unified_optimization.hpp:639-641). Here, passing a data mesh runs every
gradient/HVP evaluation batch-sharded with one psum per evaluation
and solver state (weights, curvature ring, anchors) replicated. Two
sampling layouts:

  * ``sampling="local"`` — each device samples ``b/ndev`` indices *from its
    local shard* (``fold_in(key, axis_index)``); cheapest (no cross-shard
    index traffic), but batch composition differs from the 1-device run.
  * ``sampling="global"`` — layout-invariant: the replicated key draws the
    same global without-replacement batch as the single-device run (the
    reference's sampling semantics, s_lbfgs.hpp:141-160,220); each device
    contributes its masked shard slice, so the *trajectory matches the
    1-device run* up to reduction-order rounding on any device count.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from lbfgs_ffnn.ops.sampling import sample_without_replacement
from lbfgs_ffnn.ops.two_loop import (
    TWO_LOOP_IMPLS, RingState, empty_history_state, ring_push, two_loop,
    two_loop_compact,
)
from lbfgs_ffnn.solvers.common import (
    drive_chunks, finalize, init_history, init_metric_history, record,
)
from lbfgs_ffnn.types import BatchProblem, SolveResult


class SLBFGSOptions(NamedTuple):
    epochs: int = 1000          # outer iterations
    tol: float = 1e-4           # on the full gradient norm
    m_inner: int = 0            # inner steps per epoch; 0 -> N // batch_size
    history: int = 10           # M: curvature pairs kept
    L: int = 10                 # curvature update interval
    batch_size: int = 128       # b: gradient batch
    hvp_batch_size: int = 0     # b_H; 0 -> batch_size // 2
    step_size: float = 0.01
    hvp_mode: str = "exact"     # "exact" (jvp) | "fd" (reference parity)
    fd_eps: float = 1e-4
    sampler: str = "topk"       # without-replacement index sampler:
                                # "topk" (uniform-keys top-k, ~3x cheaper)
                                # | "sort" (full random argsort — the
                                # round-1 stream; see ops/sampling.py)
    sampling: str = "local"     # mesh mode only: "local" (per-device
                                # sampling from the local shard — cheapest,
                                # batch composition differs from 1-device) |
                                # "global" (layout-invariant: the replicated
                                # key draws the same global without-
                                # replacement batch as the 1-device run —
                                # reference semantics, s_lbfgs.hpp:141-160 —
                                # and each device contributes its masked
                                # slice via one psum)
    seed: int = 123
    record_full: bool = True    # per-epoch full loss + gradient (as reference)
    curvature_eps: float = 1e-10
    curvature_rel_eps: float = 0.0  # >0: |y^T s| > rel_eps*||y||*||s|| gate
    two_loop_impl: str = "xla"  # "xla" (loop form) | "compact" (GEMV form)
    pair_dtype: str | None = None  # (S, Y) ring storage dtype, as in
                                # LBFGSOptions.pair_dtype: "bfloat16" halves
                                # ring HBM + two-loop streaming traffic;
                                # rho/gamma/recursion arithmetic stay in the
                                # solver dtype. The ring is replicated under
                                # the data-parallel mesh mode, so it applies
                                # there unchanged.
    metric_fn: object = None    # optional (w, x, y) -> scalar per-epoch metric
    scan_unroll: int = 1        # lax.scan unroll for the inner vr_step scan
                                # (same math/trajectory; trades program size
                                # for less scan loop machinery — measured in
                                # scripts/diag_stochastic_step.py)


class _VecRing(NamedTuple):
    """Ring of recent iterate vectors (the reference's w_history,
    s_lbfgs.hpp:189,201,233)."""

    buf: jax.Array   # (cap, n)
    head: jax.Array
    count: jax.Array


def _vr_empty(cap: int, n: int, dtype) -> _VecRing:
    return _VecRing(jnp.zeros((cap, n), dtype=dtype), jnp.int32(0), jnp.int32(0))


def _vr_push(r: _VecRing, v: jax.Array) -> _VecRing:
    cap = r.buf.shape[0]
    return _VecRing(
        r.buf.at[r.head].set(v), (r.head + 1) % cap, jnp.minimum(r.count + 1, cap)
    )


def _vr_mean(r: _VecRing) -> jax.Array:
    cap = r.buf.shape[0]
    j = jnp.arange(cap)
    li = (j - (r.head - r.count)) % cap
    mask = (li < r.count).astype(r.buf.dtype)
    return (mask @ r.buf) / jnp.maximum(r.count, 1).astype(r.buf.dtype)


def _vr_pick(r: _VecRing, li: jax.Array) -> jax.Array:
    cap = r.buf.shape[0]
    return r.buf[(r.head - r.count + li) % cap]


class _State(NamedTuple):
    epoch: jax.Array
    w: jax.Array        # anchor w~
    hist: RingState     # curvature pairs, persists across epochs
    u_prev: jax.Array   # last averaged iterate (u_list.back())
    has_u: jax.Array
    stop: jax.Array
    gnorm: jax.Array    # ||mu|| of the most recent epoch
    loss_h: jax.Array
    gnorm_h: jax.Array
    metric_h: jax.Array


class _Ops(NamedTuple):
    """Gradient/loss evaluation strategy: direct (one device / GSPMD) or
    explicitly sharded (per-device local sampling + psum)."""

    full_grad: callable            # (w) -> (n,)
    full_loss: callable            # (w) -> scalar
    batch_grads: callable          # (w_t, w_anchor, key) -> (g_t, g_anchor)
    hvp: callable                  # (u, s_vec, key) -> (n,)
    # Optional batching hook: (per_step_keys (m,2-key)) -> (m, b) indices,
    # consumed by batch_grads_at(w_t, w_anchor, idx_row). Lets the epoch
    # body draw ALL inner-step batches in one vmapped selection instead of
    # one per scan step — same keys, same index values. Stacks with the
    # opts.sampler choice ("topk" is ~3x cheaper per draw than the full
    # argsort while remaining an exact uniform without-replacement draw).
    epoch_batch_idx: callable = None
    batch_grads_at: callable = None


def _direct_ops(problem: BatchProblem, x, y, N: int, b: int, b_h: int, opts) -> _Ops:
    def sample(k, size):
        return sample_without_replacement(k, N, size, opts.sampler)

    def full_grad(w):
        return problem.grad(w, x, y)

    def full_loss(w):
        return problem.fun(w, x, y)

    def batch_grads(w_t, w_anchor, key):
        idx = sample(key, b)
        xb, yb = jnp.take(x, idx, axis=0), jnp.take(y, idx, axis=0)
        return problem.grad(w_t, xb, yb), problem.grad(w_anchor, xb, yb)

    def hvp(u, s_vec, key):
        idx = sample(key, b_h)
        xh, yh = jnp.take(x, idx, axis=0), jnp.take(y, idx, axis=0)
        if opts.hvp_mode == "fd":
            return problem.fd_hvp(u, s_vec, xh, yh, eps=opts.fd_eps)
        return problem.hvp(u, s_vec, xh, yh)

    def epoch_batch_idx(keys):
        # vmap of the SAME draw the per-step path makes: identical values
        # per key (deterministic fn of the key), one batched selection.
        return jax.vmap(lambda k: sample(k, b))(keys)

    def batch_grads_at(w_t, w_anchor, idx):
        # One vmapped pass for BOTH gradients: the iterate's and the
        # anchor's backward share the batch gather and lower to batched
        # GEMMs instead of two separate passes.
        # Mathematically identical to two separate passes; the batched
        # lowering may differ in the last ulp, which the f64 mirror-parity
        # test bounds at rtol 1e-9.
        xb, yb = jnp.take(x, idx, axis=0), jnp.take(y, idx, axis=0)
        g2 = jax.vmap(lambda w: problem.grad(w, xb, yb))(
            jnp.stack([w_t, w_anchor])
        )
        return g2[0], g2[1]

    return _Ops(full_grad, full_loss, batch_grads, hvp,
                epoch_batch_idx, batch_grads_at)


def _sharded_ops(
    problem: BatchProblem, x, y, N: int, b: int, b_h: int, opts, mesh, axis: str
) -> _Ops:
    nd = mesh.shape[axis]
    if N % nd:
        raise ValueError(f"N={N} must divide the mesh size {nd}")
    n_local = N // nd
    b_local = max(b // nd, 1)
    bh_local = max(b_h // nd, 1)

    # Inside shard_map, jax.grad w.r.t. a replicated operand auto-psums the
    # cotangent across the axis; differentiating pmean(local_loss) therefore
    # yields the exact global-mean gradient with one all-reduce.
    def global_loss(w, xs, ys):
        return lax.pmean(problem.fun(w, xs, ys), axis)

    def _local_take(xs, ys, key, size):
        k = jax.random.fold_in(key, lax.axis_index(axis))
        idx = sample_without_replacement(k, n_local, size, opts.sampler)
        return jnp.take(xs, idx, axis=0), jnp.take(ys, idx, axis=0)

    # --- layout-invariant ("global") sampling -----------------------------
    # The replicated key draws the SAME global without-replacement batch as
    # the single-device run (reference semantics, s_lbfgs.hpp:141-160,220);
    # each device gathers the indices that land in its shard (fixed-shape
    # masked gather) and contributes sum(masked losses)/batch, so one psum
    # reproduces the exact global batch mean regardless of device count.

    def _global_take(xs, ys, key, size):
        # replicated across devices: same key, same deterministic draw
        idx = sample_without_replacement(key, N, size, opts.sampler)
        pos = idx - lax.axis_index(axis) * n_local
        valid = (pos >= 0) & (pos < n_local)
        posc = jnp.clip(pos, 0, n_local - 1)
        return jnp.take(xs, posc, axis=0), jnp.take(ys, posc, axis=0), valid

    def _global_batch_loss(w, xb, yb, mask, size):
        ls = problem.per_sample(w, xb, yb)
        local = jnp.sum(jnp.where(mask, ls, jnp.zeros_like(ls))) / size
        out = lax.psum(local, axis)
        if problem.reg is not None:
            out = out + problem.reg(w)  # regularizer counted exactly once
        return out

    def full_grad(w):
        def local(w, xs, ys):
            return jax.grad(global_loss)(w, xs, ys)

        return jax.shard_map(
            local, mesh=mesh, in_specs=(P(), P(axis), P(axis)), out_specs=P()
        )(w, x, y)

    def full_loss(w):
        def local(w, xs, ys):
            return global_loss(w, xs, ys)

        return jax.shard_map(
            local, mesh=mesh, in_specs=(P(), P(axis), P(axis)), out_specs=P()
        )(w, x, y)

    if opts.sampling == "global":
        def batch_grads(w_t, w_anchor, key):
            def local(w_t, w_anchor, xs, ys, key):
                xb, yb, mask = _global_take(xs, ys, key, b)
                g_t = jax.grad(_global_batch_loss)(w_t, xb, yb, mask, b)
                g_a = jax.grad(_global_batch_loss)(w_anchor, xb, yb, mask, b)
                return g_t, g_a

            return jax.shard_map(
                local, mesh=mesh,
                in_specs=(P(), P(), P(axis), P(axis), P()), out_specs=(P(), P()),
            )(w_t, w_anchor, x, y, key)

        def epoch_batch_idx(keys):
            # Global sampling draws from the REPLICATED key, so the one-shot
            # vmapped draw is identical to the per-step in-loop draw by
            # construction — the same batched-sampling optimization the
            # direct path has, previously lost in mesh mode.
            return jax.vmap(
                lambda k: sample_without_replacement(k, N, b, opts.sampler)
            )(keys)

        def batch_grads_at(w_t, w_anchor, idx):
            def local(w_t, w_anchor, xs, ys, idx):
                pos = idx - lax.axis_index(axis) * n_local
                valid = (pos >= 0) & (pos < n_local)
                posc = jnp.clip(pos, 0, n_local - 1)
                xb = jnp.take(xs, posc, axis=0)
                yb = jnp.take(ys, posc, axis=0)
                # same vmapped double gradient as the direct path's
                # batch_grads_at: both backwards share the masked gather
                g2 = jax.vmap(
                    lambda w: jax.grad(_global_batch_loss)(w, xb, yb, valid, b)
                )(jnp.stack([w_t, w_anchor]))
                return g2[0], g2[1]

            return jax.shard_map(
                local, mesh=mesh,
                in_specs=(P(), P(), P(axis), P(axis), P()),
                out_specs=(P(), P()),
            )(w_t, w_anchor, x, y, idx)

        def hvp(u, s_vec, key):
            def local(u, s_vec, xs, ys, key):
                xh, yh, mask = _global_take(xs, ys, key, b_h)
                grad_fn = lambda w: jax.grad(_global_batch_loss)(w, xh, yh, mask, b_h)
                if opts.hvp_mode == "fd":
                    gp = grad_fn(u + opts.fd_eps * s_vec)
                    gm = grad_fn(u - opts.fd_eps * s_vec)
                    return (gp - gm) / (2.0 * opts.fd_eps)
                return jax.jvp(grad_fn, (u,), (s_vec,))[1]

            return jax.shard_map(
                local, mesh=mesh,
                in_specs=(P(), P(), P(axis), P(axis), P()), out_specs=P(),
            )(u, s_vec, x, y, key)

        return _Ops(full_grad, full_loss, batch_grads, hvp,
                    epoch_batch_idx, batch_grads_at)

    if opts.sampling != "local":
        raise ValueError(f"unknown sampling {opts.sampling!r}")

    def batch_grads(w_t, w_anchor, key):
        def local(w_t, w_anchor, xs, ys, key):
            xb, yb = _local_take(xs, ys, key, b_local)
            g_t = jax.grad(global_loss)(w_t, xb, yb)
            g_a = jax.grad(global_loss)(w_anchor, xb, yb)
            return g_t, g_a

        return jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(), P(), P(axis), P(axis), P()), out_specs=(P(), P()),
        )(w_t, w_anchor, x, y, key)

    def hvp(u, s_vec, key):
        def local(u, s_vec, xs, ys, key):
            xh, yh = _local_take(xs, ys, key, bh_local)
            grad_fn = lambda w: jax.grad(global_loss)(w, xh, yh)
            if opts.hvp_mode == "fd":
                gp = grad_fn(u + opts.fd_eps * s_vec)
                gm = grad_fn(u - opts.fd_eps * s_vec)
                return (gp - gm) / (2.0 * opts.fd_eps)
            return jax.jvp(grad_fn, (u,), (s_vec,))[1]

        return jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(), P(), P(axis), P(axis), P()), out_specs=P(),
        )(u, s_vec, x, y, key)

    return _Ops(full_grad, full_loss, batch_grads, hvp)


def _outofcore_ops(problem: BatchProblem, store, N: int, b: int, b_h: int, opts) -> _Ops:
    """Host-resident dataset: the SVRG full-gradient anchor accumulates over
    ChunkStore chunks (one chunk device-resident at a time) and minibatches
    arrive through host-side index gathers — the out-of-HBM configuration
    for the flagship (reference full-gradient pass: s_lbfgs.hpp:203-206 over
    CPU RAM). Same index streams as _direct_ops (identical keys, identical
    sampler), so the trajectory matches the in-HBM run up to chunked-
    summation rounding; see tests/test_outofcore.py."""
    from lbfgs_ffnn.data.outofcore import chunked_mean_evals

    def sample(k, size):
        return sample_without_replacement(k, N, size, opts.sampler)

    # Masking + divide-by-N + reg-once discipline shared with
    # outofcore_problem (data/outofcore.py) — one implementation.
    full_loss, full_grad = chunked_mean_evals(problem, store)

    def batch_grads(w_t, w_anchor, key):
        xb, yb = store.fetch_rows(sample(key, b))
        return problem.grad(w_t, xb, yb), problem.grad(w_anchor, xb, yb)

    def hvp(u, s_vec, key):
        xh, yh = store.fetch_rows(sample(key, b_h))
        if opts.hvp_mode == "fd":
            return problem.fd_hvp(u, s_vec, xh, yh, eps=opts.fd_eps)
        return problem.hvp(u, s_vec, xh, yh)

    def epoch_batch_idx(keys):
        return jax.vmap(lambda k: sample(k, b))(keys)

    def batch_grads_at(w_t, w_anchor, idx):
        # same vmapped double-gradient as _direct_ops, host gather instead
        # of jnp.take
        xb, yb = store.fetch_rows(idx)
        g2 = jax.vmap(lambda w: problem.grad(w, xb, yb))(
            jnp.stack([w_t, w_anchor])
        )
        return g2[0], g2[1]

    return _Ops(full_grad, full_loss, batch_grads, hvp,
                epoch_batch_idx, batch_grads_at)


def _make_parts(problem: BatchProblem, opts: SLBFGSOptions, N: int, mesh, axis: str,
                store=None):
    """Shared trace-time pieces: returns ``make_body(x, y) -> body(state)``,
    the per-epoch transition both drivers (while_loop and chunked) run."""
    b = min(opts.batch_size, N)
    m_inner = opts.m_inner if opts.m_inner > 0 else max(N // b, 1)
    b_h = opts.hvp_batch_size if opts.hvp_batch_size > 0 else max(b // 2, 1)
    b_h = min(b_h, N)
    cap = opts.L + 1

    if opts.two_loop_impl not in TWO_LOOP_IMPLS:
        raise ValueError(f"unknown two_loop_impl {opts.two_loop_impl!r} "
                         f"(one of {TWO_LOOP_IMPLS})")
    if opts.two_loop_impl == "compact":
        def direction(v, hist):
            return two_loop_compact(v, hist, clamp_gamma=True)
    else:
        def direction(v, hist):
            return two_loop(v, hist, clamp_gamma=True)

    def make_body(x, y, margs=()):
        if store is not None:
            ops = _outofcore_ops(problem, store, N, b, b_h, opts)
        elif mesh is None:
            ops = _direct_ops(problem, x, y, N, b, b_h, opts)
        else:
            ops = _sharded_ops(problem, x, y, N, b, b_h, opts, mesh, axis)

        key = jax.random.PRNGKey(opts.seed)

        def body(s: _State) -> _State:
            n = s.w.shape[0]
            w0 = s.w  # dtype/shape template for the iterate ring
            k_epoch = jax.random.fold_in(key, s.epoch)
            # SVRG anchor: full gradient at w~ (s_lbfgs.hpp:203-206).
            mu = ops.full_grad(s.w)
            mu_norm = jnp.linalg.norm(mu)
            converged = mu_norm < opts.tol

            def run_epoch(s: _State) -> _State:
                wr0 = _vr_push(_vr_empty(cap, n, w0.dtype), s.w)

                ts_all = jnp.arange(m_inner)
                if ops.epoch_batch_idx is not None:
                    # Draw every inner step's batch up front: one vmapped
                    # permutation over the per-step keys instead of a sort
                    # inside every scan step. Key derivation is identical
                    # to the in-loop path, so the index stream (and the
                    # trajectory) is bit-identical — gated by the S-LBFGS
                    # mirror test in tests/test_solver_parity_mlp.py.
                    step_keys = jax.vmap(
                        lambda t: jax.random.fold_in(
                            jax.random.fold_in(k_epoch, t), 0
                        )
                    )(ts_all)
                    idx_all = ops.epoch_batch_idx(step_keys)
                else:
                    idx_all = ts_all  # per-step placeholder, unused

                # The epoch runs as cond-free L-step segment scans with the
                # curvature update in STRAIGHT-LINE code between them. The
                # reference updates every L-th step (s_lbfgs.hpp:231-264),
                # and the previous formulation expressed that as a per-step
                # lax.cond inside one scan — which paid the cond machinery
                # (operand materialization for the captured iterate ring +
                # n-sized branch outputs) on EVERY step while the branch
                # runs on every 10th; see scripts/diag_stochastic_step.py
                # and PERF.md.
                # Segment boundaries are static (m_inner, L are options), so
                # the schedule is: prologue scan over t in [0, L] + pair at
                # t=L; an outer scan over the (L steps + pair) full segments
                # (compiles once regardless of their number); a tail scan
                # for the remainder. Per-step math, RNG streams and ring
                # pushes are expression-identical, so trajectories are
                # bit-equal (pinned by the f64 mirror parity test).
                def steps_scan(wt, hist, wr, ts, idx_rows):
                    # hist is captured, not carried: it never changes inside
                    # a segment, so it enters the scan as one invariant
                    # operand instead of a per-step carry.
                    def vr_step(carry, t_and_idx):
                        t, idx_row = t_and_idx
                        wt, wr = carry
                        # Variance-reduced gradient (s_lbfgs.hpp:225-228).
                        if ops.epoch_batch_idx is not None:
                            g_t, g_anchor = ops.batch_grads_at(wt, s.w, idx_row)
                        else:
                            k_t = jax.random.fold_in(k_epoch, t)
                            g_t, g_anchor = ops.batch_grads(
                                wt, s.w, jax.random.fold_in(k_t, 0)
                            )
                        v = g_t - g_anchor + mu
                        d = direction(v, hist)
                        wt = wt - opts.step_size * d
                        wr = _vr_push(wr, wt)
                        return (wt, wr), None

                    (wt, wr), _ = lax.scan(vr_step, (wt, wr), (ts, idx_rows),
                                           unroll=opts.scan_unroll)
                    return wt, wr

                def pair_update(t_b, wt, wr, hist, u_prev, has_u):
                    # Curvature pair from averaged recent iterates
                    # (s_lbfgs.hpp:231-247). Runs unconditionally at the
                    # boundary; `accept & has_u` masks the ring push when no
                    # previous average exists yet (the pre-first-boundary
                    # state), which matches the old cond's no-pair branch
                    # bit-for-bit (a masked ring_push is a no-op either way).
                    k_t = jax.random.fold_in(k_epoch, t_b)
                    u = _vr_mean(wr)
                    s_vec = u - u_prev
                    yv = ops.hvp(u, s_vec, jax.random.fold_in(k_t, 1))
                    ys = jnp.vdot(yv, s_vec)
                    if opts.curvature_rel_eps > 0.0:
                        gate = (opts.curvature_rel_eps
                                * jnp.linalg.norm(yv) * jnp.linalg.norm(s_vec))
                    else:
                        gate = opts.curvature_eps
                    accept = (jnp.abs(ys) > gate) & has_u
                    rho = jnp.where(accept, 1.0 / jnp.where(ys == 0, 1.0, ys), 0.0)
                    hist = ring_push(hist, s_vec, yv, rho, accept)
                    return hist, u, jnp.array(True)

                nb = (m_inner - 1) // opts.L  # boundaries at L, 2L, ..., nb*L
                wt, hist, wr = s.w, s.hist, wr0
                u_prev, has_u = s.u_prev, s.has_u

                p_end = opts.L if nb >= 1 else m_inner - 1  # inclusive
                wt, wr = steps_scan(wt, hist, wr,
                                    ts_all[: p_end + 1], idx_all[: p_end + 1])
                if nb >= 1:
                    hist, u_prev, has_u = pair_update(
                        opts.L, wt, wr, hist, u_prev, has_u
                    )
                if nb >= 2:
                    def segment(carry, k):
                        wt, hist, wr, u_prev, has_u = carry
                        start = k * opts.L + 1
                        ts = start + jnp.arange(opts.L)
                        idx_rows = lax.dynamic_slice_in_dim(
                            idx_all, start, opts.L, axis=0
                        )
                        wt, wr = steps_scan(wt, hist, wr, ts, idx_rows)
                        hist, u_prev, has_u = pair_update(
                            (k + 1) * opts.L, wt, wr, hist, u_prev, has_u
                        )
                        return (wt, hist, wr, u_prev, has_u), None

                    (wt, hist, wr, u_prev, has_u), _ = lax.scan(
                        segment, (wt, hist, wr, u_prev, has_u),
                        jnp.arange(1, nb)
                    )
                tail = m_inner - 1 - nb * opts.L
                if tail > 0 and nb >= 1:
                    start = nb * opts.L + 1
                    wt, wr = steps_scan(wt, hist, wr,
                                        ts_all[start:], idx_all[start:])

                # Anchor reset to a random recent iterate (s_lbfgs.hpp:265-270).
                k_r = jax.random.fold_in(k_epoch, 2**20)
                j = jax.random.randint(k_r, (), 0, jnp.maximum(wr.count - 1, 1))
                w_new = jnp.where(wr.count >= 2, _vr_pick(wr, j), wt)

                if opts.record_full:
                    full_loss = ops.full_loss(w_new)
                    full_g = ops.full_grad(w_new)
                    loss_h, gnorm_h = record(
                        s.loss_h, s.gnorm_h, s.epoch, full_loss, jnp.linalg.norm(full_g)
                    )
                else:
                    loss_h, gnorm_h = s.loss_h, s.gnorm_h
                metric_h = s.metric_h
                if opts.metric_fn is not None:
                    metric_h = metric_h.at[s.epoch].set(
                        opts.metric_fn(w_new, x, y, *margs)
                    )

                return _State(
                    epoch=s.epoch + 1, w=w_new, hist=hist, u_prev=u_prev,
                    has_u=has_u, stop=jnp.array(False), gnorm=mu_norm,
                    loss_h=loss_h, gnorm_h=gnorm_h, metric_h=metric_h,
                )

            def skip_epoch(s: _State) -> _State:
                return s._replace(stop=jnp.array(True), gnorm=mu_norm)

            return lax.cond(converged, skip_epoch, run_epoch, s)

        return body

    return make_body


def _init_state(opts: SLBFGSOptions, w0: jax.Array, x, y, margs=()) -> _State:
    n = w0.shape[0]
    loss_h, gnorm_h = init_history(opts.epochs, w0.dtype)
    return _State(
        epoch=jnp.int32(0),
        w=w0,
        hist=empty_history_state(opts.history, n, w0.dtype,
                                 pair_dtype=opts.pair_dtype),
        u_prev=jnp.zeros_like(w0),
        has_u=jnp.array(False),
        stop=jnp.array(False),
        gnorm=jnp.asarray(jnp.inf, dtype=w0.dtype),
        loss_h=loss_h,
        gnorm_h=gnorm_h,
        metric_h=init_metric_history(opts.metric_fn, opts.epochs, w0, x, y, *margs),
    )


def _not_done(s: _State, opts: SLBFGSOptions):
    return (s.epoch < opts.epochs) & ~s.stop


def _finalize_state(s: _State, opts: SLBFGSOptions) -> SolveResult:
    last = jnp.maximum(s.epoch - 1, 0)
    return finalize(
        s.w, s.epoch, s.stop, s.loss_h[last], s.gnorm, s.loss_h, s.gnorm_h,
        s.metric_h if opts.metric_fn is not None else None,
    )


def _build(problem: BatchProblem, opts: SLBFGSOptions, N: int, mesh, axis: str,
           store=None):
    make_body = _make_parts(problem, opts, N, mesh, axis, store)

    def solve(w0, x, y, margs=()):
        body = make_body(x, y, margs)
        s = lax.while_loop(
            lambda s: _not_done(s, opts), body, _init_state(opts, w0, x, y, margs)
        )
        return _finalize_state(s, opts)

    return solve


@functools.lru_cache(maxsize=256)
def _cached(problem, opts, N, mesh, axis, store=None):
    return jax.jit(_build(problem, opts, N, mesh, axis, store))


def slbfgs(
    problem: BatchProblem,
    w0: jax.Array,
    x: jax.Array,
    y: jax.Array,
    opts: SLBFGSOptions | None = None,
    mesh=None,
    axis_name: str = "data",
    metric_args: tuple = (),
    store=None,
) -> SolveResult:
    """Run S-LBFGS. With ``mesh`` set, evaluations are explicitly
    batch-sharded (pass ``x``/``y`` sharded via ``parallel.shard_batch`` and
    ``w0`` replicated); see the module docstring for the two sampling
    layouts."""
    opts = opts or SLBFGSOptions()
    if store is not None:
        # Out-of-HBM mode: the dataset lives host-side in a ChunkStore and
        # x/y must be None (see data/outofcore.py). metric_fn would receive
        # empty x/y placeholders, so it is rejected.
        if x is not None or y is not None:
            raise ValueError("pass x=y=None with store= (data lives in the store)")
        if mesh is not None:
            raise ValueError("store= (out-of-core) and mesh= are mutually exclusive")
        if opts.metric_fn is not None:
            raise ValueError("metric_fn is unsupported with store= "
                             "(no resident x/y to evaluate it on)")
        return _cached(problem, opts, store.n, None, axis_name, store)(
            w0, (), (), ()
        )
    return _cached(problem, opts, int(x.shape[0]), mesh, axis_name)(
        w0, x, y, tuple(metric_args)
    )


# ---------------------------------------------------------------------------
# Chunked driver: measured per-epoch wall time + checkpoint/resume
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def _cached_chunk_fns(problem, opts, N, mesh, axis, chunk: int):
    make_body = _make_parts(problem, opts, N, mesh, axis)

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


def slbfgs_chunked(
    problem: BatchProblem,
    w0,
    x: jax.Array,
    y: jax.Array,
    opts: SLBFGSOptions | None = None,
    chunk: int = 10,
    callback=None,
    resume_state: _State | None = None,
    mesh=None,
    axis_name: str = "data",
    metric_args: tuple = (),
) -> tuple[SolveResult, jax.Array]:
    """Run S-LBFGS in jitted ``chunk``-epoch pieces (the flagship's
    counterpart of :func:`lbfgs_ffnn.solvers.lbfgs.lbfgs_chunked`).

    Returns ``(result, time_ms)`` where ``time_ms[e]`` is the *measured*
    cumulative wall time after epoch ``e`` (chunk granularity, excluding
    compile) — real timestamps like the reference's per-epoch chrono
    recording (reference: src/minimizer/s_lbfgs.hpp:195-197,274-284)
    instead of a synthesized uniform column. ``callback(state, elapsed_s)``
    fires after each chunk — use it with ``lbfgs_ffnn.checkpoint`` to
    make long runs kill-and-resumable; ``resume_state`` continues from such
    a checkpoint with the full SVRG/curvature memory (anchor, (S,Y) ring,
    iterate ring average state) intact. On resume ``w0`` may be ``None``;
    pre-kill epochs keep NaN time entries — they were not measured here.
    ``mesh`` enables the explicit batch-sharded evaluation mode exactly as
    in :func:`slbfgs` (pass sharded ``x``/``y``, replicated ``w0``).
    """
    opts = opts or SLBFGSOptions()
    if resume_state is None and w0 is None:
        raise ValueError("w0 is required unless resume_state is given")
    init, run_chunk = _cached_chunk_fns(
        problem, opts, int(x.shape[0]), mesh, axis_name, chunk
    )

    state = (resume_state if resume_state is not None
             else init(w0, x, y, metric_args))
    state, time_ms = drive_chunks(
        run_chunk, state, (x, y, metric_args), opts.epochs,
        counter=lambda s: int(s.epoch),
        done=lambda s: bool(s.stop),
        sync=lambda s: s.gnorm,
        callback=callback,
    )
    return _finalize_state(state, opts), time_ms
