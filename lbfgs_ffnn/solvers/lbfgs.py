"""L-BFGS as one jitted program: direction, line search, update, history.

Two line-search flavors, matching the reference's two backends behaviorally:
  * ``"wolfe"`` — the reference CPU solver: Wolfe bisection search (skipped
    on the first iteration in favor of ``alpha = min(1, 1/||g||)``),
    curvature gate ``y^T s > 1e-10``
    (reference: src/minimizer/lbfgs.hpp:38-99).
  * ``"armijo"`` — the reference CUDA solver: descent-direction check with
    steepest-descent fallback + history reset, Armijo backtracking with
    safeguarded quadratic interpolation keeping the last trial on failure,
    history reset on line-search failure
    (reference: src/cuda/lbfgs.cuh:90-185).

The structural win over the CUDA reference: its two-loop recursion issues
~4m separate cuBLAS calls per iteration, each synchronizing the host
(reference: src/cuda/lbfgs.cuh:236-257) — here the whole solve is a single
XLA program; nothing touches the host until the result is fetched. The
two-loop runs in loop form or in the compact GEMV form
(``two_loop_impl``).

Two drivers over the same jitted iteration body:
  * :func:`lbfgs` — full run in one ``lax.while_loop`` (fastest).
  * :func:`lbfgs_chunked` — jitted K-iteration chunks with a host callback
    between chunks: measured (not synthesized) cumulative wall time per
    chunk, periodic checkpointing, live logging.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from lbfgs_ffnn.ops.linesearch import (
    armijo_batched_line_search,
    armijo_quad_line_search,
    wolfe_line_search,
)
from lbfgs_ffnn.ops.two_loop import (
    GramRing, RingState, empty_history_state, gram_empty, gram_push,
    TWO_LOOP_IMPLS, gram_reset, ring_push, ring_reset, two_loop,
    two_loop_compact,
)
from lbfgs_ffnn.solvers.common import (
    cached_jit_solve, drive_chunks, finalize, init_history, record,
)
from lbfgs_ffnn.types import Problem, SolveResult, prepared_aux


class LBFGSOptions(NamedTuple):
    max_iters: int = 1000
    tol: float = 1e-10
    m: int = 16
    line_search: str = "wolfe"  # "wolfe" (CPU-ref) | "armijo" (CUDA-ref)
                                # | "armijo_batched" (no reference
                                # counterpart: spec_k ladder candidates per
                                # batched forward; pure backtracking, no
                                # interpolation)
    ls_max_iters: int = 50
    c1: float = 1e-4
    c2: float = 0.9
    ls_shrink: float = 0.5
    curvature_eps: float = 1e-10
    curvature_rel_eps: float = 0.0  # >0: scale-invariant gate
                                    # y^T s > rel_eps * ||y|| * ||s||
                                    # (robust for float32; the reference's
                                    # absolute 1e-10 gate is scale-sensitive)
    curvature_pairs: str = "grad_diff"  # "grad_diff" (reference: y = g_new-g,
                                        # src/minimizer/lbfgs.hpp:67-77) |
                                        # "hvp": y = H(x_new)·s via one exact
                                        # jvp-of-grad. In f32 the gradient
                                        # difference cancels catastrophically
                                        # once plateau steps are tiny (y is
                                        # pure rounding noise); the HVP has
                                        # no cancellation — the full-batch
                                        # analogue of the S-LBFGS decoupled
                                        # pairs (s_lbfgs.hpp:246-250). Costs
                                        # one extra gradient-shaped eval per
                                        # iteration (counted in n_gevals).
    two_loop_impl: str = "xla"  # "xla" (loop form) | "compact" (GEMV
                                # form — see ops.two_loop.two_loop_compact;
                                # under mesh= this selects the incremental-
                                # Gram collective-lean direction: 2 m-vector
                                # psums instead of ~4m scalar ones)
    ls_spec_k: int = 4  # armijo_batched: candidates per batched forward
    prefix_vag: bool = True  # use LinePrefix.vag_restrict for the accepted
                             # point's value_and_grad (skips recomputing the
                             # prefix matmul in the forward; carries the
                             # prefix's rounding-noise-level drift into the
                             # gradient — set False for a fresh gradient)
    ls_value_only: bool | None = None
    # Lean trials: armijo evaluates loss-only forwards; wolfe evaluates
    # (loss, g·p) via one forward-mode jvp; either way a single
    # value_and_grad runs at the accepted point. Same trial sequence,
    # ~2-3x cheaper when backtracking dominates (see ops/linesearch.py).
    # None = auto: True for armijo (backtracking-heavy by construction),
    # False for wolfe (usually accepts the first trial; measured faster
    # fused — set True explicitly for plateau-heavy objectives like PINNs).
    pair_dtype: str | None = None
    # Storage dtype for the (S, Y) curvature ring, e.g. "bfloat16": halves
    # the ring's HBM footprint AND the two-loop's 4mn streaming traffic —
    # the dominant per-iteration cost at large m*n (deep Fashion m=100:
    # the ring is 195 MB f32). rho, gamma, and all recursion arithmetic
    # stay in the solver dtype; only the stored rows are rounded, and the
    # line search bounds any direction-quality loss. None = solver dtype.
    # Works under mesh= too: each shard's partial dot promotes its bf16
    # rows against the f32 working shard BEFORE the psum, so cross-device
    # accumulation stays f32 (halves ring memory per device).
    prefix_dtype: str | None = None
    # Storage dtype for the carried line prefix (the MLP's A = x@W1+b1 and
    # per-iteration B = x@p1), e.g. "bfloat16": halves the prefix-bound HBM
    # traffic that dominates the lean iteration once the ring is narrow —
    # every trial's (A, B) read, the accept eval's read, B's write, and the
    # accept-time A += alpha*B axpy. All arithmetic stays in the solver
    # dtype (the combine A + alpha*B upcasts in registers; XLA fuses the
    # casts into the reads/writes). Storage rounding of the accumulated A
    # random-walks at ~sqrt(steps)*eps_bf16 relative, so a narrow prefix is
    # periodically re-anchored (see prefix_refresh). None = solver dtype.
    prefix_refresh: int | None = None
    # Re-anchor the carried prefix every N iterations by recomputing
    # A = init(x) exactly (one first-layer matmul inside a lax.cond, so it
    # only runs on refresh iterations). None = auto: 16 when prefix_dtype
    # is set (bounds the bf16 random-walk drift at ~4*eps_bf16 ~ 1.6% of
    # |A| while amortizing the matmul to ~1/16 of an iteration), else 0
    # (f32 drift is rounding-noise level, see types.LinePrefix). 0 = never.
    ls_alpha_init: str = "fixed"
    # Initial trial step policy after iteration 0 (iteration 0 always uses
    # the reference's min(1, 1/||g||) heuristic):
    #   * "fixed" — alpha0 = 1 every iteration (the reference policy,
    #     src/cuda/lbfgs.cuh:108 / src/minimizer/lbfgs.hpp:62-65).
    #   * "warm"  — alpha0 = min(1, ls_alpha_growth * alpha_prev), where
    #     alpha_prev is the previous iteration's step (carried in solver
    #     state; on line-search failure, the last trial evaluated — exactly
    #     the point the reference itself keeps on failure). No reference
    #     counterpart: near a loss plateau the accepted step
    #     collapses by orders of magnitude, and restarting every search at
    #     alpha0=1 burns the whole ls_max_iters trial budget re-shrinking —
    #     the single largest per-iteration cost of the MLP headlines
    #     (13-20 trials/iter counted, PERF.md). Warm-starting
    #     resumes at the established scale (~1-3 trials) and the growth
    #     factor recovers geometrically when larger steps become viable.
    ls_alpha_growth: float = 8.0  # "warm": per-iteration growth toward 1.
                                  # 8.0 is the value benchmarked earlier
                                  # (PERF.md) and the launcher's
                                  # UnifiedConfig default — kept identical so
                                  # a direct-API user opting into "warm" gets
                                  # the measured policy (pinned by
                                  # tests/test_launcher.py).


class _State(NamedTuple):
    k: jax.Array
    x: jax.Array
    f: jax.Array
    g: jax.Array
    gnorm: jax.Array
    hist: RingState
    loss_h: jax.Array
    gnorm_h: jax.Array
    nf: jax.Array  # objective (forward / jvp-trial) evaluations
    ng: jax.Array  # full-gradient evaluations
    alpha_prev: Any = 1.0  # previous iteration's step (scalar, x.dtype):
                           # the warm-start seed for ls_alpha_init="warm";
                           # carried (and checkpointed) unconditionally so
                           # the state layout doesn't depend on the policy.
    prefix: Any = ()  # carried LinePrefix state (e.g. the MLP's A = x@W1+b1);
                      # () when the problem has none. Updated exactly as
                      # prefix += alpha * B on every step (linear in w).


def _direction(g, hist, opts: LBFGSOptions):
    if opts.two_loop_impl == "compact":
        return -two_loop_compact(g, hist)
    return -two_loop(g, hist)


def _lean(problem: Problem, opts: LBFGSOptions) -> bool:
    """Lean trials: on for armijo (backtracking-heavy by construction) and
    whenever the problem carries a cheap line restriction in either form
    (with the restriction, lean trials beat fused ones even for wolfe)."""
    if opts.ls_value_only is not None:
        return opts.ls_value_only
    return (
        opts.line_search == "armijo"
        or problem.line_fun is not None
        or problem.line_prefix is not None
    )


def _use_prefix(problem: Problem, opts: LBFGSOptions) -> bool:
    return problem.line_prefix is not None and (
        _lean(problem, opts) or opts.line_search == "armijo_batched"
    )


def _prefix_cast(opts: LBFGSOptions):
    """Leaf-wise cast of a carried prefix to ``opts.prefix_dtype`` (identity
    when unset). Applied where the prefix is (re)materialized — init, the
    per-iteration B, resume, refresh — so XLA fuses the cast into the
    producing matmul's epilogue (the narrow array is written directly;
    no separate conversion pass over HBM)."""
    if opts.prefix_dtype is None:
        return lambda P: P
    d = jnp.dtype(opts.prefix_dtype)
    return lambda P: jax.tree_util.tree_map(lambda a: a.astype(d), P)


def _prefix_refresh_n(opts: LBFGSOptions) -> int:
    if opts.prefix_refresh is None:
        return 16 if opts.prefix_dtype is not None else 0
    return int(opts.prefix_refresh)


def _init_state(problem: Problem, opts: LBFGSOptions, x0, aux,
                empty_hist=empty_history_state) -> _State:
    f0, g0 = problem.value_and_grad(x0, aux)
    loss_h, gnorm_h = init_history(opts.max_iters, x0.dtype)
    return _State(
        k=jnp.int32(0),
        x=x0,
        f=f0,
        g=g0,
        gnorm=jnp.linalg.norm(g0),
        hist=empty_hist(opts.m, x0.shape[0], x0.dtype,
                        pair_dtype=opts.pair_dtype),
        loss_h=loss_h,
        gnorm_h=gnorm_h,
        nf=jnp.int32(1),
        ng=jnp.int32(1),
        alpha_prev=jnp.ones((), dtype=x0.dtype),
        prefix=(
            _prefix_cast(opts)(problem.line_prefix.init(x0, aux))
            if _use_prefix(problem, opts) else ()
        ),
    )


def _not_done(s: _State, opts: LBFGSOptions):
    return (s.k < opts.max_iters) & (s.gnorm >= opts.tol)


def _make_body(problem: Problem, opts: LBFGSOptions, direction=None,
               push=ring_push, reset=ring_reset):
    if opts.line_search not in ("wolfe", "armijo", "armijo_batched"):
        raise ValueError(f"unknown line_search {opts.line_search!r}")
    if opts.curvature_pairs not in ("grad_diff", "hvp"):
        raise ValueError(f"unknown curvature_pairs {opts.curvature_pairs!r}")
    if opts.ls_alpha_init not in ("fixed", "warm"):
        raise ValueError(f"unknown ls_alpha_init {opts.ls_alpha_init!r}")
    if opts.two_loop_impl not in TWO_LOOP_IMPLS:
        raise ValueError(f"unknown two_loop_impl {opts.two_loop_impl!r} "
                         f"(one of {TWO_LOOP_IMPLS})")
    if direction is None:
        def direction(g, hist):
            return _direction(g, hist, opts)

    lean = _lean(problem, opts)
    use_prefix = _use_prefix(problem, opts)
    prefix_cast = _prefix_cast(opts)
    prefix_refresh = _prefix_refresh_n(opts)
    # Accept-eval prefix carry: the armijo-family accept evaluation already
    # computes the post-step prefix (the MLP's z1 = A + alpha*B, kept as the
    # relu backward's residual) — reusing it as the next carried prefix
    # deletes the separate accept-time axpy over the (batch, d1) prefix.
    # Same arithmetic expression, so the carried value is unchanged.
    carry_mode = (
        use_prefix
        and opts.prefix_vag
        and problem.line_prefix.vag_restrict_carry is not None
        and opts.line_search in ("armijo", "armijo_batched")
    )

    def make_va(s: _State, p, aux):
        """(B, value_along, vag_along, vag_carry_along): the carried-prefix
        restriction when available (one first-layer matmul for B; A comes
        from the loop state), else the per-iteration line_fun, else
        nothing."""
        if use_prefix:
            lp = problem.line_prefix
            B = prefix_cast(lp.direction(p, aux))
            va = lp.restrict(s.prefix, B, s.x, p, aux)
            vag = (
                lp.vag_restrict(s.prefix, B, s.x, p, aux)
                if (opts.prefix_vag and lp.vag_restrict is not None) else None
            )
            vagc = None
            if carry_mode:
                inner = lp.vag_restrict_carry(s.prefix, B, s.x, p, aux)

                def vagc(alpha, _inner=inner):
                    f, g, P_new = _inner(alpha)
                    return f, g, prefix_cast(P_new)
            return B, va, vag, vagc
        if problem.line_fun is not None:
            return None, problem.line_fun(s.x, p, aux), None, None
        return None, None, None, None

    def body(s: _State, aux) -> _State:
        p = direction(s.g, s.hist)
        hist = s.hist
        dg0 = jnp.vdot(s.g, p)

        if opts.line_search in ("armijo", "armijo_batched"):
            # Steepest-descent fallback + history reset on non-descent p
            # (reference: src/cuda/lbfgs.cuh:97-104).
            nondescent = dg0 >= 0
            p = jnp.where(nondescent, -s.g, p)
            dg0 = jnp.where(nondescent, -jnp.vdot(s.g, s.g), dg0)
            hist = reset(hist, nondescent)

            if opts.ls_alpha_init == "warm":
                later_alpha = jnp.minimum(
                    jnp.ones_like(s.gnorm),
                    s.alpha_prev * opts.ls_alpha_growth,
                ).astype(s.gnorm.dtype)
            else:
                later_alpha = jnp.ones_like(s.gnorm)
            alpha0 = jnp.where(
                s.k == 0,
                jnp.minimum(jnp.ones_like(s.gnorm), 1.0 / s.gnorm),
                later_alpha,
            )
            # Structure-exploiting restriction f(x + a*p) when the problem
            # provides one (e.g. the MLP's affine first layer); only useful
            # for value-only trials.
            B, va, vag, vagc = make_va(s, p, aux)
            if opts.line_search == "armijo_batched":
                ls = armijo_batched_line_search(
                    problem.value_and_grad, s.x, p, s.f, dg0, aux,
                    value=problem.fun, c1=opts.c1, shrink=opts.ls_shrink,
                    max_iters=opts.ls_max_iters, alpha0=alpha0,
                    spec_k=opts.ls_spec_k, value_along=va, vag_along=vag,
                    vag_carry_along=vagc,
                )
            else:
                ls = armijo_quad_line_search(
                    problem.value_and_grad, s.x, p, s.f, dg0, aux,
                    c1=opts.c1, shrink=opts.ls_shrink,
                    max_iters=opts.ls_max_iters, alpha0=alpha0,
                    value=problem.fun if lean else None,
                    value_along=va if lean else None,
                    vag_along=vag if lean else None,
                    vag_carry_along=vagc if lean else None,
                )
            alpha, f_new, g_new = ls.alpha, ls.f_new, ls.g_new
            prefix_carried = ls.carry if carry_mode else None
            # History reset on line-search failure (cuda/lbfgs.cuh:147).
            hist = reset(hist, ~ls.ok)
            if lean or opts.line_search == "armijo_batched":
                # value-only trials + one value_and_grad
                nf_add, ng_add = ls.n_trials + 1, jnp.int32(1)
            else:     # each trial is a fused value_and_grad
                nf_add, ng_add = ls.n_trials, ls.n_trials
        else:
            B, va0, vag0, _vagc0 = make_va(s, p, aux)
            prefix_carried = None  # wolfe keeps the explicit prefix axpy

            # First-iteration heuristic step, no search
            # (reference: src/minimizer/lbfgs.hpp:61-65).
            def first(_):
                alpha = jnp.minimum(jnp.ones_like(s.gnorm), 1.0 / s.gnorm)
                f_new, g_new = problem.value_and_grad(s.x + alpha * p, aux)
                return alpha, f_new, g_new, jnp.int32(1), jnp.int32(1)

            def later(_):
                if opts.ls_alpha_init == "warm":
                    wolfe_alpha0 = jnp.minimum(
                        jnp.ones_like(s.gnorm),
                        s.alpha_prev * opts.ls_alpha_growth,
                    ).astype(s.gnorm.dtype)
                else:
                    wolfe_alpha0 = 1.0
                ls = wolfe_line_search(
                    problem.value_and_grad, s.x, p, s.f, dg0, aux,
                    c1=opts.c1, c2=opts.c2, shrink=opts.ls_shrink,
                    max_iters=opts.ls_max_iters, alpha0=wolfe_alpha0,
                    value=problem.fun if lean else None,
                    value_along=va0 if lean else None,
                    vag_along=vag0 if lean else None,
                )
                if lean:
                    # jvp trials + one value_and_grad (at accept, or by the
                    # re-evaluation below on failure)
                    nf_add, ng_add = ls.n_trials + 1, jnp.int32(1)
                else:
                    one_more = jnp.where(ls.evaluated, 0, 1).astype(jnp.int32)
                    nf_add, ng_add = ls.n_trials + one_more, ls.n_trials + one_more

                def use_ls(_):
                    return ls.alpha, ls.f_new, ls.g_new

                def reeval(_):
                    f_new, g_new = problem.value_and_grad(s.x + ls.alpha * p, aux)
                    return ls.alpha, f_new, g_new

                alpha, f_new, g_new = lax.cond(ls.evaluated, use_ls, reeval, None)
                return alpha, f_new, g_new, nf_add, ng_add

            alpha, f_new, g_new, nf_add, ng_add = lax.cond(s.k == 0, first, later, None)

        x_new = s.x + alpha * p
        step = alpha * p
        if opts.curvature_pairs == "hvp":
            y = problem.hvp(x_new, step, aux)
            ng_add = ng_add + 1
        else:
            y = g_new - s.g
        ys = jnp.vdot(y, step)
        if opts.curvature_rel_eps > 0.0:
            gate = opts.curvature_rel_eps * jnp.linalg.norm(y) * jnp.linalg.norm(step)
        else:
            gate = opts.curvature_eps
        accept = ys > gate
        rho = jnp.where(accept, 1.0 / jnp.where(ys == 0, 1.0, ys), 0.0)
        hist = push(hist, step, y, rho, accept)

        gnorm_new = jnp.linalg.norm(g_new)
        loss_h, gnorm_h = record(s.loss_h, s.gnorm_h, s.k, f_new, gnorm_new)
        # Carried prefix moves with the iterate: x_new = x + alpha*p implies
        # prefix_new = prefix + alpha*B exactly (linear in w). Under a
        # narrow prefix_dtype the axpy upcasts in registers and rounds the
        # sum back to storage; the accumulated rounding random walk is
        # re-anchored every prefix_refresh iterations by recomputing the
        # prefix from the fresh iterate (one first-layer matmul, executed
        # only on refresh iterations thanks to the cond).
        if prefix_carried is not None:
            prefix_new = prefix_carried  # free: the accept eval computed it
        elif use_prefix:
            prefix_new = jax.tree_util.tree_map(
                lambda a, b: (a + alpha * b).astype(a.dtype), s.prefix, B
            )
        else:
            prefix_new = s.prefix
        if use_prefix and prefix_refresh > 0:
            lp = problem.line_prefix
            prefix_new = lax.cond(
                ((s.k + 1) % prefix_refresh) == 0,
                lambda xn: prefix_cast(lp.init(xn, aux)),
                lambda xn: prefix_new,
                x_new,
            )
        return _State(
            k=s.k + 1, x=x_new, f=f_new, g=g_new, gnorm=gnorm_new,
            hist=hist, loss_h=loss_h, gnorm_h=gnorm_h,
            nf=s.nf + nf_add, ng=s.ng + ng_add,
            alpha_prev=alpha.astype(s.gnorm.dtype), prefix=prefix_new,
        )

    return body


def _finalize_state(s: _State, opts: LBFGSOptions) -> SolveResult:
    return finalize(s.x, s.k, s.gnorm < opts.tol, s.f, s.gnorm,
                    s.loss_h, s.gnorm_h, n_fevals=s.nf, n_gevals=s.ng)


def _build(problem: Problem, opts: LBFGSOptions):
    body = _make_body(problem, opts)

    def solve(x0, aux):
        aux = prepared_aux(problem, aux)
        s0 = _init_state(problem, opts, x0, aux)
        s = lax.while_loop(
            lambda s: _not_done(s, opts), lambda s: body(s, aux), s0
        )
        return _finalize_state(s, opts)

    return solve


class _ShardedEnv(NamedTuple):
    """Everything the mesh-mode drivers share: the tile-padded problem, the
    iteration body with the psum-reduced direction, the sharding-constraint
    re-annotator, and the padding geometry."""

    pp: Problem
    body: Callable
    constrain: Callable
    init: Callable  # (x0_unpadded, aux) -> constrained _State
    n: int
    n_pad: int


def _sharded_env(problem: Problem, opts: LBFGSOptions, mesh, axis: str,
                 n: int) -> _ShardedEnv:
    """Build the parameter-sharded solver environment for a fixed parameter
    count ``n`` (static). See :func:`_build_param_sharded` for the design;
    this factoring lets :func:`lbfgs_chunked` run the identical body in
    measured chunks (the history-exceeds-one-device scenario is
    exactly the long-run scenario that needs resume)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lbfgs_ffnn.ops.two_loop import (
        _pad_to, _round_up, two_loop_sharded, two_loop_sharded_compact,
    )

    ndev = mesh.shape[axis]
    vec_s = NamedSharding(mesh, P(axis))
    row_s = NamedSharding(mesh, P(None, axis, None))

    # "compact" under a mesh = the incremental-Gram form: the solver state
    # carries a GramRing (ring + replicated M = S.Y^T and per-slot y.y,
    # updated at each push) and the direction costs exactly two m-vector
    # psums instead of ~4m scalar ones (ops.two_loop.two_loop_sharded_compact).
    compact = opts.two_loop_impl == "compact"
    if compact:
        def direction(g, hist):
            return -two_loop_sharded_compact(g, hist, mesh, axis)

        push, reset, empty_hist = gram_push, gram_reset, gram_empty
    else:
        def direction(g, hist):
            return -two_loop_sharded(g, hist, mesh, axis)

        push, reset, empty_hist = ring_push, ring_reset, empty_history_state

    # A narrow (pair_dtype) ring pads its rows to the bf16 tile (16x128);
    # the iterate/gradient must share that padded length so the recursion's
    # per-shard axpys line up. Every partial dot promotes bf16 rows against
    # the f32 working shard BEFORE the psum, so accumulation is f32 on
    # every device (gamma's pair-x-pair dots upcast inside the core).
    pd = jnp.dtype(opts.pair_dtype) if opts.pair_dtype is not None else None
    n_pad = _round_up(n, 2048 if (pd is not None and pd.itemsize < 4) else 1024)
    # The ring is sharded over its TILE-ROW axis (rows = n_pad/128), so
    # the row count — not the raw padded length — must split evenly.
    if (n_pad // 128) % ndev:
        raise ValueError(
            f"tile-row count {n_pad // 128} (= padded params {n_pad} / "
            f"128) must be divisible by the mesh axis size {ndev}"
        )

    # The padded objective: evaluation sees the real n parameters;
    # gradients come back zero-padded so all solver axpys/dots operate
    # on even (n_pad,) shards. Padding lanes stay exactly zero through
    # every update (their gradient, direction, and step are zero).
    # The line restriction (line_fun / carried prefix) is wrapped
    # through the same slice-and-pad adapters, so the lean-trial
    # machinery survives the mesh mode instead of silently degrading
    # to full-objective trials.
    def fun_pad(w, aux):
        return problem.fun(w[:n], aux)

    def grad_pad(w, aux):
        return _pad_to(problem.grad(w[:n], aux), n_pad)

    def vag_pad(w, aux):
        f, g = problem.value_and_grad(w[:n], aux)
        return f, _pad_to(g, n_pad)

    line_fun_pad = None
    if problem.line_fun is not None:
        def line_fun_pad(w, p, aux, _lf=problem.line_fun):
            return _lf(w[:n], p[:n], aux)

    lp_pad = None
    if problem.line_prefix is not None:
        from lbfgs_ffnn.types import LinePrefix

        lp = problem.line_prefix
        if lp.vag_restrict is not None:
            def vag_restrict_pad(P, B, w, p, aux, _v=lp.vag_restrict):
                inner = _v(P, B, w[:n], p[:n], aux)

                def call(alpha):
                    f, g = inner(alpha)
                    return f, _pad_to(g, n_pad)

                return call
        else:
            vag_restrict_pad = None
        if lp.vag_restrict_carry is not None:
            def vag_carry_pad(P, B, w, p, aux, _v=lp.vag_restrict_carry):
                inner = _v(P, B, w[:n], p[:n], aux)

                def call(alpha):
                    f, g, P_new = inner(alpha)
                    return f, _pad_to(g, n_pad), P_new

                return call
        else:
            vag_carry_pad = None
        lp_pad = LinePrefix(
            init=lambda w, aux, _i=lp.init: _i(w[:n], aux),
            direction=lambda p, aux, _d=lp.direction: _d(p[:n], aux),
            restrict=lambda P, B, w, p, aux, _r=lp.restrict: _r(
                P, B, w[:n], p[:n], aux
            ),
            vag_restrict=vag_restrict_pad,
            vag_restrict_carry=vag_carry_pad,
        )

    pp = Problem(fun=fun_pad, grad=grad_pad, value_and_grad=vag_pad,
                 line_fun=line_fun_pad, line_prefix=lp_pad)
    body = _make_body(pp, opts, direction=direction, push=push, reset=reset)

    def constrain_hist(h):
        row = lambda a: lax.with_sharding_constraint(a, row_s)
        if isinstance(h, GramRing):  # M/yy stay replicated
            return h._replace(ring=h.ring._replace(S=row(h.ring.S), Y=row(h.ring.Y)))
        return h._replace(S=row(h.S), Y=row(h.Y))

    def constrain(s: _State) -> _State:
        sh = lambda a: lax.with_sharding_constraint(a, vec_s)
        return s._replace(x=sh(s.x), g=sh(s.g), hist=constrain_hist(s.hist))

    def init(x0, aux):
        x0p = lax.with_sharding_constraint(_pad_to(x0, n_pad), vec_s)
        return constrain(_init_state(pp, opts, x0p, aux, empty_hist=empty_hist))

    return _ShardedEnv(pp=pp, body=body, constrain=constrain, init=init,
                       n=n, n_pad=n_pad)


def _build_param_sharded(problem: Problem, opts: LBFGSOptions, mesh, axis: str):
    """Parameter-sharded L-BFGS: the model axis of every large vector — the
    iterate, gradient, direction, and the (S, Y) curvature ring — is sharded
    over ``mesh``; scalars (f, alpha, rho, gamma, ring indices, histories)
    stay replicated. Every inner product of the two-loop recursion is a
    per-shard partial dot + one ``psum`` over the mesh (``two_loop_sharded``);
    line-search and update axpys stay shard-local (GSPMD keeps elementwise
    ops on the operands' sharding). This is the model-parallel complement of
    the batch-sharded gradient path, for when the m x n curvature history
    exceeds one device's memory — no reference counterpart (it is single-device
    only); SURVEY.md §2.6's parameter-axis ambition.

    The solver runs in padded parameter space (n rounded up to the ring's
    row padding, 1024 or 2048), so shards are even; the
    objective sees the unpadded slice and gradients are zero-padded back.
    """

    def solve(x0, aux):
        aux = prepared_aux(problem, aux)
        env = _sharded_env(problem, opts, mesh, axis, x0.shape[0])
        s0 = env.init(x0, aux)
        s = lax.while_loop(
            lambda s: _not_done(s, opts),
            lambda s: env.constrain(env.body(s, aux)), s0
        )
        res = _finalize_state(s, opts)
        return res._replace(x=res.x[: env.n])

    return solve


@functools.lru_cache(maxsize=256)
def _cached_param_sharded(problem, opts, mesh, axis):
    return jax.jit(_build_param_sharded(problem, opts, mesh, axis))


def lbfgs(
    problem: Problem,
    x0: jax.Array,
    aux: Any = (),
    opts: LBFGSOptions | None = None,
    mesh=None,
    shard_axis: str = "model",
) -> SolveResult:
    """Run L-BFGS. With ``mesh`` set, solver state is parameter-sharded over
    ``mesh.shape[shard_axis]`` devices (see :func:`_build_param_sharded`);
    the trajectory matches the single-device run up to float rounding of the
    psum-reduced inner products."""
    opts = opts or LBFGSOptions()
    if mesh is not None:
        return _cached_param_sharded(problem, opts, mesh, shard_axis)(x0, aux)
    return cached_jit_solve(_build, problem, opts)(x0, aux)


# ---------------------------------------------------------------------------
# Chunked driver: measured per-chunk wall time + host callback
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def _cached_chunk_fns(problem, opts, chunk: int):
    def init(x0, aux):
        return _init_state(problem, opts, x0, prepared_aux(problem, aux))

    body = _make_body(problem, opts)

    def run_chunk(state, aux):
        aux = prepared_aux(problem, aux)
        # A bounded while_loop, NOT scan+cond: a cond's identity branch
        # copies the whole carry (histories + the m x n ring) every step,
        # measured ~2.5x slower per iteration than the plain solve. This
        # body is bit-identical to the full solve's.
        k_end = state.k + chunk
        return lax.while_loop(
            lambda s: _not_done(s, opts) & (s.k < k_end),
            lambda s: body(s, aux),
            state,
        )

    return jax.jit(init), jax.jit(run_chunk)


@functools.lru_cache(maxsize=256)
def _cached_chunk_fns_sharded(problem, opts, mesh, axis, n: int, chunk: int):
    """Mesh-mode chunk functions: the identical parameter-sharded body as
    :func:`_build_param_sharded`, run in bounded-while chunks. ``n`` (the
    unpadded parameter count) is part of the cache key because the padding
    adapters close over it."""
    env = _sharded_env(problem, opts, mesh, axis, n)

    def init(x0, aux):
        return env.init(x0, prepared_aux(problem, aux))

    def run_chunk(state, aux):
        aux = prepared_aux(problem, aux)
        k_end = state.k + chunk
        return lax.while_loop(
            lambda s: _not_done(s, opts) & (s.k < k_end),
            lambda s: env.constrain(env.body(s, aux)),
            state,
        )

    return jax.jit(init), jax.jit(run_chunk), env


def lbfgs_chunked(
    problem: Problem,
    x0: Optional[jax.Array],
    aux: Any = (),
    opts: LBFGSOptions | None = None,
    chunk: int = 10,
    callback: Optional[Callable[[_State, float], None]] = None,
    resume_state: Optional[_State] = None,
    mesh=None,
    shard_axis: str = "model",
    n_params: Optional[int] = None,
) -> tuple[SolveResult, "jnp.ndarray"]:
    """Run L-BFGS in jitted ``chunk``-iteration pieces.

    Returns ``(result, time_ms)`` where ``time_ms[i]`` is the *measured*
    cumulative wall time after iteration ``i`` (at chunk granularity,
    excluding compile) — the honest version of the reference's per-iteration
    timestamps. ``callback(state, elapsed_s)`` fires after each chunk (use
    for live logging or checkpointing via lbfgs_ffnn.checkpoint).

    ``resume_state`` continues from a previously checkpointed chunk state
    (the full carry: iterate, gradient, curvature ring, histories), so a
    long solve can be killed and resumed with its quasi-Newton memory intact
    — a capability the reference lacks entirely (SURVEY.md §5). On resume
    ``x0`` may be ``None`` (only the checkpoint is needed); time_ms entries
    for the pre-kill iterations stay NaN — they were not measured here.

    The carried line prefix is a *derived* field (prefix == line_prefix.init
    (x, aux) up to rounding), so on resume it is recomputed from the
    restored iterate rather than trusted from the checkpoint — a checkpoint
    written by an older release (or migrated with template-filled fields,
    see ``checkpoint.restore_checkpoint``) can therefore never resume with a
    stale prefix silently corrupting every subsequent line-search trial.

    ``mesh`` runs the *parameter-sharded* body (identical to
    ``lbfgs(mesh=...)``) in measured chunks, so a run whose curvature
    history exceeds one chip can be timed and kill-and-resumed like any
    other. A mesh-mode ``resume_state`` carries the TILE-PADDED iterate, so
    resuming without ``x0`` requires ``n_params`` (the unpadded parameter
    count); the restored state re-shards onto the current mesh through the
    body's sharding constraints — the checkpoint itself is layout-free.
    """
    opts = opts or LBFGSOptions()
    if resume_state is None and x0 is None:
        raise ValueError("x0 is required unless resume_state is given")
    if mesh is not None:
        if x0 is not None:
            n = int(x0.shape[0])
        elif n_params is not None:
            n = int(n_params)
        else:
            raise ValueError(
                "mesh-mode resume needs n_params (resume_state.x is "
                "tile-padded; the unpadded count cannot be inferred)"
            )
        init, run_chunk, env = _cached_chunk_fns_sharded(
            problem, opts, mesh, shard_axis, n, chunk
        )
        prefix_problem = env.pp
    else:
        init, run_chunk = _cached_chunk_fns(problem, opts, chunk)
        prefix_problem = problem

    state = resume_state if resume_state is not None else init(x0, aux)
    if resume_state is not None and _use_prefix(problem, opts):
        # Jitted so a mesh-mode resume works on a sharded (possibly
        # non-fully-addressable multi-host) iterate — eager slicing/matmul
        # on such an array would raise before the first chunk, and even
        # single-host it would run a full (batch, d1) matmul unjitted.
        # Prepared aux so the re-init reads the SAME input copy the chunks
        # do (e.g. the bf16 line_input copy) — a raw-f32 re-init would
        # shift trial values by one operand rounding vs the in-run prefix. One extra compile per resume; resume happens once per run.
        prefix_init = jax.jit(
            lambda xx, au: _prefix_cast(opts)(
                prefix_problem.line_prefix.init(xx, prepared_aux(problem, au))
            )
        )
        state = state._replace(prefix=prefix_init(state.x, aux))
    state, time_ms = drive_chunks(
        run_chunk, state, (aux,), opts.max_iters,
        counter=lambda s: int(s.k),
        done=lambda s: float(s.gnorm) < opts.tol,
        sync=lambda s: s.f,
        callback=callback,
    )
    res = _finalize_state(state, opts)
    if mesh is not None:
        res = res._replace(x=res.x[: env.n])
    return res, time_ms
