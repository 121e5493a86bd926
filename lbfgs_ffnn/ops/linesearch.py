"""Line searches as jit-compatible ``lax.while_loop``s.

Two families, matching the reference's two backends behaviorally:

* :func:`wolfe_line_search` — bracketing bisection satisfying the (weak)
  Wolfe conditions; same accept/expand/bisect policy as the reference CPU
  search (reference: src/minimizer/full_batch_minimizer.hpp:126-157,
  c1=1e-4, c2=0.9, rho=0.5, <=50 trials).
* :func:`armijo_quad_line_search` — Armijo backtracking with safeguarded
  quadratic interpolation; same policy as the reference CUDA search
  (reference: src/cuda/lbfgs.cuh:108-147), including keeping the *last
  evaluated* trial point when no trial satisfies Armijo.

Unlike the reference, the entire search compiles into the enclosing jitted
solver — there is no host round-trip per trial. The Wolfe search evaluates
loss and gradient together in one fused forward+backward per trial (its
curvature test needs the gradient); the Armijo search can instead run
forward-only trials and take a single ``value_and_grad`` at the chosen point
(pass ``value=``), since its accept test needs only the loss.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class LineSearchResult(NamedTuple):
    alpha: jax.Array       # accepted (or last-evaluated) step length
    ok: jax.Array          # bool: did any trial satisfy the accept test?
    evaluated: jax.Array   # bool: do f_new/g_new correspond to `alpha`?
    f_new: jax.Array       # loss at x + alpha*p   (valid iff evaluated)
    g_new: jax.Array       # grad at x + alpha*p   (valid iff evaluated)
    # objective evaluations performed (plain-int default: a jnp default here
    # would initialize the JAX backend at import time, before callers can
    # select a platform)
    n_trials: jax.Array | int = 0
    # opaque accept-point carry from ``vag_carry_along`` (e.g. the solver's
    # next line prefix, already computed inside the accept evaluation); ()
    # when no carry-producing evaluator was supplied
    carry: Any = ()


def wolfe_line_search(
    value_and_grad: Callable[..., tuple[jax.Array, jax.Array]],
    x: jax.Array,
    p: jax.Array,
    f0: jax.Array,
    dg0: jax.Array,
    aux: Any = (),
    *,
    c1: float = 1e-4,
    c2: float = 0.9,
    shrink: float = 0.5,
    max_iters: int = 50,
    alpha0: jax.Array | float = 1.0,
    value: Callable[..., jax.Array] | None = None,
    value_along: Callable[[jax.Array], jax.Array] | None = None,
    vag_along: Callable[[jax.Array], tuple] | None = None,
) -> LineSearchResult:
    """Bracketing bisection Wolfe search.

    Policy (per trial at step ``alpha``):
      * Armijo fails (``f(x+ap) > f0 + c1*a*dg0``): bracket above,
        ``alpha = shrink*(lo+hi)``.
      * Curvature fails (``g(x+ap)·p < c2*dg0``): bracket below; double
        ``alpha`` while unbracketed, else bisect.
      * Both hold: accept.
    If no trial is accepted within ``max_iters``, returns the last *updated*
    alpha unevaluated (``evaluated=False``), matching the reference which
    returns the post-update alpha after exhausting trials.

    When ``value`` (loss-only) is supplied, each trial computes
    ``(f, df/dalpha)`` with one forward-mode ``jax.jvp`` along ``p`` — the
    directional derivative is exactly the ``g·p`` the curvature test needs —
    at roughly half the cost of a fused forward+backward, and the full
    gradient is produced by a single ``value_and_grad`` at the accepted
    point. Mathematically the same trial sequence (``jvp`` computes the same
    inner product; last-ulp rounding may differ). Worth it only when
    searches typically take several trials (e.g. PINN plateaus); a
    one-trial-dominated run (e.g. MNIST-5k Wolfe) is faster fused.

    ``value_along`` (a precomputed restriction ``alpha -> f(x + alpha*p)``,
    see ``Problem.line_fun``) replaces the lean trial's full forward with the
    structure-exploiting one; the directional derivative is then the scalar
    jvp d/dalpha of that restriction. Requires ``value`` mode (ignored when
    fused).
    """
    dtype = x.dtype
    inf = jnp.array(jnp.inf, dtype=dtype)
    fused = value is None

    class _C(NamedTuple):
        i: jax.Array
        alpha: jax.Array
        lo: jax.Array
        hi: jax.Array
        ok: jax.Array
        f_new: jax.Array
        g_new: jax.Array

    c0 = _C(
        i=jnp.int32(0),
        alpha=jnp.asarray(alpha0, dtype=dtype),
        lo=jnp.zeros((), dtype=dtype),
        hi=inf,
        ok=jnp.array(False),
        f_new=f0,
        g_new=jnp.zeros_like(x) if fused else jnp.zeros((0,), dtype=dtype),
    )

    def cond(c: _C):
        return (c.i < max_iters) & ~c.ok

    def body(c: _C) -> _C:
        x_new = x + c.alpha * p
        if fused:
            f_new, g_new = value_and_grad(x_new, aux)
            dg_new = jnp.vdot(g_new, p)
        elif value_along is not None:
            f_new, dg_new = jax.jvp(
                value_along, (c.alpha,), (jnp.ones_like(c.alpha),)
            )
            g_new = c.g_new
        else:
            f_new, dg_new = jax.jvp(lambda u: value(u, aux), (x_new,), (p,))
            g_new = c.g_new
        armijo_fail = f_new > f0 + c1 * c.alpha * dg0
        curv_fail = dg_new < c2 * dg0

        ok = ~armijo_fail & ~curv_fail
        # Armijo failure: shrink into [lo, alpha].
        hi_a = c.alpha
        alpha_a = shrink * (c.lo + hi_a)
        # Curvature failure: expand or bisect [alpha, hi].
        lo_c = c.alpha
        alpha_c = jnp.where(jnp.isinf(c.hi), c.alpha * 2.0, shrink * (lo_c + c.hi))

        alpha = jnp.where(ok, c.alpha, jnp.where(armijo_fail, alpha_a, alpha_c))
        lo = jnp.where(ok | armijo_fail, c.lo, lo_c)
        hi = jnp.where(ok | ~armijo_fail, c.hi, hi_a)
        return _C(i=c.i + 1, alpha=alpha, lo=lo, hi=hi, ok=ok, f_new=f_new, g_new=g_new)

    c = lax.while_loop(cond, body, c0)
    if fused:
        f_new, g_new = c.f_new, c.g_new
    else:
        # Full gradient only at the accepted point; on failure the caller
        # re-evaluates at the (unevaluated) post-update alpha itself, so skip
        # the extra pass entirely.
        def at_accept(_):
            if vag_along is not None:
                return c.f_new, vag_along(c.alpha)[1]
            return c.f_new, value_and_grad(x + c.alpha * p, aux)[1]

        def skip(_):
            return c.f_new, jnp.zeros_like(x)

        f_new, g_new = lax.cond(c.ok, at_accept, skip, None)
    return LineSearchResult(alpha=c.alpha, ok=c.ok, evaluated=c.ok,
                            f_new=f_new, g_new=g_new, n_trials=c.i)


def armijo_batched_line_search(
    value_and_grad: Callable[..., tuple[jax.Array, jax.Array]],
    x: jax.Array,
    p: jax.Array,
    f0: jax.Array,
    dg0: jax.Array,
    aux: Any = (),
    *,
    value: Callable[..., jax.Array],
    c1: float = 1e-4,
    shrink: float = 0.5,
    max_iters: int = 20,
    alpha0: jax.Array | float = 1.0,
    spec_k: int = 4,
    value_along: Callable[[jax.Array], jax.Array] | None = None,
    vag_along: Callable[[jax.Array], tuple] | None = None,
    vag_carry_along: Callable[[jax.Array], tuple] | None = None,
) -> LineSearchResult:
    """Speculative batched Armijo backtracking (no reference
    counterpart).

    ``vag_carry_along`` (preferred over ``vag_along`` when given) returns
    ``(f, g, carry)`` at the accept point; the carry is handed back in
    ``LineSearchResult.carry`` (see LinePrefix.vag_restrict_carry).

    Evaluates ``spec_k`` ladder candidates ``alpha0 * shrink**j`` per round
    in ONE batched forward — ``vmap`` over stacked trial weight vectors
    turns the per-candidate GEMMs into a single batched GEMM whose
    activations amortize the input read. Accepts the largest
    candidate satisfying Armijo — exactly the sequential pure-backtracking
    (no interpolation) accept point, found in ``ceil/spec_k`` as many
    dispatch rounds. On total failure keeps the last (smallest) evaluated
    candidate with ``ok=False``, mirroring the sequential policy's failure
    semantics. ``n_trials`` counts every speculated evaluation.

    On the MNIST 60k L-BFGS headline, with a plain objective the ladder
    needs more trials than the sequential search's quadratic interpolation
    (~16 vs ~13.7 per iteration), cancelling the batching discount; with a
    line restriction (``value_along`` from ``Problem.line_fun``) the
    per-round A/B reads amortize across all spec_k candidates. Whether
    that pays on the GPU is not measured yet (ROADMAP A4).
    """
    dtype = x.dtype
    K = int(spec_k)
    n_rounds = max(1, -(-max_iters // K))
    alpha0 = jnp.asarray(alpha0, dtype=dtype)
    ladder = shrink ** jnp.arange(K, dtype=dtype)  # within-round factors

    if value_along is not None:
        batched_value = jax.vmap(value_along)
    else:
        batched_value = jax.vmap(lambda a: value(x + a * p, aux))

    class _C(NamedTuple):
        r: jax.Array
        ok: jax.Array
        alpha: jax.Array   # accepted (or last-evaluated) alpha
        f_new: jax.Array
        trials: jax.Array

    c0 = _C(
        r=jnp.int32(0),
        ok=jnp.array(False),
        alpha=alpha0,
        f_new=f0,
        trials=jnp.int32(0),
    )

    def cond(c: _C):
        return (c.r < n_rounds) & ~c.ok

    def body(c: _C) -> _C:
        alphas = alpha0 * (shrink ** (c.r * K).astype(dtype)) * ladder
        fs = batched_value(alphas)
        passed = fs <= f0 + c1 * alphas * dg0
        any_pass = jnp.any(passed)
        first = jnp.argmax(passed)  # alphas descend, so first pass = largest
        idx = jnp.where(any_pass, first, K - 1)
        return _C(
            r=c.r + 1,
            ok=any_pass,
            alpha=alphas[idx],
            f_new=fs[idx],
            trials=c.trials + jnp.int32(K),  # every speculated candidate ran
        )

    c = lax.while_loop(cond, body, c0)
    carry = ()
    if vag_carry_along is not None:
        f_new, g_new, carry = vag_carry_along(c.alpha)
    elif vag_along is not None:
        f_new, g_new = vag_along(c.alpha)
    else:
        f_new, g_new = value_and_grad(x + c.alpha * p, aux)
    return LineSearchResult(
        alpha=c.alpha, ok=c.ok, evaluated=jnp.array(True),
        f_new=f_new, g_new=g_new, n_trials=c.trials, carry=carry,
    )


def armijo_quad_line_search(
    value_and_grad: Callable[..., tuple[jax.Array, jax.Array]],
    x: jax.Array,
    p: jax.Array,
    f0: jax.Array,
    dg0: jax.Array,
    aux: Any = (),
    *,
    c1: float = 1e-4,
    shrink: float = 0.5,
    max_iters: int = 20,
    alpha0: jax.Array | float = 1.0,
    value: Callable[..., jax.Array] | None = None,
    value_along: Callable[[jax.Array], jax.Array] | None = None,
    vag_along: Callable[[jax.Array], tuple] | None = None,
    vag_carry_along: Callable[[jax.Array], tuple] | None = None,
) -> LineSearchResult:
    """Armijo backtracking with safeguarded quadratic interpolation.

    ``vag_carry_along`` (preferred over ``vag_along`` when given) returns
    ``(f, g, carry)`` at the accept point; the carry is handed back in
    ``LineSearchResult.carry`` (see LinePrefix.vag_restrict_carry).

    Per trial: evaluate at ``alpha``; if Armijo holds, accept. Otherwise
    propose the minimizer of the quadratic fit
    ``a* = -dg0*a^2 / (2*(f_new - f0 - dg0*a))`` and take it if it lies in
    ``[0.1a, 0.9a]``; else ``a *= shrink``. When every trial fails, the result
    carries the last *evaluated* alpha with ``ok=False`` (the reference keeps
    the parameters at that trial point and resets the curvature history).

    When ``value`` (loss-only) is supplied, trials run forward-only — the
    accept test and the quadratic fit need nothing but loss values — and one
    ``value_and_grad`` at the chosen point produces the returned ``f_new`` /
    ``g_new``. The trial sequence is identical to the fused variant, but a
    backtracking-heavy iteration costs ``trials*fwd + (fwd+bwd)`` instead of
    ``trials*(fwd+bwd)`` — the dominant late-iteration saving on large
    full-batch objectives. (The reference cannot do this: its single
    ``LossGradFun`` callback always computes both,
    reference: src/cuda/minimizer_base.cuh:15-16.)

    ``value_along`` (a precomputed restriction ``alpha -> f(x + alpha*p)``,
    see ``Problem.line_fun``) further replaces each trial's full forward
    with the structure-exploiting one. Requires ``value`` mode.
    """
    dtype = x.dtype
    fused = value is None
    trial_f = value_and_grad if fused else value

    class _C(NamedTuple):
        i: jax.Array
        alpha_next: jax.Array  # alpha to evaluate next
        alpha_eval: jax.Array  # last evaluated alpha
        ok: jax.Array
        f_new: jax.Array
        g_new: jax.Array

    c0 = _C(
        i=jnp.int32(0),
        alpha_next=jnp.asarray(alpha0, dtype=dtype),
        alpha_eval=jnp.asarray(alpha0, dtype=dtype),
        ok=jnp.array(False),
        f_new=f0,
        g_new=jnp.zeros_like(x) if fused else jnp.zeros((0,), dtype=dtype),
    )

    def cond(c: _C):
        return (c.i < max_iters) & ~c.ok

    def body(c: _C) -> _C:
        a = c.alpha_next
        x_new = x + a * p
        if fused:
            f_new, g_new = trial_f(x_new, aux)
        elif value_along is not None:
            f_new, g_new = value_along(a), c.g_new
        else:
            f_new, g_new = trial_f(x_new, aux), c.g_new
        ok = f_new <= f0 + c1 * a * dg0

        denom = 2.0 * (f_new - f0 - dg0 * a)
        a_quad = -(dg0 * a * a) / jnp.where(denom == 0.0, jnp.ones_like(denom), denom)
        quad_ok = (jnp.abs(denom) > 1e-20) & (a_quad >= 0.1 * a) & (a_quad <= 0.9 * a)
        a_next = jnp.where(quad_ok, a_quad, a * shrink)

        return _C(
            i=c.i + 1,
            alpha_next=jnp.where(ok, a, a_next),
            alpha_eval=a,
            ok=ok,
            f_new=f_new,
            g_new=g_new,
        )

    c = lax.while_loop(cond, body, c0)
    carry = ()
    if fused:
        f_new, g_new = c.f_new, c.g_new
    elif vag_carry_along is not None:
        f_new, g_new, carry = vag_carry_along(c.alpha_eval)
    elif vag_along is not None:
        f_new, g_new = vag_along(c.alpha_eval)
    else:
        f_new, g_new = value_and_grad(x + c.alpha_eval * p, aux)
    # alpha_eval was always evaluated (max_iters >= 1).
    return LineSearchResult(
        alpha=c.alpha_eval,
        ok=c.ok,
        evaluated=jnp.array(True) if max_iters >= 1 else jnp.array(False),
        f_new=f_new,
        g_new=g_new,
        n_trials=c.i,
        carry=carry,
    )
