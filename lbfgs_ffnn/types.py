"""Core problem / result types.

The reference expresses objectives as opaque std::function closures
(``VecFun``/``GradFun``/``HessFun``, reference: src/common.hpp:32-38, and the
batch callbacks ``BatchGradFun``/``BatchLossFun``,
reference: src/minimizer/s_lbfgs.hpp:37-38). Here an objective is a pytree of
pure callables ``fun(w, aux) -> scalar``; gradients default to ``jax.grad``
and Hessian-vector products to exact ``jax.jvp`` instead of the reference's
hand-rolled backprop and finite differences.

``aux`` is an arbitrary pytree of traced operands (e.g. the training set)
threaded through the jitted solve so that data is a runtime input rather than
a baked-in constant.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


# Largest parameter count for which make_problem's *default* dense
# jax.hessian is allowed to materialize (8k^2 f64 = 512 MB). Problems above
# this must supply an explicit `hess` or use matrix-free Newton-CG.
DENSE_HESSIAN_LIMIT = 8192


class LinePrefix(NamedTuple):
    """Carried line-restriction protocol for problems whose objective has a
    parameter-linear prefix (e.g. an MLP's first-layer preactivation).

    ``init(w, aux) -> P`` computes the prefix at the current iterate;
    ``direction(p, aux) -> B`` its directional increment; the restriction
    ``restrict(P, B, w, p, aux)(alpha)`` equals ``fun(w + alpha*p, aux)`` up
    to rounding. Because the prefix is linear in ``w``, accepting a step
    ``alpha`` updates it exactly as ``P <- P + alpha * B`` (an elementwise
    axpy the solver performs with ``jax.tree_util.tree_map``) — the ``init``
    matmul runs once per solve, not once per iteration. f32 drift of the
    accumulated prefix is ~sqrt(iters)*eps (rounding-noise level). It
    influences line-search trial values and — when ``vag_restrict`` is used
    (``LBFGSOptions(prefix_vag=True)``, the default) — the accepted point's
    loss and gradient as well. Set ``prefix_vag=False`` to keep the accepted
    point's ``value_and_grad`` fresh (trajectory anchored to the exact
    objective) at the cost of recomputing the prefix matmul each iteration.
    """

    init: Callable[..., Any]
    direction: Callable[..., Any]
    restrict: Callable[..., Callable[[jax.Array], jax.Array]]
    # Optional: ``vag_restrict(P, B, w, p, aux)(alpha) -> (loss, grad)`` —
    # the full value_and_grad at ``w + alpha*p`` computed FROM the prefix
    # (the forward never recomputes the prefix matmul; only the backward
    # touches the raw input once). Carries the prefix's f32 drift into the
    # gradient at rounding-noise level (~sqrt(iters)*eps relative) — see
    # the class docstring; opt out with LBFGSOptions(prefix_vag=False).
    vag_restrict: Optional[Callable[..., Callable]] = None
    # Optional: ``vag_restrict_carry(P, B, w, p, aux)(alpha) ->
    # (loss, grad, P_new)`` — vag_restrict that ADDITIONALLY returns the
    # post-step prefix ``P_new = P + alpha*B`` it already computed for its
    # own forward (the MLP's z1, which the relu backward keeps as a
    # residual anyway). Letting the solver reuse it as the next carried
    # prefix deletes the separate accept-time axpy over the (batch, d1)
    # prefix — read P, read B, write P — entirely (same arithmetic
    # expression, so the carried value is unchanged). Used by the armijo
    # line-search paths when present; wolfe keeps the explicit axpy.
    vag_restrict_carry: Optional[Callable[..., Callable]] = None


class Problem(NamedTuple):
    """A smooth unconstrained objective for full-batch solvers.

    All callables take ``(w, aux)`` where ``w`` is the flat parameter vector
    and ``aux`` is a pytree of extra operands (possibly ``()``).
    """

    fun: Callable[..., jax.Array]
    grad: Callable[..., jax.Array]
    value_and_grad: Callable[..., tuple[jax.Array, jax.Array]]
    hess: Optional[Callable[..., jax.Array]] = None
    # Optional line-restriction factory: ``line_fun(w, p, aux)`` returns a
    # callable ``alpha -> fun(w + alpha*p, aux)`` that may exploit structure
    # to make repeated evaluations along a FIXED direction cheap (e.g. the
    # MLP objective precomputes the first-layer preactivation's affine
    # decomposition A + alpha*B, so line-search trials skip re-reading the
    # input matrix — the dominant HBM cost). Must agree with ``fun`` up to
    # float rounding. Solvers fall back to ``fun`` when None.
    line_fun: Optional[Callable[..., Callable[[jax.Array], jax.Array]]] = None
    # Optional carried form of the same restriction (see LinePrefix): lets a
    # solver keep the w-dependent precomputation (the MLP's A = x@W1 + b1)
    # in its loop state and update it for free via A <- A + alpha*B instead
    # of recomputing a big matmul every iteration. L-BFGS uses it when
    # present; other solvers fall back to line_fun.
    line_prefix: Optional["LinePrefix"] = None
    # Optional one-time aux preparation ``prepare(aux) -> aux``: applied by
    # the full-batch solvers ONCE at the start of each jitted solve (and
    # once per chunk in the chunked drivers), before any other callable sees
    # ``aux``. Use for derived operands that must not be recomputed every
    # iteration — e.g. the MLP's bfloat16 input copy for the backward's
    # dW1 GEMM (grad_input_dtype), cast once instead of per accept-eval.
    # All other callables must accept both the raw and the prepared shape.
    prepare: Optional[Callable[[Any], Any]] = None

    def hvp(self, w: jax.Array, v: jax.Array, aux: Any = ()) -> jax.Array:
        """Exact Hessian-vector product via forward-over-reverse jvp."""
        return jax.jvp(lambda u: self.grad(u, aux), (w,), (v,))[1]


class BatchProblem(NamedTuple):
    """A finite-sum objective exposed through per-batch callables.

    Mirrors the reference's stochastic contract — a loss and gradient over a
    set of sample indices (reference: src/minimizer/s_lbfgs.hpp:37-38) — but
    the callables here take a *batch of data* ``(w, xb, yb)`` directly and the
    index gather lives in ``take_batch``, so the hot path is pure GEMM work.

    ``fun_masked``/``grad_masked`` additionally take a ``(b,)`` 0/1 mask and
    average over the unmasked samples only — used for ragged trailing batches
    under jit's static shapes (the reference's CUDA SGD handles the trailing
    batch with a smaller dynamic launch, src/cuda/sgd.cuh:103-108).
    """

    fun: Callable[..., jax.Array]  # (w, xb, yb) -> scalar mean loss (+reg)
    grad: Callable[..., jax.Array]  # (w, xb, yb) -> flat grad of fun
    value_and_grad: Callable[..., tuple[jax.Array, jax.Array]]
    fun_masked: Callable[..., jax.Array]  # (w, xb, yb, mask) -> scalar
    grad_masked: Callable[..., jax.Array]
    per_sample: Callable[..., jax.Array]  # (w, xb, yb) -> (b,) losses, no reg
    reg: Optional[Callable[..., jax.Array]] = None  # (w,) -> scalar, or None

    def hvp(self, w: jax.Array, v: jax.Array, xb: jax.Array, yb: jax.Array) -> jax.Array:
        """Exact HVP of the batch loss (replaces the reference's central
        finite-difference HVP, src/minimizer/s_lbfgs.hpp:88-101)."""
        return jax.jvp(lambda u: self.grad(u, xb, yb), (w,), (v,))[1]

    def fd_hvp(
        self, w: jax.Array, v: jax.Array, xb: jax.Array, yb: jax.Array, eps: float = 1e-4
    ) -> jax.Array:
        """Central finite-difference HVP — exact behavioral mirror of the
        reference helper (src/minimizer/s_lbfgs.hpp:88-101), kept for parity
        testing against the exact ``hvp``."""
        gp = self.grad(w + eps * v, xb, yb)
        gm = self.grad(w - eps * v, xb, yb)
        return (gp - gm) / (2.0 * eps)


class SolveResult(NamedTuple):
    """Outcome of a solver run.

    ``loss_history`` / ``gnorm_history`` are fixed-shape ``(max_iters,)``
    arrays padded with NaN past ``n_iters`` — the functional mirror of the
    reference's IterationRecorder (reference: src/iteration_recorder.hpp).
    """

    x: jax.Array
    n_iters: jax.Array  # int32 number of iterations performed
    converged: jax.Array  # bool
    final_loss: jax.Array
    final_gnorm: jax.Array
    loss_history: jax.Array
    gnorm_history: jax.Array
    metric_history: Optional[jax.Array] = None  # e.g. per-epoch accuracy
    # Evaluation counters (scipy-style nfev/njev; the reference has no
    # equivalent). A forward-mode jvp trial counts as one feval.
    n_fevals: Optional[jax.Array] = None  # objective (forward) evaluations
    n_gevals: Optional[jax.Array] = None  # full-gradient evaluations
    # Matrix-free work counters (exact, carried through the solve loops):
    n_hevals: Optional[jax.Array] = None  # Hessian-vector products (Newton-CG)
    n_matvecs: Optional[jax.Array] = None  # Krylov operator applications
                                           # (BFGS cg/gmres linear solves)


def prepared_aux(problem: "Problem", aux: Any) -> Any:
    """Apply the problem's one-time aux preparation (identity when absent).
    Solvers call this at the top of each jitted solve / chunk program."""
    prep = getattr(problem, "prepare", None)
    return prep(aux) if prep is not None else aux


def make_problem(
    fun: Callable[..., jax.Array],
    grad: Optional[Callable[..., jax.Array]] = None,
    hess: Optional[Callable[..., jax.Array]] = None,
    line_fun: Optional[Callable[..., Callable]] = None,
    line_prefix: Optional[LinePrefix] = None,
    prepare: Optional[Callable[[Any], Any]] = None,
) -> Problem:
    """Build a :class:`Problem` from a scalar objective ``fun(w, aux)``.

    Analytic ``grad``/``hess`` may be supplied (as the reference's test suite
    does, reference: tests/main.cpp:71-156); otherwise autodiff is used.
    """
    if grad is None:
        grad = jax.grad(fun)
        value_and_grad = jax.value_and_grad(fun)
    else:
        def value_and_grad(w, aux=(), _f=fun, _g=grad):
            return _f(w, aux), _g(w, aux)

    if hess is None:
        _dense_hess = jax.hessian(fun)

        def hess(w, aux=(), _h=_dense_hess):
            # Fail fast instead of materializing an n^2 Hessian for
            # MLP-sized problems (e.g. 101k params -> 41 GB f32). The
            # reference's Newton likewise requires an explicit HessFun
            # (reference: src/minimizer/newton.hpp:25). Shape is static, so
            # this raises at trace time, before any allocation.
            n = int(w.shape[0])
            if n > DENSE_HESSIAN_LIMIT:
                raise ValueError(
                    f"default dense jax.hessian refused for n={n} > "
                    f"{DENSE_HESSIAN_LIMIT} parameters (would materialize an "
                    f"n^2 = {n * n:,}-element matrix). Pass an analytic/"
                    "structured `hess` to make_problem, or use the "
                    "matrix-free Newton-CG path: NewtonOptions(hess_mode="
                    "'hvp_cg') solves (H + mu I) p = -g with CG over exact "
                    "Hessian-vector products (Problem.hvp) and never forms H."
                )
            return _h(w, aux)
    if line_fun is None and line_prefix is not None:
        # The per-call restriction is derivable from the carried protocol.
        def line_fun(w, p, aux, _lp=line_prefix):
            return _lp.restrict(_lp.init(w, aux), _lp.direction(p, aux), w, p, aux)
    return Problem(fun=fun, grad=grad, value_and_grad=value_and_grad,
                   hess=hess, line_fun=line_fun, line_prefix=line_prefix,
                   prepare=prepare)


def make_batch_problem(
    per_sample: Callable[..., jax.Array],
    reg: Optional[Callable[..., jax.Array]] = None,
) -> BatchProblem:
    """Build a :class:`BatchProblem` from a per-sample loss.

    ``per_sample(w, xb, yb) -> (b,)`` individual losses; ``reg(w)`` an
    optional whole-parameter regularizer added to every batch loss (the
    reference S-LBFGS training adds 0.5*lam*||w||^2 this way,
    src/unified_optimization.hpp:375,398).
    """

    def fun(w, xb, yb):
        loss = jnp.mean(per_sample(w, xb, yb))
        return loss + reg(w) if reg is not None else loss

    def fun_masked(w, xb, yb, mask):
        # Zero the padded rows before per_sample: a `where` on the loss alone
        # protects the forward, but the VJP's zero cotangent times a NaN
        # activation is still NaN, so grad_masked needs clean inputs too.
        xb = zero_masked_rows(mask, xb)
        yb = zero_masked_rows(mask, yb)
        ls = per_sample(w, xb, yb)
        # where, not multiply: masked-out rows may hold padding whose loss is
        # NaN/Inf (NaN*0 = NaN would poison the mean).
        loss = jnp.sum(jnp.where(mask > 0, ls, 0.0)) / jnp.maximum(jnp.sum(mask), 1.0)
        return loss + reg(w) if reg is not None else loss

    return BatchProblem(
        fun=fun,
        grad=jax.grad(fun),
        value_and_grad=jax.value_and_grad(fun),
        fun_masked=fun_masked,
        grad_masked=jax.grad(fun_masked),
        per_sample=per_sample,
        reg=reg,
    )


def zero_masked_rows(mask: jax.Array, arr: jax.Array) -> jax.Array:
    """Replace rows of ``arr`` where ``mask == 0`` with zeros.

    Used by the masked evaluators so NaN/Inf padding in ragged trailing
    batches cannot poison either the forward mean or the backward pass
    (zero cotangent times a NaN activation is NaN). Rows are independent in
    ``per_sample``, so zeroing masked rows never perturbs unmasked outputs.
    """
    shape = (mask.shape[0],) + (1,) * (arr.ndim - 1)
    return jnp.where(mask.reshape(shape) > 0, arr, jnp.zeros((), arr.dtype))


def empty_history(max_iters: int, dtype) -> jax.Array:
    return jnp.full((max_iters,), jnp.nan, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _cached_jit(fn, static_argnums):
    return jax.jit(fn, static_argnums=static_argnums)
