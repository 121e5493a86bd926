"""Out-of-core evaluation: datasets that stay in HOST memory.

The reference holds the whole training set in CPU RAM and streams it through
cache (full-gradient pass: reference src/minimizer/s_lbfgs.hpp:203-206); the
device analogue of "bigger than fast memory" is a dataset that exceeds one
device's memory. The in-HBM solvers take ``x``/``y`` as whole traced operands —
the fastest path, and the right one whenever the data fits. This module is
the scaling escape hatch (PARITY.md §2.5): the dataset lives host-side in a
:class:`ChunkStore`, and jitted programs pull device-sized pieces on demand
through ``jax.experimental.io_callback``, so the device-resident footprint
is one chunk (full-gradient accumulation) or one minibatch (stochastic
steps) instead of the whole array.

Two adapters:

* :func:`outofcore_problem` — a full-batch :class:`Problem` whose
  ``fun``/``grad``/``value_and_grad`` accumulate over chunks inside a
  ``lax.fori_loop``. Plug it into any full-gradient solver (``lbfgs``,
  ``gradient_descent``, ...) unchanged: the whole solve stays ONE XLA
  program; each chunk fetch is an unordered host callback.
* ``ChunkStore.fetch_rows`` — host-side gather of sampled minibatch indices,
  used by ``slbfgs(..., store=...)`` for the SVRG inner steps while the
  full-gradient anchor passes accumulate over chunks.

Cost model: every fetch is a host round trip (device -> host -> device),
amortized over the chunk's compute — worth it exactly when the
dataset cannot be resident. Trajectories match the in-HBM run up to
summation-order rounding (chunked partial sums vs one flat mean); the f64
parity tests in tests/test_outofcore.py bound the drift.

Autodiff discipline: ``io_callback`` is not differentiable, so every
differentiated function here takes the fetched chunk as an *input* — the
callbacks sit between pre-differentiated pure pieces, never inside them.
Consequently ``Problem.hvp`` (jvp of a grad that contains callbacks) is NOT
supported by the adapter; use the default ``curvature_pairs="grad_diff"``.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import io_callback

from lbfgs_ffnn.types import BatchProblem, Problem, zero_masked_rows


class ChunkStore:
    """Host-resident ``(x, y)`` dataset served to jitted programs in fixed-
    shape pieces.

    ``chunk_rows`` bounds the device-resident slice; the trailing ragged
    chunk is zero-padded and masked. Reuse ONE store object across solver
    calls — adapters built from it key the jit caches by identity.
    """

    def __init__(self, x, y, chunk_rows: int):
        self.x = np.ascontiguousarray(x)
        self.y = np.ascontiguousarray(y)
        if len(self.x) != len(self.y):
            raise ValueError(f"x/y length mismatch: {len(self.x)} vs {len(self.y)}")
        self.n = int(len(self.x))
        self.chunk_rows = int(min(chunk_rows, self.n))
        self.num_chunks = -(-self.n // self.chunk_rows)  # ceil

    # -- host-side callbacks (numpy in, numpy out, fixed shapes) -----------
    def _chunk_np(self, c):
        c = int(c)
        lo = c * self.chunk_rows
        hi = min(lo + self.chunk_rows, self.n)
        rows = self.chunk_rows
        xb = np.zeros((rows,) + self.x.shape[1:], self.x.dtype)
        yb = np.zeros((rows,) + self.y.shape[1:], self.y.dtype)
        xb[: hi - lo] = self.x[lo:hi]
        yb[: hi - lo] = self.y[lo:hi]
        mask = np.zeros((rows,), self.x.dtype)
        mask[: hi - lo] = 1
        return xb, yb, mask

    def _rows_np(self, idx):
        idx = np.asarray(idx)
        return self.x[idx], self.y[idx]

    # -- traced fetchers ----------------------------------------------------
    def fetch_chunk(self, c):
        """``(xb, yb, mask)`` for chunk ``c`` (traced int32), zero-padded."""
        rows = self.chunk_rows
        spec = (
            jax.ShapeDtypeStruct((rows,) + self.x.shape[1:], self.x.dtype),
            jax.ShapeDtypeStruct((rows,) + self.y.shape[1:], self.y.dtype),
            jax.ShapeDtypeStruct((rows,), self.x.dtype),
        )
        return io_callback(self._chunk_np, spec, c)

    def fetch_rows(self, idx):
        """Host-side gather: ``(x[idx], y[idx])`` for a traced index vector —
        the out-of-core counterpart of the in-HBM ``jnp.take``."""
        spec = (
            jax.ShapeDtypeStruct(idx.shape + self.x.shape[1:], self.x.dtype),
            jax.ShapeDtypeStruct(idx.shape + self.y.shape[1:], self.y.dtype),
        )
        return io_callback(self._rows_np, spec, idx)


def accumulate_chunks(store: ChunkStore, contrib, init):
    """``sum_c contrib(xb_c, yb_c, mask_c)`` over all chunks as a
    ``fori_loop`` — one chunk device-resident at a time. ``contrib`` must be
    pure (the fetch happens outside it, keeping autodiff legal)."""

    def body(c, acc):
        xb, yb, mask = store.fetch_chunk(c)
        return jax.tree_util.tree_map(
            lambda a, b: a + b, acc, contrib(xb, yb, mask)
        )

    return lax.fori_loop(0, store.num_chunks, body, init)


def masked_chunk_sums(bp: BatchProblem):
    """``(sum_loss, sum_grad, sum_vag)`` over ONE zero-padded masked chunk.

    The masking discipline lives here and only here: padding rows are
    zeroed before ``per_sample`` (they may hold anything, including NaN —
    see types.zero_masked_rows) and their losses dropped through ``where``,
    so both the value and the cotangents of masked rows are exactly zero.
    Shared by :func:`outofcore_problem` and the S-LBFGS out-of-core anchor
    ops (solvers/slbfgs.py::_outofcore_ops)."""

    def sum_loss(w, xb, yb, mask):
        xb = zero_masked_rows(mask, xb)
        yb = zero_masked_rows(mask, yb)
        ls = bp.per_sample(w, xb, yb)
        return jnp.sum(jnp.where(mask > 0, ls, 0.0))

    return sum_loss, jax.grad(sum_loss), jax.value_and_grad(sum_loss)


def chunked_mean_evals(bp: BatchProblem, store: ChunkStore):
    """``(full_loss, full_grad)`` callables ``(w) -> scalar / (n,)`` that
    accumulate the masked per-chunk sums over the whole store, divide by N
    once, and add the regularizer once — the chunked equivalent of the
    in-HBM ``bp.fun/grad`` over the full dataset."""
    N = store.n
    _sum_loss, _sum_grad, _ = masked_chunk_sums(bp)

    def full_loss(w):
        total = accumulate_chunks(
            store, lambda xb, yb, m: _sum_loss(w, xb, yb, m),
            jnp.zeros((), w.dtype),
        )
        out = total / N
        return out + bp.reg(w) if bp.reg is not None else out

    def full_grad(w):
        g = accumulate_chunks(
            store, lambda xb, yb, m: _sum_grad(w, xb, yb, m),
            jnp.zeros_like(w),
        )
        g = g / N
        return g + jax.grad(bp.reg)(w) if bp.reg is not None else g

    return full_loss, full_grad


def outofcore_problem(bp: BatchProblem, store: ChunkStore) -> Problem:
    """Full-batch :class:`Problem` over a host-resident dataset.

    The objective equals the in-HBM ``bp.fun(w, x, y)`` (mean per-sample
    loss + the regularizer once) up to chunked-summation rounding; the
    ``aux`` slot is unused (pass ``()``). No line restriction is exposed —
    trials are full chunk sweeps — and ``hess``/``hvp`` are unsupported
    (see the module docstring). For MLP objectives prefer
    :func:`outofcore_mlp_problem`, whose carried line prefix makes
    line-search trials device-resident (no chunk sweep per trial).
    """
    N = store.n

    _sum_loss, _sum_grad, _sum_vag = masked_chunk_sums(bp)
    full_loss, full_grad = chunked_mean_evals(bp, store)

    def fun(w, aux=()):
        return full_loss(w)

    def grad(w, aux=()):
        return full_grad(w)

    def value_and_grad(w, aux=()):
        total, g = accumulate_chunks(
            store, lambda xb, yb, m: _sum_vag(w, xb, yb, m),
            (jnp.zeros((), w.dtype), jnp.zeros_like(w)),
        )
        f, g = total / N, g / N
        if bp.reg is not None:
            rf, rg = jax.value_and_grad(bp.reg)(w)
            f, g = f + rf, g + rg
        return f, g

    return Problem(fun=fun, grad=grad, value_and_grad=value_and_grad)


def outofcore_mlp_problem(spec, store: ChunkStore, lam: float = 0.0) -> Problem:
    """Out-of-core MLP :class:`Problem` with **device-resident line-search
    trials** via the carried line prefix.

    The plain :func:`outofcore_problem` pays a full chunk sweep (with one
    io_callback round trip per chunk) for every Armijo/Wolfe trial — 13-20
    trials/iter near a plateau. But the MLP's first-layer preactivation
    ``z1(alpha) = A + alpha*B`` is linear in the step, and the carried
    ``A`` (N, d1) plus the targets (N, d_out) are together ~6x smaller than
    the raw (N, in_dim) input on the benchmark shapes (784 vs 128+10) —
    they often fit HBM even when ``x`` does not. So this adapter keeps
    them device-resident and the per-iteration chunk sweeps drop to
    exactly two (the new direction's ``B = x@W1_p + b1_p`` and the accept
    point's ``value_and_grad``); every line-search trial is a pure
    on-device combine over (N, d1), identical to the in-HBM lean path.

    Mirrors the line-search cost the reference pays by streaming RAM per
    trial (reference: src/minimizer/full_batch_minimizer.hpp:126-157).

    ``aux``: pass ``()``; the solver's one-time ``prepare`` fetches the
    padded targets + row mask to the device. f64 trajectory parity vs the
    in-HBM problem is bounded by chunked-summation rounding only
    (tests/test_outofcore.py).
    """
    from lbfgs_ffnn.objectives.mlp import (
        _ACTIVATIONS, MLPSpec, mlp_apply,
    )
    from lbfgs_ffnn.objectives.mlp import mlp_batch_problem
    from lbfgs_ffnn.types import LinePrefix

    reg = (lambda w: 0.5 * lam * jnp.vdot(w, w)) if lam else None
    bp = mlp_batch_problem(spec, lam=lam)
    base = outofcore_problem(bp, store)

    w_off, b_off, d_in, d_out0 = next(iter(spec.layer_slices()))
    first_elems = d_in * d_out0 + d_out0
    act0 = _ACTIVATIONS[spec.activations[0]]
    rest_spec = (
        MLPSpec(dims=spec.dims[1:], activations=spec.activations[1:])
        if spec.n_layers > 1 else None
    )
    N, rows = store.n, store.chunk_rows
    n_pad = store.num_chunks * rows
    d_last = spec.dims[-1]

    # NOTE: _first_affine_chunk and restrict.value deliberately mirror
    # objectives/mlp.py's _first_affine/_loss_from_z1 rather than import
    # them: the out-of-core restriction masks PADDED STORE ROWS and
    # normalizes by the true N (mlp.py's forms are unmasked batch means),
    # and it has no narrow-input (bf16/u8) variants — chunks arrive f32
    # from the host store. Threading a mask through the in-HBM hot path to
    # share ~10 lines would be the wrong trade; if mlp.py's loss
    # convention ever changes, tests/test_outofcore.py's f64 parity gate
    # vs the in-HBM problem catches the divergence.
    def _first_affine_chunk(v, xb):
        W = v[w_off : w_off + d_in * d_out0].reshape(d_in, d_out0)
        b = v[b_off : b_off + d_out0]
        return jnp.dot(xb, W, preferred_element_type=v.dtype) + b

    def _affine_sweep(v):
        """(n_pad, d1) first-layer preactivation over the whole store, one
        chunk device-resident at a time. Padded rows hold b1 (x=0 there);
        they are mask-dropped in the restriction."""
        out = jnp.zeros((n_pad, d_out0), v.dtype)

        def body(c, acc):
            xb, _yb, _m = store.fetch_chunk(c)
            z = _first_affine_chunk(v, xb)
            return lax.dynamic_update_slice(acc, z, (c * rows, 0))

        return lax.fori_loop(0, store.num_chunks, body, out)

    def _y_mask_np():
        y_pad = np.zeros((n_pad,) + store.y.shape[1:], store.y.dtype)
        y_pad[:N] = store.y
        mask = np.zeros((n_pad,), store.x.dtype)
        mask[:N] = 1
        return y_pad, mask

    def prepare(aux):
        # One-time per solve: the padded targets + row mask become the aux
        # the restriction reads. Idempotent (a prepared 2-tuple passes
        # through unchanged — the chunked drivers prepare once per chunk).
        if isinstance(aux, tuple) and len(aux) == 2:
            return aux
        spec_out = (
            jax.ShapeDtypeStruct((n_pad, d_last), jnp.dtype(store.y.dtype)),
            jax.ShapeDtypeStruct((n_pad,), jnp.dtype(store.x.dtype)),
        )
        return io_callback(_y_mask_np, spec_out)

    def restrict(A, B, w, p, aux):
        y, mask = aux[0], aux[1]
        w_rest = w[first_elems:]
        p_rest = p[first_elems:]

        def value(alpha):
            z1 = A + alpha * B
            h = act0(z1)
            out = (
                mlp_apply(rest_spec, w_rest + alpha * p_rest, h)
                if rest_spec is not None else h
            )
            diff = out - y
            row = 0.5 * jnp.sum(diff * diff, axis=tuple(range(1, diff.ndim)))
            loss = jnp.sum(jnp.where(mask > 0, row, 0.0)) / N
            if lam:
                wa = w + alpha * p
                loss = loss + 0.5 * lam * jnp.vdot(wa, wa)
            return loss

        return value

    line_prefix = LinePrefix(
        init=lambda w, aux: _affine_sweep(w),
        direction=lambda p, aux: _affine_sweep(p),
        restrict=restrict,
        # vag at accept streams chunks (problem.value_and_grad) — the
        # input matrix must be read once per accepted step regardless.
        vag_restrict=None,
        vag_restrict_carry=None,
    )

    return Problem(
        fun=base.fun, grad=base.grad, value_and_grad=base.value_and_grad,
        line_prefix=line_prefix, prepare=prepare,
    )
