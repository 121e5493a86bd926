"""Data-parallel objective evaluation over a device mesh.

Two complementary mechanisms, both keeping solver state (weights, curvature
ring, line search) replicated and sharding only the sample axis — the
multi-chip generalization of the reference's OpenMP sample-axis threading
and critical-section gradient reduction
(reference: tests/burgers/test_burgers_parallel.cpp:171-208).

1. **GSPMD (implicit)**: place ``x``/``y`` with a ``P("data")`` sharding via
   :func:`shard_batch` and run any solver unchanged — XLA partitions the
   batch GEMMs across the mesh and inserts the gradient ``all-reduce``
   automatically. This is the idiomatic pjit path.
2. **shard_map (explicit)**: :func:`data_parallel_batch_problem` wraps a
   BatchProblem so each device evaluates its local shard and the scalar
   loss is ``pmean``-reduced. Gradients come from differentiating the
   shard_mapped loss *outside* the shard_map — its transpose rule reduces
   the per-device weight cotangents over the mesh (one all-reduce per
   evaluation), which keeps collective placement deterministic.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lbfgs_ffnn.types import BatchProblem, Problem, zero_masked_rows


def shard_batch(mesh: Mesh, *arrays: jax.Array, axis_name: str = "data"):
    """Place arrays with their leading (sample) axis sharded over the mesh.

    Sample counts must divide the mesh size (pad upstream if not).
    """
    sharding = NamedSharding(mesh, P(axis_name))
    out = tuple(jax.device_put(a, sharding) for a in arrays)
    return out[0] if len(out) == 1 else out


def replicate(mesh: Mesh, tree: Any):
    """Replicate a pytree (e.g. the flat weight vector) over the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sharding), tree)


def _sharded_scalar(fn, mesh: Mesh, axis: str, n_data_args: int):
    """shard_map a scalar-valued ``fn(w, *data)`` with data args sharded on
    ``axis`` and w replicated; output is the pmean over devices (equal-size
    shards make pmean-of-local-means the exact global mean)."""

    def local(w, *data):
        return jax.lax.pmean(fn(w, *data), axis)

    in_specs = (P(),) + (P(axis),) * n_data_args
    return jax.shard_map(local, mesh=mesh, in_specs=in_specs, out_specs=P())


def data_parallel_batch_problem(
    bp: BatchProblem, mesh: Mesh, axis_name: str = "data"
) -> BatchProblem:
    """Explicit shard_map wrapper for a finite-sum problem.

    The returned callables require batch sizes divisible by the mesh size.
    The scalar loss is pmean-reduced in the mapped body; grad and
    value_and_grad differentiate the mapped loss, so the weight-cotangent
    all-reduce is inserted by shard_map's transpose — replacing the
    reference's OpenMP critical-section gradient sum.
    """
    axis = axis_name
    fun = _sharded_scalar(bp.fun, mesh, axis, 2)

    def fun_masked_local(w, xb, yb, mask):
        # Weight each device's local masked mean by its share of the unmasked
        # count so the psum reproduces the global masked mean; the reg term
        # (included in fun_masked) is scaled back to appear exactly once.
        # Same NaN-padding discipline as types.py fun_masked: zero the padded
        # rows (protects the VJP) and `where` the loss (protects the forward);
        # `ls * mask` would let one NaN row poison the psum.
        xb = zero_masked_rows(mask, xb)
        yb = zero_masked_rows(mask, yb)
        ls = bp.per_sample(w, xb, yb)
        cnt = jnp.sum(mask)
        total = jnp.maximum(jax.lax.psum(cnt, axis), 1.0)
        local = jnp.sum(jnp.where(mask > 0, ls, 0.0)) / total
        out = jax.lax.psum(local, axis)
        if bp.reg is not None:
            out = out + bp.reg(w)  # regularizer counted exactly once
        return out

    def fun_masked(w, xb, yb, mask):
        return jax.shard_map(
            fun_masked_local, mesh=mesh,
            in_specs=(P(), P(axis), P(axis), P(axis)), out_specs=P(),
        )(w, xb, yb, mask)

    return BatchProblem(
        fun=fun,
        grad=jax.grad(fun),
        value_and_grad=jax.value_and_grad(fun),
        fun_masked=fun_masked,
        grad_masked=jax.grad(fun_masked),
        per_sample=bp.per_sample,  # local-only helper; not collective
    )


def data_parallel_problem(
    problem: Problem, mesh: Mesh, axis_name: str = "data"
) -> Problem:
    """Explicit shard_map wrapper for a full-batch Problem whose ``aux`` is
    ``(x, y)`` batch-major data."""
    base = _sharded_scalar(
        lambda w, x, y: problem.fun(w, (x, y)), mesh, axis_name, 2
    )

    def fun(w, aux):
        return base(w, *aux)

    grad_base = jax.grad(base)
    vag_base = jax.value_and_grad(base)

    def grad(w, aux):
        return grad_base(w, *aux)

    def value_and_grad(w, aux):
        return vag_base(w, *aux)

    return Problem(fun=fun, grad=grad, value_and_grad=value_and_grad, hess=None)
