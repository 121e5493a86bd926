"""Flat-parameter dense MLP objective.

The reference evaluates its MLP with hand-rolled per-layer forward/backward
over a contiguous flat parameter buffer (reference: src/network.hpp,
src/layer.hpp for CPU; src/cuda/{network,layer}.cuh for CUDA). Here the
network is a pure function of the flat parameter vector: the forward pass is
a chain of matmuls, gradients come from ``jax.value_and_grad`` (one fused
forward+backward XLA program), and HVPs from exact ``jax.jvp``.

The flat layout is kept — quasi-Newton solvers want a single contiguous
vector for their O(m*n) vector arithmetic — with static (offset, shape)
metadata per layer replacing the reference's bound Eigen::Map views
(reference: src/layer.hpp:76-83).

Conventions preserved from the reference:
  * loss = 0.5*||out - y||^2 / batch  (reference: src/unified_optimization.hpp:101-108)
  * init std = act_scale * sqrt(1/fan_in), act_scale = sqrt(2) for ReLU else 1
    (reference: src/layer.hpp:16-47,130)
  * CPU backend randomizes biases, CUDA zeroes them — both available via
    ``bias_init`` (reference: src/network.hpp:64-69 vs src/cuda/network.cuh:52-53)
  * optional L2 term 0.5*lam*||w||^2 as used by S-LBFGS training
    (reference: src/unified_optimization.hpp:334,375,398)
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

from lbfgs_ffnn.types import (
    BatchProblem, LinePrefix, Problem, make_batch_problem, make_problem,
)

_ACTIVATIONS = {
    "linear": lambda z: z,
    "relu": lambda z: jnp.maximum(z, 0.0),
    "sigmoid": jax.nn.sigmoid,
    "tanh": jnp.tanh,
}

# He-style init scale per activation (reference: src/layer.hpp Linear/ReLU/
# Sigmoid/Tanh ::scale).
_INIT_SCALE = {
    "linear": 1.0,
    "relu": math.sqrt(2.0),
    "sigmoid": 1.0,
    "tanh": 1.0,
}


class MLPSpec(NamedTuple):
    """Static architecture description: ``dims[i] -> dims[i+1]`` per layer."""

    dims: tuple[int, ...]
    activations: tuple[str, ...]

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    @property
    def n_params(self) -> int:
        return sum(
            self.dims[i] * self.dims[i + 1] + self.dims[i + 1]
            for i in range(self.n_layers)
        )

    def layer_slices(self):
        """Yield (w_offset, b_offset, in_dim, out_dim) per layer."""
        off = 0
        for i in range(self.n_layers):
            d_in, d_out = self.dims[i], self.dims[i + 1]
            yield off, off + d_in * d_out, d_in, d_out
            off += d_in * d_out + d_out


def mlp_spec(dims: Sequence[int], activations: Sequence[str]) -> MLPSpec:
    dims = tuple(int(d) for d in dims)
    activations = tuple(a.lower() for a in activations)
    if len(activations) != len(dims) - 1:
        raise ValueError("need one activation per layer")
    for a in activations:
        if a not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {a!r}")
    return MLPSpec(dims=dims, activations=activations)


def mlp_init(
    spec: MLPSpec,
    key: jax.Array,
    dtype=jnp.float32,
    bias_init: str = "random",
) -> jax.Array:
    """Seeded N(0, sigma) init into one flat vector.

    ``bias_init='random'`` draws biases from the same distribution as weights
    (reference CPU convention); ``'zeros'`` zeroes them (reference CUDA
    convention).
    """
    parts = []
    keys = jax.random.split(key, spec.n_layers)
    for li, (w_off, b_off, d_in, d_out) in enumerate(spec.layer_slices()):
        std = _INIT_SCALE[spec.activations[li]] * math.sqrt(1.0 / d_in)
        kw, kb = jax.random.split(keys[li])
        w = std * jax.random.normal(kw, (d_in * d_out,), dtype=dtype)
        if bias_init == "random":
            b = std * jax.random.normal(kb, (d_out,), dtype=dtype)
        elif bias_init == "zeros":
            b = jnp.zeros((d_out,), dtype=dtype)
        else:
            raise ValueError(f"unknown bias_init {bias_init!r}")
        parts.append(w)
        parts.append(b)
    return jnp.concatenate(parts)


def mlp_apply(
    spec: MLPSpec, w: jax.Array, x: jax.Array, compute_dtype=None
) -> jax.Array:
    """Forward pass. ``x`` is batch-major ``(B, in_dim)`` -> ``(B, out_dim)``.

    (The reference stores samples column-major, one per column; batch-major
    keeps features contiguous, the layout a row-major GEMM wants.)

    ``compute_dtype=jnp.bfloat16`` feeds the matmuls bf16 operands while
    accumulating in f32 (params, activations and the loss stay f32) —
    tensor-core throughput at a small precision cost; not available in the
    reference's f32 cuBLAS path.
    """
    # uint8 pixel-quantized input (round(x*255), see quantize_pixels):
    # upcast inside the first dot's operand read and rescale on the OUTPUT
    # epilogue, exactly as the full problem's _first_affine — the (B, in)
    # HBM read is a quarter of f32 and the integer operands are exact
    # (PERF.md). Only uint8 carries this convention; any
    # other integer input is almost certainly a caller error (raw counts,
    # labels in the wrong slot) and silently dividing it by 255 would
    # corrupt results, so reject loudly.
    quant = jnp.issubdtype(x.dtype, jnp.integer)
    if quant and x.dtype != jnp.dtype(jnp.uint8):
        raise ValueError(
            f"integer inputs to mlp_apply must be uint8 pixel-quantized "
            f"(quantize_pixels convention), got {x.dtype}")
    h = x
    acc = w.dtype if quant else x.dtype
    for li, (w_off, b_off, d_in, d_out) in enumerate(spec.layer_slices()):
        W = w[w_off : w_off + d_in * d_out].reshape(d_in, d_out)
        b = w[b_off : b_off + d_out]
        rescale = quant and li == 0
        if compute_dtype is not None:
            hd = h.astype(compute_dtype) if not rescale else \
                h.astype(acc).astype(compute_dtype)
            z = jnp.dot(hd, W.astype(compute_dtype),
                        preferred_element_type=acc)
        else:
            hd = h.astype(acc) if rescale else h
            z = jnp.dot(hd, W, preferred_element_type=acc)
        if rescale:
            z = z * jnp.asarray(1.0 / 255.0, acc)
        z = z + b
        h = _ACTIVATIONS[spec.activations[li]](z)
    return h


def mlp_apply_single(spec: MLPSpec, w: jax.Array, x: jax.Array) -> jax.Array:
    """Forward pass for one sample ``x (in_dim,) -> (out_dim,)``.

    Written as vector-matrix products so that ``jax.vmap`` over samples
    lowers to clean (B, in) @ (in, out) GEMMs — the per-point form PINN
    residuals vmap over."""
    h = x
    for li, (w_off, b_off, d_in, d_out) in enumerate(spec.layer_slices()):
        W = w[w_off : w_off + d_in * d_out].reshape(d_in, d_out)
        b = w[b_off : b_off + d_out]
        z = jnp.dot(h, W, preferred_element_type=h.dtype) + b
        h = _ACTIVATIONS[spec.activations[li]](z)
    return h


def mlp_loss(
    spec: MLPSpec, w: jax.Array, x: jax.Array, y: jax.Array,
    lam: float = 0.0, compute_dtype=None,
) -> jax.Array:
    """Mean 0.5*MSE over the batch, optionally L2-regularized."""
    out = mlp_apply(spec, w, x, compute_dtype)
    diff = out - y
    loss = 0.5 * jnp.sum(diff * diff) / x.shape[0]
    if lam:
        loss = loss + 0.5 * lam * jnp.vdot(w, w)
    return loss


def mlp_problem(
    spec: MLPSpec, lam: float = 0.0, compute_dtype=None, remat: bool = False,
    grad_input_dtype=None, line_input_dtype=None, fun_input_dtype=None,
) -> Problem:
    """Full-batch Problem; ``aux = (x, y)``.

    ``grad_input_dtype="bfloat16"`` halves the HBM read of the input matrix
    in the accept-point gradient: ``Problem.prepare`` casts one persistent
    bf16 copy of ``x`` per jitted solve (aux becomes ``(x, y, x_b16)``), and
    ``vag_restrict`` feeds it to the dW1 = x^T dz1 GEMM — the only place the
    raw input is read per L-BFGS iteration once the carried line prefix is
    active. The products differ from the f32 read's by one bf16 rounding
    of x (a default-precision GPU dot may itself round f32 operands to
    TF32, which keeps 3 more mantissa bits than bf16); the forward, loss,
    and every line-search trial stay f32 reads. No reference counterpart
    (f32 cuBLAS reads f32, src/cuda/network.cuh).

    ``line_input_dtype="bfloat16"`` feeds the same prepared narrow copy to
    the OTHER per-iteration reader of the raw input: the line-restriction
    GEMMs (the carried prefix's ``B = x @ W1_p`` each iteration, plus
    A-init/refresh and per-call ``line_fun``), halving B's dominant
    (batch, in_dim) traffic. Trial/accept values shift by one bf16
    rounding of x, so this is a separate opt-in from
    ``grad_input_dtype``: the full-batch ``fun`` and the very first f0
    stay raw-f32 reads either way.

    ``fun_input_dtype`` extends the same narrow read to the FULL objective:
    the first-layer forward ``z1 = x @ W1`` and (via autodiff) its backward
    ``dW1 = x^T dz1`` consume the prepared copy, while every other layer is
    untouched. This is the lever for full-gradient solvers with no line
    search — GD's iteration is one value_and_grad whose cost at benchmark
    shapes is almost entirely the two x reads. Loss/gradient VALUES shift
    by the input-rounding class (one bf16 rounding for "bfloat16"; for
    "uint8" on-grid pixels the quantized read is exact), so it is an
    explicit opt-in; un-prepared 2-tuple aux falls back
    to the raw read.

    All the ``*_input_dtype`` options also accept ``"uint8"`` for PIXEL
    data (values on the
    k/255 grid, k = 0..255 — MNIST/Fashion exactly): the prepared copy
    stores ``round(x*255)`` as uint8 — a QUARTER of the f32 read (47 vs
    188 MB on the 60k benchmarks) — and every consumer GEMM computes
    ``dot(xq, ·) * (1/255)`` with the scale fused into the dot epilogue.
    The int->float upcast is EXACT (integers <= 255 are exact in bf16 and
    TF32), so the u8 products are if anything *more* faithful than a
    reduced-precision f32 read's (k is exact where k/255 rounds). Inputs off the
    pixel grid are quantized (clipped to [0,1], rounded to the grid) —
    this is an explicit opt-in for image data, not a general-purpose mode.

    ``remat=True`` wraps the loss in ``jax.checkpoint``: the backward pass
    recomputes activations instead of storing them — trades ~one extra
    forward of FLOPs for O(batch x width) less HBM during the gradient.
    Irrelevant at MNIST scale; the switch exists for models whose
    activations would not fit (gradients are bitwise-equivalent
    mathematically, checked in tests).

    Includes a ``line_fun`` restriction: along a fixed direction ``p`` the
    first-layer preactivation is affine in the step length,
    ``z1(alpha) = (x@W1_w + b1_w) + alpha*(x@W1_p + b1_p) = A + alpha*B``,
    so repeated line-search trials replace the dominant (batch, in_dim)
    input-matrix read+GEMM with one elementwise combine over (batch, d1) —
    much cheaper trials on MNIST-60k. Mathematically identical to
    ``fun(w + alpha*p)``; float rounding differs in the last ulps (and a bit
    more under ``compute_dtype=bf16``, where bf16(w)+alpha*bf16(p) stands in
    for bf16(w+alpha*p)).
    """

    def _fun_raw(w, aux):
        x, y = aux[0], aux[1]
        return mlp_loss(spec, w, x, y, lam, compute_dtype)

    w_off, b_off, d_in, d_out = next(iter(spec.layer_slices()))
    first_elems = d_in * d_out + d_out
    act0 = _ACTIVATIONS[spec.activations[0]]
    rest_spec = (
        MLPSpec(dims=spec.dims[1:], activations=spec.activations[1:])
        if spec.n_layers > 1 else None
    )

    def _first_affine(v, x):
        # preferred_element_type comes from the PARAM vector so a narrow
        # line_input x (bf16/u8) still yields a full-width prefix; the
        # narrow read upcasts inside the dot (exact).
        # A uint8 x holds round(raw*255): the 1/255 rescale rides the dot
        # OUTPUT (a scalar multiply XLA fuses into the epilogue), so the
        # operands stay the exactly-representable integers.
        W = v[w_off : w_off + d_in * d_out].reshape(d_in, d_out)
        b = v[b_off : b_off + d_out]
        quant = jnp.issubdtype(x.dtype, jnp.integer)
        if compute_dtype is not None:
            z = jnp.dot(x.astype(compute_dtype), W.astype(compute_dtype),
                        preferred_element_type=v.dtype)
        else:
            xf = x.astype(v.dtype) if quant else x
            z = jnp.dot(xf, W, preferred_element_type=v.dtype)
        if quant:
            z = z * jnp.asarray(1.0 / 255.0, v.dtype)
        return z + b

    def _line_x(aux):
        # The prepared narrow copy feeds the restriction GEMMs only when
        # line_input_dtype asked for it (aux[2] is OUR copy only when this
        # problem attached a prepare; a caller-supplied 3-element aux must
        # not be misread — same guard as vag_restrict's xg).
        if line_input_dtype is not None and len(aux) > 2:
            return aux[2]
        return aux[0]

    def _loss_from_z1(w_rest_alpha, z1, y, n_batch):
        """Shared loss body for the restriction and its value_and_grad form —
        one place owns the 0.5/batch convention and the rest-layer forward."""
        h = act0(z1)
        out = (
            mlp_apply(rest_spec, w_rest_alpha, h, compute_dtype)
            if rest_spec is not None else h
        )
        diff = out - y
        return 0.5 * jnp.sum(diff * diff) / n_batch

    def restrict(A, B, w, p, aux):
        x, y = aux[0], aux[1]
        w_rest = w[first_elems:]
        p_rest = p[first_elems:]

        def value(alpha):
            loss = _loss_from_z1(
                w_rest + alpha * p_rest, A + alpha * B, y, x.shape[0]
            )
            if lam:
                wa = w + alpha * p
                loss = loss + 0.5 * lam * jnp.vdot(wa, wa)
            return loss

        return value

    def line_fun(w, p, aux):
        x = _line_x(aux)
        return restrict(_first_affine(w, x), _first_affine(p, x), w, p, aux)

    def _vag_restrict_full(A, B, w, p, aux):
        """Full (loss, grad, z1) at ``w + alpha*p`` computed FROM the prefix:
        the forward never recomputes ``x @ W1`` (z1 = A + alpha*B), and the
        first layer's gradient is assembled manually as dW1 = x^T dz1,
        db1 = sum(dz1) — the input matrix is read once (backward only)
        instead of twice (and at half width under ``grad_input_dtype``,
        which supplies the prepared bf16 copy as ``aux[2]``). The returned
        ``z1`` IS the post-step prefix (LinePrefix.vag_restrict_carry):
        it is already materialized as the relu backward's residual, so
        handing it to the solver as the next carried prefix costs nothing
        and deletes the solver's separate A += alpha*B axpy."""
        x, y = aux[0], aux[1]
        # aux[2] is OUR prepared copy only when this problem attached a
        # prepare (a caller-supplied 3-element aux must not be misread).
        xg = aux[2] if (grad_input_dtype is not None and len(aux) > 2) else x

        def value_and_grad_at(alpha):
            z1 = A + alpha * B
            w_rest = w[first_elems:] + alpha * p[first_elems:]

            def from_z1(w_r, z1_):
                return _loss_from_z1(w_r, z1_, y, x.shape[0])

            loss, vjp_fn = jax.vjp(from_z1, w_rest, z1)
            g_rest, dz1 = vjp_fn(jnp.ones_like(loss))
            quant = jnp.issubdtype(xg.dtype, jnp.integer)
            if compute_dtype is not None:
                gW1 = jnp.dot(
                    xg.T.astype(compute_dtype), dz1.astype(compute_dtype),
                    preferred_element_type=x.dtype,
                )
            else:
                xgf = xg.T.astype(x.dtype) if quant else xg.T
                gW1 = jnp.dot(xgf, dz1, preferred_element_type=x.dtype)
            if quant:
                # xg holds round(x*255); rescale on the (in, d1) output —
                # negligible next to the (batch, in) operand read it saves.
                gW1 = gW1 * jnp.asarray(1.0 / 255.0, x.dtype)
            gb1 = jnp.sum(dz1, axis=0)
            g = jnp.concatenate([gW1.ravel(), gb1, g_rest])
            if lam:
                wa = w + alpha * p
                loss = loss + 0.5 * lam * jnp.vdot(wa, wa)
                g = g + lam * wa
            return loss, g, z1

        return value_and_grad_at

    def vag_restrict(A, B, w, p, aux):
        inner = _vag_restrict_full(A, B, w, p, aux)

        def value_and_grad_at(alpha):
            loss, g, _z1 = inner(alpha)
            return loss, g

        return value_and_grad_at

    # Carried form: A lives in the solver state and updates via A += alpha*B
    # (the first-layer preactivation is linear in w), so the per-iteration
    # cost drops to ONE first-layer matmul (for the new direction's B).
    line_prefix = LinePrefix(
        init=lambda w, aux: _first_affine(w, _line_x(aux)),
        direction=lambda p, aux: _first_affine(p, _line_x(aux)),
        restrict=restrict,
        # vag_restrict stores the rest-layer activations for its backward —
        # it would defeat remat's memory guarantee, so remat problems keep
        # the checkpointed autodiff path for the accepted point.
        vag_restrict=None if remat else vag_restrict,
        vag_restrict_carry=None if remat else _vag_restrict_full,
    )

    if fun_input_dtype is None:
        fun = _fun_raw
    else:
        def fun(w, aux):
            # The full objective's first-layer GEMMs (forward z1 and, via
            # autodiff of this expression, the backward dW1) read the
            # prepared narrow copy — the whole win for the full-gradient
            # solvers with no line search (GD reads x twice per iteration
            # and nothing else of comparable size). Falls back to the raw
            # read when handed un-prepared 2-tuple aux, which keeps every
            # caller (f0 probes, harness oracles) valid.
            y = aux[1]
            xn = aux[2] if len(aux) > 2 else aux[0]
            loss = _loss_from_z1(w[first_elems:], _first_affine(w, xn), y,
                                 aux[0].shape[0])
            if lam:
                loss = loss + 0.5 * lam * jnp.vdot(w, w)
            return loss

    if remat:
        fun = jax.checkpoint(fun)

    # ONE prepared narrow copy serves every consumer (vag_restrict's dW1
    # read under grad_input_dtype, the restriction GEMMs under
    # line_input_dtype, the full objective under fun_input_dtype);
    # requiring a single dtype keeps aux fixed-shape.
    narrow_dtype = None
    narrow_sources = []
    if grad_input_dtype is not None and not remat:
        # Only vag_restrict consumes the grad-side copy; under remat it is
        # disabled (see LinePrefix above), so preparing for it alone would
        # be pure HBM dead weight.
        narrow_sources.append(("grad_input_dtype", grad_input_dtype))
    if line_input_dtype is not None:
        narrow_sources.append(("line_input_dtype", line_input_dtype))
    if fun_input_dtype is not None:
        narrow_sources.append(("fun_input_dtype", fun_input_dtype))
    for _name, _dt in narrow_sources:
        d = jnp.dtype(_dt)
        if narrow_dtype is not None and d != narrow_dtype:
            raise ValueError(
                f"{_name}={_dt!r} conflicts with an earlier narrow input "
                f"dtype {narrow_dtype} — all *_input_dtype options must "
                "match; they share one prepared input copy")
        narrow_dtype = d

    prepare = None
    if narrow_dtype is not None:
        if jnp.issubdtype(narrow_dtype, jnp.integer):
            if narrow_dtype != jnp.dtype(jnp.uint8):
                raise ValueError(
                    f"integer narrow input dtype must be uint8 (the pixel "
                    f"quantization convention), got {narrow_dtype}")

            def prepare(aux):
                xq = jnp.clip(jnp.round(aux[0] * 255.0), 0.0, 255.0)
                return (aux[0], aux[1], xq.astype(jnp.uint8))
        else:
            def prepare(aux, _d=narrow_dtype):
                return (aux[0], aux[1], aux[0].astype(_d))

    return make_problem(fun, line_fun=line_fun, line_prefix=line_prefix,
                        prepare=prepare)


def quantize_pixels(x: jax.Array) -> jax.Array:
    """Pixel-quantize an in-[0,1] input matrix to the uint8 grid
    (``round(x*255)``) — the storage convention every ``*_input_dtype=
    "uint8"`` consumer expects (the 1/255 rescale rides the dot epilogues).
    Exact for k/255 pixel data; off-grid values clip and round."""
    return jnp.clip(jnp.round(x * 255.0), 0.0, 255.0).astype(jnp.uint8)


def mlp_batch_problem(
    spec: MLPSpec, lam: float = 0.0, compute_dtype=None
) -> BatchProblem:
    """Per-batch problem for stochastic solvers; callables take (w, xb, yb).

    Callers may hand the problem uint8 pixel-quantized batches
    (``quantize_pixels``); ``mlp_apply`` upcasts inside the first dot and
    rescales on its output epilogue, so every per-step (b, in_dim) batch
    read — the dominant HBM term of a fixed-step stochastic epoch — is a
    quarter of f32, and the per-epoch full-dataset recording read shrinks
    the same way. Exact for k/255 pixel data; the device-side analogue of
    nothing in the reference (its SGD reads f32, src/cuda/sgd.cuh:100-124).
    Non-uint8 integer batches are rejected by ``mlp_apply``."""

    def per_sample(w, xb, yb):
        out = mlp_apply(spec, w, xb, compute_dtype)
        diff = out - yb
        return 0.5 * jnp.sum(diff * diff, axis=1)

    reg = (lambda w: 0.5 * lam * jnp.vdot(w, w)) if lam else None
    return make_batch_problem(per_sample, reg)


def take_batch(x: jax.Array, y: jax.Array, indices: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Gather a minibatch by index set (the reference's column-gather,
    src/unified_optimization.hpp:268-271, as one XLA gather)."""
    return jnp.take(x, indices, axis=0), jnp.take(y, indices, axis=0)


def evaluate(spec: MLPSpec, w: jax.Array, x: jax.Array, y: jax.Array) -> dict:
    """Accuracy (argmax match) and total 0.5*||out-y||^2, as the reference's
    Network::test prints (reference: src/network.hpp:121-144)."""
    out = mlp_apply(spec, w, x)
    pred = jnp.argmax(out, axis=1)
    true = jnp.argmax(y, axis=1)
    correct = jnp.sum(pred == true)
    diff = out - y
    mse = 0.5 * jnp.sum(diff * diff)
    n = x.shape[0]
    return {
        "n": n,
        "correct": int(correct),
        "accuracy": float(correct) / n * 100.0,
        "total_mse": float(mse),
    }
