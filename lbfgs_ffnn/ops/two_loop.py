"""L-BFGS two-loop recursion and curvature-pair ring buffer, functional.

The reference keeps (s, y, rho) history in a heap RingBuffer
(reference: src/minimizer/ring_buffer.hpp) and runs the two-loop recursion as
~4m separate BLAS calls — on the CUDA backend each dot product is a
host-synchronizing cuBLAS launch (reference: src/cuda/lbfgs.cuh:206-261),
which is the dominant per-iteration latency at large m.

Here the history is a pair of fixed-shape ``(m, n)`` stacked arrays plus
``head``/``count`` ring indices carried as traced ints; the recursion is a
``lax.fori_loop`` over the *static* capacity ``m`` with masking of empty
slots, so the whole thing compiles into one XLA program with zero host
synchronization. :func:`two_loop_compact` computes the same product as
a few GEMVs over the whole history (cuBLAS on a GPU).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


LANE_ALIGN = 1024  # row padding of the (m, rows, 128) ring layout

# Direction forms a solver's ``two_loop_impl`` may name: the loop form
# (:func:`two_loop`) and the GEMV form (:func:`two_loop_compact`).
TWO_LOOP_IMPLS = ("xla", "compact")


def _round_up(x: int, k: int = LANE_ALIGN) -> int:
    return -(-x // k) * k


class RingState(NamedTuple):
    """Fixed-shape curvature history.

    S, Y are stored ``(m, rows, 128)`` with ``rows = n_pad / 128`` and
    ``n_pad`` the parameter count rounded up to 1024 (2048 for a narrow
    ``pair_dtype``); pushes pad+reshape their row, reads slice. Zero
    padding is inert in every dot/axpy of the recursion. Each row is
    contiguous in memory, so the layout is equivalent to a flat
    ``(m, n_pad)`` stack; the 3-D shape and the padding are kept from the
    layout an earlier fused kernel consumed, and the parameter-sharded
    mode shards the ``rows`` axis.
    """

    S: jax.Array      # (m, rows, 128)
    Y: jax.Array      # (m, rows, 128)
    rho: jax.Array
    head: jax.Array   # int32: next physical slot to write
    count: jax.Array  # int32: number of valid pairs (<= m)


def ring_n_pad(hist: "RingState") -> int:
    """Padded parameter length of a ring (rows * 128)."""
    return hist.S.shape[1] * hist.S.shape[2]


def empty_history_state(m: int, n: int, dtype=jnp.float32,
                        pair_dtype=None) -> RingState:
    """``pair_dtype`` stores the (S, Y) stacks in a narrower dtype than the
    solver (e.g. bfloat16: halves the ring's HBM footprint AND the two-loop's
    4mn streaming traffic — the dominant per-iteration cost at large m*n).
    rho and all recursion arithmetic stay in ``dtype``; rows are padded to
    2048 (16 x 128) when narrower than 4 bytes."""
    pd = jnp.dtype(pair_dtype) if pair_dtype is not None else jnp.dtype(dtype)
    align = 2048 if pd.itemsize < 4 else LANE_ALIGN
    n_pad = _round_up(n, align)
    return RingState(
        S=jnp.zeros((m, n_pad // 128, 128), dtype=pd),
        Y=jnp.zeros((m, n_pad // 128, 128), dtype=pd),
        rho=jnp.zeros((m,), dtype=dtype),
        head=jnp.int32(0),
        count=jnp.int32(0),
    )


def _pad_to(v: jax.Array, n_pad: int) -> jax.Array:
    n = v.shape[0]
    if n == n_pad:
        return v
    return jnp.zeros((n_pad,), dtype=v.dtype).at[:n].set(v)


def _pad_row(v: jax.Array, n_pad: int) -> jax.Array:
    """Pad a flat vector to n_pad and shape it as a (rows, 128) tile row
    (reshape of a freshly built array — free, unlike reshaping a carried
    buffer at a kernel boundary)."""
    return _pad_to(v, n_pad).reshape(n_pad // 128, 128)


def ring_push(hist: RingState, s: jax.Array, y: jax.Array, rho: jax.Array, accept) -> RingState:
    """Conditionally push a curvature pair (overwrite-oldest ring semantics).

    When ``accept`` is False the state is unchanged — the functional mirror of
    the reference's curvature gate ``y^T s > 1e-10`` guarding push_back
    (reference: src/minimizer/lbfgs.hpp:77-82, src/cuda/lbfgs.cuh:163-168).
    """
    m = hist.S.shape[0]
    n_pad = ring_n_pad(hist)
    s = _pad_row(s, n_pad).astype(hist.S.dtype)  # narrowed if pair_dtype set
    y = _pad_row(y, n_pad).astype(hist.Y.dtype)
    # Write the head row unconditionally, selecting between the new pair
    # and the existing row — NOT `where(accept, S.at[...].set(...), S)`,
    # whose select touches the whole (m, n_pad) buffer (82 MB at m=100,
    # n=102k, copied every iteration). This form reads+writes one
    # row and keeps the dynamic-update in place.
    S = hist.S.at[hist.head].set(jnp.where(accept, s, hist.S[hist.head]))
    Y = hist.Y.at[hist.head].set(jnp.where(accept, y, hist.Y[hist.head]))
    rho_arr = hist.rho.at[hist.head].set(
        jnp.where(accept, rho, hist.rho[hist.head])
    )
    head = jnp.where(accept, (hist.head + 1) % m, hist.head)
    count = jnp.where(accept, jnp.minimum(hist.count + 1, m), hist.count)
    return RingState(S=S, Y=Y, rho=rho_arr, head=head, count=count)


def ring_reset(hist: RingState, do_reset) -> RingState:
    """Conditionally drop all pairs (reference: src/cuda/lbfgs.cuh:73-76)."""
    head = jnp.where(do_reset, jnp.int32(0), hist.head)
    count = jnp.where(do_reset, jnp.int32(0), hist.count)
    return RingState(S=hist.S, Y=hist.Y, rho=hist.rho, head=head, count=count)


def _two_loop_core(
    v, S, Y, rho, head, count, dot,
    clamp_gamma: bool, gamma_min: float, gamma_max: float,
):
    """Two-loop recursion with a pluggable inner-product.

    ``dot(a, b)`` is ``jnp.vdot`` on one device, or a psum-reduced partial
    dot when the parameter axis is sharded over a mesh. ``v`` and the
    S/Y rows may be any (matching) shape — vdot flattens; axpys are
    elementwise.
    """
    m = S.shape[0]

    def phys(li):
        # logical index (0 = oldest) -> physical ring slot
        return (head - count + li) % m

    # Backward pass: newest -> oldest.
    def bwd(j, carry):
        q, alphas = carry
        li = count - 1 - j
        valid = li >= 0
        i = phys(jnp.maximum(li, 0))
        a = rho[i] * dot(S[i], q)
        a = jnp.where(valid, a, jnp.zeros_like(a))
        q = q - a * Y[i]
        store = jnp.where(valid, li, 0)
        alphas = alphas.at[store].set(jnp.where(valid, a, alphas[store]))
        return q, alphas

    q0 = v
    alphas0 = jnp.zeros((m,), dtype=v.dtype)
    q, alphas = lax.fori_loop(0, m, bwd, (q0, alphas0))

    # Initial Hessian scaling from the newest pair. Upcast the rows when
    # the ring is stored narrow (pair_dtype=bfloat16): the mixed dots of
    # the passes promote against the f32 working vector automatically, but
    # s.y / y.y here are pair x pair and would reduce in bf16.
    last = phys(jnp.maximum(count - 1, 0))
    s_last = S[last].astype(v.dtype)
    y_last = Y[last].astype(v.dtype)
    ys = dot(s_last, y_last)
    yy = dot(y_last, y_last)
    if clamp_gamma:
        gamma = jnp.where(jnp.abs(yy) < 1e-12, jnp.ones_like(ys), ys / jnp.where(yy == 0, 1.0, yy))
        gamma = jnp.clip(gamma, gamma_min, gamma_max)
    else:
        gamma = jnp.where(yy > 0, ys / jnp.where(yy == 0, 1.0, yy), jnp.ones_like(ys))
    gamma = jnp.where(count > 0, gamma, jnp.ones_like(gamma))

    z = gamma * q

    # Forward pass: oldest -> newest.
    def fwd(li, z):
        valid = li < count
        i = phys(jnp.minimum(li, jnp.maximum(count - 1, 0)))
        b = rho[i] * dot(Y[i], z)
        coeff = jnp.where(valid, alphas[li] - b, jnp.zeros_like(b))
        return z + coeff * S[i]

    return lax.fori_loop(0, m, fwd, z)


def two_loop(
    v: jax.Array,
    hist: RingState,
    *,
    clamp_gamma: bool = False,
    gamma_min: float = 1e-6,
    gamma_max: float = 1e6,
) -> jax.Array:
    """Compute ``r = H_k @ v`` via the two-loop recursion (not negated).

    With empty history returns ``v`` (identity initial Hessian); callers
    negate for a descent direction. The initial scaling is
    ``gamma = (s^T y)/(y^T y)`` of the newest pair; with ``clamp_gamma`` the
    stochastic variant's guards apply (gamma -> 1 when y^T y ~ 0, clamp to
    [1e-6, 1e6]; reference behavior of src/minimizer/s_lbfgs.hpp:119-127).
    """
    n_pad = ring_n_pad(hist)
    S, Y, rho, head, count = hist
    n = v.shape[0]
    v3 = _pad_row(v, n_pad)
    z = _two_loop_core(
        v3, S, Y, rho, head, count, jnp.vdot, clamp_gamma, gamma_min, gamma_max
    )
    return z.reshape(n_pad)[:n]


def two_loop_sharded(
    v: jax.Array,
    hist: RingState,
    mesh,
    axis_name: str = "data",
    *,
    clamp_gamma: bool = False,
    gamma_min: float = 1e-6,
    gamma_max: float = 1e6,
) -> jax.Array:
    """Two-loop recursion with the *parameter axis* sharded over a mesh.

    Each device holds a contiguous column shard of S/Y and of the input
    vector; every inner product in the recursion becomes a partial dot +
    ``psum`` over the mesh, and all vector axpys stay local. Use when the
    curvature history itself exceeds one device's memory — the
    model-parallel complement of the
    batch-sharded gradient evaluation.

    ``v`` must be padded length (``rows * 128``) and sharded on its (only)
    axis; S/Y are sharded on their tile-row axis (``P(None, axis, None)``),
    rho/head/count replicated. The tile-row count must be divisible by the
    mesh axis size. Returns the sharded result vector.
    """
    from jax.sharding import PartitionSpec as P

    S, Y, rho, head, count = hist

    def local(v, S, Y, rho, head, count):
        def dot(a, b):
            return jax.lax.psum(jnp.vdot(a, b), axis_name)

        # Local shard of v viewed as its local tile rows (contiguous
        # shards keep the 1-D <-> (rows, 128) mapping shard-local).
        z = _two_loop_core(
            v.reshape(-1, 128), S, Y, rho, head, count, dot,
            clamp_gamma, gamma_min, gamma_max,
        )
        return z.reshape(-1)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis_name), P(None, axis_name, None),
                  P(None, axis_name, None), P(), P(), P()),
        out_specs=P(axis_name),
    )(v, S, Y, rho, head, count)


class GramRing(NamedTuple):
    """A curvature ring plus the incrementally-maintained Gram data the
    compact two-loop needs: ``M[i, j] = s_i . y_j`` over PHYSICAL ring slots
    and ``yy[i] = y_i . y_i`` per slot (both replicated under sharding —
    O(m^2) scalars). Maintaining M across pushes cuts the compact direction
    to 4mn history traffic (c/q/d/r sweeps only) and — in the sharded form —
    to TWO m-vector psums per direction instead of the loop form's ~4m
    scalar psums. Entries for invalid slots are stale garbage,
    masked by ``count`` exactly like the ring rows themselves.
    """

    ring: RingState
    M: jax.Array   # (m, m) physical-slot Gram
    yy: jax.Array  # (m,)


def gram_empty(m: int, n: int, dtype=jnp.float32, pair_dtype=None) -> GramRing:
    """``pair_dtype`` narrows the ring rows exactly as in
    :func:`empty_history_state`; M/yy (and every Gram update) stay in the
    solver ``dtype`` — bf16 rows feed the GEMVs, f32 accumulates."""
    return GramRing(
        ring=empty_history_state(m, n, dtype, pair_dtype=pair_dtype),
        M=jnp.zeros((m, m), dtype=dtype),
        yy=jnp.zeros((m,), dtype=dtype),
    )


def gram_push(gr: GramRing, s: jax.Array, y: jax.Array, rho: jax.Array, accept) -> GramRing:
    """Ring push + incremental Gram update.

    The new slot's row (``s_new . y_j``) and column (``s_i . y_new``) are two
    (m, n) GEMVs over the post-push history — 2mn traffic, the same cost the
    per-call compact form pays to rebuild M from scratch, but paid once per
    *push* instead of once per *direction* (directions can outnumber pushes).
    The GEMVs run unconditionally and ``jnp.where(accept, ...)`` selects the
    result — a rejected pair still pays the 2mn read (a ``lax.cond`` would
    skip it, but a data-dependent branch around a GEMV blocks XLA fusion and
    costs more than it saves at solver scale; rejections are rare under the
    curvature gate). Under GSPMD with the ring sharded on its tile-row axis,
    XLA partitions the GEMVs and all-reduces the (m,) results automatically.
    """
    head = gr.ring.head  # slot the push writes
    ring = ring_push(gr.ring, s, y, rho, accept)
    n_pad = ring_n_pad(ring)
    m = ring.S.shape[0]
    # M is the Gram of the STORED rows: narrow the new pair to the ring
    # dtype BEFORE the GEMVs (under pair_dtype=bfloat16 the direction's
    # a/b recurrences must see s_i . y_j of the same bf16 rows the q/r
    # sweeps read — mixed f32-vector x bf16-row entries would disagree
    # with the loop form at bf16 rounding level and compound across
    # iterations). Accumulation stays in the solver dtype (M's).
    acc = gr.M.dtype
    s_r = _pad_row(s, n_pad).astype(ring.S.dtype)
    y_r = _pad_row(y, n_pad).astype(ring.Y.dtype)
    # Post-push history: slot `head` already holds (s_new, y_new), so the
    # row/col GEMVs cover the diagonal entry s_new . y_new consistently.
    row = jnp.einsum("mrk,rk->m", ring.Y, s_r,
                     preferred_element_type=acc)   # s_new . y_j
    col = jnp.einsum("mrk,rk->m", ring.S, y_r,
                     preferred_element_type=acc)   # s_i . y_new
    M = jnp.where(
        accept,
        gr.M.at[head, :].set(row).at[:, head].set(col),
        gr.M,
    )
    yy = jnp.where(
        accept,
        gr.yy.at[head].set(
            jnp.einsum("rk,rk->", y_r, y_r, preferred_element_type=acc)
        ),
        gr.yy,
    )
    return GramRing(ring=ring, M=M, yy=yy)


def gram_reset(gr: GramRing, do_reset) -> GramRing:
    """Drop all pairs (stale M/yy entries are masked by count)."""
    return gr._replace(ring=ring_reset(gr.ring, do_reset))


def _compact_recurrences(c, d_fn, Ml, rhol, valid, count, yy_last, dtype,
                         clamp_gamma, gamma_min, gamma_max):
    """The O(m^2) scalar core of the compact form, shared by the dense and
    sharded variants. ``d_fn(gamma, a)`` returns the forward-pass GEMV
    ``d_l = y_l . (gamma * (v - a @ Y))`` — supplied by the caller because
    its reduction is layout-dependent (local vdot vs psum)."""
    m = Ml.shape[0]
    li = jnp.arange(m)

    def bwd(t, a):
        l = m - 1 - t
        mask_newer = (li > l) & valid
        acc = jnp.sum(jnp.where(mask_newer, Ml[l] * a, 0.0))
        a_l = jnp.where(valid[l], rhol[l] * (c[l] - acc), 0.0)
        return a.at[l].set(a_l)

    a = lax.fori_loop(0, m, bwd, jnp.zeros((m,), dtype=dtype))

    last = jnp.maximum(count - 1, 0)
    ys = Ml[last, last]
    yy = yy_last
    if clamp_gamma:
        gamma = jnp.where(jnp.abs(yy) < 1e-12, jnp.ones_like(ys),
                          ys / jnp.where(yy == 0, 1.0, yy))
        gamma = jnp.clip(gamma, gamma_min, gamma_max)
    else:
        gamma = jnp.where(yy > 0, ys / jnp.where(yy == 0, 1.0, yy),
                          jnp.ones_like(ys))
    gamma = jnp.where(count > 0, gamma, jnp.ones_like(gamma))

    d = d_fn(gamma, a)

    def fwd(l, b):
        mask_older = (li < l) & valid
        acc = jnp.sum(jnp.where(mask_older, Ml[:, l] * (a - b), 0.0))
        b_l = jnp.where(valid[l], rhol[l] * (d[l] + acc), 0.0)
        return b.at[l].set(b_l)

    b = lax.fori_loop(0, m, fwd, jnp.zeros((m,), dtype=dtype))
    return a, b, gamma


def two_loop_sharded_compact(
    v: jax.Array,
    gr: GramRing,
    mesh,
    axis_name: str = "data",
    *,
    clamp_gamma: bool = False,
    gamma_min: float = 1e-6,
    gamma_max: float = 1e6,
) -> jax.Array:
    """Parameter-sharded compact two-loop using the maintained Gram matrix:
    collective-lean — exactly TWO psums per direction (the (m,) partial-dot
    vectors ``c = S . v`` and ``d = Y . z0``), vs ~4m scalar psums in
    :func:`two_loop_sharded`. Across devices each scalar psum is pure
    collective latency; the collective count is pinned by a jaxpr assertion
    in tests/test_parallel.py.

    Contract matches :func:`two_loop_sharded`: ``v`` padded and sharded on
    its axis, ring S/Y sharded on the tile-row axis, everything else
    (rho/head/count/M/yy) replicated. Returns the sharded H_k @ v.
    """
    from jax.sharding import PartitionSpec as P

    S, Y, rho, head, count = gr.ring
    m = S.shape[0]

    def local(v, S, Y, rho, head, count, M, yy):
        li = jnp.arange(m)
        phys = (head - count + li) % m
        valid = li < count
        rows = S.shape[1]  # local tile rows
        S2 = S.reshape(m, rows * 128)
        Y2 = Y.reshape(m, rows * 128)
        Sl = S2[phys]
        Yl = Y2[phys]
        rhol = jnp.where(valid, rho[phys], 0.0)
        Ml = M[phys][:, phys]          # logical-order Gram (replicated)
        yy_last = yy[phys[jnp.maximum(count - 1, 0)]]

        c = lax.psum(Sl @ v, axis_name)            # collective 1

        z0_box = {}

        def d_fn(gamma, a):
            q = v - a @ Yl
            z0 = gamma * q
            z0_box["z0"] = z0
            return lax.psum(Yl @ z0, axis_name)    # collective 2

        a, b, gamma = _compact_recurrences(
            c, d_fn, Ml, rhol, valid, count, yy_last, v.dtype,
            clamp_gamma, gamma_min, gamma_max,
        )
        return z0_box["z0"] + (a - b) @ Sl

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis_name), P(None, axis_name, None),
                  P(None, axis_name, None), P(), P(), P(), P(), P()),
        out_specs=P(axis_name),
    )(v, S, Y, rho, head, count, gr.M, gr.yy)


def two_loop_compact(
    v: jax.Array,
    hist: RingState,
    *,
    clamp_gamma: bool = False,
    gamma_min: float = 1e-6,
    gamma_max: float = 1e6,
) -> jax.Array:
    """Compact (GEMM-form) two-loop recursion — same H_k @ v as
    :func:`two_loop`, restructured as dense linear algebra.

    The loop form's 2*count sequential (dot, axpy) stages each wait for a
    reduction over all of n before the next can start. In exact arithmetic the recursion
    collapses to dense linear algebra over the whole history (the classic
    compact representation, cf. Byrd/Nocedal/Schnabel):

        c_i = s_i . v                    (one (m, n) GEMV)
        a_i = rho_i (c_i - sum_{j>i} M_ij a_j),  M_ij = s_i . y_j
                                         (m-step scalar back-substitution)
        q   = v - a @ Y                  (one GEMM)
        z0  = gamma * q
        d_i = y_i . z0                   (one GEMV)
        b_i = rho_i (d_i + sum_{j<i} M_ji (a_j - b_j))
        r   = z0 + (a - b) @ S           (one GEMM)

    All O(n) work is four full-bandwidth reads of the history (plus one
    more for M = S Y^T, computed fresh per call) with NO sequential
    dependency on the n axis — the m-length recurrences touch scalars only.
    Float rounding differs from the loop form in the last ulps (different
    reduction order); the logical trajectory is the same.
    """
    n_pad = ring_n_pad(hist)
    S, Y, rho, head, count = hist
    m = S.shape[0]
    n = v.shape[0]
    v3 = _pad_row(v, n_pad)

    # Logical (oldest -> newest) gather of the ring: physical slot of
    # logical index l is (head - count + l) % m. All gathered objects are
    # O(m) or O(m^2) — cheap.
    li = jnp.arange(m)
    phys = (head - count + li) % m
    valid = (li < count)

    S2 = S.reshape(m, n_pad)
    Y2 = Y.reshape(m, n_pad)
    Sl = S2[phys]                      # (m, n_pad) logical order
    Yl = Y2[phys]
    rhol = jnp.where(valid, rho[phys], 0.0)

    v1 = v3.reshape(n_pad)
    c = Sl @ v1                        # s_l . v (promotes vs f32 v)
    # M accumulates in the solver dtype even when the ring is stored
    # narrow — bf16 inputs with f32 accumulation.
    M = jnp.einsum("ln,jn->lj", Sl, Yl,
                   preferred_element_type=v.dtype)  # M[l, j] = s_l . y_j

    # gamma's y.y from the newest pair (upcast: bf16 x bf16 would sum in
    # bf16); s.y comes from M inside the shared recurrence core.
    last = jnp.maximum(count - 1, 0)
    y_last = Yl[last].astype(v.dtype)
    yy_last = jnp.sum(y_last * y_last)

    z0_box = {}

    def d_fn(gamma, a):
        z0 = gamma * (v1 - a @ Yl)
        z0_box["z0"] = z0
        return Yl @ z0                 # y_l . z0

    a, b, _ = _compact_recurrences(
        c, d_fn, M, rhol, valid, count, yy_last, v.dtype,
        clamp_gamma, gamma_min, gamma_max,
    )
    r = z0_box["z0"] + (a - b) @ Sl
    return r[:n]
