"""Minibatch index sampling primitives.

The reference samples minibatches uniformly WITHOUT replacement via partial
Fisher-Yates (reference: src/minimizer/s_gd.hpp:146-170,
src/minimizer/s_lbfgs.hpp:141-160). Two implementations of the same
distribution:

* ``"topk"`` (default) — draw n iid 32-bit random keys and take the
  indices of the ``size`` largest. For exchangeable iid keys every
  size-subset is equally likely and the rank order within the subset is a
  uniform random permutation, so this is a uniform without-replacement
  draw — a partial selection instead of a full argsort. Caveat: key collisions are tie-broken by index,
  biasing toward lower indices; integer keys use all 2^32 values (vs ~2^24
  for f32 uniforms in [0, 1)), so the expected number of colliding pairs
  is n^2/2^33 — ~0.4 at n = 60000, i.e. negligible but not exactly zero.
  Use ``"sort"`` where exact uniformity matters.
* ``"sort"`` — ``jax.random.permutation(key, n)[:size]`` (the round-1
  implementation; a full random argsort). Kept because its index *stream*
  differs from topk's: existing trajectories/checkpoints reproduce only
  under the sampler they were created with.

Both are deterministic functions of ``key``; solver mirrors in the test
suite call this same helper so trajectory parity pins the solver logic
regardless of which sampler is selected.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def sample_without_replacement(key, n: int, size: int, impl: str = "topk"):
    """``size`` distinct indices from ``range(n)``, uniformly, keyed on
    ``key``. See the module docstring for the two implementations."""
    if impl == "topk":
        # Raw 32-bit keys, bitcast to int32 for top_k (any strict total
        # order on iid keys gives the same distribution). See the module
        # docstring for the collision/tie-bias accounting.
        bits = jax.random.bits(key, (n,), dtype=jnp.uint32)
        return lax.top_k(lax.bitcast_convert_type(bits, jnp.int32), size)[1]
    if impl == "sort":
        return jax.random.permutation(key, n)[:size]
    raise ValueError(f"unknown sampler impl {impl!r}")
