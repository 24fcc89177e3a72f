"""Cross-device collectives for binary-field reductions.

The reference's only reductions are intra-kernel ``atomicXor``
(src/ulvt/sumcheck/core/kernels.cuh:86-101) and ``atomicAdd`` on u64
(src/ulvt/prime_field_sumcheck/core/kernels.cu:70-77).  Across a device mesh:

  * XOR is NOT ``lax.psum`` (psum adds); an XOR all-reduce is composed from
    ``all_gather`` + a local XOR tree.  XOR is associative and commutative,
    so the result is bit-identical on every device and deterministic —
    stronger than the reference's atomics (which are merely
    order-insensitive by algebra).
  * The M31 modular sum uses ``psum`` on uint32 lifted pairwise — but to
    stay in uint32 without overflow we use the same gather + modular-tree
    approach (device counts are small; the payload is a few hundred bytes).

These are called inside ``shard_map``-decorated programs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..fields.m31 import m31_add

__all__ = ["xor_all_reduce", "m31_all_reduce"]


def xor_all_reduce(x, axis_name: str):
    """All-reduce with the XOR monoid over a mesh axis."""
    gathered = jax.lax.all_gather(x, axis_name)  # (D, ...)
    return jax.lax.reduce(gathered, jnp.uint32(0), jax.lax.bitwise_xor, (0,))


def m31_all_reduce(x, axis_name: str):
    """All-reduce with addition mod 2^31 - 1 (components canonical)."""
    gathered = jax.lax.all_gather(x, axis_name)
    return jax.lax.reduce(gathered, jnp.uint32(0), m31_add, (0,))
