"""Compact-layout tower multiplication above 32 bits: one element = 2^(h-5)
uint32 limbs (little-endian), vectorised over element arrays.

The reference's compact wide muls live in its test utils — the 64-bit
scalar tower (src/ulvt/sumcheck/test/utils/unbitsliced_mul.cuh:16-262) and
the 128-bit Karatsuba split on top of it
(src/ulvt/sumcheck/test/utils/tower_7_mul.cu:4-24).  Here they are
device-side vector ops (compact 4x-uint32-per-element GF(2^128)
multiplication):

  * heights <= 5 delegate to the SWAR form (one full element per uint32
    word, tower_simd.mul_packed at height 5);
  * heights 6 and 7 run the Fan-Paar Karatsuba recursion over the limb
    axis: split into halves, three sub-multiplies plus multiply-by-alpha
    (binary_tower.cuh:35-50 widened to limb vectors).

Layout: limbs on the LAST axis — ``a`` has shape (..., L) with
L = 2^(height-5) uint32 limbs per element.
"""

from __future__ import annotations

import jax.numpy as jnp

from .tower_simd import mul_packed

__all__ = ["mul_compact", "multiply_alpha_compact"]


def _alpha_limbs(x, height: int):
    """multiply_alpha over limb-major list of arrays; binary_tower.cuh:83-93."""
    if height <= 5:
        # single limb: SWAR path's alpha is mul by the constant alpha element
        alpha = jnp.uint32(1 << (1 << (height - 1))) if height >= 1 else None
        if height == 0:
            return [x[0]]            # alpha = 1 at height 0
        return [mul_packed(x[0], alpha, height)]
    half = len(x) // 2
    x0, x1 = x[:half], x[half:]
    t = _alpha_limbs(x1, height - 1)
    return list(x1) + [a ^ b for a, b in zip(x0, t)]


def _mul_limbs(a, b, height: int):
    """Karatsuba over limb lists; binary_tower.cuh:35-50 on limb vectors."""
    if height <= 5:
        return [mul_packed(a[0], b[0], height)]
    h = height - 1
    half = len(a) // 2
    a0, a1 = a[:half], a[half:]
    b0, b1 = b[:half], b[half:]
    z0 = _mul_limbs(a0, b0, h)
    z2 = _mul_limbs(a1, b1, h)
    zm = _mul_limbs([x ^ y for x, y in zip(a0, a1)],
                    [x ^ y for x, y in zip(b0, b1)], h)
    z2a = _alpha_limbs(z2, h)
    lo = [x ^ y for x, y in zip(z0, z2)]
    hi = [m ^ l ^ x for m, l, x in zip(zm, lo, z2a)]
    return lo + hi


def mul_compact(a, b, height: int = 7):
    """Tower product of compact element arrays.

    a, b: uint32 arrays of shape (..., 2^(height-5)) for height > 5, or
    any broadcastable shape for height <= 5 (one element per word).
    """
    if height <= 5:
        return mul_packed(a, b, height)
    nl = 1 << (height - 5)
    la = [a[..., i] for i in range(nl)]
    lb = [b[..., i] for i in range(nl)]
    return jnp.stack(_mul_limbs(la, lb, height), axis=-1)


def multiply_alpha_compact(x, height: int = 7):
    """x * alpha_height for compact element arrays (binary_tower.cuh:83-93)."""
    if height <= 5:
        return _alpha_limbs([x], height)[0]
    nl = 1 << (height - 5)
    return jnp.stack(
        _alpha_limbs([x[..., i] for i in range(nl)], height), axis=-1)
