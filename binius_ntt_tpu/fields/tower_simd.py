"""Packed (SWAR) binary-tower multiplication, vectorised over JAX arrays.

A uint32 word is interpreted as ``32 / 2^h`` packed GF(2^(2^h)) elements and
all of them are multiplied in parallel using only XOR/AND/shift — exactly the
representation of the reference's ``mul_binary_tower_32b_simd``
(src/ulvt/finite_fields/binary_tower_simd.cuh:77-149).  Every op is an
elementwise uint32 instruction, so it vectorises over arrays of any shape
with no code change (the idiomatic replacement for the reference's
per-thread scalar calls).

At height 5 a word holds a single GF(2^32) element, so this function doubles
as the *compact-layout* multiplier used by the additive NTT butterfly —
~2^h leaf ANDs per word versus 3^h for the element-recursive form
(binary_tower.cuh:35-50), because Karatsuba's three half-width products are
evaluated two-per-word in the even/odd lanes.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["mul_packed", "inverse_packed", "interleave_32b",
           "xor_adjacent_32b", "MASKS", "ALPHAS"]

# binary_tower_simd.cuh:37-67
MASKS = (0x55555555, 0x33333333, 0x0F0F0F0F, 0x00FF00FF, 0x0000FFFF)
ALPHAS = (0x55555555, 0x22222222, 0x04040404, 0x00100010, 0x00000100)


def interleave_32b(a, b, height: int):
    """cf. binary_tower_simd.cuh:129-139; works on arrays."""
    mask = jnp.uint32(MASKS[height])
    blen = 1 << height
    t = ((a >> blen) ^ b) & mask
    return a ^ (t << blen), b ^ t


def xor_adjacent_32b(a, height: int):
    """cf. binary_tower_simd.cuh:141-149."""
    mask = jnp.uint32(MASKS[height])
    blen = 1 << height
    t = ((a >> blen) ^ a) & mask
    return t ^ (t << blen)


def mul_packed(a, b, height: int):
    """Lane-parallel tower multiply; cf. binary_tower_simd.cuh:82-127.

    `a`, `b`: uint32 arrays (any shape, broadcastable) of packed elements.
    """
    if height == 0:
        return a & b
    h = height - 1
    z0_even_z2_odd = mul_packed(a, b, h)

    lo, hi = interleave_32b(a, b, h)
    lo_plus_hi = lo ^ hi

    even_mask = jnp.uint32(MASKS[h])
    alphas = jnp.uint32(ALPHAS[h])
    blen = 1 << h
    odd_mask = jnp.uint32((MASKS[h] << blen) & 0xFFFFFFFF)

    alpha_even_z2_odd = alphas ^ (z0_even_z2_odd & odd_mask)
    a_lh_even_alpha_odd, b_lh_even_z2_odd = interleave_32b(
        lo_plus_hi, alpha_even_z2_odd, h
    )
    z1z0z2_even_z2a_odd = mul_packed(a_lh_even_alpha_odd, b_lh_even_z2_odd, h)

    zero_even_sum_odd = (
        z1z0z2_even_z2a_odd ^ (z1z0z2_even_z2a_odd << blen)
    ) & odd_mask
    z0_plus_z2_dup = xor_adjacent_32b(z0_even_z2_odd, h)
    return z0_plus_z2_dup ^ zero_even_sum_odd


def inverse_packed(x, height: int):
    """Tower-field inverse of ONE element per uint32 word (any array shape).

    Device-side port of generic_inverse (binary_tower.cuh:63-81):
    delta = a0*(a0 ^ alpha*a1) ^ a1^2, then recurse; the reference's
    height-2 inverse table becomes Fermat x^14 = x^2 * x^4 * x^8 in GF(16)
    (branchless, no gathers).  inverse(0) = 0, like the reference's table.
    The element must occupy the low 2^height bits (upper bits zero), which
    keeps every lane-parallel sub-multiply's unused lanes zero.

    No production path calls it — NTT normalisation inverts log_h scalars
    on the HOST and neither sumcheck prover inverts on device — so it has
    no kernel; revisit only if an inverse ever lands on a hot path.
    """
    if height <= 2:
        x2 = mul_packed(x, x, 2)
        x4 = mul_packed(x2, x2, 2)
        x8 = mul_packed(x4, x4, 2)
        return mul_packed(x2, mul_packed(x4, x8, 2), 2)
    h = height - 1
    half = 1 << h
    mask = jnp.uint32((1 << half) - 1)
    a0 = x & mask
    a1 = x >> half
    alpha = jnp.uint32(1 << (1 << (h - 1)))     # x_h basis element
    intermediate = a0 ^ mul_packed(a1, alpha, h)
    delta = mul_packed(a0, intermediate, h) ^ mul_packed(a1, a1, h)
    dinv = inverse_packed(delta, h)
    out0 = mul_packed(dinv, intermediate, h)
    out1 = mul_packed(dinv, a1, h)
    return (out1 << half) | out0
