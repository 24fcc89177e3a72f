"""Bit-sliced binary-tower arithmetic as a *stacked* Karatsuba pipeline (JAX).

The reference implements bit-sliced multiplication as ~30k lines of
machine-generated straight-line XOR/AND code (multiply_unrolled<H>,
src/ulvt/finite_fields/circuit_generator/unrolled/binary_tower_unrolled*.cu,
produced by circuit_generator/multiply_and_generate_circuit.cpp:86-155).

We do not need codegen: the Karatsuba recursion *is* the circuit, and we
evaluate it level-synchronously — at level ``d`` all ``3^d`` pending
half-width products are stacked along one axis and processed by a handful
of large vector ops.  This keeps the XLA graph to O(height^2) ops (instead
of ~15k statements) while performing the same 3^h leaf ANDs.

Layout: an array of shape ``(..., W)`` uint32, ``W = 2^height``, where the
last axis is the bit-plane index and each bit-lane of a word is one of 32
field elements — identical to the reference's bit-sliced layout
(see layout/bitslicing.py).

``multiply(a, b, height)`` multiplies 32 * prod(batch shape) elements.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["multiply", "multiply_alpha", "square", "mul_subfield_chunks"]


def multiply_alpha(x, height: int):
    """Bit-sliced multiply by the tower generator alpha_height.

    cf. generic_multiply_alpha (binary_tower.cuh:83-93): [a0,a1] -> [a1, a0 ^
    alpha_{h-1}(a1)].  `x`: (..., 2^height) uint32 bit-planes.
    """
    if height == 0:
        return x
    half = x.shape[-1] // 2
    x0, x1 = x[..., :half], x[..., half:]
    return jnp.concatenate([x1, x0 ^ multiply_alpha(x1, height - 1)], axis=-1)


def multiply(a, b, height: int):
    """Bit-sliced tower multiply of (..., 2^height) bit-plane arrays.

    Same function as the reference's multiply_unrolled<height>
    (binary_tower_unrolled.cuh:4-5), evaluated level-synchronously.
    """
    w = 1 << height
    assert a.shape[-1] == w and b.shape[-1] == w, (a.shape, b.shape, height)
    a, b = jnp.broadcast_arrays(a, b)

    # Forward sweep: split each pending product into Karatsuba's three
    # half-width products, stacked block-wise along a new axis:
    # [all z0 operands | all z2 operands | all middle operands].
    A = a[..., None, :]
    B = b[..., None, :]
    for _ in range(height):
        half = A.shape[-1] // 2
        a0, a1 = A[..., :half], A[..., half:]
        b0, b1 = B[..., :half], B[..., half:]
        A = jnp.concatenate([a0, a1, a0 ^ a1], axis=-2)
        B = jnp.concatenate([b0, b1, b0 ^ b1], axis=-2)

    z = A & B  # (..., 3^height, 1): all leaf products in one vector op

    # Unwind: combine triples back up.  At level d the sub-products have
    # width 2^(d-1) and we emit width-2^d results:
    #   lo = z0 ^ z2 ; hi = (zm ^ z0 ^ z2) ^ alpha_{d-1}(z2)
    # cf. generic_multiply (binary_tower.cuh:44-49).
    for d in range(1, height + 1):
        k = z.shape[-2] // 3
        z0 = z[..., :k, :]
        z2 = z[..., k : 2 * k, :]
        zm = z[..., 2 * k :, :]
        lo = z0 ^ z2
        hi = zm ^ lo ^ multiply_alpha(z2, d - 1)
        z = jnp.concatenate([lo, hi], axis=-1)

    return z[..., 0, :]


def square(a, height: int):
    """Bit-sliced squaring: [a0,a1] -> [s0 ^ s2, alpha(s2)] with s = a^2.

    cf. generic_square (binary_tower.cuh:52-61).  Squaring is GF(2)-linear so
    this is XOR-only (no ANDs at all).
    """
    if height == 0:
        return a
    half = a.shape[-1] // 2
    s0 = square(a[..., :half], height - 1)
    s2 = square(a[..., half:], height - 1)
    return jnp.concatenate([s0 ^ s2, multiply_alpha(s2, height - 1)], axis=-1)


def mul_subfield_chunks(x, coeff_planes, full_height: int, sub_height: int):
    """Multiply a bit-sliced batch by a subfield scalar, chunk-wise.

    GF(2^(2^full)) is a vector space over GF(2^(2^sub)); multiplying by a
    subfield element acts independently on each 2^sub-bit chunk.  This is the
    reference's interpolation-point fold path (core.cu:45-48: one
    multiply_unrolled<2> per 4-plane chunk against the coefficient batch's
    first 4 planes).

    `x`: (..., 2^full) bit-planes; `coeff_planes`: (..., 2^sub) bit-planes of
    the (subfield-valued) coefficient batch.
    """
    wf, ws = 1 << full_height, 1 << sub_height
    lead = x.shape[:-1]
    chunks = x.reshape(lead + (wf // ws, ws))
    prod = multiply(chunks, coeff_planes[..., None, :], sub_height)
    return prod.reshape(lead + (wf,))
