"""Baby Bear prime field F_p, p = 15*2^27 + 1, Montgomery form (JAX).

Matches the reference's vendored RISC Zero ``Fp``
(src/ulvt/finite_fields/risc0_baby_bear.h:43-190): M = 0x88000001 = -P^-1
mod 2^32, R = 2^32, R2 = 1172168163; REDC multiply, add/sub with one
conditional correction.

``mulhi`` is built from 16-bit limb products — four uint32 multiplies plus
carries, all elementwise and fusible, with no 64-bit type (JAX runs
without x64).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

P = 15 * (1 << 27) + 1          # 0x78000001
M = 0x88000001                  # -P^-1 mod 2^32
R2 = 1172168163                 # (2^32)^2 mod P

__all__ = ["P", "M", "R2", "add", "sub", "mont_mul", "encode", "decode",
           "pow_host", "inv_host"]


def add(a, b):
    """(a + b) mod P for canonical inputs; risc0_baby_bear.h:160-163."""
    r = a + b
    return jnp.where(r >= P, r - P, r)


def sub(a, b):
    """(a - b) mod P for canonical inputs; risc0_baby_bear.h:166-169."""
    r = a - b
    return jnp.where(r > P, r + P, r)


def _mulhi32(a, b):
    """High 32 bits of the 64-bit product of two uint32 arrays."""
    a0 = a & 0xFFFF
    a1 = a >> 16
    b0 = b & 0xFFFF
    b1 = b >> 16
    t = a0 * b0
    mid = a0 * b1 + (t >> 16)
    mid2 = a1 * b0 + (mid & 0xFFFF)
    return a1 * b1 + (mid >> 16) + (mid2 >> 16)


def _mul32_full(a, b):
    """(low, high) 32 bits of a*b from ONE set of four 16x16 limb
    products — ``a * b`` and ``_mulhi32(a, b)`` computed separately cost
    the limb products twice (XLA can't CSE across the two lowerings)."""
    a0 = a & 0xFFFF
    a1 = a >> 16
    b0 = b & 0xFFFF
    b1 = b >> 16
    t = a0 * b0
    m1 = a0 * b1
    m2 = a1 * b0
    mid = m1 + (t >> 16)
    mid2 = m2 + (mid & 0xFFFF)
    hi = a1 * b1 + (mid >> 16) + (mid2 >> 16)
    lo = t + ((m1 + m2) << 16)
    return lo, hi


def _mulhi_P(a):
    """High 32 bits of a * P, specialised for P = 0x78000001.

    P's limbs are b0 = 1, b1 = 0x7800 = (1<<15) - (1<<11), so the four
    generic 16x16 limb products collapse to shifts: integer multiplies
    are the costly op in this path, and this removes 4 of the generic
    path's 11 per-butterfly multiplies.
    """
    a0 = a & 0xFFFF
    a1 = a >> 16
    mid = (a0 << 15) - (a0 << 11)          # a0 * 0x7800  (< 2^31)
    mid2 = a1 + (mid & 0xFFFF)             # a1 * b0 + carry limb
    return (a1 << 15) - (a1 << 11) + (mid >> 16) + (mid2 >> 16)


def mont_mul(a, b):
    """Montgomery multiply: REDC(a*b); risc0_baby_bear.h:172-179.

    ret = hi(a*b) + hi(red*P) + (lo(a*b) != 0), red = -(M * lo(a*b))
    mod 2^32, then one conditional subtract.

    Multiply-count: the reference form costs 11 emulated u32 multiplies
    per call; here only the four 16x16 limb products of a*b remain —
    ``M * lo`` is shift-only (M = 0x88000001 = 2^31 + 2^27 + 1, and the
    reference's trailing ``* 0xFFFFFFFF`` is just negation), and
    ``hi(red*P)`` is shift-only via _mulhi_P.
    """
    lo, hi = _mul32_full(a, b)
    red = jnp.uint32(0) - (lo + (lo << 31) + (lo << 27))
    ret = hi + _mulhi_P(red) + (lo != 0).astype(jnp.uint32)
    return jnp.where(ret >= P, ret - P, ret)


def encode(a):
    """uint32 -> Montgomery form: a*R mod P (wraps a >= P like the reference)."""
    return mont_mul(a, jnp.uint32(R2))


def decode(a):
    """Montgomery form -> canonical uint32: a*R^-1 mod P."""
    return mont_mul(a, jnp.uint32(1))


# ---- host-side scalar helpers (twiddle precompute, test oracles) ----

def pow_host(x: int, n: int) -> int:
    return pow(x % P, n, P)


def inv_host(x: int) -> int:
    """Fermat inverse, x^(P-2); risc0_baby_bear.h:149."""
    return pow(x % P, P - 2, P)


def encode_host(v: np.ndarray) -> np.ndarray:
    """Vectorised host-side Montgomery encode of canonical uint32 values."""
    v = v.astype(np.uint64)
    return ((v << np.uint64(32)) % np.uint64(P)).astype(np.uint32)
