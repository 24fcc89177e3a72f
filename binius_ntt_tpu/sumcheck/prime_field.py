"""Sumcheck prover over the QM31 prime extension field.

Parity with the reference prime-field prover
(src/ulvt/prime_field_sumcheck/sumcheck.cuh:8-97, core/kernels.cu:5-78):
  * fixed 2 multilinear columns, degree-2 composition (a product);
  * ``round_messages()`` returns the round polynomial evaluated at X = 0, 1, 2:
    p(0) = sum of lower products, p(1) = sum of upper products,
    p(2) via (upper - lower) + upper per column (kernels.cu:44-63);
  * ``fold(challenge)``: lower' = lower + (upper - lower) * challenge
    (kernels.cu:5-25).

Formulation: sums are modular tree reductions with the M31 add monoid —
bit-identical to the reference's lazy u64 accumulation + atomicAdd + final
reduction (kernels.cu:65-77, qm31.cuh:75-78) because every partial is
canonical mod P and addition mod P is associative/commutative.  This also
maps directly onto ``psum``-style cross-device reduction later.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..fields.m31 import P, m31_add, m31_sub, qm31_mul

__all__ = ["PrimeFieldSumcheck", "interpolate_at_host"]

ONE_HALF = 0x40000000  # 2^30 == 1/2 mod P (prime_field_sumcheck/utils/interpolate.hpp:3)


# Fixed-shape kernels: the buffer keeps its full (2, B, 4) shape for the
# whole protocol and the live row count arrives as a traced scalar, so ONE
# compile serves every round (the reference re-picks launch dims per round
# through a 13-way if/else ladder, test_sumcheck.cu:36-64; per-round-shape
# jits would compile once per round).  A power of two:
# then a tile smaller than the live half divides it, and a larger one
# reads rows still inside the buffer (a slice past its end would be
# clamped, not refused).
ROW_TILE = 4096


@jax.jit
def _round_kernel(evals, rows):
    """evals: (2, B, 4), rows: traced live count -> points (3, 4)."""
    _, b, _ = evals.shape
    tile = min(ROW_TILE, b // 2)
    half = rows // 2
    tiles = (half + tile - 1) // tile

    def masked(t, base):
        idx = base + jax.lax.broadcasted_iota(jnp.int32, (tile, 1), 0)
        return jnp.where(idx < half, t, jnp.uint32(0))

    def body(state):
        i, acc = state
        base = i * tile
        lower = jax.lax.dynamic_slice(evals, (0, base, 0), (2, tile, 4))
        upper = jax.lax.dynamic_slice(
            evals, (0, base + half, 0), (2, tile, 4))
        two_up_minus_low = m31_add(m31_sub(upper, lower), upper)

        def reduce_prod(lo, up):  # (tile, 4) each -> (4,)
            prod = masked(qm31_mul(lo, up), base)   # 0 = add identity
            return jax.lax.reduce(prod, jnp.uint32(0), _m31_add_monoid, (0,))

        part = jnp.stack([
            reduce_prod(lower[0], lower[1]),
            reduce_prod(upper[0], upper[1]),
            reduce_prod(two_up_minus_low[0], two_up_minus_low[1]),
        ])
        return i + jnp.int32(1), _m31_add_monoid(acc, part)

    init = (jnp.int32(0), jnp.zeros((3, 4), jnp.uint32))
    _, acc = jax.lax.while_loop(lambda s: s[0] < tiles, body, init)
    # the monoid keeps the s == P alias of 0 (self-correcting on every
    # later add, but not on the last one): canonicalise the final value
    return jnp.where(acc == jnp.uint32(P), jnp.uint32(0), acc)


def _m31_add_monoid(a, b):
    s = a + b
    return (s + (s >> 31)) & jnp.uint32(P)


@functools.partial(jax.jit, donate_argnums=(0,))
def _fold_kernel(evals, challenge, rows):
    """Fold rows [0, rows) in half in the fixed (2, B, 4) buffer; the stale
    upper region is never read again (kernels.cu:20-28 convention).
    Donates the buffer (the caller rebinds) so peak HBM stays one copy."""
    _, b, _ = evals.shape
    tile = min(ROW_TILE, b // 2)
    half = rows // 2
    tiles = (half + tile - 1) // tile

    def body(state):
        i, buf = state
        base = i * tile
        lower = jax.lax.dynamic_slice(evals, (0, base, 0), (2, tile, 4))
        upper = jax.lax.dynamic_slice(
            evals, (0, base + half, 0), (2, tile, 4))
        folded = m31_add(lower, qm31_mul(m31_sub(upper, lower), challenge))
        idx = base + jax.lax.broadcasted_iota(jnp.int32, (tile, 1), 0)
        folded = jnp.where(idx < half, folded, lower)
        buf = jax.lax.dynamic_update_slice(buf, folded, (0, base, 0))
        return i + jnp.int32(1), buf

    init = (jnp.int32(0), evals)
    _, buf = jax.lax.while_loop(lambda s: s[0] < tiles, body, init)
    return buf


class PrimeFieldSumcheck:
    """QM31 sumcheck prover for the degree-2 two-column composition, on the
    fixed-shape jnp while_loop kernels above."""

    def __init__(self, evals):
        """evals: (2, 2^n, 4) uint32 QM31 columns, components canonical."""
        evals = jnp.asarray(evals, dtype=jnp.uint32)
        if not (evals.ndim == 3 and evals.shape[0] == 2
                and evals.shape[2] == 4):
            raise ValueError(f"evals shape {evals.shape} != (2, 2^n, 4)")
        self._num_rows = evals.shape[1]
        self.round = 0
        self._evals = evals

    # ---- checkpoint / resume -------------------------------------------
    # (round, live folded rows) is the complete protocol state.

    def state_dict(self) -> dict:
        return {"round": self.round,
                "evals": np.asarray(self._evals[:, : self._num_rows])}

    @classmethod
    def from_state_dict(cls, d: dict) -> "PrimeFieldSumcheck":
        self = cls(jnp.asarray(d["evals"]))
        self.round = int(d["round"])
        return self

    def round_messages(self) -> np.ndarray:
        """Round polynomial at X = 0, 1, 2 as a (3, 4) uint32 array."""
        return np.asarray(
            _round_kernel(self._evals, jnp.int32(self._num_rows)))

    def fold(self, challenge) -> None:
        challenge = jnp.asarray(challenge, dtype=jnp.uint32).reshape(4)
        self._evals = _fold_kernel(self._evals, challenge,
                                   jnp.int32(self._num_rows))
        self._num_rows //= 2
        self.round += 1


def interpolate_at_host(challenge, points) -> np.ndarray:
    """Quadratic interpolation at `challenge` given p(0), p(1), p(2).

    cf. interpolate_at (prime_field_sumcheck/utils/interpolate.hpp:5-8):
    p(x) = x(x-1)e2/2 - x(x-2)e1 + (x-1)(x-2)e0/2.
    """
    from ..fields.m31 import qm31_add_host, qm31_mul_host, qm31_sub_host

    x = np.asarray(challenge, dtype=np.uint32)
    e0, e1, e2 = (np.asarray(p, dtype=np.uint32) for p in points)
    one = np.array([1, 0, 0, 0], np.uint32)
    two = np.array([2, 0, 0, 0], np.uint32)
    half = np.array([ONE_HALF, 0, 0, 0], np.uint32)
    xm1 = qm31_sub_host(x, one)
    xm2 = qm31_sub_host(x, two)
    t2 = qm31_mul_host(qm31_mul_host(qm31_mul_host(x, xm1), e2), half)
    t1 = qm31_mul_host(qm31_mul_host(x, xm2), e1)
    t0 = qm31_mul_host(qm31_mul_host(qm31_mul_host(xm1, xm2), e0), half)
    return qm31_add_host(qm31_sub_host(t2, t1), t0)
