"""Sumcheck prover over GF(2^128), bit-sliced.

Protocol/API parity with the reference prover
(src/ulvt/sumcheck/sumcheck.cuh:82-301):

  * state = COMPOSITION_SIZE multilinear columns of 2^num_vars evaluations,
    bit-sliced in 32-element batches (layout/bitslicing.py);
  * ``round_messages()`` returns (sum, points): sum = XOR over all rows of
    the composition product; points[p] = XOR over folded rows of the
    composition product after folding every column at interpolation point p
    (the fused compute_compositions kernel, sumcheck/core/kernels.cuh:5-102);
  * ``move_to_next_round(challenge)`` folds every column in half:
    lower' = lower + challenge * (lower + upper) (core.cu:25-56);
  * when 32 evaluations remain the state migrates to the host and the tail
    rounds run there (sumcheck.cuh:160-195, 283-297) — the tail is
    negligible and runs in numpy via the same jnp kernels on CPU.

The round is a single jitted program —
  - composition products: (COMPOSITION_SIZE-1) bit-sliced stacked-Karatsuba
    multiplies over a (C, B, 128) array (fields/bitsliced.py);
  - interpolation folds: height-2 subfield chunk multiplies (core.cu:45-48);
  - reductions: XOR tree over the batch axis — replaces the reference's
    per-thread partials + atomicXor (kernels.cuh:86-101); XOR is associative
    and commutative so the result is identical and deterministic.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..fields import bitsliced as bf
from ..layout.bitslicing import (
    bitslice_transpose,
    bitslice_untranspose,
    repeat_value_bitsliced,
)
from ..utils.capabilities import check_platform

__all__ = ["Sumcheck"]

TOWER_HEIGHT = 7
INTERPOLATION_TOWER_HEIGHT = 2
BITS_WIDTH = 1 << TOWER_HEIGHT          # 128 bit-planes per batch
W = BITS_WIDTH
INTS_PER_VALUE = BITS_WIDTH // 32       # 4 words per value


def _compute_sum(batch: np.ndarray, count: int) -> np.ndarray:
    """XOR the first `count` values of a bit-sliced batch into 4 words.

    cf. compute_sum (sumcheck/core/core.cu:84-96).
    """
    words = np.asarray(bitslice_untranspose(batch))
    take = min(BITS_WIDTH, INTS_PER_VALUE * count)
    out = np.zeros(INTS_PER_VALUE, dtype=np.uint32)
    for i in range(take):
        out[i % INTS_PER_VALUE] ^= words[i]
    return out


def _mul128(a, b):
    """Full-height bit-sliced multiply (stacked Karatsuba)."""
    return bf.multiply(a, b, TOWER_HEIGHT)


def _composition(cols):
    """Product of the column batches; cf. evaluate_composition_on_batch_row
    (core.cu:9-23).  cols: (C, ..., 128) -> (..., 128)."""
    prod = cols[0]
    for c in range(1, cols.shape[0]):
        prod = _mul128(prod, cols[c])
    return prod


def _xor_reduce(x, axis=0):
    return jax.lax.reduce(x, jnp.uint32(0), jax.lax.bitwise_xor, (axis,))


# Row-tile size of the plain fixed-shape kernels: one compile serves every
# round (cf. the reference's grid-stride loop, kernels.cuh:25).  The
# stacked multiply holds ~17x a tile in leaf planes, ~70 MB per column at
# 4096 rows.  On an H100 the full 2^24 protocol took 2.72 / 2.88 / 2.86 s
# at C=2 and 4.37 / 4.41 / 4.94 s at C=3 for tiles of 4096 / 1024 / 256
# (tools/row_tile_ab.py; PERF.md).  A power of two:
# then a tile smaller than the live half divides it, and a larger one
# reads rows still inside the buffer (a slice past its end would be
# clamped, not refused).
ROW_TILE = 4096


@partial(jax.jit, static_argnames=("num_points",), donate_argnums=())
def _round_kernel_tiled(evals, coeffs, num_rows, *, num_points: int):
    """Fused round over the first `num_rows` rows of a fixed-size buffer.

    evals: (C, B, 128) with only [0, num_rows) live; num_rows: traced scalar.
    Returns (1 + num_points, 128): [sum_batch, point_batches...].
    One compiled program serves all rounds (num_rows halves each round).
    """
    c, b, _ = evals.shape
    tile = min(ROW_TILE, b // 2)
    half = num_rows // 2
    tiles = (half + tile - 1) // tile

    def masked(t, base, limit):
        # zero rows at global index >= limit (XOR identity)
        idx = base + jax.lax.broadcasted_iota(jnp.int32, (tile, 1), 0)
        return jnp.where(idx < limit, t, jnp.uint32(0))

    def body(state):
        i, acc = state
        base = i * tile
        lower = jax.lax.dynamic_slice(evals, (0, base, 0), (c, tile, W))
        upper = jax.lax.dynamic_slice(
            evals, (0, base + half, 0), (c, tile, W))
        lower = masked(lower, base, half)
        upper = masked(upper, base, half)
        # total sum gets contributions from both halves
        sum_part = _xor_reduce(_composition(lower) ^ _composition(upper))
        parts = [sum_part]
        xh = lower ^ upper
        for p in range(num_points):
            prod = bf.mul_subfield_chunks(
                xh, coeffs[p, : 1 << INTERPOLATION_TOWER_HEIGHT],
                TOWER_HEIGHT, INTERPOLATION_TOWER_HEIGHT)
            parts.append(_xor_reduce(_composition(lower ^ prod)))
        return i + jnp.int32(1), acc ^ jnp.stack(parts)

    init = (jnp.int32(0), jnp.zeros((1 + num_points, W), jnp.uint32))
    _, acc = jax.lax.while_loop(lambda s: s[0] < tiles, body, init)
    return acc


@jax.jit
def _fold_kernel_tiled(evals, coeff, num_rows):
    """Fold rows [0, num_rows) in half inside the fixed-size buffer.

    Returns the buffer with [0, num_rows//2) updated; the stale upper region
    is never read again (mirrors the reference folding in place at original
    column stride, kernels.cu:20-28).
    """
    c, b, _ = evals.shape
    tile = min(ROW_TILE, b // 2)
    half = num_rows // 2
    tiles = (half + tile - 1) // tile

    def body(state):
        i, buf = state
        base = i * tile
        lower = jax.lax.dynamic_slice(evals, (0, base, 0), (c, tile, W))
        upper = jax.lax.dynamic_slice(
            evals, (0, base + half, 0), (c, tile, W))
        xh = lower ^ upper
        folded = lower ^ _mul128(xh, jnp.broadcast_to(coeff, xh.shape))
        # rows beyond `half` must keep their old content (partial last tile)
        idx = base + jax.lax.broadcasted_iota(jnp.int32, (tile, 1), 0)
        folded = jnp.where(idx < half, folded, lower)
        buf = jax.lax.dynamic_update_slice(buf, folded, (0, base, 0))
        return i + jnp.int32(1), buf

    init = (jnp.int32(0), evals)
    _, buf = jax.lax.while_loop(lambda s: s[0] < tiles, body, init)
    return buf


@jax.jit
def _transpose_kernel(evals):
    return bitslice_transpose(evals)


def _fold_small(src: np.ndarray, coeff: np.ndarray, list_len: int) -> np.ndarray:
    """Intra-batch fold on (C, 128) host state; cf. fold_small (core.cu:58-82)."""
    half = list_len // 2
    b = (src >> np.uint32(half)) ^ src
    prod = np.asarray(bf.multiply(jnp.asarray(b), jnp.asarray(coeff), TOWER_HEIGHT))
    return src ^ prod


class Sumcheck:
    """Bit-sliced GF(2^128) sumcheck prover.

    Parameters
    ----------
    evals : flat uint32 array of INTS_PER_VALUE * 2^num_vars * composition_size
        words — composition_size concatenated multilinear columns, each
        column 2^num_vars evaluations grouped in 32-element batches
        (element-major little-endian unless `data_is_transposed`).
    data_is_transposed : if True the batches are already bit-sliced
        (the DATA_IS_TRANSPOSED=true template config, sumcheck.cuh:10).
    """

    def __init__(self, evals, composition_size: int, num_vars: int,
                 data_is_transposed: bool = False):
        if num_vars < 6:
            raise ValueError("num_vars must be >= 6 (at least two batches)")
        if composition_size < 2:
            raise ValueError("composition_size must be >= 2")
        check_platform()
        self.num_vars = num_vars
        self.composition_size = composition_size
        self.num_points = composition_size + 1
        self.round = 0

        b = (1 << num_vars) // 32
        if isinstance(evals, jnp.ndarray) and evals.ndim == 3:
            # already-device-resident bit-sliced columns (capacity sizes:
            # prepared chunk-streamed via layout.bitslicing.
            # bitslice_transpose_streamed_cols — the whole-array device
            # transpose peaks at >= 2x the buffer and OOMs 2^28 configs)
            if not data_is_transposed:
                raise ValueError(
                    "device-resident evals must be pre-bit-sliced "
                    "(data_is_transposed=True)")
            if evals.shape != (composition_size, b, BITS_WIDTH):
                raise ValueError(
                    f"device evals shape {evals.shape} != "
                    f"({composition_size}, {b}, {BITS_WIDTH})")
            if evals.dtype != jnp.uint32:
                # the host path coerces; a device-resident int32 would pass
                # the shape check and silently corrupt the shift/XOR math
                raise ValueError(
                    f"device evals dtype {evals.dtype} != uint32")
            arr = evals
        else:
            evals = np.ascontiguousarray(np.asarray(evals, dtype=np.uint32))
            assert evals.size == (
                INTS_PER_VALUE * (1 << num_vars) * composition_size)
            arr = jnp.asarray(evals.reshape(composition_size, b, BITS_WIDTH))
            if not data_is_transposed:
                arr = _transpose_kernel(arr)
        self._device_evals = arr            # (C, B', 128) while B' >= 2
        self._b0 = b                        # first fold shrinks B -> B/2
        self._host_evals = None             # (C, 128) once 32 evals remain

        # interpolation-point coefficient batches (sumcheck.cuh:103-121)
        self._coeffs_np = np.stack([
            repeat_value_bitsliced(
                np.array([p, 0, 0, 0], dtype=np.uint32), BITS_WIDTH)
            for p in range(self.num_points)
        ])
        self._coeffs = jnp.asarray(self._coeffs_np)

    # ---- checkpoint / resume -------------------------------------------
    # The complete protocol state is (round, folded evaluations) — the
    # reference keeps exactly this implicitly (sumcheck.cuh:25-29); here it
    # is an explicit serialisable dict so long multi-host runs can resume.

    def state_dict(self) -> dict:
        num = self._num_evals
        live = None
        if self._device_evals is not None:
            live = np.asarray(self._device_evals[:, : num // 32, :])
        return {
            "num_vars": self.num_vars,
            "composition_size": self.composition_size,
            "round": self.round,
            "device_evals": live,
            "host_evals": None if self._host_evals is None
            else np.asarray(self._host_evals),
        }

    @classmethod
    def from_state_dict(cls, d: dict) -> "Sumcheck":
        if d["device_evals"] is not None:
            state = jnp.asarray(d["device_evals"])
        else:
            state = jnp.asarray(d["host_evals"])[:, None, :]
        self = cls._from_state(
            state, d["composition_size"], d["num_vars"], d["round"])
        if d["device_evals"] is None:
            self._device_evals = None
            self._host_evals = np.asarray(d["host_evals"])
        return self

    @classmethod
    def _from_state(cls, device_evals, composition_size: int, num_vars: int,
                    round_: int):
        """Resume from mid-protocol device state (C, B', 128) — used by the
        sharded prover to hand off its gathered tail."""
        self = cls.__new__(cls)
        self.num_vars = num_vars
        self.composition_size = composition_size
        self.num_points = composition_size + 1
        self.round = round_
        self._coeffs_np = np.stack([
            repeat_value_bitsliced(
                np.array([p, 0, 0, 0], dtype=np.uint32), BITS_WIDTH)
            for p in range(self.num_points)
        ])
        self._coeffs = jnp.asarray(self._coeffs_np)
        if device_evals.shape[1] == 1:
            self._device_evals = None
            self._host_evals = np.asarray(device_evals[:, 0, :])
        else:
            self._device_evals = device_evals
            self._host_evals = None
        self._b0 = device_evals.shape[1]
        return self

    @property
    def _num_evals(self) -> int:
        return (1 << self.num_vars) >> self.round

    def round_messages(self):
        """Returns (sum, points): sum (4,) uint32 words; points (P, 4)."""
        num = self._num_evals
        if num > 32:
            rows = num // 32
            parts = np.asarray(_round_kernel_tiled(
                self._device_evals, self._coeffs, jnp.int32(rows),
                num_points=self.num_points,
            ))
            sum_batch = parts[0]
            point_batches = parts[1:]
            # GPU path always sums all 32 lanes (sumcheck.cuh:238-243)
            s = _compute_sum(sum_batch, 32)
            pts = np.stack([_compute_sum(point_batches[p], 32)
                            for p in range(self.num_points)])
            return s, pts

        # host tail path (sumcheck.cuh:160-195)
        cols = self._host_evals  # (C, 128)
        prod = np.asarray(_host_composition(cols))
        s = _compute_sum(prod, num)
        pts = []
        for p in range(self.num_points):
            folded = _fold_small(cols, self._coeffs_np[p], num)
            pts.append(_compute_sum(np.asarray(_host_composition(folded)), num // 2))
        return s, np.stack(pts)

    def move_to_next_round(self, challenge):
        """Fold every column at the (random) challenge; cf. sumcheck.cuh:248-300.

        challenge: 4 uint32 words (little-endian 128-bit value).
        """
        challenge = np.asarray(challenge, dtype=np.uint32).reshape(INTS_PER_VALUE)
        num = self._num_evals

        if num > 32:
            rows = num // 32
            coeff = repeat_value_bitsliced(challenge, BITS_WIDTH)
            self._device_evals = _fold_kernel_tiled(
                self._device_evals, jnp.asarray(coeff), jnp.int32(rows))
            if num // 2 == 32:
                # migrate to the host for the tail (sumcheck.cuh:283-297)
                self._host_evals = np.asarray(self._device_evals[:, 0, :])
                self._device_evals = None
        else:
            coeff = repeat_value_bitsliced(challenge, BITS_WIDTH)
            self._host_evals = _fold_small(self._host_evals, coeff, num)

        self.round += 1


def _host_composition(cols: np.ndarray):
    prod = jnp.asarray(cols[0])
    for c in range(1, cols.shape[0]):
        prod = bf.multiply(prod, jnp.asarray(cols[c]), TOWER_HEIGHT)
    return prod
