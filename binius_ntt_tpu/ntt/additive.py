"""Additive (Gao–Mateer / LCH) NTT over binary tower fields.

Computes the same transform as the reference's AdditiveNTT
(src/ulvt/ntt/additive_ntt.cuh:176-318) with the same public semantics:

  * ``AdditiveNTT(log_h, log_rate)`` precomputes the normalised
    subspace-polynomial evaluation table (port of precompute_subspace_evals,
    additive_ntt.cuh:273-309, run host-side with the scalar oracle).
  * ``apply(x)`` takes an IN_ORDER input of 2^log_h field elements and
    returns the 2^(log_h+log_rate) IN_ORDER extended evaluation: the input is
    replicated into 2^log_rate coset rows (additive_ntt.cuh:213-215), then
    butterfly stages run from ``log_h-1`` *down to* 0 (DIT order,
    additive_ntt.cuh:222-247 reversed kernel launches + descending stage loop
    :138-154), with the butterfly u' = u + w*v ; v' = u' + v (:10-14).

Design decisions (not a port):
  * Twiddles are GF(2)-linear in the indicator bits
    (calculate_twiddle, additive_ntt.cuh:59-77: an XOR-subset-sum of
    ``constants[stage][k]`` over set bits of ``coset << (log_h-1-stage) |
    block``), so each stage's *entire twiddle vector* is materialised once at
    construction by a doubling construction — the direction the reference
    prototyped with texture twiddles (modified_antt.cuh:323-380) but never
    shipped.  No dynamic bit loop in the hot path.
  * Each stage is a vectorised butterfly over a (cosets, blocks, 2, 2^s)
    view; the field multiply is the lane-parallel SWAR form (tower_simd),
    which costs ~2^h leaf ANDs/word instead of 3^h for the recursion the
    reference's kernel evaluates per thread (binary_tower.cuh:35-50).
  * Everything is one jit-compiled functional program per (log_h, log_rate)
    config; XLA fuses the twiddle broadcast and XORs into the multiply DAG.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..fields import tower_scalar as ts
from ..fields.tower_simd import mul_packed

__all__ = ["AdditiveNTT", "precompute_subspace_evals", "stage_twiddles"]

# From this size on, apply() compiles one program per stage.
PER_STAGE_JIT_LOG_H = 22


def precompute_subspace_evals(log_h: int, log_rate: int, height: int = 5):
    """Normalised subspace evaluation table, rows = stages.

    Port of additive_ntt.cuh:273-309 (host-side, scalar oracle, Python ints).
    Row ``i`` has ``log_h + log_rate - 1 - i`` valid entries.
    Returns a list of Python-int lists.
    """
    width = log_h + log_rate - 1
    rows: list[list[int]] = [[0] * width for _ in range(log_h)]

    # row 0: the field elements 2^i for i = 1..log_h+log_rate-1
    for i in range(1, log_rate + log_h):
        rows[0][i - 1] = 1 << i
    norm_consts = [1]

    def subspace_map(x, c):
        # q(x) = x^2 + c*x (additive_ntt.cuh:16-19)
        return ts.square(x, height) ^ ts.multiply(c, x, height)

    for i in range(1, log_h):
        norm_prev = norm_consts[-1]
        prev = rows[i - 1]
        norm_i = subspace_map(prev[0], norm_prev)
        for j in range(1, log_h + log_rate - i):
            rows[i][j - 1] = subspace_map(prev[j], norm_prev)
        norm_consts.append(norm_i)

    for i in range(log_h):
        inv_norm = ts.inverse(norm_consts[i], height)
        for j in range(log_h + log_rate - i - 1):
            rows[i][j] = ts.multiply(inv_norm, rows[i][j], height)

    return rows


def stage_twiddles(constants_row, num_bits: int) -> np.ndarray:
    """All twiddles for one stage by the XOR doubling construction.

    twiddle[ind] = XOR over set bits k of ind of constants_row[k]
    (cf. calculate_twiddle, additive_ntt.cuh:59-77).  Output shape
    (2^num_bits,), index = ``coset << (log_h-1-stage) | butterfly_block``.
    """
    table = np.zeros(1, dtype=np.uint32)
    for k in range(num_bits):
        table = np.concatenate([table, table ^ np.uint32(constants_row[k])])
    return table


class AdditiveNTT:
    """Additive NTT over GF(2^(2^height)) elements packed one per uint32.

    Supports height <= 5 (uint32 storage, like the reference's
    FanPaarTowerField<5> instantiation, test_ntt.cu:201-202).
    """

    def __init__(self, log_h: int, log_rate: int = 0, height: int = 5):
        # validation mirrors AdditiveNTTConf (nttconf.cuh:55-60)
        if not log_h >= 1:
            raise ValueError("log_h must be >= 1")
        if not log_h + log_rate <= (1 << height):
            raise ValueError("log_h + log_rate must be <= field bits")
        if not 0 <= log_rate <= 4:
            raise ValueError("log_rate must be in [0, 4]")
        if height > 5:
            raise ValueError("compact layout supports height <= 5")

        self.log_h = log_h
        self.log_rate = log_rate
        self.height = height

        rows = precompute_subspace_evals(log_h, log_rate, height)
        # one twiddle table per stage, indexed by the full indicator
        self._twiddles = tuple(
            jnp.asarray(stage_twiddles(rows[s], log_h + log_rate - 1 - s))
            for s in range(log_h)
        )
        self._apply = jax.jit(
            partial(_additive_ntt_apply, log_h=log_h, log_rate=log_rate,
                    height=height)
        )

    def apply(self, x, per_stage_jit: bool | None = None):
        """x: (2^log_h,) uint32 IN_ORDER -> (2^(log_h+log_rate),) IN_ORDER.

        per_stage_jit: compile one small program per butterfly stage instead
        of one monolithic program, so compile time stays flat in the
        transform size; the steady state pays one dispatch per stage.
        Defaults on for log_h >= PER_STAGE_JIT_LOG_H.

        Accepts an NTTData wrapper: the additive transform requires
        IN_ORDER input — a BIT_REVERSED wrapper raises, the analogue of
        the reference's order assertion (additive_ntt.cuh:206-208).
        """
        from .nttdata import DataOrder, NTTData

        if isinstance(x, NTTData):
            if x.order is not DataOrder.IN_ORDER:
                raise ValueError(
                    "AdditiveNTT.apply requires IN_ORDER input "
                    "(additive_ntt.cuh:206-208)")
            return NTTData(self.apply(x.data, per_stage_jit=per_stage_jit),
                           DataOrder.IN_ORDER)
        x = jnp.asarray(x, dtype=jnp.uint32)
        if x.shape != (1 << self.log_h,):
            raise ValueError(
                f"apply: input shape {x.shape} != (2^log_h,) = "
                f"({1 << self.log_h},)")
        if per_stage_jit is None:
            per_stage_jit = self.log_h >= PER_STAGE_JIT_LOG_H
        if self.log_h < 7:
            per_stage_jit = False    # (128, rows) view needs n >= 128
        if not per_stage_jit:
            return self._apply(x, self._twiddles)
        cosets = 1 << self.log_rate
        data = jnp.broadcast_to(x[None, :], (cosets, 1 << self.log_h))
        for s in range(self.log_h - 1, 6, -1):
            data = _additive_ntt_stage(
                data, self._twiddles[s], s=s, log_h=self.log_h,
                log_rate=self.log_rate, height=self.height)
        # small-span stages on the transposed (C, 128, rows) view, so every
        # array keeps a long minor axis
        data = _transpose_in(data)
        for s in range(min(self.log_h - 1, 6), -1, -1):
            data = _additive_ntt_stage_small(
                data, self._twiddles[s], s=s, log_h=self.log_h,
                log_rate=self.log_rate, height=self.height)
        data = _transpose_out(data)
        return data.reshape(cosets << self.log_h)


@jax.jit
def _transpose_in(data):
    c, n = data.shape
    return data.reshape(c, n // 128, 128).transpose(0, 2, 1)


@jax.jit
def _transpose_out(xt):
    c, _, rows = xt.shape
    return xt.transpose(0, 2, 1).reshape(c, rows * 128)


def _stage_body(data, tw, *, s: int, log_h: int, log_rate: int, height: int):
    """One butterfly stage on (cosets, n) — shared by the monolithic and
    per-stage-jit paths."""
    n = 1 << log_h
    cosets = 1 << log_rate
    nblocks = n >> (s + 1)
    w = tw.reshape(cosets, nblocks) if log_rate else tw.reshape(1, nblocks)
    v4 = data.reshape(cosets, nblocks, 2, 1 << s)
    u, v = v4[:, :, 0, :], v4[:, :, 1, :]
    u2 = u ^ mul_packed(w[:, :, None], v, height)
    v2 = u2 ^ v
    return jnp.stack([u2, v2], axis=2).reshape(cosets, n)


@partial(jax.jit, static_argnames=("s", "log_h", "log_rate", "height"),
         donate_argnums=(0,))
def _additive_ntt_stage(data, tw, *, s: int, log_h: int, log_rate: int,
                        height: int):
    """One large-span butterfly stage (2^s >= 128) on (cosets, n)."""
    return _stage_body(data, tw, s=s, log_h=log_h, log_rate=log_rate,
                       height=height)


@partial(jax.jit, static_argnames=("s", "log_h", "log_rate", "height"),
         donate_argnums=(0,))
def _additive_ntt_stage_small(xt, tw, *, s: int, log_h: int, log_rate: int,
                              height: int):
    """One small-span stage (2^s < 128) on the transposed (C, 128, rows)
    view: element e = 128*r + j sits at xt[c, j, r], pairs differ in bit s
    of j, so the butterfly axis is major and the minor dim stays `rows`."""
    n = 1 << log_h
    cosets = 1 << log_rate
    rows = n // 128
    nblocks = n >> (s + 1)
    m = 128 >> (s + 1)
    w = tw.reshape(cosets, nblocks) if log_rate else tw.reshape(1, nblocks)
    # block index of e is r*m + jb  ->  w[c, jb, r] = w[c, r*m + jb]
    wt = w.reshape(-1, rows, m).transpose(0, 2, 1)[:, :, None, :]
    v5 = xt.reshape(cosets, m, 2, 1 << s, rows)
    u, v = v5[:, :, 0], v5[:, :, 1]
    u2 = u ^ mul_packed(wt, v, height)
    v2 = u2 ^ v
    return jnp.stack([u2, v2], axis=2).reshape(cosets, 128, rows)


def _additive_ntt_apply(x, twiddles, *, log_h: int, log_rate: int, height: int):
    n = 1 << log_h
    cosets = 1 << log_rate
    # replicate the input into one row per coset (additive_ntt.cuh:213-215);
    # indicator = coset << (log_h-1-s) | block → each stage's table reshapes
    # to (cosets, nblocks) coset-major inside _stage_body
    data = jnp.broadcast_to(x[None, :], (cosets, n))
    for s in range(log_h - 1, -1, -1):
        data = _stage_body(data, twiddles[s], s=s, log_h=log_h,
                           log_rate=log_rate, height=height)
    return data.reshape(cosets * n)
