"""Additive NTT over GF(2^128), bit-sliced — the flagship pipeline.

The reference only ever instantiates its additive NTT over GF(2^32)
(src/ulvt/ntt/tests/test_ntt.cu:201-202); the 128-bit transform is the
framework's north-star config (BASELINE.json config 3).  Same algorithm as
ntt/additive.py (stages descend log_h-1..0; butterfly u' = u + w*v,
v' = u' + v, additive_ntt.cuh:10-14; twiddles are XOR-subset-sums of the
normalised subspace evaluations, :59-77) — but over *bit-sliced* data:

  * an element batch is 32 GF(2^128) values as 128 uint32 bit-planes
    (lane j of plane i = bit i of element 32k+j) — shape (batches, 128),
    one word per batch in each plane;
  * one multiply costs 3^7 = 2187 word-ANDs per 32 elements (~70 AND
    ops/element) versus ~2^5 x 32 for the compact SWAR form — bit-slicing is
    the speed-of-light layout for tower multiplication;
  * stages s >= 5 pair whole batches; the twiddle is constant per pair-block
    so it enters as bit-broadcast planes of a single 128-bit value;
  * stages s < 5 pair lanes inside each batch: align v onto u with a word
    shift (lane index == bit position), multiply against per-lane twiddle
    planes, then recombine under even/odd lane masks.  The per-lane twiddle
    factors as (batch-dependent value) XOR (lane-dependent value) by
    GF(2)-linearity, so it costs one bit-broadcast plus one precomputed
    static plane batch per stage.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..fields import bitsliced as bf
from ..layout.bitslicing import (bitslice_transpose,
                                 bitslice_transpose_streamed,
                                 bitslice_untranspose,
                                 bitslice_untranspose_streamed)
from ..utils.capabilities import check_platform, device_memory_limit
from .additive import precompute_subspace_evals

__all__ = ["AdditiveNTT128"]

HEIGHT = 7
W = 1 << HEIGHT            # 128 bit-planes
IPV = W // 32              # 4 words per compact value

# even-lane masks for in-batch butterflies at stage s (= MASKS of tower_simd)
_LANE_MASKS = (0x55555555, 0x33333333, 0x0F0F0F0F, 0x00FF00FF, 0x0000FFFF)

# Share of the device memory limit the on-device layout transforms may
# plan for.  Whole-array device (un)transposes hold temporaries of about
# four times the array, so apply() bit-slices on the host, streamed in
# chunks, once 4x the larger of input and output passes this share.
LAYOUT_SHARE = 0.9


def layout_on_host(nbytes: int, limit: int | None) -> bool:
    """True when an `nbytes` array is too large to (un)transpose on a
    device whose memory limit is `limit` (None: no limit reported)."""
    return limit is not None and 4 * nbytes > LAYOUT_SHARE * limit


def _stage_twiddles_multiword(constants_row, num_bits: int) -> np.ndarray:
    """Doubling-construction twiddle table of 128-bit values: (2^bits, 4)."""
    table = np.zeros((1, IPV), dtype=np.uint32)
    for k in range(num_bits):
        c = np.array(
            [(constants_row[k] >> (32 * i)) & 0xFFFFFFFF for i in range(IPV)],
            dtype=np.uint32,
        )
        table = np.concatenate([table, table ^ c[None, :]])
    return table


def _expand_bits(w4):
    """(..., 4) compact uint32 words -> (..., 128) all-ones/zeros bit-planes."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (w4[..., :, None] >> shifts) & jnp.uint32(1)       # (..., 4, 32)
    planes = bits.reshape(bits.shape[:-2] + (W,))
    return jnp.uint32(0) - planes                              # 1 -> 0xFFFFFFFF


class AdditiveNTT128:
    """Additive NTT over GF(2^128), bit-sliced layout, one device: the
    per-stage jnp program ``_apply128``."""

    def __init__(self, log_h: int, log_rate: int = 0):
        if not log_h >= 5:
            raise ValueError("log_h must be >= 5 (at least one 32-elem batch)")
        if not 0 <= log_rate <= 4:
            raise ValueError("log_rate must be in [0, 4]")
        check_platform()
        self.log_h = log_h
        self.log_rate = log_rate
        rows = precompute_subspace_evals(log_h, log_rate, HEIGHT)
        self._apply_sliced = plain_transform(rows, log_h, log_rate)

    def apply_sliced(self, data):
        """data: (2^log_h/32, 128) bit-sliced IN_ORDER input.

        Returns (2^(log_h+log_rate)/32, 128) bit-sliced IN_ORDER output.
        """
        return self._apply_sliced(data)

    def apply(self, x_words):
        """Compact interface: x_words (2^log_h * 4,) uint32 little-endian
        element-major -> (2^(log_h+log_rate) * 4,) words.

        Accepts an NTTData wrapper (IN_ORDER required, like the reference's
        order assertion at additive_ntt.cuh:206-208)."""
        from .nttdata import DataOrder, NTTData

        if isinstance(x_words, NTTData):
            if x_words.order is not DataOrder.IN_ORDER:
                raise ValueError(
                    "AdditiveNTT128.apply requires IN_ORDER input "
                    "(additive_ntt.cuh:206-208)")
            return NTTData(self.apply(x_words.data), DataOrder.IN_ORDER)
        n = 1 << self.log_h
        out_n = 1 << (self.log_h + self.log_rate)
        if layout_on_host(max(n, out_n) * 16, device_memory_limit()):
            xh = np.asarray(x_words, dtype=np.uint32)
            if xh.shape != (n * IPV,):
                raise ValueError(
                    f"apply: input shape {xh.shape} != (2^log_h * {IPV},) = "
                    f"({n * IPV},)")
            # stream the layout transforms through the device in chunks:
            # whole-array device transposes would not fit, and host numpy
            # on one core is far slower
            sliced = bitslice_transpose_streamed(xh.reshape(n // 32, W))
            out = self.apply_sliced(sliced)
            del sliced
            return bitslice_untranspose_streamed(out).reshape(-1)
        x = jnp.asarray(x_words, dtype=jnp.uint32)
        if x.shape != (n * IPV,):
            raise ValueError(
                f"apply: input shape {x.shape} != (2^log_h * {IPV},) = "
                f"({n * IPV},)")
        x = x.reshape(n // 32, W)
        sliced = jax.jit(bitslice_transpose)(x)
        out = self.apply_sliced(sliced)
        back = jax.jit(bitslice_untranspose)(out)
        return back.reshape(-1)


def stage_tables(rows, log_h: int, log_rate: int):
    """Twiddle tables of every stage, as three dicts keyed by stage:
    s >= 5: the doubling table in indicator order (2^bits, 4);
    s < 5: the batch part of the indicator (doubling table) and the
    bit-sliced planes of the 32 per-lane values (128,)."""
    high_tables = {}
    low_batch_tables = {}
    low_lane_planes = {}
    for s in range(log_h):
        bits = log_h + log_rate - 1 - s
        if s >= 5:
            high_tables[s] = jnp.asarray(
                _stage_twiddles_multiword(rows[s], bits))
            continue
        # indicator = coset<<(log_h-1-s) | k<<(4-s) | (j>>(s+1));
        # lane part: bits m < 4-s from j, batch part: the rest.
        lane_bits = min(4 - s, bits)
        lane_vals = np.zeros((32, IPV), dtype=np.uint32)
        for j in range(32):
            v = 0
            jj = j >> (s + 1)
            for m in range(lane_bits):
                if (jj >> m) & 1:
                    v ^= rows[s][m]
            for i in range(IPV):
                lane_vals[j, i] = (v >> (32 * i)) & 0xFFFFFFFF
        low_lane_planes[s] = jnp.asarray(
            bitslice_transpose(lane_vals.reshape(W)))
        low_batch_tables[s] = jnp.asarray(
            _stage_twiddles_multiword(rows[s][lane_bits:], bits - lane_bits))
    return high_tables, low_batch_tables, low_lane_planes


def plain_transform(rows, log_h: int, log_rate: int):
    """The plain per-stage transform (``_apply128``) with its twiddle
    tables, as a jitted function of the (nb, 128) sliced input."""
    tables = stage_tables(rows, log_h, log_rate)
    fn = jax.jit(partial(_apply128, log_h=log_h, log_rate=log_rate))
    return lambda data: fn(data, *tables)


def high_stage(x, wp, db: int):
    """Butterfly stage s >= 5 on (C, nb, 128) batches: pairs are whole
    batches `db` = 2^(s-5) apart; `wp` (C, G, 1, 128) holds the twiddle
    planes of each of the G pair blocks."""
    cosets, nb, _ = x.shape
    v5 = x.reshape(cosets, wp.shape[1], 2, db, W)
    u, v = v5[:, :, 0], v5[:, :, 1]
    u2 = u ^ bf.multiply(wp, v, HEIGHT)
    v2 = u2 ^ v
    return jnp.stack([u2, v2], axis=2).reshape(cosets, nb, W)


def low_stage(x, wp, s: int):
    """Butterfly stage s < 5, lanes inside each batch: align v onto u with
    a word shift, multiply by the per-lane twiddle planes `wp`, recombine
    under the even/odd lane masks."""
    shift = 1 << s
    umask = jnp.uint32(_LANE_MASKS[s])
    vmask = jnp.uint32((_LANE_MASKS[s] << shift) & 0xFFFFFFFF)
    un = x ^ bf.multiply(wp, x >> shift, HEIGHT)
    return (un & umask) | ((x ^ (un << shift)) & vmask)


def _apply128(data, high_tables, low_batch_tables, low_lane_planes, *,
              log_h: int, log_rate: int):
    """Plain path: one butterfly stage after another, each multiply the
    stacked Karatsuba of fields/bitsliced.py over the whole array."""
    n = 1 << log_h
    nb = n // 32
    cosets = 1 << log_rate
    # replicate input per coset row: (C, nb, 128)
    x = jnp.broadcast_to(data[None], (cosets, nb, W))

    for s in range(log_h - 1, 4, -1):
        db = 1 << (s - 5)                     # pair distance in batches
        groups = nb // (2 * db)
        # indicator = coset << (log_h-1-s) | group, and the doubling table is
        # already in indicator order — a reshape, not a gather
        w4 = high_tables[s].reshape(-1, groups, IPV)[:cosets]
        if log_h - 1 - s < 0 or high_tables[s].shape[0] != cosets * groups:
            raise AssertionError("twiddle table layout mismatch")
        x = high_stage(x, _expand_bits(w4)[:, :, None, :], db)

    for s in range(min(log_h - 1, 4), -1, -1):
        # batch part of the indicator: coset<<(log_h-1-s-lane_bits) | k with
        # k = 0..nb-1 contiguous — again a reshape of the doubling table
        a4 = low_batch_tables[s].reshape(-1, nb, IPV)[:cosets]
        x = low_stage(x, _expand_bits(a4) ^ low_lane_planes[s][None, None, :],
                      s)

    return x.reshape(cosets * nb, W)
