"""Classical radix-2 DIF NTT over a 32-bit prime field (BB31).

Same transform as the reference's ``NTT<BB31>`` (src/ulvt/ntt/gpuntt.cuh:126-209):
  * twiddles: n/2 powers of omega = g^(2^(log_group_order - log_n)), stored in
    bit-reversed order (gpuntt.cuh:139-143,186-204);
  * input is bit-reversed if IN_ORDER (gpuntt.cuh:163-168);
  * stages ascend 0..log_n-1; at stage s butterflies pair indices
    (g, g + 2^s) with g = (e % 2^s) | ((e >> s) << (s+1)), twiddle index
    (e >> s) mod (twiddle_size >> s) (gpuntt.cuh:54-63,111-118);
  * butterfly U = u + v ; V = (u - v) * w (gpuntt.cuh:39-44).

Formulation: the per-stage index algebra collapses to a reshape —
view the array as (blocks, 2, 2^s); the twiddle vector for stage s is simply
the first ``blocks`` bit-reversed twiddles.  The whole transform (including
Montgomery encode/decode at the boundary) is one jitted program; the
bit-reversal permutation is a precomputed gather.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..fields import baby_bear as bb

__all__ = ["NTTRadix2", "FieldOps", "BB31_OPS", "make_modp_ops",
           "bit_reverse_indices"]

# From this size on, apply() compiles one program per stage.
PER_STAGE_JIT_LOG_N = 22


class FieldOps(NamedTuple):
    """Field-op bundle making NTTRadix2 generic over any <= 32-bit prime
    field — the analogue of the reference's ``NTT<E>`` template parameter
    (gpuntt.cuh:126-131, ``sizeof(E) <= 4``).  Device ops act on the
    field's *internal* representation (Montgomery form for BB31);
    encode/decode convert canonical uint32 <-> internal on device."""

    p: int                        # field modulus
    add: Callable                 # device: internal x internal -> internal
    sub: Callable
    mul: Callable
    encode: Callable              # device: canonical -> internal
    decode: Callable              # device: internal -> canonical
    encode_host: Callable         # numpy: canonical -> internal
    pow_host: Callable            # python ints: x^n mod p


BB31_OPS = FieldOps(p=bb.P, add=bb.add, sub=bb.sub, mul=bb.mont_mul,
                    encode=bb.encode, decode=bb.decode,
                    encode_host=bb.encode_host, pow_host=bb.pow_host)


def make_modp_ops(p: int) -> FieldOps:
    """Plain modular FieldOps for a small odd prime p < 2^16 (no
    Montgomery form; internal representation = canonical residues; the
    p < 2^16 bound keeps every product inside uint32 — jnp.uint64 silently
    downcasts without the x64 flag, so a 64-bit reduce would be WRONG for
    large p).  Instantiates the radix-2 NTT over toy 2-adic fields in
    tests, matching the reference template's genericity — BB31 remains
    the only tuned/fused configuration."""
    assert 2 < p < (1 << 16), "make_modp_ops is for toy primes < 2^16"
    pj = np.uint32(p)

    def add(a, b):
        s = a + b
        return jnp.where(s >= pj, s - pj, s)

    def sub(a, b):
        return jnp.where(a < b, a - b + pj, a - b)

    def mul(a, b):
        return (a * b) % pj            # both < 2^16: product fits uint32

    def encode(x):
        return x % pj               # same wrap semantics as BB31's ctor

    def decode(x):
        return x

    def pow_host(x: int, n: int) -> int:
        return pow(int(x), int(n), p)

    def encode_host(v):
        return np.asarray(v, dtype=np.uint32) % pj

    return FieldOps(p=p, add=add, sub=sub, mul=mul, encode=encode,
                    decode=decode, encode_host=encode_host,
                    pow_host=pow_host)


def bit_reverse_indices(log_n: int) -> np.ndarray:
    """Permutation idx[i] = reverse of i's low log_n bits; gpuntt.cuh:12-19."""
    n = 1 << log_n
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def _geometric_powers(base: int, count: int, p: int) -> np.ndarray:
    """[1, base, base^2, ...] mod p, vectorised by doubling."""
    out = np.array([1], dtype=np.uint64)
    step = base % p
    while out.size < count:
        out = np.concatenate([out, (out * np.uint64(step)) % np.uint64(p)])
        step = (step * step) % p
    return out[:count].astype(np.uint32)


class NTTRadix2:
    """Radix-2 NTT over a 32-bit prime field (BB31 by default) with
    generator `g` of order 2^log_group_order.

    ``field_ops`` injects the field (cf. the reference's ``NTT<E>``
    template, gpuntt.cuh:126-131); the reference only ever instantiates
    BB31 (ntt/tests/test_ntt.cu:126-152).
    """

    def __init__(self, generator: int, log_group_order: int, log_n: int,
                 field_ops: FieldOps | None = None):
        # validation mirrors NTTConfRad2 (nttconf.cuh:32-39)
        if not 1 <= log_n <= 27:
            raise ValueError("log_n must be in [1, 27]")
        if not log_group_order >= log_n:
            raise ValueError("log_group_order must be >= log_n")
        self.log_n = log_n
        n = 1 << log_n
        ops = BB31_OPS if field_ops is None else field_ops
        self._ops = ops

        omega = ops.pow_host(generator, 1 << (log_group_order - log_n))
        tw = _geometric_powers(omega, n // 2, ops.p)
        # bit-reverse with idx_size = log_n - 1 (gpuntt.cuh:141-142)
        if log_n > 1:
            tw = tw[bit_reverse_indices(log_n - 1)]
        tw_mont_host = ops.encode_host(tw)
        self._apply = partial(_radix2_apply, log_n=log_n, ops=ops)
        self._tw_mont = jnp.asarray(tw_mont_host)
        self._bitrev = jnp.asarray(bit_reverse_indices(log_n))

    def apply(self, x, input_bit_reversed: bool = False,
              per_stage_jit: bool | None = None):
        """x: (2^log_n,) canonical uint32 values -> IN_ORDER transform output.

        `input_bit_reversed=False` matches DataOrder::IN_ORDER (the kernel
        bit-reverses first, gpuntt.cuh:163-168).  An NTTData wrapper is
        accepted in place of the flag and returned with the output's order
        (always IN_ORDER — gpuntt.cuh:180 labels it so).

        per_stage_jit: one small program per stage, with the small-span
        stages (2^s < 128) run on a transposed (128, rows) view so every
        array keeps a long minor axis; compile time stays flat in the
        size.  Defaults on for log_n >= PER_STAGE_JIT_LOG_N.
        """
        from .nttdata import DataOrder, NTTData

        if isinstance(x, NTTData):
            out = self.apply(
                x.data,
                input_bit_reversed=(x.order is DataOrder.BIT_REVERSED),
                per_stage_jit=per_stage_jit)
            return NTTData(out, DataOrder.IN_ORDER)
        x = jnp.asarray(x, dtype=jnp.uint32)
        if x.shape != (1 << self.log_n,):
            raise ValueError(
                f"apply: input shape {x.shape} != (2^log_n,) = "
                f"({1 << self.log_n},)")
        if per_stage_jit is None:
            per_stage_jit = self.log_n >= PER_STAGE_JIT_LOG_N
        if self.log_n < 7:
            per_stage_jit = False    # (128, rows) view needs n >= 128
        if not per_stage_jit:
            return self._apply(x, self._tw_mont, self._bitrev,
                               skip_bitrev=input_bit_reversed)
        ops = self._ops
        x = _encode_stage(x, ops=ops)
        if not input_bit_reversed:
            x = x[self._bitrev]
        # small-span stages run on the transposed (128, rows) view so the
        # butterfly axis is major and every array keeps a 128-wide minor
        n_small = min(7, self.log_n)
        x = _transpose_in(x)
        for s in range(n_small):
            x = _radix2_stage_small(x, self._tw_mont, s=s, log_n=self.log_n,
                                    ops=ops)
        x = _transpose_out(x)
        for s in range(n_small, self.log_n):
            x = _radix2_stage(x, self._tw_mont, s=s, log_n=self.log_n,
                              ops=ops)
        return _decode_stage(x, ops=ops)


@partial(jax.jit, static_argnames=("ops",))
def _encode_stage(x, *, ops: FieldOps = BB31_OPS):
    return ops.encode(x)


@partial(jax.jit, static_argnames=("ops",))
def _decode_stage(x, *, ops: FieldOps = BB31_OPS):
    return ops.decode(x)


@jax.jit
def _transpose_in(x):
    return x.reshape(-1, 128).T          # (128, rows)


@jax.jit
def _transpose_out(xt):
    return xt.T.reshape(-1)


def _radix2_stage_body(x, tw_mont, *, s: int, log_n: int,
                       ops: FieldOps = BB31_OPS):
    """One DIF stage on the flat internal-representation array — shared by
    the monolithic and per-stage-jit paths."""
    n = 1 << log_n
    nb = n >> (s + 1)
    v3 = x.reshape(nb, 2, 1 << s)
    u, v = v3[:, 0, :], v3[:, 1, :]
    w = tw_mont[:nb][:, None]
    big_u = ops.add(u, v)
    big_v = ops.mul(ops.sub(u, v), w)
    return jnp.stack([big_u, big_v], axis=1).reshape(n)


@partial(jax.jit, static_argnames=("s", "log_n", "ops"), donate_argnums=(0,))
def _radix2_stage(x, tw_mont, *, s: int, log_n: int,
                  ops: FieldOps = BB31_OPS):
    """One large-span DIF stage (2^s >= 128) on the flat array."""
    return _radix2_stage_body(x, tw_mont, s=s, log_n=log_n, ops=ops)


@partial(jax.jit, static_argnames=("s", "log_n", "ops"), donate_argnums=(0,))
def _radix2_stage_small(xt, tw_mont, *, s: int, log_n: int,
                        ops: FieldOps = BB31_OPS):
    """One small-span stage (2^s < 128) on the transposed (128, rows) view.

    Element e = 128*r + j lives at xt[j, r]; pairs differ in bit s of j, so
    the butterfly runs along the major axis and every array keeps `rows`
    as its minor dim, where the naive (nb, 2, 2^s) view would have a
    tiny minor axis.
    """
    n = 1 << log_n
    rows = n // 128
    nb = n >> (s + 1)
    m = 128 >> (s + 1)                   # twiddle blocks per row
    v4 = xt.reshape(m, 2, 1 << s, rows)
    u, v = v4[:, 0], v4[:, 1]
    # block index of e is r*m + jb  ->  w[jb, r] = tw[r*m + jb]
    w = tw_mont[:nb].reshape(rows, m).T[:, None, :]
    big_u = ops.add(u, v)
    big_v = ops.mul(ops.sub(u, v), w)
    return jnp.stack([big_u, big_v], axis=1).reshape(128, rows)


@partial(jax.jit, static_argnames=("log_n", "skip_bitrev", "ops"))
def _radix2_apply(x, tw_mont, bitrev, *, log_n: int,
                  skip_bitrev: bool = False, ops: FieldOps = BB31_OPS):
    n = 1 << log_n
    x = ops.encode(x)  # BB31(uint32) ctor semantics: wrap + encode
    if not skip_bitrev:
        x = x[bitrev]
    for s in range(log_n):
        x = _radix2_stage_body(x, tw_mont, s=s, log_n=log_n, ops=ops)
    return ops.decode(x)
