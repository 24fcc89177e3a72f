"""JAX field-arithmetic tests: SWAR packed and bit-sliced multipliers.

KAT vectors from the reference suite (src/ulvt/finite_fields/tests/):
SWAR heights 3/4 (test_fanpaartower.cu:9-53), height 0/2/5 lane semantics
(tests.cu:68-92), interleave primitives (tests.cu:17-52), bit-sliced 32-bit
and 128-bit products (test_fanpaartower.cu:122-274, tests.cu:115-201).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from binius_ntt_tpu.fields import bitsliced as bf
from binius_ntt_tpu.fields import tower_scalar as ts
from binius_ntt_tpu.fields.tower_simd import interleave_32b, mul_packed
from binius_ntt_tpu.layout.bitslicing import (
    bitslice_transpose,
    bitslice_untranspose,
)
from binius_ntt_tpu.utils.mt19937 import mt19937_stream


def _mp(a, b, h):
    return int(mul_packed(jnp.uint32(a), jnp.uint32(b), h))


def test_swar_h4():
    vectors = [
        (0x4F4B, 0x4386, 0x7202), (0x2276, 0xC732, 0x15F8),
        (0x45A6, 0x30FD, 0x78F1), (0xB6C2, 0x80C5, 0x41E7),
        (0x190F, 0x3ECE, 0x313B), (0x556C, 0x04D2, 0x4E9C),
        (0x03BA, 0x7D6F, 0x97BC), (0x9F1A, 0x5A23, 0x7CDC),
        (0x33A4, 0xB4BD, 0xF117), (0xF55C, 0x7796, 0x6F93),
        (0x2593, 0xB435, 0xBF68), (0x3C42, 0x587E, 0x11F4),
        (0xF797, 0x722C, 0xA499), (0xFDBA, 0x8F62, 0x4D14),
        (0xC92A, 0x0EE8, 0xED17), (0x944A, 0xAD43, 0x39EE),
        (0x9ACB, 0x15DF, 0xC270), (0xDDB4, 0x8F96, 0x4D71),
        (0x35C6, 0x4F5C, 0x1DB0), (0xF812, 0x7F13, 0xEB7C),
    ]
    for a, b, expect in vectors:
        # a word packs two 16-bit lanes; low lane must match the scalar mul
        assert _mp(a, b, 4) & 0xFFFF == expect & 0xFFFF
        assert ts.multiply(a & 0xFFFF, b & 0xFFFF, 4) == expect & 0xFFFF


def test_swar_h3():
    vectors = [
        (0xE0, 0x76, 0x96), (0x1B, 0xA6, 0xE5), (0xD2, 0xDB, 0x72),
        (0x9A, 0x0E, 0xB2), (0x8D, 0xEE, 0xC1), (0xC0, 0x33, 0x68),
        (0x9A, 0x68, 0xFF), (0x03, 0xBA, 0x65), (0xE0, 0x20, 0x57),
        (0xF9, 0x84, 0x77), (0x7C, 0x6D, 0xCE), (0x5C, 0xB9, 0x8C),
        (0xA4, 0x48, 0x38), (0x53, 0xB1, 0x9A), (0x70, 0x23, 0x49),
        (0x83, 0x81, 0x94), (0x40, 0xCB, 0x77), (0xD6, 0xEE, 0x5C),
        (0xDD, 0xC3, 0x19), (0xAF, 0xB4, 0xE5),
    ]
    for a, b, expect in vectors:
        assert _mp(a, b, 3) & 0xFF == expect
        assert ts.multiply(a, b, 3) == expect


def test_swar_full_word_lanes():
    # tests.cu:68-92
    assert _mp(0xD82C07CD, 0xD82C07CD, 0) == 0xD82C07CD
    assert _mp(0x31A9358B, 0xD82C07CD, 0) == 0x10280589
    assert _mp(0xD82C07CD, 0xD82C07CD, 2) == 0xF73E0BEF
    assert _mp(0x71948B72, 0xD82C07CD, 2) == 0x88E704F6
    assert _mp(0x71948B72, 0x8B86A383, 2) == 0xABF1B6A1
    assert _mp(0xD82C07CD, 0xD82C07CD, 5) == 0xAFAB1B8F
    assert _mp(0x6B4C9946, 0xD82C07CD, 5) == 0xF35C8D0F
    assert _mp(0x6B4C9946, 0x3D47E731, 5) == 0xF849322D
    assert _mp(0xBE127079, 0xD82C07CD, 5) == 0xD86F9EBA
    assert _mp(0xBE127079, 0x2CD911FC, 5) == 0x2B8B8F27


def test_interleave_32b():
    # tests.cu:17-52
    cases = [
        (0, 0x0000FFFF, 0xFFFF0000, 0xAAAA5555, 0xAAAA5555),
        (1, 0x0000FFFF, 0xFFFF0000, 0xCCCC3333, 0xCCCC3333),
        (2, 0x0000FFFF, 0xFFFF0000, 0xF0F00F0F, 0xF0F00F0F),
        (3, 0x03020100, 0x13121110, 0x12021000, 0x13031101),
        (4, 0x03020100, 0x13121110, 0x11100100, 0x13120302),
    ]
    for h, a, b, c, d in cases:
        got_c, got_d = interleave_32b(jnp.uint32(a), jnp.uint32(b), h)
        assert (int(got_c), int(got_d)) == (c, d)
        back_a, back_b = interleave_32b(got_c, got_d, h)
        assert (int(back_a), int(back_b)) == (a, b)


def test_swar_random_vs_oracle():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << 32, size=64, dtype=np.uint32)
    b = rng.integers(0, 1 << 32, size=64, dtype=np.uint32)
    for h in (0, 1, 2, 3, 4, 5):
        got = np.asarray(mul_packed(jnp.asarray(a), jnp.asarray(b), h))
        lanes = 32 >> h
        nbits = 1 << h
        mask = (1 << nbits) - 1
        for i in range(8):
            for lane in range(lanes):
                av = (int(a[i]) >> (lane * nbits)) & mask
                bv = (int(b[i]) >> (lane * nbits)) & mask
                gv = (int(got[i]) >> (lane * nbits)) & mask
                assert gv == ts.multiply(av, bv, h)


def test_bitsliced_32b_kat():
    # test_fanpaartower.cu:122-197 (first 17 slots of a 32-element batch)
    a_vals = [0x15292D36, 0xA510DF1D, 0x5A727AE6, 0xCE7254E6, 0xF81191BE,
              0x7D12A994, 0x0F842FB9, 0x85BAC424, 0xB2E07978, 0x16B4DD34,
              0xB6638341, 0x6CD7829F, 0x43EE57FE, 0xC3A8A8F1, 0xE5F8605E,
              0x0709BBEF, 0xF50AB4FE]
    b_vals = [0x96CA6D0C, 0xDC41B407, 0x545E0FE1, 0x4DB30A30, 0x0E366F2E,
              0xE2DF7626, 0xC62861BB, 0x0F4ECAF9, 0x4B65FF89, 0xFFB94D84,
              0x56BE64F1, 0x993C39D2, 0x8F74F10B, 0x8DD4C194, 0x53CBC3AC,
              0xCB2C72BC, 0xB9FEE15D]
    expect = [0x6BE27E5C, 0xA68B93B1, 0xD1BEACF8, 0xA7604999, 0x242A14FB,
              0x99CCAFD0, 0xE9C53105, 0x57E5C123, 0x589F6811, 0xC41E546F,
              0x39513551, 0xC2B49A16, 0xE9327422, 0xA4BD9048, 0x3992EC5E,
              0x09A14FB2, 0xE2BD264E]
    a = np.zeros(32, np.uint32); a[:17] = a_vals
    b = np.zeros(32, np.uint32); b[:17] = b_vals
    r = bf.multiply(jnp.asarray(bitslice_transpose(a)),
                    jnp.asarray(bitslice_transpose(b)), 5)
    r = bitslice_untranspose(np.asarray(r))
    assert list(r[:17]) == expect and (r[17:] == 0).all()


def test_bitsliced_128b_kat():
    # tests.cu:172-201: one 128-bit product in a 128-plane batch
    a_int = 0xF31223322755A4797859382795323434
    b_int = 0xD3473493847943875934759322048438
    expect = [0x4B3220E5, 0x999C424F, 0x2DC6D28C, 0xCEAA247E]
    a = np.zeros(128, np.uint32)
    b = np.zeros(128, np.uint32)
    for i in range(4):
        a[i] = (a_int >> (32 * i)) & 0xFFFFFFFF
        b[i] = (b_int >> (32 * i)) & 0xFFFFFFFF
    r = bf.multiply(jnp.asarray(bitslice_transpose(a)),
                    jnp.asarray(bitslice_transpose(b)), 7)
    r = bitslice_untranspose(np.asarray(r))
    assert list(r[:4]) == expect


def test_bitsliced_random_batches_vs_oracle():
    # widths >= 32: use the layout transposes (like the reference batches)
    for h in (5, 6, 7):
        w = 1 << h
        ipv = w // 32
        words = mt19937_stream(h * 101, 2 * w)
        a, b = words[:w], words[w:]
        r = bf.multiply(jnp.asarray(bitslice_transpose(a)),
                        jnp.asarray(bitslice_transpose(b)), h)
        r = bitslice_untranspose(np.asarray(r))
        for j in range(0, 32, 7):
            av = int.from_bytes(a[j*ipv:(j+1)*ipv].astype('<u4').tobytes(), 'little')
            bv = int.from_bytes(b[j*ipv:(j+1)*ipv].astype('<u4').tobytes(), 'little')
            gv = int.from_bytes(r[j*ipv:(j+1)*ipv].astype('<u4').tobytes(), 'little')
            assert gv == ts.multiply(av, bv, h)

    # height 2 (4 bit-planes, 32 lanes): build planes by hand
    rng = np.random.default_rng(h)
    a_el = rng.integers(0, 16, size=32)
    b_el = rng.integers(0, 16, size=32)

    def planes(vals):
        out = np.zeros(4, np.uint32)
        for i in range(4):
            for j in range(32):
                out[i] |= np.uint32(((int(vals[j]) >> i) & 1) << j)
        return out

    r = np.asarray(bf.multiply(jnp.asarray(planes(a_el)),
                               jnp.asarray(planes(b_el)), 2))
    for j in range(32):
        gv = sum(((int(r[i]) >> j) & 1) << i for i in range(4))
        assert gv == ts.multiply(int(a_el[j]), int(b_el[j]), 2)


def test_bitsliced_h2_chunks_via_subfield():
    # multiplying by a height-2 subfield scalar acts nibble-wise
    # (sumcheck/core/core.cu:45-48)
    words = mt19937_stream(999, 128)
    sliced = jnp.asarray(bitslice_transpose(words))
    coeff = 0x3
    from binius_ntt_tpu.layout.bitslicing import repeat_value_bitsliced
    cb = repeat_value_bitsliced(np.array([coeff, 0, 0, 0], np.uint32), 128)
    got = bf.mul_subfield_chunks(sliced, jnp.asarray(cb[:4]), 7, 2)
    got = bitslice_untranspose(np.asarray(got))
    for j in range(0, 32, 11):
        v = int.from_bytes(words[j*4:(j+1)*4].astype('<u4').tobytes(), 'little')
        g = int.from_bytes(got[j*4:(j+1)*4].astype('<u4').tobytes(), 'little')
        assert g == ts.multiply(v, coeff, 7)


def test_bitsliced_square_and_alpha():
    words = mt19937_stream(777, 128)
    sliced = jnp.asarray(bitslice_transpose(words))
    sq = bitslice_untranspose(np.asarray(bf.square(sliced, 7)))
    al = bitslice_untranspose(np.asarray(bf.multiply_alpha(sliced, 7)))
    for j in range(0, 32, 9):
        v = int.from_bytes(words[j*4:(j+1)*4].astype('<u4').tobytes(), 'little')
        s = int.from_bytes(sq[j*4:(j+1)*4].astype('<u4').tobytes(), 'little')
        a = int.from_bytes(al[j*4:(j+1)*4].astype('<u4').tobytes(), 'little')
        assert s == ts.square(v, 7)
        assert a == ts.multiply_alpha(v, 7)


def test_inverse_packed_matches_oracle():
    """Device-side tower inverse (tower_simd.inverse_packed) == scalar
    oracle; cf. the reference inverse kernel (binary_tower.cuh:63-81,
    profiled at 2^24 in test_kernels.cu:223-255)."""
    import numpy as np

    from binius_ntt_tpu.fields import tower_scalar as ts
    from binius_ntt_tpu.fields.tower_simd import inverse_packed, mul_packed

    rng = np.random.default_rng(11)
    for h in (2, 3, 4, 5):
        vals = rng.integers(0, 1 << (1 << h), size=128, dtype=np.uint32)
        got = np.asarray(inverse_packed(jnp.asarray(vals), h))
        want = np.array([ts.inverse(int(v), h) for v in vals],
                        dtype=np.uint32)
        assert np.array_equal(got, want)
        prod = np.asarray(mul_packed(jnp.asarray(vals), jnp.asarray(got), h))
        assert all(int(p) == (1 if v else 0)
                   for p, v in zip(prod, vals))



def _to_planes(vals, w):
    """(..., 32) element values of w bits -> (..., w) bit-planes."""
    bits = (vals[..., None, :] >> np.arange(w, dtype=object)[:, None]) & 1
    return (bits << np.arange(32, dtype=object)).sum(-1).astype(np.uint32)


@pytest.mark.parametrize("h", [2, 3, 4, 5, 6, 7])
def test_multiply_broadcast_vs_scalar(h):
    """A (3, 2^h) stack times one broadcast (1, 2^h) batch — the twiddle
    broadcast of the NTT stages — equals the scalar tower product lane by
    lane."""
    w = 1 << h
    rng = np.random.default_rng(60 + h)
    a_el = np.array([[int.from_bytes(rng.bytes(w // 8 or 1), "little")
                      % (1 << w) for _ in range(32)] for _ in range(3)],
                    dtype=object)
    b_el = np.array([[int.from_bytes(rng.bytes(w // 8 or 1), "little")
                      % (1 << w) for _ in range(32)]], dtype=object)
    got = np.asarray(bf.multiply(jnp.asarray(_to_planes(a_el, w)),
                                 jnp.asarray(_to_planes(b_el, w)), h))
    assert got.shape == (3, w)
    for r in range(3):
        for j in range(32):
            gv = sum(((int(got[r, i]) >> j) & 1) << i for i in range(w))
            assert gv == ts.multiply(int(a_el[r, j]), int(b_el[0, j]), h)
