"""BB31 radix-2 NTT tests: golden hashes + fwd/inv round-trip.

cf. reference src/ulvt/ntt/tests/test_ntt.cu:126-187.
"""

import hashlib

import numpy as np
import pytest

from golden_hashes import BB31_NTT_HASHES
from binius_ntt_tpu.fields import baby_bear as bb
from binius_ntt_tpu.ntt.radix2 import NTTRadix2
from binius_ntt_tpu.utils.mt19937 import mt19937_stream


def _digest(arr) -> str:
    return hashlib.md5(np.asarray(arr).astype("<u4").tobytes()).hexdigest()


@pytest.mark.parametrize("log_len", list(range(1, 11)))
def test_bb31_golden(log_len):
    inp = mt19937_stream(0xDEADBEEF + log_len, 1 << log_len)
    out = NTTRadix2(137, 27, log_len).apply(inp)
    assert _digest(out) == BB31_NTT_HASHES[log_len]


def test_roundtrip():
    log_len = 10
    gen = mt19937_stream(0xAABBCCDD, 1 << log_len)
    fwd = NTTRadix2(137, 27, log_len)
    inv = NTTRadix2(bb.inv_host(137), 27, log_len)
    out = np.asarray(inv.apply(np.asarray(fwd.apply(gen))))
    final = (out.astype(np.uint64) * bb.inv_host(1 << log_len)) % bb.P
    assert (final == gen.astype(np.uint64) % bb.P).all()


def test_montgomery_field_ops():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    a = rng.integers(0, bb.P, size=256, dtype=np.uint32)
    b = rng.integers(0, bb.P, size=256, dtype=np.uint32)
    am = bb.encode(jnp.asarray(a))
    bm = bb.encode(jnp.asarray(b))
    prod = np.asarray(bb.decode(bb.mont_mul(am, bm)))
    expect = (a.astype(np.uint64) * b.astype(np.uint64)) % bb.P
    assert (prod == expect).all()
    s = np.asarray(bb.decode(bb.add(am, bm)))
    assert (s == (a.astype(np.uint64) + b) % bb.P).all()
    d = np.asarray(bb.decode(bb.sub(am, bm)))
    assert (d == (a.astype(np.uint64) + bb.P - b) % bb.P).all()


def test_validation():
    with pytest.raises(ValueError):
        NTTRadix2(137, 27, 0)
    with pytest.raises(ValueError):
        NTTRadix2(137, 27, 28)
    with pytest.raises(ValueError):
        NTTRadix2(137, 5, 6)


def test_field_ops_injection_toy_prime():
    """NTTRadix2 over a non-BB31 field (the reference's NTT<E> genericity,
    gpuntt.cuh:126-131): F_257, generator 3 of the full 2^8 group."""
    from binius_ntt_tpu.ntt.radix2 import make_modp_ops

    p = 257
    ops = make_modp_ops(p)
    log_n = 6
    rng = np.random.default_rng(11)
    x = rng.integers(0, p, size=1 << log_n, dtype=np.uint32)
    fwd = NTTRadix2(3, 8, log_n, field_ops=ops)
    inv = NTTRadix2(pow(3, -1, p), 8, log_n, field_ops=ops)
    out = np.asarray(inv.apply(np.asarray(fwd.apply(x))))
    final = (out.astype(np.uint64) * pow(1 << log_n, -1, p)) % p
    assert (final == x).all()
    # injected path also exercises the per-stage-jit pipeline
    out2 = np.asarray(fwd.apply(x, per_stage_jit=False))
    assert (np.asarray(fwd.apply(x)) == out2).all()


def test_field_ops_injection_reproduces_bb31_golden():
    """A DISTINCT FieldOps instance carrying the BB31 functions must
    reproduce the reference's committed digests — pins the injection seam
    itself (the non-default-ops code path with known-good field math)."""
    from binius_ntt_tpu.ntt.radix2 import BB31_OPS, FieldOps

    ops = FieldOps(*BB31_OPS)          # equal contents, different identity
    assert ops is not BB31_OPS
    for log_len in (6, 9):
        inp = mt19937_stream(0xDEADBEEF + log_len, 1 << log_len)
        ntt = NTTRadix2(137, 27, log_len, field_ops=ops)
        out = ntt.apply(inp)
        assert _digest(out) == BB31_NTT_HASHES[log_len]


def test_per_stage_jit_path_matches_golden():
    for log_len in (8, 10):
        inp = mt19937_stream(0xDEADBEEF + log_len, 1 << log_len)
        out = NTTRadix2(137, 27, log_len).apply(inp, per_stage_jit=True)
        assert _digest(out) == BB31_NTT_HASHES[log_len]
