"""Full sumcheck protocol tests with the verifier as oracle.

Mirrors the reference protocol test (src/ulvt/sumcheck/test/test.cu:13-101):
per round, claim == p(0) ^ p(1) and claim == Lagrange(previous points,
challenge); the final claim is checked against a brute-force multilinear
composition evaluation.  Reduced sizes (the protocol structure is
size-independent; 2^20+ configs are exercised by bench.py on real hardware).
"""

import numpy as np
import pytest

from binius_ntt_tpu.sumcheck import verifier as V
from binius_ntt_tpu.sumcheck.prover import INTS_PER_VALUE, Sumcheck
from binius_ntt_tpu.utils.mt19937 import mt19937_stream


def run_protocol(num_vars, comp, transposed, seed):
    n_ints = INTS_PER_VALUE * (1 << num_vars) * comp
    vals = mt19937_stream(seed, n_ints + 4 * num_vars)
    evals = vals[:n_ints].copy()
    challenges = vals[n_ints:].reshape(num_vars, 4)

    if transposed:
        from binius_ntt_tpu.layout.bitslicing import bitslice_transpose
        given = bitslice_transpose(evals.reshape(-1, 128)).reshape(-1)
    else:
        given = evals
    s = Sumcheck(given, comp, num_vars, data_is_transposed=transposed)

    expected_claim = None
    chal_ints = []
    for rnd in range(num_vars):
        sm, pts = s.round_messages()
        sm_i = V.words_to_int(sm)
        pts_i = [V.words_to_int(pts[p]) for p in range(comp + 1)]
        assert rnd == 0 or sm_i == expected_claim
        assert sm_i == pts_i[0] ^ pts_i[1]
        ch_i = V.words_to_int(challenges[rnd])
        chal_ints.append(ch_i)
        expected_claim = V.evaluate_univariate_given_points(
            ch_i, pts_i, comp + 1)
        s.move_to_next_round(challenges[rnd])

    sm, _ = s.round_messages()
    assert V.words_to_int(sm) == expected_claim

    # brute-force final evaluation (verifier.cu:88-107)
    per_col = (1 << num_vars) * INTS_PER_VALUE
    cols = []
    for c in range(comp):
        colw = evals[c * per_col:(c + 1) * per_col].reshape(-1, 4)
        cols.append([V.words_to_int(w) for w in colw])
    assert V.evaluate_multilinear_composition(cols, chal_ints) == expected_claim


@pytest.mark.parametrize("comp,transposed", [(2, False), (3, True)])
def test_protocol(comp, transposed):
    run_protocol(8, comp, transposed, seed=1000 + comp)


@pytest.fixture
def row_tile(monkeypatch):
    """Set prover.ROW_TILE for one test; the tile is read at trace time,
    so the jit caches are cleared on the way in and out."""
    import jax

    from binius_ntt_tpu.sumcheck import prover

    def set_tile(tile):
        monkeypatch.setattr(prover, "ROW_TILE", tile)
        jax.clear_caches()

    yield set_tile
    monkeypatch.undo()
    jax.clear_caches()


@pytest.mark.parametrize("tile", [1, 2, 8])
@pytest.mark.parametrize("comp", [2, 4])
def test_protocol_multi_tile(tile, comp, row_tile):
    """Tiles smaller than the live half make the round and fold kernels
    take several while_loop steps, as at 2^24; the protocol still checks
    round by round and against the brute-force final evaluation."""
    row_tile(tile)
    run_protocol(10, comp, False, seed=2000 + comp)


def test_lagrange_oracle_basics():
    # interpolating through the points of x^2 over GF(2^128) tower:
    # p(x) = x*x sampled at 0,1,2 -> evaluate at arbitrary challenge
    import binius_ntt_tpu.fields.tower_scalar as ts
    pts = [ts.multiply(x, x, 7) for x in range(3)]
    ch = 0xDEADBEEFCAFE
    got = V.evaluate_univariate_given_points(ch, pts, 3)
    assert got == ts.multiply(ch, ch, 7)


def test_checkpoint_resume_identical_messages():
    """state_dict/from_state_dict mid-protocol reproduces the remaining
    rounds bit-identically (SURVEY section 5: state = (round, folded
    evals), mirroring sumcheck.cuh:25-29)."""
    num_vars, comp = 8, 2
    evals = mt19937_stream(77, INTS_PER_VALUE * (1 << num_vars) * comp)
    a = Sumcheck(evals, comp, num_vars)
    rng = np.random.default_rng(3)
    challenges = [rng.integers(0, 2 ** 32, size=4, dtype=np.uint32)
                  for _ in range(num_vars)]
    for r in range(3):
        a.round_messages()
        a.move_to_next_round(challenges[r])

    b = Sumcheck.from_state_dict(a.state_dict())
    assert b.round == a.round
    for r in range(3, num_vars):
        sa, pa = a.round_messages()
        sb, pb = b.round_messages()
        assert np.array_equal(sa, sb) and np.array_equal(pa, pb)
        a.move_to_next_round(challenges[r])
        b.move_to_next_round(challenges[r])


def test_device_resident_presliced_ctor_matches():
    """Capacity-size entry: a device-resident pre-bit-sliced (C, B, 128)
    array (prepared via bitslice_transpose_streamed_cols, which keeps the
    device peak at buffer+chunk instead of the whole-array transpose's
    >=2x) must drive the identical protocol."""
    import jax.numpy as jnp  # noqa: F401

    from binius_ntt_tpu.layout.bitslicing import (
        bitslice_transpose_streamed_cols)

    nv, comp = 8, 2
    evals = mt19937_stream(123, INTS_PER_VALUE * (1 << nv) * comp)
    dev = bitslice_transpose_streamed_cols(
        evals.reshape(comp, -1, 128), chunk_rows=4)
    a = Sumcheck(evals, comp, nv)
    b = Sumcheck(dev, comp, nv, data_is_transposed=True)
    rng = np.random.default_rng(5)
    for _ in range(nv):
        ta, pa = a.round_messages()
        tb, pb = b.round_messages()
        assert np.array_equal(np.asarray(ta), np.asarray(tb))
        for x, y in zip(pa, pb):
            assert np.array_equal(np.asarray(x), np.asarray(y))
        ch = rng.integers(0, 2**32, size=4, dtype=np.uint32)
        a.move_to_next_round(ch)
        b.move_to_next_round(ch)
    with pytest.raises(ValueError):
        Sumcheck(dev, comp, nv)                      # not marked transposed
