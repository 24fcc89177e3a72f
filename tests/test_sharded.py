"""Multi-device tests on the virtual 8-device CPU mesh.

The distributed layer is new design (the reference is single-GPU): the
sharded implementations must be bit-identical to the single-device ones.
"""

import numpy as np
import pytest

import jax

from binius_ntt_tpu.ntt.additive import AdditiveNTT
from binius_ntt_tpu.parallel.mesh import make_mesh
from binius_ntt_tpu.parallel.ntt_sharded import ShardedAdditiveNTT
from binius_ntt_tpu.parallel.sumcheck_sharded import ShardedSumcheck
from binius_ntt_tpu.sumcheck.prover import INTS_PER_VALUE, Sumcheck
from binius_ntt_tpu.utils.mt19937 import mt19937_stream

needs_mesh = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


@needs_mesh
@pytest.mark.parametrize("log_h,log_rate", [(8, 0), (8, 2), (4, 1)])
def test_sharded_ntt_bit_identical(log_h, log_rate):
    mesh = make_mesh()
    inp = mt19937_stream(0xDEADBEEF + log_h + log_rate, 1 << log_h)
    ref = np.asarray(AdditiveNTT(log_h, log_rate).apply(inp))
    got = np.asarray(ShardedAdditiveNTT(log_h, log_rate, mesh).apply(inp))
    assert (ref == got).all()


@needs_mesh
@pytest.mark.parametrize("nv,comp,n_dev,tile", [
    (10, 2, 8, None),
    (9, 3, 4, None),
    (10, 4, 2, 2),       # several while_loop steps per local round
    (11, 2, 8, 1),
])
def test_sharded_sumcheck_bit_identical(nv, comp, n_dev, tile, monkeypatch):
    """Each device runs the single-chip tiled kernels on its local rows;
    tile: prover.ROW_TILE (None: the default)."""
    if tile is not None:
        from binius_ntt_tpu.sumcheck import prover

        monkeypatch.setattr(prover, "ROW_TILE", tile)
        jax.clear_caches()              # the tile is read at trace time
    mesh = make_mesh(n_dev)
    n_ints = INTS_PER_VALUE * (1 << nv) * comp
    vals = mt19937_stream(123, n_ints + 4 * nv)
    evals, chals = vals[:n_ints], vals[n_ints:].reshape(nv, 4)

    a = Sumcheck(evals.copy(), comp, nv)
    b = ShardedSumcheck(evals.copy(), comp, nv, mesh)
    for rnd in range(nv):
        sa, pa = a.round_messages()
        sb, pb = b.round_messages()
        assert (sa == sb).all() and (pa == pb).all(), f"round {rnd}"
        a.move_to_next_round(chals[rnd])
        b.move_to_next_round(chals[rnd])
    sa, _ = a.round_messages()
    sb, _ = b.round_messages()
    assert (sa == sb).all()
    if tile is not None:
        monkeypatch.undo()
        jax.clear_caches()


@needs_mesh
def test_dryrun_multichip_entry():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


@needs_mesh
@pytest.mark.parametrize("log_h,log_rate,n_dev", [
    (9, 0, 8),       # two local batches per device
    (10, 1, 8),      # cosets
    (13, 0, 8),      # several shard-local high stages
    (14, 2, 8),      # rate 2: cosets through the stage indicators
    (11, 3, 4),      # rate 3 on a smaller mesh
    (12, 4, 2),      # rate 4, two devices
    (10, 0, 1),      # one device: every stage shard-local
])
def test_sharded_ntt128_bit_identical(log_h, log_rate, n_dev):
    """The sharded transform (cross-device ppermute stages, then the
    single-device stage bodies on each shard's slice of the twiddle
    tables) is bit-identical to the single-device transform."""
    from binius_ntt_tpu.layout.bitslicing import bitslice_transpose
    from binius_ntt_tpu.ntt.additive_bitsliced import AdditiveNTT128
    from binius_ntt_tpu.parallel.ntt128_sharded import ShardedAdditiveNTT128

    import jax.numpy as jnp

    mesh = make_mesh(n_dev)
    words = mt19937_stream(0xBEEF + log_h, (1 << log_h) * 4)
    sliced = np.asarray(
        bitslice_transpose(jnp.asarray(words.reshape(-1, 128))))
    ref = np.asarray(AdditiveNTT128(
        log_h, log_rate).apply_sliced(jnp.asarray(sliced)))
    out = ShardedAdditiveNTT128(log_h, log_rate, mesh).apply_sliced(sliced)
    assert len({sh.device for sh in out.addressable_shards}) == n_dev
    assert (ref == np.asarray(out)).all()


@needs_mesh
def test_sharded_ntt128_production_geometry():
    """log_h 18 over 8 devices: 1024 local batch rows per shard, 13
    shard-local high stages below 3 cross-device ones — the stage mix of
    a 2^28 transform on 8 devices, at a size the CPU runs."""
    from binius_ntt_tpu.layout.bitslicing import bitslice_transpose
    from binius_ntt_tpu.ntt.additive_bitsliced import AdditiveNTT128
    from binius_ntt_tpu.parallel.ntt128_sharded import ShardedAdditiveNTT128

    import jax.numpy as jnp

    log_h = 18
    mesh = make_mesh()
    words = mt19937_stream(0xBEEF + log_h, (1 << log_h) * 4)
    sliced = np.asarray(
        bitslice_transpose(jnp.asarray(words.reshape(-1, 128))))
    ref = np.asarray(AdditiveNTT128(
        log_h, 0).apply_sliced(jnp.asarray(sliced)))
    got = np.asarray(ShardedAdditiveNTT128(log_h, 0, mesh).apply_sliced(
        sliced))
    assert (ref == got).all()


@needs_mesh
@pytest.mark.parametrize("nv,n_dev", [(7, 8), (8, 4), (9, 1)])
def test_sharded_prime_sumcheck_bit_identical(nv, n_dev):
    """QM31 sharded prover == single-chip prover, full protocol (the
    prime-field analogue of the binary-field parity test; reference
    reduction: prime_field_sumcheck/core/kernels.cu:70-77)."""
    from binius_ntt_tpu.fields.m31 import P
    from binius_ntt_tpu.parallel.prime_sharded import (
        ShardedPrimeFieldSumcheck)
    from binius_ntt_tpu.sumcheck.prime_field import PrimeFieldSumcheck

    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(51)
    evals = rng.integers(0, P, size=(2, 1 << nv, 4), dtype=np.uint32)
    chals = rng.integers(0, P, size=(nv, 4), dtype=np.uint32)

    a = PrimeFieldSumcheck(evals)
    b = ShardedPrimeFieldSumcheck(evals, mesh)
    for r in range(nv):
        pa = a.round_messages()
        pb = b.round_messages()
        assert np.array_equal(pa, pb), f"round {r} diverged"
        a.fold(chals[r])
        b.fold(chals[r])


@needs_mesh
@pytest.mark.parametrize("snap_round,resume_devices", [
    (1, 8),    # live sharded state, same mesh
    (2, 4),    # live sharded state, SMALLER mesh (elastic resume)
    (4, 8),    # after the single-chip tail handoff
])
def test_sharded_sumcheck_checkpoint_resume(snap_round, resume_devices):
    """state_dict/from_state_dict mid-protocol reproduces the uninterrupted
    prover's messages bit-exactly — including resuming onto a mesh of a
    different size (the state serialises GLOBAL row order).  This is the
    checkpoint story SURVEY.md §5 asks for on the sharded prover (the
    config long enough to need it: 2^28 multi-host)."""
    mesh = make_mesh()
    nv, comp = 10, 2
    n_ints = INTS_PER_VALUE * (1 << nv) * comp
    vals = mt19937_stream(321, n_ints + 4 * nv)
    evals, chals = vals[:n_ints], vals[n_ints:].reshape(nv, 4)

    ref = Sumcheck(evals.copy(), comp, nv)
    b = ShardedSumcheck(evals.copy(), comp, nv, mesh)
    for rnd in range(snap_round):
        ref.round_messages()
        ref.move_to_next_round(chals[rnd])
        b.round_messages()
        b.move_to_next_round(chals[rnd])

    state = b.state_dict()
    del b
    c = ShardedSumcheck.from_state_dict(state, make_mesh(resume_devices))
    assert c.round == snap_round
    for rnd in range(snap_round, nv):
        sa, pa = ref.round_messages()
        sb, pb = c.round_messages()
        assert (sa == sb).all() and (pa == pb).all(), f"round {rnd}"
        ref.move_to_next_round(chals[rnd])
        c.move_to_next_round(chals[rnd])
    sa, _ = ref.round_messages()
    sb, _ = c.round_messages()
    assert (sa == sb).all()


@needs_mesh
@pytest.mark.parametrize("snap_round,resume_devices", [
    (2, 8),    # live sharded state
    (3, 4),    # live state onto a smaller mesh
    (5, 8),    # after the tail handoff
])
def test_sharded_prime_checkpoint_resume(snap_round, resume_devices):
    from binius_ntt_tpu.fields.m31 import P
    from binius_ntt_tpu.parallel.prime_sharded import (
        ShardedPrimeFieldSumcheck)
    from binius_ntt_tpu.sumcheck.prime_field import PrimeFieldSumcheck

    mesh = make_mesh()
    nv = 7
    rng = np.random.default_rng(83)
    evals = rng.integers(0, P, size=(2, 1 << nv, 4), dtype=np.uint32)
    chals = rng.integers(0, P, size=(nv, 4), dtype=np.uint32)

    ref = PrimeFieldSumcheck(evals)
    b = ShardedPrimeFieldSumcheck(evals, mesh)
    for r in range(snap_round):
        ref.round_messages()
        ref.fold(chals[r])
        b.round_messages()
        b.fold(chals[r])

    state = b.state_dict()
    del b
    c = ShardedPrimeFieldSumcheck.from_state_dict(
        state, make_mesh(resume_devices))
    assert c.round == snap_round
    for r in range(snap_round, nv):
        pa = ref.round_messages()
        pb = c.round_messages()
        assert np.array_equal(pa, pb), f"round {r} diverged"
        ref.fold(chals[r])
        c.fold(chals[r])
