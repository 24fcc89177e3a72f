"""Pin the communication schedule of the sharded paths (SCALING.md §4).

The weak-scaling analysis depends on three layout facts about what XLA's
SPMD partitioner emits (collectives are decided before backend codegen,
so the CPU-mesh compile is authoritative for a real ICI mesh):

  * sharded GF(2^128) NTT: exactly log2(D) cross-device exchanges of
    exactly the local shard — nothing else.  Each exchange is issued as
    OVERLAP_HALVES collective-permutes of half the shard (the double
    buffering that lets XLA overlap one half's exchange with the other
    half's butterflies), so op count = OVERLAP_HALVES * log2(D) while
    total permuted bytes stay exactly log2(D) * shard;
  * sharded sumcheck round: exactly one all-gather of the (1+P)*128-word
    partial sums;
  * sharded sumcheck fold: zero collectives.

A regression here (an extra all-gather from a lost sharding annotation, a
resharding collective-permute) silently multiplies the communication
volume that SCALING.md's >=80% efficiency claim is built on.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

from comm_volume import collective_bytes  # noqa: E402

from binius_ntt_tpu.parallel.mesh import make_mesh  # noqa: E402
from binius_ntt_tpu.parallel.ntt128_sharded import (  # noqa: E402
    ShardedAdditiveNTT128)
from binius_ntt_tpu.parallel.sumcheck_sharded import (  # noqa: E402
    ShardedSumcheck)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    return make_mesh()


def test_ntt128_ppermute_schedule(mesh):
    log_h, log_rate = 12, 1
    d = int(mesh.devices.size)
    ntt = ShardedAdditiveNTT128(log_h, log_rate, mesh)
    nb = (1 << log_h) // 32
    cosets = 1 << log_rate
    x = jax.device_put(np.zeros((cosets, nb, 128), np.uint32),
                       ntt._data_sharding)
    hlo = ntt._apply.lower(x, *ntt._tables).compile().as_text()
    got = collective_bytes(hlo)
    from binius_ntt_tpu.parallel.ntt128_sharded import OVERLAP_HALVES
    shard_bytes = cosets * (nb // d) * 128 * 4
    assert got["collective-permute"]["count"] == (
        ntt.log_d * OVERLAP_HALVES)
    assert got["collective-permute"]["bytes"] == ntt.log_d * shard_bytes
    assert got["total_bytes"] == ntt.log_d * shard_bytes, (
        "unexpected extra collectives in the sharded NTT")


def test_sumcheck_collective_schedule(mesh):
    nv, c = 11, 2
    d = int(mesh.devices.size)
    s = ShardedSumcheck(np.zeros(4 * (1 << nv) * c, np.uint32), c, nv, mesh)
    rows = jax.numpy.int32(s._rows)
    rhlo = s._round_fn.lower(
        s._device_evals, s._coeffs, rows).compile().as_text()
    fhlo = s._fold_fn.lower(
        s._device_evals, jax.numpy.zeros((128,), jax.numpy.uint32),
        rows).compile().as_text()
    rgot = collective_bytes(rhlo)
    fgot = collective_bytes(fhlo)
    assert rgot["all-gather"]["count"] == 1
    assert rgot["total_bytes"] == d * (1 + c + 1) * 128 * 4
    assert fgot["total_bytes"] == 0
