"""Multi-chip bit-sliced GF(2^128) additive NTT over a 1-D mesh.

Combines parallel/ntt_sharded.py's stage decomposition (cross-device stages
exchange whole shards via ppermute; the re-tiling seam of the reference's
stage-group kernels, src/ulvt/ntt/additive_ntt.cuh:222-247) with
ntt/additive_bitsliced.py's bit-sliced butterflies.  This is the BASELINE
config-5 pipeline: 2^28-point transforms over GF(2^128) sharded past one
chip's HBM.

Sharding: the batch axis (n/32 bit-sliced batches) is block-sharded; device d
holds batches [d*Sb, (d+1)*Sb).  For stage s (pair distance 2^(s-5) batches):
  * 2^(s-5) >= Sb: partners live on device d XOR 2^(s-5)/Sb — one ppermute,
    each side computes its half of the butterfly; the twiddle is a single
    128-bit value per (coset, device) bit-broadcast into planes;
  * 2^(s-5) < Sb: shard-local, identical to the single-chip stage with the
    group index offset by d * local_groups;
  * s < 5: always local (in-batch lane butterflies).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as Pspec

from ..fields import bitsliced as bf
from ..ntt.additive import precompute_subspace_evals
from ..ntt.additive_bitsliced import (
    HEIGHT,
    IPV,
    W,
    _expand_bits,
    high_stage,
    low_stage,
    stage_tables,
)
from ..utils.capabilities import check_platform
from .mesh import AXIS

__all__ = ["ShardedAdditiveNTT128"]

# Communication/compute overlap: each cross-device stage splits the local
# shard into this many halves and issues one ppermute per half, so XLA's
# async collectives (collective-permute-start/done) can run half k+1's
# exchange while half k's butterflies compute — and, across stages, half
# 0's next-stage exchange while half 1 is still multiplying.  Total bytes
# exchanged are unchanged (pinned by tools/comm_volume.py).  Whether the
# overlap happens on a real mesh is read from a trace.  1 disables.
OVERLAP_HALVES = 2


class ShardedAdditiveNTT128:
    """The bit-sliced GF(2^128) additive NTT with the batch axis sharded
    over a 1-D mesh.  Shard-local stages run the single-device stage
    bodies (``high_stage``, ``low_stage``) on a slice of the same twiddle
    tables."""

    def __init__(self, log_h: int, log_rate: int, mesh):
        self.log_h = log_h
        self.log_rate = log_rate
        self.mesh = mesh
        check_platform()
        n_dev = int(mesh.devices.size)
        self.log_d = int(np.log2(n_dev))
        assert 1 << self.log_d == n_dev
        nb = (1 << log_h) // 32
        assert nb >= 2 * n_dev, "need >= 2 batches per device"

        rows = precompute_subspace_evals(log_h, log_rate, HEIGHT)
        self._tables = stage_tables(rows, log_h, log_rate)
        self._data_sharding = NamedSharding(mesh, Pspec(None, AXIS, None))
        self._apply = jax.jit(jax.shard_map(
            partial(_sharded_apply128, log_h=log_h, log_rate=log_rate,
                    log_d=self.log_d),
            mesh=mesh,
            in_specs=(Pspec(None, AXIS, None), Pspec(), Pspec(), Pspec()),
            out_specs=Pspec(None, AXIS, None),
        ))

    def apply_sliced(self, data):
        """data: (2^log_h/32, 128) bit-sliced (replicated or host) input.

        Returns (cosets * nb, 128) bit-sliced output, batch axis sharded.
        """
        cosets = 1 << self.log_rate
        nb = (1 << self.log_h) // 32
        # host-side zero-copy broadcast; device_put ships one shard per
        # device instead of materialising the full array on device 0
        host = np.broadcast_to(
            np.asarray(data, dtype=np.uint32)[None], (cosets, nb, W))
        x = jax.device_put(host, self._data_sharding)
        out = self._apply(x, *self._tables)
        return out.reshape(cosets * nb, W)


def _sharded_apply128(x, high, lowb, lowl, *, log_h: int, log_rate: int,
                      log_d: int):
    """Per-device body. x: (C, Sb, 128) local batches; high, lowb, lowl:
    the stage_tables dicts, replicated."""
    n = 1 << log_h
    nb = n // 32
    cosets = 1 << log_rate
    n_dev = 1 << log_d
    sb = nb // n_dev
    d = jax.lax.axis_index(AXIS)
    coset_ids = jnp.arange(cosets, dtype=jnp.uint32)

    # ---- cross-device stages (the top log_d: s >= log_h - log_d) ----
    # Double-buffered shard halves: all ppermutes of a stage are issued
    # before any butterfly math, and the halves stay split ACROSS stages,
    # so half h's next-stage exchange depends only on half h's butterfly —
    # XLA's async collective-permute overlaps it with the other half's
    # multiply (OVERLAP_HALVES above; bit-exactness pinned on the CPU mesh
    # by tests/test_sharded.py, schedule by tests/test_comm_volume.py).
    cross_lo = log_h - log_d
    if log_d > 0:
        nh = OVERLAP_HALVES if sb % OVERLAP_HALVES == 0 else 1
        hb = sb // nh
        parts = [x[:, i * hb:(i + 1) * hb] for i in range(nh)]
        for s in range(log_h - 1, cross_lo - 1, -1):
            db = 1 << (s - 5)
            bit = int(np.log2(db // sb))
            mask = 1 << bit
            perm = [(i, i ^ mask) for i in range(n_dev)]
            recvs = [jax.lax.ppermute(p, AXIS, perm) for p in parts]
            block = (d >> (bit + 1)).astype(jnp.uint32)
            ind = (coset_ids << (log_h - 1 - s)) | block
            w4 = high[s][ind]                       # (C, 4)
            wp = _expand_bits(w4)[:, None, :]       # (C, 1, 128)

            i_am_v = ((d >> bit) & 1).astype(bool)
            new_parts = []
            for p, recv in zip(parts, recvs):
                # one multiply serves both sides (w*v with v = recv on the
                # u-side device, v = x on the v-side device)
                m = bf.multiply(wp, jnp.where(i_am_v, p, recv), HEIGHT)
                new_parts.append(jnp.where(i_am_v, (recv ^ m) ^ p, p ^ m))
            parts = new_parts
        x = parts[0] if nh == 1 else jnp.concatenate(parts, axis=1)

    # ---- shard-local high stages ----
    for s in range(cross_lo - 1, 4, -1):
        db = 1 << (s - 5)
        groups_local = sb // (2 * db)
        groups_global = nb // (2 * db)
        # indicator = coset << (log_h-1-s) | group with groups contiguous
        # per coset: a reshape + slice at this device's offset, not a
        # gather
        table = high[s].reshape(cosets, groups_global, IPV)
        w4 = jax.lax.dynamic_slice(
            table, (0, d * groups_local, 0),
            (cosets, groups_local, IPV))
        x = high_stage(x, _expand_bits(w4)[:, :, None, :], db)

    # ---- low stages (always local) ----
    for s in range(min(log_h - 1, 4), -1, -1):
        # batch part of the indicator is contiguous per coset: slice the
        # doubling table at this device's batch offset (no gather)
        table = lowb[s].reshape(cosets, nb, IPV)
        a4 = jax.lax.dynamic_slice(
            table, (0, d * sb, 0), (cosets, sb, IPV))
        x = low_stage(x, _expand_bits(a4) ^ lowl[s][None, None, :], s)

    return x
