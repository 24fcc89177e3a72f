"""Multi-chip additive NTT: element axis sharded over a 1-D mesh.

The reference scales the butterfly ladder by splitting it into stage-groups
of <= 11 stages, one kernel launch per group, re-tiling the thread->data
mapping between groups (src/ulvt/ntt/additive_ntt.cuh:222-247,
nttconf.cuh:43-46).  That kernel-boundary re-tiling seam is exactly where a
multi-device implementation exchanges data between devices (SURVEY.md §5).

Design (new work — no distributed code exists in the reference):
  * elements block-sharded: device d holds columns [d*S, (d+1)*S) of the
    (cosets, n) array, S = n / D;
  * stages s >= log2(S) pair elements on different devices: each pair of
    devices exchanges shards via ``ppermute`` (partner = d XOR 2^(s - logS))
    and computes its half of the butterfly — the u-side device produces
    u' = u + w*v, the v-side v' = u' + v.  The twiddle for such a stage is a
    single scalar per (coset, device) because the whole shard lies in one
    butterfly block (block = element >> (s+1) is constant when 2^(s+1) >= 2S);
  * stages s < log2(S) are shard-local, identical to the single-chip stage
    with the stage twiddle vector sliced at this device's block offset.

Like the single-chip path, twiddles come from precomputed per-stage tables
(GF(2)-linear doubling construction; see ntt/additive.py) — replicated, tiny.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..fields.tower_simd import mul_packed
from ..ntt.additive import precompute_subspace_evals, stage_twiddles
from .mesh import AXIS

__all__ = ["ShardedAdditiveNTT"]


class ShardedAdditiveNTT:
    """Additive NTT over GF(2^(2^height)) sharded over `mesh` (1-D)."""

    def __init__(self, log_h: int, log_rate: int, mesh, height: int = 5):
        import numpy as np

        self.log_h = log_h
        self.log_rate = log_rate
        self.height = height
        self.mesh = mesh
        n_dev = mesh.devices.size
        self.log_d = int(np.log2(n_dev))
        assert 1 << self.log_d == n_dev, "device count must be a power of two"
        assert log_h > self.log_d, "need at least 2 elements per shard"

        rows = precompute_subspace_evals(log_h, log_rate, height)
        self._twiddles = tuple(
            jnp.asarray(stage_twiddles(rows[s], log_h + log_rate - 1 - s))
            for s in range(log_h)
        )

        from jax.sharding import NamedSharding, PartitionSpec as Pspec

        self._data_sharding = NamedSharding(mesh, Pspec(None, AXIS))
        local = partial(
            _sharded_apply_local,
            log_h=log_h, log_rate=log_rate, height=height, log_d=self.log_d,
        )
        n_twiddle_args = log_h
        self._apply = jax.jit(
            jax.shard_map(
                local,
                mesh=mesh,
                in_specs=(Pspec(None, AXIS),) + (Pspec(),) * n_twiddle_args,
                out_specs=Pspec(None, AXIS),
            )
        )

    def apply(self, x):
        """x: (2^log_h,) uint32 IN_ORDER -> (2^(log_h+log_rate),) IN_ORDER.

        Accepts an unsharded array; places it block-sharded over the mesh.
        """
        import numpy as np

        n = 1 << self.log_h
        cosets = 1 << self.log_rate
        # broadcast on the host (zero-copy view) and let device_put transfer
        # one shard per device — materialising the full (cosets, n) array on
        # device 0 first would defeat sharding past one chip's HBM
        host = np.broadcast_to(
            np.asarray(x, dtype=np.uint32)[None, :], (cosets, n))
        data = jax.device_put(host, self._data_sharding)
        out = self._apply(data, *self._twiddles)
        return out.reshape(cosets * n)


def _sharded_apply_local(data, *twiddles, log_h: int, log_rate: int,
                         height: int, log_d: int):
    """Per-device body (inside shard_map). data: (cosets, S) local shard."""
    n = 1 << log_h
    cosets = 1 << log_rate
    n_dev = 1 << log_d
    s_shard = n >> log_d          # elements per device
    log_s = log_h - log_d
    d = jax.lax.axis_index(AXIS)
    coset_ids = jnp.arange(cosets, dtype=jnp.uint32)

    # ---- cross-device stages: one ppermute + half-butterfly each ----
    for s in range(log_h - 1, log_s - 1, -1):
        bit = s - log_s
        mask = 1 << bit
        perm = [(i, i ^ mask) for i in range(n_dev)]
        recv = jax.lax.ppermute(data, AXIS, perm)

        block = (d >> (bit + 1)).astype(jnp.uint32)
        ind = (coset_ids << (log_h - 1 - s)) | block          # (cosets,)
        w = jnp.take(twiddles[s], ind)[:, None]               # (cosets, 1)

        i_am_v = ((d >> bit) & 1).astype(bool)
        # one multiply serves both sides: the u side needs w*v (= w*recv),
        # the v side needs w*v (= w*data) for v' = u' ^ v = recv ^ w*v ^ v
        m = mul_packed(w, jnp.where(i_am_v, data, recv), height)
        data = jnp.where(i_am_v, (recv ^ m) ^ data, data ^ m)

    # ---- shard-local stages ----
    for s in range(log_s - 1, -1, -1):
        nb_local = s_shard >> (s + 1)
        nb_global = n >> (s + 1)
        table = twiddles[s].reshape(cosets, nb_global)
        w = jax.lax.dynamic_slice(
            table, (0, d * nb_local), (cosets, nb_local)
        )
        v4 = data.reshape(cosets, nb_local, 2, 1 << s)
        u, v = v4[:, :, 0, :], v4[:, :, 1, :]
        u2 = u ^ mul_packed(w[:, :, None], v, height)
        v2 = u2 ^ v
        data = jnp.stack([u2, v2], axis=2).reshape(cosets, s_shard)

    return data
