"""Multi-chip sumcheck: batch rows cyclically sharded over a 1-D mesh.

New work (the reference is single-GPU; its scaling mechanisms are
grid-stride batching and per-round halving, SURVEY.md §5).  Key design
choice: rows are sharded *cyclically* — device d holds global batch rows
{r : r mod D == d} — so that the per-round fold pairs (r, r + rows/2) are
always device-local (D divides rows/2 until the tail).  The only
communication in the entire protocol is one XOR all-reduce of the
(1 + num_points) x 128-word partial sums per round, the cross-device
analogue of the reference's atomicXor reduction
(src/ulvt/sumcheck/core/kernels.cuh:86-101).

Each device runs the single-chip fixed-shape kernels (prover.py's
``_round_kernel_tiled`` and ``_fold_kernel_tiled``) on its local buffer,
which keeps its shape for the whole protocol while the live row count
halves: one compile serves every round.

When one batch row per device remains, the state is gathered and the tail
rounds run on the single-chip path (mirroring the reference's GPU->CPU
migration at 32 evaluations, sumcheck.cuh:283-297).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as Pspec

from ..sumcheck.prover import (
    BITS_WIDTH,
    INTS_PER_VALUE,
    Sumcheck,
    _compute_sum,
    _fold_kernel_tiled,
    _round_kernel_tiled,
)
from ..layout.bitslicing import repeat_value_bitsliced
from .collectives import xor_all_reduce
from .mesh import AXIS

__all__ = ["ShardedSumcheck"]


class ShardedSumcheck:
    """Bit-sliced GF(2^128) sumcheck prover over a device mesh.

    Same protocol and message values as sumcheck.prover.Sumcheck — verified
    bit-identical in tests — with rows cyclically sharded over `mesh`.
    """

    def __init__(self, evals, composition_size: int, num_vars: int, mesh,
                 data_is_transposed: bool = False):
        self.mesh = mesh
        self.num_vars = num_vars
        self.composition_size = composition_size
        self.num_points = composition_size + 1
        self.round = 0
        self.n_dev = int(mesh.devices.size)

        b = (1 << num_vars) // 32
        assert b % (2 * self.n_dev) == 0, (
            "need at least two batch rows per device")

        evals = np.ascontiguousarray(np.asarray(evals, dtype=np.uint32))
        arr = evals.reshape(composition_size, b, BITS_WIDTH)
        # cyclic resharding: (C, B, W) -> (D, C, B/D, W), row r -> (r%D, r//D)
        arr = arr.reshape(composition_size, b // self.n_dev, self.n_dev,
                          BITS_WIDTH).transpose(2, 0, 1, 3)
        sharding = NamedSharding(mesh, Pspec(AXIS))
        # device_put the numpy array directly: each device receives only
        # its shard (jnp.asarray first would commit the full table to
        # device 0 — the unsharded footprint this class exists to avoid)
        dev = jax.device_put(arr, sharding)
        if not data_is_transposed:
            from ..layout.bitslicing import bitslice_transpose
            dev = jax.jit(bitslice_transpose)(dev)
        self._device_evals = dev      # (D, C, B/D, W) sharded on axis 0
        self._rows = b // self.n_dev  # live local rows of the buffer
        self._tail: Sumcheck | None = None
        self._build_fns()

    def _build_fns(self):
        mesh = self.mesh
        self._coeffs_np = np.stack([
            repeat_value_bitsliced(np.array([p, 0, 0, 0], np.uint32), BITS_WIDTH)
            for p in range(self.num_points)
        ])
        self._coeffs = jax.device_put(
            jnp.asarray(self._coeffs_np), NamedSharding(mesh, Pspec()))

        # check_vma=False: the round body ends in xor_all_reduce
        # (all_gather + lax.reduce with the XOR monoid) — replicated by
        # algebra, but shard_map's static replication checker cannot infer
        # invariance through lax.reduce with a custom computation, so
        # out_specs=P() is rejected with "could not infer replication over
        # any axes" (probed on jax 0.9).  Correctness is pinned by the
        # bit-equality tests against the single-chip prover
        # (tests/test_sharded.py) and by the comm-schedule HLO pin
        # (tools/comm_volume.py: exactly one all-gather per round).
        self._round_fn = jax.jit(jax.shard_map(
            partial(_wrapped_round, num_points=self.num_points),
            mesh=mesh,
            in_specs=(Pspec(AXIS), Pspec(), Pspec()),
            out_specs=Pspec(),
            check_vma=False,
        ))
        self._fold_fn = jax.jit(jax.shard_map(
            _wrapped_fold,
            mesh=mesh,
            in_specs=(Pspec(AXIS), Pspec(), Pspec()),
            out_specs=Pspec(AXIS),
        ))

    # ---- checkpoint / resume -------------------------------------------
    # The complete protocol state is (round, folded evaluations) — exactly
    # the property SURVEY.md §5 calls out (the reference's implicit state,
    # sumcheck.cuh:25-29).  The sharded prover serialises the GLOBAL row
    # order, so a 2^28 multi-host run can resume on a mesh of a DIFFERENT
    # size (or on one chip) — the elastic-recovery story for the configs
    # long enough to need it.

    def state_dict(self) -> dict:
        d = {
            "num_vars": self.num_vars,
            "composition_size": self.composition_size,
            "round": self.round,
        }
        if self._tail is not None:
            d["evals"] = None
            d["tail"] = self._tail.state_dict()
            return d
        # gather replicated (np.asarray on a P(AXIS)-sharded array raises
        # for non-addressable shards under multi-process), then invert the
        # cyclic layout: (D, C, J, W) -> global row j*D + d
        replicate = jax.jit(
            lambda e: e, out_shardings=NamedSharding(self.mesh, Pspec()))
        g = np.asarray(replicate(self._device_evals))[:, :, :self._rows]
        d["evals"] = np.ascontiguousarray(
            g.transpose(1, 2, 0, 3).reshape(
                self.composition_size, -1, BITS_WIDTH))
        d["tail"] = None
        return d

    @classmethod
    def from_state_dict(cls, d: dict, mesh) -> "ShardedSumcheck":
        self = cls.__new__(cls)
        self.mesh = mesh
        self.num_vars = int(d["num_vars"])
        self.composition_size = int(d["composition_size"])
        self.num_points = self.composition_size + 1
        self.round = int(d["round"])
        self.n_dev = int(mesh.devices.size)
        self._build_fns()
        if d["evals"] is None:
            self._tail = Sumcheck.from_state_dict(d["tail"])
            self._device_evals = None
            return self
        glob = np.ascontiguousarray(np.asarray(d["evals"], dtype=np.uint32))
        c, b, _ = glob.shape
        if b < 2 * self.n_dev:
            # too few live rows for this mesh: run the rest on the
            # single-chip tail (same handoff as move_to_next_round)
            self._tail = Sumcheck._from_state(
                jnp.asarray(glob), self.composition_size, self.num_vars,
                self.round)
            self._device_evals = None
            return self
        arr = glob.reshape(c, b // self.n_dev, self.n_dev, BITS_WIDTH
                           ).transpose(2, 0, 1, 3)
        self._device_evals = jax.device_put(
            arr, NamedSharding(mesh, Pspec(AXIS)))
        self._rows = b // self.n_dev
        self._tail = None
        return self

    def round_messages(self):
        if self._tail is not None:
            return self._tail.round_messages()
        parts = np.asarray(self._round_fn(
            self._device_evals, self._coeffs, jnp.int32(self._rows)))
        s = _compute_sum(parts[0], 32)
        pts = np.stack([_compute_sum(parts[1 + p], 32)
                        for p in range(self.num_points)])
        return s, pts

    def move_to_next_round(self, challenge):
        if self._tail is not None:
            self._tail.move_to_next_round(challenge)
            self.round += 1
            return
        challenge = np.asarray(challenge, np.uint32).reshape(INTS_PER_VALUE)
        coeff = jnp.asarray(repeat_value_bitsliced(challenge, BITS_WIDTH))
        self._device_evals = self._fold_fn(
            self._device_evals, coeff, jnp.int32(self._rows))
        self._rows //= 2
        self.round += 1
        if self._rows == 1:
            # gather: rows are (j=0, d) -> global row r = d, already ordered.
            # Replicate on device first — np.asarray on a Pspec(AXIS)-sharded
            # array raises for non-addressable shards under a multi-process
            # runtime; a replicated array is addressable on every process.
            replicate = jax.jit(
                lambda e: e,
                out_shardings=NamedSharding(self.mesh, Pspec()))
            gathered = np.asarray(
                replicate(self._device_evals))         # (D, C, 1, W)
            state = gathered[:, :, 0, :].transpose(1, 0, 2)  # (C, D, W)
            self._tail = Sumcheck._from_state(
                jnp.asarray(state), self.composition_size, self.num_vars,
                self.round)
            self._device_evals = None


def _wrapped_round(evals, coeffs, rows, *, num_points: int):
    # evals arrives as (1, C, B_loc, W) per device (axis 0 sharded); the
    # XOR all-reduce of the local partials is replicated, matching
    # out_specs=P().
    part = _round_kernel_tiled(evals[0], coeffs, rows, num_points=num_points)
    return xor_all_reduce(part, AXIS)


def _wrapped_fold(evals, coeff, rows):
    return _fold_kernel_tiled(evals[0], coeff, rows)[None]
