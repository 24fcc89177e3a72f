"""Multi-chip QM31 sumcheck: rows cyclically sharded over a 1-D mesh.

The prime-field analogue of parallel/sumcheck_sharded.py, sharing its key
design: rows live cyclically (device d holds global rows {r : r mod D == d})
so the per-round fold pairs (r, r + rows/2) stay device-local until the
tail, and the ONLY communication is one modular all-reduce of the (3, 4)
round-message words per round — the cross-device analogue of the
reference's lazy-u64 atomicAdd reduction
(src/ulvt/prime_field_sumcheck/core/kernels.cu:70-77).  Addition mod P is
associative and commutative, so the sharded sums equal the single-chip
prover's bit-for-bit after canonicalisation.

Each device runs the single-chip fixed-shape kernels (prime_field.py's
``_round_kernel`` and ``_fold_kernel``) on its local buffer, whose shape
stays fixed while the live row count halves: one compile serves every
round.

When one row per device remains, the state gathers onto the single-chip
prover for the tail rounds (mirroring sumcheck_sharded.py and the
reference's GPU->CPU migration pattern, sumcheck.cuh:283-297).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as Pspec

from ..fields.m31 import P
from ..sumcheck.prime_field import (PrimeFieldSumcheck, _fold_kernel,
                                    _round_kernel)
from .collectives import m31_all_reduce
from .mesh import AXIS

__all__ = ["ShardedPrimeFieldSumcheck"]


def _local_round(evals, rows):
    """Per-device round; evals: (2, B_loc, 4) buffer, `rows` live.

    Returns the replicated (3, 4) round polynomial at X = 0, 1, 2.
    """
    total = m31_all_reduce(_round_kernel(evals, rows), AXIS)
    # the add monoid keeps the s == P alias of 0; canonicalise the final
    # value (same guard as the single-chip _round_kernel)
    return jnp.where(total == jnp.uint32(P), jnp.uint32(0), total)


class ShardedPrimeFieldSumcheck:
    """QM31 sumcheck prover over a device mesh; message values are
    bit-identical to sumcheck.prime_field.PrimeFieldSumcheck (tested on
    the virtual mesh)."""

    def __init__(self, evals, mesh):
        """evals: (2, 2^n, 4) uint32 QM31 columns, components canonical."""
        self.mesh = mesh
        self.n_dev = int(mesh.devices.size)
        self.round = 0
        evals = np.ascontiguousarray(np.asarray(evals, dtype=np.uint32))
        assert evals.ndim == 3 and evals.shape[0] == 2 and evals.shape[2] == 4
        b = evals.shape[1]
        # the per-round halving requires a power of two (a non-power-of-two
        # local count would silently broadcast in the fold's lower/upper
        # split instead of erroring) and >= 2 rows per device
        if b & (b - 1) or b < 2 * self.n_dev:
            raise ValueError(
                f"evals rows ({b}) must be a power of two with >= 2 rows "
                f"per device ({self.n_dev} devices)")
        self._num_rows = b

        # cyclic resharding: row r -> (device r % D, local index r // D);
        # device_put ships one shard per device (no full-array staging)
        arr = evals.reshape(2, b // self.n_dev, self.n_dev, 4
                            ).transpose(2, 0, 1, 3)
        self._device_evals = jax.device_put(
            arr, NamedSharding(mesh, Pspec(AXIS)))
        self._tail: PrimeFieldSumcheck | None = None
        self._build_fns()

    def _build_fns(self):
        mesh = self.mesh
        # check_vma=False for the same reason as sumcheck_sharded.py: the
        # round ends in m31_all_reduce (all_gather + lax.reduce with the
        # modular-add monoid), replicated by algebra but opaque to
        # shard_map's static replication checker; bit-equality vs the
        # single-chip prover is pinned in tests/test_sharded.py.
        self._round_fn = jax.jit(jax.shard_map(
            lambda e, rows: _local_round(e[0], rows),
            mesh=mesh, in_specs=(Pspec(AXIS), Pspec()), out_specs=Pspec(),
            check_vma=False,
        ))
        self._fold_fn = jax.jit(jax.shard_map(
            lambda e, c, rows: _fold_kernel(e[0], c, rows)[None],
            mesh=mesh, in_specs=(Pspec(AXIS), Pspec(), Pspec()),
            out_specs=Pspec(AXIS),
        ))

    @property
    def _rows(self) -> int:
        """Live local rows of the fixed-shape buffer."""
        return self._num_rows // self.n_dev

    # ---- checkpoint / resume -------------------------------------------
    # Global row order is serialised, so a resume may use a mesh of a
    # different size (or fall back to the single-chip tail prover).

    def state_dict(self) -> dict:
        d = {"round": self.round}
        if self._tail is not None:
            d["evals"] = None
            d["tail"] = self._tail.state_dict()
            return d
        replicate = jax.jit(
            lambda e: e, out_shardings=NamedSharding(self.mesh, Pspec()))
        g = np.asarray(replicate(self._device_evals))[:, :, :self._rows]
        d["evals"] = np.ascontiguousarray(
            g.transpose(1, 2, 0, 3).reshape(2, -1, 4))
        d["tail"] = None
        return d

    @classmethod
    def from_state_dict(cls, d: dict, mesh) -> "ShardedPrimeFieldSumcheck":
        if d["evals"] is not None and d["evals"].shape[1] >= 2 * int(
                mesh.devices.size):
            self = cls(d["evals"], mesh)
            self.round = int(d["round"])
            return self
        self = cls.__new__(cls)
        self.mesh = mesh
        self.n_dev = int(mesh.devices.size)
        self.round = int(d["round"])
        self._device_evals = None
        self._build_fns()
        if d["evals"] is not None:
            self._num_rows = d["evals"].shape[1]
            self._tail = PrimeFieldSumcheck(jnp.asarray(d["evals"]))
            self._tail.round = self.round
        else:
            self._tail = PrimeFieldSumcheck.from_state_dict(d["tail"])
            self._num_rows = self._tail._num_rows
        return self

    def round_messages(self) -> np.ndarray:
        if self._tail is not None:
            return self._tail.round_messages()
        return np.asarray(self._round_fn(
            self._device_evals, jnp.int32(self._rows)))

    def fold(self, challenge) -> None:
        if self._tail is not None:
            self._tail.fold(challenge)
            self.round += 1
            return
        challenge = jnp.asarray(challenge, dtype=jnp.uint32).reshape(4)
        self._device_evals = self._fold_fn(
            self._device_evals, challenge, jnp.int32(self._rows))
        self._num_rows //= 2
        self.round += 1
        if self._num_rows == self.n_dev:
            # one row per device: global row r == d, already in order.
            # Replicate on device before materialising: np.asarray on a
            # Pspec(AXIS)-sharded array raises for non-addressable shards
            # under a multi-process runtime; a replicated array is fully
            # addressable on every process.
            replicate = jax.jit(
                lambda e: e,
                out_shardings=NamedSharding(self.mesh, Pspec()))
            gathered = np.asarray(
                replicate(self._device_evals))             # (D, 2, 1, 4)
            state = gathered[:, :, 0, :].transpose(1, 0, 2)  # (2, D, 4)
            self._tail = PrimeFieldSumcheck(jnp.asarray(state))
            self._device_evals = None
