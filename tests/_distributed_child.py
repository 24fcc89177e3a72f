"""Child process for the real 2-process distributed test.

Run by tests/test_distributed_2proc.py in TWO OS processes with
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID set — this
exercises the PRODUCTION multi-host bring-up line
(binius_ntt_tpu.parallel.mesh.initialize_distributed -> real
jax.distributed.initialize, no monkeypatching) and real cross-process
collectives (Gloo on the CPU backend; the same program text runs over
NCCL on GPUs).

Usage: python tests/_distributed_child.py OUT_JSON
"""

import hashlib
import json
import pathlib
import sys

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from binius_ntt_tpu.parallel.mesh import (  # noqa: E402
    initialize_distributed, make_mesh)

assert initialize_distributed(), "env-driven multi-process init must engage"

import numpy as np  # noqa: E402

from binius_ntt_tpu.layout.bitslicing import bitslice_transpose  # noqa: E402
from binius_ntt_tpu.parallel.ntt128_sharded import (  # noqa: E402
    ShardedAdditiveNTT128)
from binius_ntt_tpu.parallel.sumcheck_sharded import (  # noqa: E402
    ShardedSumcheck)
from binius_ntt_tpu.utils.mt19937 import mt19937_stream  # noqa: E402

NV, COMP, LOG_H = 10, 2, 9


def main() -> None:
    out_path = sys.argv[1]
    mesh = make_mesh()
    n_dev = int(mesh.devices.size)

    # ---- sharded sumcheck, full protocol ----
    n_ints = 4 * (1 << NV) * COMP
    vals = mt19937_stream(999, n_ints + 4 * NV)
    evals, chals = vals[:n_ints], vals[n_ints:].reshape(NV, 4)
    s = ShardedSumcheck(evals, COMP, NV, mesh)
    messages = []
    for rnd in range(NV):
        total, pts = s.round_messages()
        messages.append([np.asarray(total).tolist(),
                         np.asarray(pts).tolist()])
        s.move_to_next_round(chals[rnd])

    # ---- sharded GF(2^128) NTT ----
    words = mt19937_stream(0xBEEF + LOG_H, (1 << LOG_H) * 4)
    sliced = bitslice_transpose(words.reshape(-1, 128))
    ntt = ShardedAdditiveNTT128(LOG_H, 0, mesh)
    out = ntt.apply_sliced(sliced)
    # replicate before materialising: the sharded output has
    # non-addressable shards in a multi-process runtime
    from jax.sharding import NamedSharding, PartitionSpec as Pspec

    rep = jax.jit(lambda a: a, out_shardings=NamedSharding(mesh, Pspec()))
    ntt_md5 = hashlib.md5(
        np.asarray(rep(out)).astype("<u4").tobytes()).hexdigest()

    with open(out_path, "w") as f:
        json.dump({"process_index": jax.process_index(),
                   "n_devices": n_dev,
                   "messages": messages,
                   "ntt_md5": ntt_md5}, f)


if __name__ == "__main__":
    main()
