"""Beyond-one-chip sumcheck evidence: C=4 at 2^26 on the virtual 8-mesh.

The reference RECORDED a failure at its 28-var config (result.txt tail;
SURVEY.md §4) — on a 16 GB GPU, 2^28 evaluations x 4 columns x 16 B = 17 GB
cannot fit.  The sharded prover exists for exactly that class of config:
rows cyclically sharded, per-shard footprint total/D, one XOR all-reduce
per round.  A real >16 GB run needs a real multi-chip mesh; what THIS tool
proves, on the virtual 8-device CPU mesh at the largest size it can hold
in reasonable wall time (2^26, C=4 — same column count as the failing
reference config, 4 GB of evaluations, 512 MB per shard), is that the
sharded prover is correct and memory-scaled at capacity:

  * round-0 messages satisfy the verifier identity sum == p(0) ^ p(1);
  * after a fold, round 1 satisfies the Fiat-Shamir chain
    claim == Lagrange(points, challenge) == p'(0) ^ p'(1);
  * per-shard buffer bytes == total/D exactly (printed below).

Memory math for the real target: 2^28 x C=4 x 16 B = 17.2 GB; at D=8
each shard holds 2.1 GB + the replicated coefficient batches (a few KB).

Usage:  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
            python tools/capacity_sharded_sumcheck.py [nv] [comp]
Prints one JSON row (suite "sharded_capacity").
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from jax.extend.backend import clear_backends

    clear_backends()
    import numpy as np

    from binius_ntt_tpu.parallel.mesh import make_mesh
    from binius_ntt_tpu.parallel.sumcheck_sharded import ShardedSumcheck
    from binius_ntt_tpu.sumcheck.verifier import (
        evaluate_univariate_given_points, words_to_int)
    from binius_ntt_tpu.utils.mt19937 import mt19937_stream

    nv = int(sys.argv[1]) if len(sys.argv) > 1 else 26
    comp = int(sys.argv[2]) if len(sys.argv) > 2 else 4

    t0 = time.time()
    evals = mt19937_stream(41 + nv + comp, 4 * (1 << nv) * comp)
    mesh = make_mesh()
    d = int(mesh.devices.size)
    s = ShardedSumcheck(evals, comp, nv, mesh)
    del evals
    setup_s = time.time() - t0

    shard_bytes = (s._device_evals.sharding.shard_shape(
        s._device_evals.shape))
    shard_bytes = int(np.prod(shard_bytes)) * 4
    total_bytes = comp * (1 << nv) * 16

    rng = np.random.default_rng(7)
    ok = True

    t0 = time.time()
    total, pts = s.round_messages()
    round0_s = time.time() - t0
    ok &= (words_to_int(total)
           == words_to_int(pts[0]) ^ words_to_int(pts[1]))

    challenge = rng.integers(0, 2 ** 32, size=4, dtype=np.uint32)
    claim = evaluate_univariate_given_points(
        words_to_int(challenge), [words_to_int(p) for p in pts], comp + 1)
    t0 = time.time()
    s.move_to_next_round(challenge)
    fold_s = time.time() - t0

    total1, pts1 = s.round_messages()
    ok &= (words_to_int(total1) == claim)
    ok &= (words_to_int(total1)
           == words_to_int(pts1[0]) ^ words_to_int(pts1[1]))

    rec = {
        "suite": "sharded_capacity", "backend": "cpu-mesh",
        "num_vars": nv, "composition": comp, "devices": d,
        "pass": bool(ok),
        "total_bytes": total_bytes, "per_shard_bytes": shard_bytes,
        "shard_is_total_over_d": shard_bytes * d == total_bytes,
        "setup_s": round(setup_s, 1), "round0_s": round(round0_s, 1),
        "fold_s": round(fold_s, 1),
        "ts": round(time.time(), 1),
    }
    print(json.dumps(rec), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
