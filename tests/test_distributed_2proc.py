"""REAL 2-process distributed run on localhost (CPU backend, Gloo).

tests/test_mesh_init.py pins initialize_distributed()'s argument plumbing
with a monkeypatched jax.distributed.initialize; this test runs the real
thing: two OS processes, a real coordination service, an 8-device global
mesh (4 per process), real cross-process collectives — and asserts the
sharded provers' messages and the sharded NTT's output are bit-identical
to the single-process implementations.  This is the only seam of the
multi-host path (SURVEY.md §5 "distributed communication backend") that
the virtual single-process mesh cannot exercise.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
CHILD = Path(__file__).resolve().parent / "_distributed_child.py"

NV, COMP, LOG_H = 10, 2, 9   # must match _distributed_child.py


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed(tmp_path):
    port = _free_port()
    outs = [tmp_path / f"proc{i}.json" for i in range(2)]
    procs = []
    for i in range(2):
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env["JAX_COORDINATOR_ADDRESS"] = f"localhost:{port}"
        env["JAX_NUM_PROCESSES"] = "2"
        env["JAX_PROCESS_ID"] = str(i)
        # a persistent-cache dir shared with other suites is fine; compile
        # artifacts are keyed by topology
        procs.append(subprocess.Popen(
            [sys.executable, str(CHILD), str(outs[i])],
            env=env, cwd=str(REPO),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    fail = []
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"distributed child {i} timed out")
        if p.returncode != 0:
            fail.append(f"child {i} rc={p.returncode}:\n"
                        f"{out.decode(errors='replace')[-2000:]}")
    assert not fail, "\n".join(fail)

    results = [json.loads(o.read_text()) for o in outs]
    assert {r["process_index"] for r in results} == {0, 1}
    assert all(r["n_devices"] == 8 for r in results)

    # ---- single-process reference (this pytest process, 8 local devices)
    from binius_ntt_tpu.layout.bitslicing import bitslice_transpose
    from binius_ntt_tpu.ntt.additive_bitsliced import AdditiveNTT128
    from binius_ntt_tpu.sumcheck.prover import Sumcheck
    from binius_ntt_tpu.utils.mt19937 import mt19937_stream

    n_ints = 4 * (1 << NV) * COMP
    vals = mt19937_stream(999, n_ints + 4 * NV)
    evals, chals = vals[:n_ints], vals[n_ints:].reshape(NV, 4)
    ref = Sumcheck(evals, COMP, NV)
    ref_messages = []
    for rnd in range(NV):
        total, pts = ref.round_messages()
        ref_messages.append([np.asarray(total).tolist(),
                             np.asarray(pts).tolist()])
        ref.move_to_next_round(chals[rnd])

    words = mt19937_stream(0xBEEF + LOG_H, (1 << LOG_H) * 4)
    sliced = bitslice_transpose(words.reshape(-1, 128))
    import jax.numpy as jnp
    ref_out = np.asarray(AdditiveNTT128(
        LOG_H, 0).apply_sliced(jnp.asarray(sliced)))
    ref_md5 = hashlib.md5(ref_out.astype("<u4").tobytes()).hexdigest()

    for r in results:
        assert r["messages"] == ref_messages, (
            f"process {r['process_index']} sumcheck messages diverged")
        assert r["ntt_md5"] == ref_md5, (
            f"process {r['process_index']} NTT output diverged")
