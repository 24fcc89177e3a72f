"""Measure the communication volume of the sharded paths from compiled HLO.

SCALING.md §4's weak-scaling analysis assumes a specific communication
schedule: the sharded GF(2^128) NTT exchanges its whole local shard once
per cross-device stage (log2(D) exchanges, each issued as OVERLAP_HALVES
half-shard ppermutes so the exchange overlaps the butterfly compute), and
the sharded sumcheck's only communication is one small XOR all-reduce per
round.  This tool
*verifies those assumptions against what XLA actually compiled*: it lowers
each sharded computation on a virtual 8-device CPU mesh, walks the
post-SPMD HLO text, and sums the per-device bytes moved by every
collective op (collective-permute / all-gather / all-reduce / all-to-all).

The numbers are layout facts, not timings — identical on a real ICI mesh,
because SPMD partitioning happens before backend codegen.

Usage:  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
            python tools/comm_volume.py [log_h] [nv]
"""

from __future__ import annotations

import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_COLLECTIVES = ("collective-permute", "all-gather", "all-reduce",
                "reduce-scatter", "ragged-all-to-all", "all-to-all")
_DTYPE_BYTES = {"u32": 4, "s32": 4, "f32": 4, "u64": 8, "s64": 8,
                "u16": 2, "s16": 2, "u8": 1, "s8": 1, "pred": 1}

# one HLO op line, e.g.:  %x = u32[4,256,128]{...} collective-permute(...)
_OP_RE = re.compile(
    r"=\s+(?:\([^)]*\)|(\w+)\[([\d,]*)\][^ ]*)\s+"
    r"(" + "|".join(_COLLECTIVES) + r")(?:-start)?\(")


def collective_bytes(hlo_text: str) -> dict:
    """Per-device bytes moved by each collective kind in an HLO module."""
    out: dict = {k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}
    for m in _OP_RE.finditer(hlo_text):
        dtype, dims, kind = m.group(1), m.group(2), m.group(3)
        if dtype is None:
            # tuple-shaped result (e.g. all-reduce of several operands):
            # sum the element shapes between '=' and the op kind — sliced
            # by match-group positions, NOT by splitting the line on the
            # kind string (the instruction's own NAME usually contains it,
            # e.g. '%all-reduce.1 = ...')
            size = 0
            tuple_text = hlo_text[m.start():m.start(3)]
            for dt, ds in re.findall(r"(\w+)\[([\d,]*)\]", tuple_text):
                n = 1
                for d in ds.split(","):
                    if d:
                        n *= int(d)
                size += n * _DTYPE_BYTES.get(dt, 4)
        else:
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            size = n * _DTYPE_BYTES.get(dtype, 4)
        out[kind]["count"] += 1
        out[kind]["bytes"] += size
    out["total_bytes"] = sum(v["bytes"] for k, v in out.items()
                             if isinstance(v, dict))
    return out


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from jax.extend.backend import clear_backends

    clear_backends()
    import numpy as np

    from binius_ntt_tpu.parallel.mesh import make_mesh
    from binius_ntt_tpu.parallel.ntt128_sharded import ShardedAdditiveNTT128
    from binius_ntt_tpu.parallel.sumcheck_sharded import ShardedSumcheck

    log_h = int(sys.argv[1]) if len(sys.argv) > 1 else 14
    nv = int(sys.argv[2]) if len(sys.argv) > 2 else 14
    log_rate = 1

    mesh = make_mesh()
    d = int(mesh.devices.size)
    results = []

    # ---- sharded GF(2^128) NTT ----
    ntt = ShardedAdditiveNTT128(log_h, log_rate, mesh)
    nb = (1 << log_h) // 32
    cosets = 1 << log_rate
    x = jax.device_put(
        np.zeros((cosets, nb, 128), np.uint32), ntt._data_sharding)
    hlo = ntt._apply.lower(x, *ntt._tables).compile().as_text()
    got = collective_bytes(hlo)
    # analytic: log2(D) cross-device stages x the local shard
    shard_bytes = cosets * (nb // d) * 128 * 4
    want = ntt.log_d * shard_bytes
    results.append({
        "path": f"ntt128 log_h={log_h} rate={log_rate} D={d}",
        "measured": got, "analytic_ppermute_bytes": want,
        "match": got["collective-permute"]["bytes"] == want,
    })

    # ---- sharded sumcheck: round + fold ----
    c = 2
    ev = np.zeros(4 * (1 << nv) * c, np.uint32)
    s = ShardedSumcheck(ev, c, nv, mesh)
    rows = jax.numpy.int32(s._rows)
    rhlo = s._round_fn.lower(
        s._device_evals, s._coeffs, rows).compile().as_text()
    fhlo = s._fold_fn.lower(
        s._device_evals, jax.numpy.zeros((128,), jax.numpy.uint32),
        rows).compile().as_text()
    rgot = collective_bytes(rhlo)
    fgot = collective_bytes(fhlo)
    # analytic: one all-reduce/gather of (1+P) 128-word partials per round
    want_round = d * (1 + c + 1) * 128 * 4   # all_gather: D copies land
    results.append({
        "path": f"sumcheck round nv={nv} C={c} D={d}",
        "measured": rgot, "analytic_allgather_bytes": want_round,
        "match": rgot["total_bytes"] <= 2 * want_round,
    })
    results.append({
        "path": f"sumcheck fold nv={nv} C={c} D={d}",
        "measured": fgot, "analytic_bytes": 0,
        "match": fgot["total_bytes"] == 0,
    })

    for r in results:
        print(json.dumps(r))
    ok = all(r["match"] for r in results)
    print("COMM VOLUME:", "MATCHES ANALYTIC MODEL" if ok else "MISMATCH")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
