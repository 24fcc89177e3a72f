"""Time the full GF(2^128) sumcheck protocol at several row-tile sizes.

The plain round and fold kernels (sumcheck/prover.py) walk the live rows
in tiles of ``ROW_TILE`` inside a ``lax.while_loop``; this script runs the
whole 2^log_n protocol once per (tile, composition size) and prints one
JSON line each: compile-plus-first-protocol seconds and the median of
``--reps`` later protocols, every one ending in ``block_until_ready``.
Every run's round messages must equal the first tile's, so a tile size
that changes the result fails the script.

    python tools/row_tile_ab.py                 # 2^24, C = 2 and 3
    python tools/row_tile_ab.py --log-n 12 --tiles 8 64   # quick, any CPU
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=24)
    ap.add_argument("--comps", type=int, nargs="+", default=[2, 3])
    ap.add_argument("--tiles", type=int, nargs="+",
                    default=[256, 1024, 4096])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)

    import jax

    from binius_ntt_tpu.sumcheck import prover
    from binius_ntt_tpu.utils.benchlib import (first_and_steady,
                                               setup_compile_cache)
    from binius_ntt_tpu.utils.mt19937 import mt19937_stream

    setup_compile_cache()
    card = _card()
    log_n = args.log_n
    for comp in args.comps:
        evals = mt19937_stream(7 + comp,
                               prover.INTS_PER_VALUE * (1 << log_n) * comp)
        chals = mt19937_stream(100 + comp, 4 * log_n).reshape(log_n, 4)

        def protocol():
            s = prover.Sumcheck(evals, comp, log_n)
            msgs = []
            for r in range(log_n):
                msgs.append(np.concatenate([m.ravel() for m in
                                            s.round_messages()]))
                s.move_to_next_round(chals[r])
            return np.stack(msgs)

        want = None
        for tile in args.tiles:
            prover.ROW_TILE = tile
            jax.clear_caches()          # the tile is read at trace time
            msgs, first, steady = first_and_steady(protocol, reps=args.reps)
            if want is None:
                want = msgs
            if not np.array_equal(msgs, want):
                raise AssertionError(f"C={comp} tile {tile}: messages differ")
            print(json.dumps({
                "op": "sumcheck128_protocol", "log_n": log_n, "comp": comp,
                "row_tile": tile, "first_s": first, "steady_median_s": steady,
                "reps": args.reps, "platform": jax.devices()[0].platform,
                "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
