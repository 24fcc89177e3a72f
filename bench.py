"""Benchmark driver — prints ONE JSON line with the headline metric.

North-star metric (BASELINE.json): additive-NTT butterflies/s/chip at 2^24
over GF(2^128), bit-sliced layout.  A 2^24-point transform runs
log_h * 2^(log_h-1) butterflies per coset.  Extras time the other hot ops
at 2^24.  Every time is the median of several calls that each end in
``block_until_ready``; compile-plus-first-call time is reported apart.

Usage: ``python bench.py [log_h]`` on a machine with a GPU.  With no
accelerator it exits non-zero and prints no result.

vs_baseline: the reference publishes no per-size numbers (BASELINE.md) and
only ever runs the additive NTT over GF(2^32); its "Additive NTT r=0
log_h 1..28" Catch2 suite totals 67.8 s on a Kaggle-class GPU including
H<->D copies and MD5 hashing (reference src/ulvt/ntt/result.txt).
Attributing the geometric bulk of that to the top sizes gives roughly ~2 s
for the 2^24 transform => ~1.0e8 butterflies/s as the baseline estimate used
for the ratio below (GF(2^32) there vs GF(2^128) here — i.e. the ratio is
conservative by a further ~8x field-width factor).
"""

import json
import sys

BASELINE_BUTTERFLIES_PER_S = 1.0e8


def bench_ntt128(log_h: int, log_rate: int = 0):
    """(butterflies/s, steady s, first-call s) of the GF(2^128) transform."""
    import jax
    import jax.numpy as jnp

    from binius_ntt_tpu.layout.bitslicing import bitslice_transpose
    from binius_ntt_tpu.ntt.additive_bitsliced import AdditiveNTT128
    from binius_ntt_tpu.utils.benchlib import first_and_steady
    from binius_ntt_tpu.utils.mt19937 import mt19937_stream

    ntt = AdditiveNTT128(log_h, log_rate)
    words = mt19937_stream(0xDEADBEEF + log_h, (1 << log_h) * 4)
    sliced = jax.block_until_ready(
        jax.jit(bitslice_transpose)(jnp.asarray(words.reshape(-1, 128))))
    _, first, steady = first_and_steady(lambda: ntt.apply_sliced(sliced))
    butterflies = log_h * (1 << (log_h - 1)) * (1 << log_rate)
    return butterflies / steady, steady, first


def bench_ntt32(log_h: int):
    import jax
    import jax.numpy as jnp

    from binius_ntt_tpu.ntt.additive import AdditiveNTT
    from binius_ntt_tpu.utils.benchlib import first_and_steady
    from binius_ntt_tpu.utils.mt19937 import mt19937_stream

    ntt = AdditiveNTT(log_h, 0)
    x = jax.block_until_ready(
        jnp.asarray(mt19937_stream(0xDEADBEEF + log_h, 1 << log_h)))
    _, first, steady = first_and_steady(lambda: ntt.apply(x))
    return steady, first


def bench_sumcheck_round(num_vars: int, comp: int = 2):
    """Steady time of one full-size device round: messages + fold, through
    the prover's own dispatch."""
    import jax.numpy as jnp

    from binius_ntt_tpu.sumcheck.prover import INTS_PER_VALUE, Sumcheck
    from binius_ntt_tpu.utils.benchlib import first_and_steady
    from binius_ntt_tpu.utils.mt19937 import mt19937_stream

    s = Sumcheck(mt19937_stream(7, INTS_PER_VALUE * (1 << num_vars) * comp),
                 comp, num_vars)
    challenge = mt19937_stream(11, INTS_PER_VALUE)

    def step():
        # the same full-size round each call: reset the round counter (the
        # folded rows are as good as fresh evaluations for timing)
        s.round = 0
        s.round_messages()
        s.move_to_next_round(challenge)
        return s._device_evals

    _, first, steady = first_and_steady(step, reps=3)
    return steady, first


def bench_radix2(log_n: int):
    """Forward BB31 radix-2 NTT (the reference suite's generator/group,
    test_ntt.cu:128-136)."""
    import jax
    import jax.numpy as jnp

    from binius_ntt_tpu.ntt.radix2 import NTTRadix2
    from binius_ntt_tpu.utils.benchlib import first_and_steady
    from binius_ntt_tpu.utils.mt19937 import mt19937_stream

    ntt = NTTRadix2(137, 27, log_n)
    x = jax.block_until_ready(
        jnp.asarray(mt19937_stream(0xDEADBEEF + log_n, 1 << log_n)))
    _, first, steady = first_and_steady(lambda: ntt.apply(x), reps=3)
    return steady, first


def main():
    import jax

    from binius_ntt_tpu.utils.benchlib import setup_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU (platform {dev.platform!r}); "
              "device metrics need the card", file=sys.stderr)
        sys.exit(1)
    setup_compile_cache()

    log_h = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    bps, ntt_s, first_s = bench_ntt128(log_h)
    log_small = min(log_h, 24)
    sc_s, sc_first = bench_sumcheck_round(log_small)
    bb_s, bb_first = bench_radix2(log_small)
    n32_s, n32_first = bench_ntt32(log_small)
    extras = {
        f"ntt128_2^{log_h}_seconds": ntt_s,
        "ntt128_first_call_seconds": first_s,
        f"sumcheck_2^{log_small}_c2_round_fold_seconds": sc_s,
        f"bb31_ntt_2^{log_small}_seconds": bb_s,
        f"ntt32_2^{log_small}_seconds": n32_s,
        "first_call_seconds": {"sumcheck": sc_first, "bb31": bb_first,
                               "ntt32": n32_first},
    }
    print(json.dumps({
        "metric": f"additive_ntt128_butterflies_per_s_chip_2^{log_h}",
        "value": bps,
        "unit": "butterflies/s",
        "vs_baseline": bps / BASELINE_BUTTERFLIES_PER_S,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extras": extras,
    }))


if __name__ == "__main__":
    main()
