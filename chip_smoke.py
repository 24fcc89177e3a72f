"""Smoke run of the main path on the GPU, at the sizes the reference's own
test grid calls real (2^24 points / evaluations).

Usage::

    python chip_smoke.py              # every single-card phase, one card
    python chip_smoke.py --devices 4  # only the four-card path and the
                                      # single-card results it is held to

Phases (one card):
  ntt128      AdditiveNTT128(24, 0).apply and (24, 2).apply, MD5 against the
              native oracle's golden digests (tests/golden_hashes_oracle.py)
  ntt32       AdditiveNTT(24, 0).apply, MD5 against the reference's digest
  bb31        NTTRadix2(137, 27, 24) forward (MD5 against the reference's
              digest), then the inverse transform returns the input
  sumcheck128 full 24-variable Sumcheck at C=2 and C=3, every round checked
              with sumcheck/verifier.py (claim consistency, sum = p(0)^p(1))
  qm31        full 24-variable PrimeFieldSumcheck, per-round claim checks

The path has no hand-written kernel: every op runs its plain jnp program
(PERF.md), so there is no kernel-against-plain phase.

Inputs come from the repo's mt19937 generator with the golden tables' seeds.
All arithmetic on the path is integer or bitwise (binary-field XOR/AND,
prime-field uint32 limb products): no floating point occurs, so TF32 cannot
arise and every comparison is exact equality.

Each phase prints one line: compile-plus-first-result seconds, the median of
several steady runs that each end in ``block_until_ready``, the device's
``peak_bytes_in_use`` so far, and the card's name and power limit as
nvidia-smi reports them.  The last line is one JSON object with the device.
With no GPU, or if any check fails, the script exits non-zero and prints no
such line.  It runs in one process and starts no other process that opens
the card.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
LOG = 24


@functools.lru_cache(maxsize=None)
def _stream(seed: int, n: int) -> np.ndarray:
    """mt19937 words, generated once per (seed, length) in this run."""
    from binius_ntt_tpu.utils.mt19937 import mt19937_stream

    out = mt19937_stream(seed, n)
    out.setflags(write=False)
    return out


def _md5(words) -> str:
    return hashlib.md5(np.asarray(words).astype("<u4").tobytes()).hexdigest()


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Checks:
    """Per-phase timing lines; a failed check raises and ends the run."""

    def __init__(self, card: str):
        self.card = card

    @staticmethod
    def require(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"check failed: {what}")

    def timed(self, name: str, fn, reps: int = 3, **extra):
        """Run fn once (compile + first result) then `reps` more times;
        print the phase line and return the first result."""
        import jax

        from binius_ntt_tpu.utils.benchlib import first_and_steady

        out, first, steady = first_and_steady(fn, reps=reps)
        stats = jax.devices()[0].memory_stats() or {}
        line = {"phase": name, "first_s": first, "steady_median_s": steady,
                "reps": reps,
                "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
                "card": self.card, **extra}
        print(json.dumps(line), flush=True)
        return out


def phase_ntt128(ck: Checks):
    from golden_hashes_oracle import ADDITIVE_NTT128_HASHES

    from binius_ntt_tpu.ntt.additive_bitsliced import AdditiveNTT128

    for rate in (0, 2):
        ntt = AdditiveNTT128(LOG, rate)
        words = _stream(0xDEADBEEF + LOG + rate, (1 << LOG) * 4)
        out = ck.timed(f"ntt128_r{rate}", lambda: ntt.apply(words))
        ck.require(_md5(out) == ADDITIVE_NTT128_HASHES[rate][LOG],
                   f"ntt128 2^{LOG} r{rate} golden MD5")


def phase_ntt32(ck: Checks):
    from golden_hashes import ADDITIVE_NTT_HASHES

    from binius_ntt_tpu.ntt.additive import AdditiveNTT

    ntt = AdditiveNTT(LOG, 0)
    x = _stream(0xDEADBEEF + LOG, 1 << LOG)
    out = ck.timed("ntt32", lambda: ntt.apply(x))
    ck.require(_md5(out) == ADDITIVE_NTT_HASHES[0][LOG],
               f"ntt32 2^{LOG} golden MD5")


def phase_bb31(ck: Checks):
    from golden_hashes import BB31_NTT_HASHES

    from binius_ntt_tpu.fields import baby_bear as bb
    from binius_ntt_tpu.ntt.radix2 import NTTRadix2

    fwd = NTTRadix2(137, 27, LOG)
    inv = NTTRadix2(bb.inv_host(137), 27, LOG)
    x = _stream(0xDEADBEEF + LOG, 1 << LOG)
    y = ck.timed("bb31_forward", lambda: fwd.apply(x))
    ck.require(_md5(y) == BB31_NTT_HASHES[LOG], f"bb31 2^{LOG} golden MD5")
    z = np.asarray(ck.timed("bb31_inverse", lambda: inv.apply(y)))
    n_inv = np.uint64(bb.inv_host(1 << LOG))
    z = (z.astype(np.uint64) * n_inv % np.uint64(bb.P)).astype(np.uint32)
    ck.require(np.array_equal(z, x % np.uint32(bb.P)),
               "bb31 inverse(forward(x)) / n == x")


def _run_sumcheck128(evals, comp: int, seed: int):
    """Full protocol with the verifier's per-round checks; returns the
    number of rounds checked."""
    from binius_ntt_tpu.sumcheck.prover import Sumcheck
    from binius_ntt_tpu.sumcheck.verifier import (
        evaluate_univariate_given_points, words_to_int)

    chals = _stream(seed, 4 * LOG).reshape(LOG, 4)
    s = Sumcheck(evals, comp, LOG)
    claim = None
    for r in range(LOG):
        total, pts = s.round_messages()
        if claim is not None:
            Checks.require(words_to_int(total) == claim,
                           f"sumcheck C={comp} round {r} claim")
        Checks.require(words_to_int(total) == words_to_int(pts[0])
                       ^ words_to_int(pts[1]),
                       f"sumcheck C={comp} round {r} sum = p(0)^p(1)")
        claim = evaluate_univariate_given_points(
            words_to_int(chals[r]), [words_to_int(p) for p in pts], comp + 1)
        s.move_to_next_round(chals[r])
    return np.int32(LOG)


def phase_sumcheck128(ck: Checks):
    from binius_ntt_tpu.sumcheck.prover import INTS_PER_VALUE

    for comp in (2, 3):
        evals = _stream(7 + comp, INTS_PER_VALUE * (1 << LOG) * comp)
        ck.timed(f"sumcheck128_c{comp}",
                 lambda: _run_sumcheck128(evals, comp, 100 + comp), reps=1)


def phase_qm31(ck: Checks):
    from binius_ntt_tpu.fields.m31 import P, qm31_add_host
    from binius_ntt_tpu.sumcheck.prime_field import (PrimeFieldSumcheck,
                                                     interpolate_at_host)

    evals = (_stream(31, 2 * (1 << LOG) * 4) % np.uint32(P)).reshape(
        2, 1 << LOG, 4)
    chals = (_stream(32, 4 * LOG) % np.uint32(P)).reshape(LOG, 4)

    def run():
        pfs = PrimeFieldSumcheck(evals)
        claim = None
        for r in range(LOG):
            p = pfs.round_messages()
            if claim is not None:
                Checks.require(np.array_equal(qm31_add_host(p[0], p[1]),
                                              claim),
                               f"qm31 round {r} claim")
            claim = interpolate_at_host(chals[r], p)
            pfs.fold(chals[r])
        return np.int32(LOG)

    ck.timed("qm31", run, reps=1)


def phase_four_devices(ck: Checks):
    """The four-card path: sharded classes against golden digests and
    against the single-card provers, message for message."""
    import jax
    import jax.numpy as jnp

    from golden_hashes import ADDITIVE_NTT_HASHES
    from golden_hashes_oracle import ADDITIVE_NTT128_HASHES

    from binius_ntt_tpu.fields.m31 import P
    from binius_ntt_tpu.layout.bitslicing import (bitslice_transpose,
                                                  bitslice_untranspose)
    from binius_ntt_tpu.parallel.mesh import make_mesh
    from binius_ntt_tpu.parallel.ntt128_sharded import ShardedAdditiveNTT128
    from binius_ntt_tpu.parallel.ntt_sharded import ShardedAdditiveNTT
    from binius_ntt_tpu.parallel.prime_sharded import (
        ShardedPrimeFieldSumcheck)
    from binius_ntt_tpu.parallel.sumcheck_sharded import ShardedSumcheck
    from binius_ntt_tpu.sumcheck.prime_field import PrimeFieldSumcheck
    from binius_ntt_tpu.sumcheck.prover import INTS_PER_VALUE, Sumcheck

    mesh = make_mesh(4)

    def one_shard_per_device(arr, what):
        devs = {sh.device for sh in arr.addressable_shards}
        Checks.require(len(devs) == 4, f"{what}: shards on {len(devs)} "
                       "devices, want 4")

    words = _stream(0xDEADBEEF + LOG, (1 << LOG) * 4)
    sliced = np.asarray(jax.jit(bitslice_transpose)(
        jnp.asarray(words.reshape(-1, 128))))
    ntt128 = ShardedAdditiveNTT128(LOG, 0, mesh)
    out = ck.timed("sharded_ntt128_r0", lambda: ntt128.apply_sliced(sliced),
                   devices=4)
    one_shard_per_device(out, "sharded ntt128 output")
    Checks.require(
        _md5(jax.jit(bitslice_untranspose)(out)) ==
        ADDITIVE_NTT128_HASHES[0][LOG], "sharded ntt128 golden MD5")

    ntt32 = ShardedAdditiveNTT(LOG, 0, mesh)
    x32 = _stream(0xDEADBEEF + LOG, 1 << LOG)
    out = ck.timed("sharded_ntt32_r0", lambda: ntt32.apply(x32), devices=4)
    Checks.require(_md5(out) == ADDITIVE_NTT_HASHES[0][LOG],
                   "sharded ntt32 golden MD5")

    comp = 2
    evals = _stream(9, INTS_PER_VALUE * (1 << LOG) * comp)
    chals = _stream(102, 4 * LOG).reshape(LOG, 4)

    def run_sumcheck():
        sharded = ShardedSumcheck(evals, comp, LOG, mesh)
        one_shard_per_device(sharded._device_evals, "sharded sumcheck state")
        single = Sumcheck(evals, comp, LOG)
        for r in range(LOG):
            a, apts = sharded.round_messages()
            b, bpts = single.round_messages()
            Checks.require(np.array_equal(a, b) and np.array_equal(apts, bpts),
                           f"sharded sumcheck round {r} == single card")
            sharded.move_to_next_round(chals[r])
            single.move_to_next_round(chals[r])
        return np.int32(LOG)

    ck.timed("sharded_sumcheck128_c2_vs_single", run_sumcheck, reps=1,
             devices=4)

    # the sumcheck's words again (same length, generated once), reduced
    qe = (_stream(9, 2 * (1 << LOG) * 4) % np.uint32(P)).reshape(
        2, 1 << LOG, 4)
    qch = (_stream(34, 4 * LOG) % np.uint32(P)).reshape(LOG, 4)

    def run_qm31():
        sharded = ShardedPrimeFieldSumcheck(qe, mesh)
        single = PrimeFieldSumcheck(qe)
        for r in range(LOG):
            Checks.require(np.array_equal(sharded.round_messages(),
                                          single.round_messages()),
                           f"sharded qm31 round {r} == single card")
            sharded.fold(qch[r])
            single.fold(qch[r])
        return np.int32(LOG)

    ck.timed("sharded_qm31_vs_single", run_qm31, reps=1, devices=4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card path")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    if len(jax.devices()) < args.devices:
        print(f"chip_smoke: need {args.devices} GPUs, JAX sees "
              f"{len(jax.devices())}", file=sys.stderr)
        return 1

    from binius_ntt_tpu.utils.benchlib import setup_compile_cache

    print(f"compile cache: {setup_compile_cache()}", flush=True)
    card = _card()
    ck = Checks(card)
    t0 = time.perf_counter()
    if args.devices == 4:
        phases = [phase_four_devices]
    else:
        phases = [phase_ntt128, phase_ntt32, phase_bb31, phase_sumcheck128,
                  phase_qm31]
    for phase in phases:
        phase(ck)
    print(json.dumps({"total_s": time.perf_counter() - t0}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
