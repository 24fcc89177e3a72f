"""binius_ntt_tpu — binary tower field / NTT / sumcheck framework in JAX.

A from-scratch JAX/XLA/Pallas implementation with the capabilities of the
CUDA reference library shourovrm/binius-NTT (see SURVEY.md):

  * binary tower fields GF(2^(2^h)) in scalar, packed-SWAR and bit-sliced
    representations (fields/);
  * the additive (Gao-Mateer/LCH) NTT and the radix-2 BB31 NTT (ntt/);
  * the GF(2^128) bit-sliced sumcheck prover and the QM31 prime-field
    sumcheck prover (sumcheck/);
  * multi-device sharding over a jax Mesh with ppermute stage exchange and
    XOR all-reduce (parallel/).
"""

from .fields import baby_bear, bitsliced, m31, tower_scalar, tower_simd
from .layout.bitslicing import (
    bitslice_transpose,
    bitslice_untranspose,
    repeat_value_bitsliced,
)
from .ntt.additive import AdditiveNTT
from .ntt.additive_bitsliced import AdditiveNTT128
from .ntt.radix2 import NTTRadix2
from .sumcheck.prover import Sumcheck
from .sumcheck.prime_field import PrimeFieldSumcheck
from .sumcheck import verifier

__all__ = [
    "AdditiveNTT",
    "AdditiveNTT128",
    "NTTRadix2",
    "Sumcheck",
    "PrimeFieldSumcheck",
    "baby_bear",
    "bitsliced",
    "bitslice_transpose",
    "bitslice_untranspose",
    "m31",
    "repeat_value_bitsliced",
    "tower_scalar",
    "tower_simd",
    "verifier",
]

__version__ = "0.1.0"
