"""Value-level pins from the native-oracle golden table.

Covers what the reference's own table cannot (test_ntt.cu:52-124 has only
GF(2^32) at rates 0/2): the GF(2^128) transform at committed digests, and
every other accepted log_rate (1/3/4 — domain per nttconf.cuh:55-60) for
both widths.  Digests minted by tools/gen_golden128.py, whose oracle first
reproduces the reference's GF(2^32) table (see _selfcheck there and
tests/test_native_oracle.py).  chip_smoke.py checks the 2^24 entries on
the card.
"""

import hashlib

import numpy as np
import pytest

from golden_hashes_oracle import (ADDITIVE_NTT128_HASHES,
                                  ADDITIVE_NTT32_EXTRA_HASHES)
from binius_ntt_tpu.ntt.additive import AdditiveNTT
from binius_ntt_tpu.ntt.additive_bitsliced import AdditiveNTT128
from binius_ntt_tpu.utils.mt19937 import mt19937_stream


def _md5(words) -> str:
    return hashlib.md5(np.asarray(words).astype("<u4").tobytes()).hexdigest()


@pytest.mark.parametrize("log_h,log_rate", [
    (6, 0), (9, 0), (12, 0), (6, 2), (10, 2),
    (6, 1), (8, 3), (8, 4), (10, 1),
])
def test_ntt128_golden_cpu(log_h, log_rate):
    words = mt19937_stream(0xDEADBEEF + log_h + log_rate, (1 << log_h) * 4)
    got = _md5(AdditiveNTT128(log_h, log_rate).apply(words))
    assert got == ADDITIVE_NTT128_HASHES[log_rate][log_h]


@pytest.mark.parametrize("log_h,log_rate", [
    (6, 1), (10, 1), (8, 3), (10, 3), (8, 4), (12, 4),
])
def test_ntt32_extra_rates_golden_cpu(log_h, log_rate):
    x = mt19937_stream(0xDEADBEEF + log_h + log_rate, 1 << log_h)
    got = _md5(AdditiveNTT(log_h, log_rate).apply(x))
    assert got == ADDITIVE_NTT32_EXTRA_HASHES[log_rate][log_h]
