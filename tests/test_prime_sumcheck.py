"""QM31 prime-field sumcheck protocol test.

Mirrors the reference test (src/ulvt/prime_field_sumcheck/test_sumcheck.cu:9-99)
at a reduced size: evals[i] = QM31(i) for both columns, claim checked every
round via p(0) + p(1), next claim via quadratic interpolation at a fixed
challenge, with the exact reference challenge value.
"""

import numpy as np
import pytest

from binius_ntt_tpu.fields.m31 import P, qm31_add_host, qm31_mul_host
from binius_ntt_tpu.sumcheck.prime_field import (
    PrimeFieldSumcheck,
    interpolate_at_host,
)


def test_interpolate_constant():
    # test_sumcheck.cu:10-11 — interpolating a constant-4 polynomial at 7
    pts = [np.array([4, 0, 0, 0], np.uint32)] * 3
    r = interpolate_at_host(np.array([7, 0, 0, 0], np.uint32), pts)
    assert (r == np.array([4, 0, 0, 0], np.uint32)).all()


@pytest.mark.parametrize("tile", [None, 1, 64])
def test_protocol_num_vars_12(tile, monkeypatch):
    """tile: ROW_TILE of the while_loop kernels (None: the default); a
    small tile makes every round take several loop steps."""
    if tile is not None:
        import jax

        from binius_ntt_tpu.sumcheck import prime_field

        monkeypatch.setattr(prime_field, "ROW_TILE", tile)
        jax.clear_caches()              # the tile is read at trace time
    num_vars = 12
    n = 1 << num_vars
    col = np.zeros((n, 4), np.uint32)
    col[:, 0] = np.arange(n, dtype=np.uint32)  # QM31(i)
    evals = np.stack([col, col])  # two identical columns (test_sumcheck.cu:17-24)

    expected_claim = np.zeros(4, np.uint32)
    for i in range(n):
        expected_claim = qm31_add_host(
            expected_claim, qm31_mul_host(col[i], col[i])
        )

    s = PrimeFieldSumcheck(evals)
    challenge = np.array(
        [32482843 % P, 85864538 % P, 8348234 % P, 9544334 % P], np.uint32
    )  # test_sumcheck.cu:67-68
    for _ in range(num_vars):
        pts = s.round_messages()
        claim = qm31_add_host(pts[0], pts[1])
        assert (claim == expected_claim).all()
        expected_claim = interpolate_at_host(challenge, pts)
        s.fold(challenge)

    # after all rounds a single evaluation remains: it must equal the claim
    final = np.asarray(s._evals)[:, 0, :]
    final_prod = qm31_mul_host(final[0], final[1])
    assert (final_prod == expected_claim).all()
    if tile is not None:
        monkeypatch.undo()
        jax.clear_caches()


def test_m31_add_canonicalises_p_alias():
    # regression: the branchless fold maps a+b == P to P, not 0
    import jax.numpy as jnp

    from binius_ntt_tpu.fields.m31 import P, m31_add

    out = np.asarray(m31_add(
        jnp.asarray([1, 5, P - 1], dtype=jnp.uint32),
        jnp.asarray([P - 1, 3, P - 1], dtype=jnp.uint32)))
    assert (out == np.array([0, 8, P - 2], dtype=np.uint32)).all()
