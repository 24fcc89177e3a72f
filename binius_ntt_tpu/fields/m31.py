"""Mersenne-31 tower: M31, CM31 = M31[i], QM31 = CM31[j] (JAX + host scalar).

Matches the reference's field definitions exactly:
  * M31 = GF(2^31 - 1), branchless add/sub/mul-fold
    (src/ulvt/finite_fields/m31.cuh:6-77);
  * CM31 with i^2 = -1 (cm31.cuh:48-53);
  * QM31 with j^2 = R = 2 + i (qm31.cuh:6, :38-43).

JAX representation: structure-of-arrays — a QM31 array is a uint32 array of
shape (..., 4) with components (a, b, c, d) = (a + bi) + (c + di)j, each
component canonical in [0, P).  All ops are elementwise uint32; the 31x31
product uses the same 16-bit-limb mulhi as baby_bear (no 64-bit type).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

P = (1 << 31) - 1

__all__ = ["P", "m31_add", "m31_sub", "m31_mul", "qm31_add", "qm31_sub", "qm31_mul", "qm31_scalar"]


def m31_add(a, b):
    """(a + b) mod P, inputs canonical; m31.cuh:23-27.

    The branchless fold (s + (s >> 31)) & P maps s == P to P (bit 31 is
    clear, so nothing wraps) — canonicalise that alias to 0 explicitly.
    """
    s = a + b
    s = (s + (s >> 31)) & jnp.uint32(P)
    return jnp.where(s == P, jnp.uint32(0), s)


def m31_sub(a, b):
    """(a - b) mod P, inputs canonical; m31.cuh:36-40."""
    d = a - b
    return (d - (d >> 31)) & jnp.uint32(P)


def _mul64(a, b):
    """(hi, lo) of the 64-bit product of two uint32 arrays (16-bit limbs)."""
    a0 = a & 0xFFFF
    a1 = a >> 16
    b0 = b & 0xFFFF
    b1 = b >> 16
    t = a0 * b0
    mid = a0 * b1 + (t >> 16)
    mid2 = a1 * b0 + (mid & 0xFFFF)
    hi = a1 * b1 + (mid >> 16) + (mid2 >> 16)
    lo = (t & 0xFFFF) | (mid2 << 16)
    return hi, lo


def m31_mul(a, b):
    """(a * b) mod P, canonical inputs; m31.cuh:49-51 via the u62 fold."""
    hi, lo = _mul64(a, b)
    # val = hi*2^32 + lo < P^2 < 2^62.  Fold: val = (val >> 31) + (val & P)
    # twice (Mersenne reduction), then a final conditional subtract.
    top = (hi << 1) | (lo >> 31)             # val >> 31, < 2^31
    low = lo & jnp.uint32(P)
    s = top + low                            # < 2^32
    s = (s >> 31) + (s & jnp.uint32(P))      # < P + 1
    return jnp.where(s == P, jnp.uint32(0), s)


# ---- QM31 as (..., 4) uint32: (a + bi) + (c + di) j, j^2 = 2 + i ----

def qm31_add(x, y):
    return m31_add(x, y)


def qm31_sub(x, y):
    return m31_sub(x, y)


def _cm31_mul(ax, ay, bx, by):
    """(ax + ay i)(bx + by i) with i^2 = -1; cm31.cuh:48-53."""
    re = m31_sub(m31_mul(ax, bx), m31_mul(ay, by))
    im = m31_add(m31_mul(ax, by), m31_mul(ay, bx))
    return re, im


def qm31_mul(x, y):
    """QM31 product of (..., 4) component arrays; qm31.cuh:38-43.

    (u + vj)(s + tj) = (u s + R v t) + (u t + v s) j,  R = 2 + i.
    """
    ax, ay, az, aw = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    bx, by, bz, bw = y[..., 0], y[..., 1], y[..., 2], y[..., 3]
    us_re, us_im = _cm31_mul(ax, ay, bx, by)
    vt_re, vt_im = _cm31_mul(az, aw, bz, bw)
    # R * vt = (2 + i)(vt_re + vt_im i) = (2 vt_re - vt_im) + (vt_re + 2 vt_im) i
    rvt_re = m31_sub(m31_add(vt_re, vt_re), vt_im)
    rvt_im = m31_add(vt_re, m31_add(vt_im, vt_im))
    ut_re, ut_im = _cm31_mul(ax, ay, bz, bw)
    vs_re, vs_im = _cm31_mul(az, aw, bx, by)
    return jnp.stack([
        m31_add(us_re, rvt_re),
        m31_add(us_im, rvt_im),
        m31_add(ut_re, vs_re),
        m31_add(ut_im, vs_im),
    ], axis=-1)


def qm31_scalar(v: int) -> np.ndarray:
    """QM31(uint32 v) — the scalar embedding (qm31.cuh:20)."""
    return np.array([v % P, 0, 0, 0], dtype=np.uint32)


# ---- host-side scalar helpers (oracle / twiddle-free tests) ----

def qm31_mul_host(x, y):
    xs = np.asarray(x, np.uint64); ys = np.asarray(y, np.uint64)
    # np.uint64 op python-int promotes to float64 under NumPy < 2 (pre-NEP
    # 50) and silently loses low bits of ~2^62 products — keep p a uint64
    p = np.uint64(P)

    def cm(a, b, c, d):
        return ((a * c + p * p - b * d) % p, (a * d + b * c) % p)

    us = cm(xs[0], xs[1], ys[0], ys[1])
    vt = cm(xs[2], xs[3], ys[2], ys[3])
    two = np.uint64(2)
    rvt = ((two * vt[0] + p - vt[1]) % p, (vt[0] + two * vt[1]) % p)
    ut = cm(xs[0], xs[1], ys[2], ys[3])
    vs = cm(xs[2], xs[3], ys[0], ys[1])
    return np.array([
        (us[0] + rvt[0]) % p, (us[1] + rvt[1]) % p,
        (ut[0] + vs[0]) % p, (ut[1] + vs[1]) % p,
    ], dtype=np.uint32)


def qm31_add_host(x, y):
    return ((np.asarray(x, np.uint64) + np.asarray(y, np.uint64)) % P).astype(np.uint32)


def qm31_sub_host(x, y):
    return ((np.asarray(x, np.uint64) + P - np.asarray(y, np.uint64) % P) % P).astype(np.uint32)
