"""Bit-slicing layout transforms (vectorised, numpy- and JAX-compatible).

Layout contract (identical to the reference, little-endian):
  * An *unbitsliced* batch is ``BITS_WIDTH`` uint32 words holding 32 field
    elements of ``BITS_WIDTH`` bits each, element-major: element ``j``
    occupies words ``[j*IPV, (j+1)*IPV)`` where ``IPV = BITS_WIDTH // 32``,
    word 0 being the least-significant 32 bits.
  * A *bitsliced* batch is the 32 x BITS_WIDTH bit-matrix transpose of that:
    sliced word ``i`` is bit-plane ``i`` — bit ``j`` of sliced word ``i`` is
    bit ``i`` of element ``j``.

Reference semantics: src/ulvt/utils/bitslicing.cuh —
  transpose32 (:14-26, Hacker's Delight 32x32 bit transpose),
  bitslice_transpose (:32-47), bitslice_untranspose (:49-64),
  repeat_value_bitsliced (:66-74).

All functions here operate on arrays of shape ``(..., BITS_WIDTH)`` — i.e.
arbitrarily many batches at once — and are pure (return new arrays), which is
the idiomatic JAX formulation of the reference's in-place CUDA kernels
(transpose_kernel / untranspose_kernel, bitslicing.cuh:89-105).
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "transpose32",
    "bitslice_transpose",
    "bitslice_untranspose",
    "bitslice_transpose_streamed",
    "bitslice_transpose_streamed_cols",
    "bitslice_untranspose_streamed",
    "repeat_value_bitsliced",
]


def _xp(arr):
    """Return the array namespace (numpy or jax.numpy) for `arr`."""
    if isinstance(arr, np.ndarray):
        return np
    import jax.numpy as jnp

    return jnp


def transpose32(a):
    """Transpose the 32x32 bit matrix held in the last axis (32 uint32 words).

    Vectorised form of the Hacker's Delight in-place transpose
    (bitslicing.cuh:14-26); accepts shape (..., 32).
    """
    xp = _xp(a)
    assert a.shape[-1] == 32
    m = 0x0000FFFF
    j = 16
    while j != 0:
        # rows with bit j of the index clear pair with rows where it is set
        lead = a.shape[:-1]
        a = a.reshape(lead + (32 // (2 * j), 2, j))
        lo = a[..., 0, :]
        hi = a[..., 1, :]
        t = ((lo >> j) ^ hi) & xp.uint32(m)
        lo = lo ^ (t << j)
        hi = hi ^ t
        a = xp.stack([lo, hi], axis=-2).reshape(lead + (32,))
        j >>= 1
        m = (m ^ (m << j)) & 0xFFFFFFFF if j else m
    return a


def bitslice_transpose(arr):
    """Unbitsliced (..., W) -> bitsliced (..., W); cf. bitslicing.cuh:32-47."""
    xp = _xp(arr)
    w = arr.shape[-1]
    ipv = w // 32
    lead = arr.shape[:-1]
    # permutation: new[32*(i % ipv) + i // ipv] = old[i]
    a = arr.reshape(lead + (32, ipv))
    a = xp.swapaxes(a, -1, -2)  # (..., ipv, 32): square s holds word s of each elem
    a = transpose32(a)
    return a.reshape(lead + (w,))


def bitslice_untranspose(arr):
    """Bitsliced (..., W) -> unbitsliced (..., W); cf. bitslicing.cuh:49-64."""
    xp = _xp(arr)
    w = arr.shape[-1]
    ipv = w // 32
    lead = arr.shape[:-1]
    a = arr.reshape(lead + (ipv, 32))
    a = transpose32(a)
    # permutation: new[ipv * (i % 32) + i // 32] = tmp[i]
    a = xp.swapaxes(a, -1, -2)  # (..., 32, ipv)
    return a.reshape(lead + (w,))


def _pick_chunk(rows: int, chunk_rows: int) -> int:
    """Largest divisor of ``rows`` not exceeding ``chunk_rows``.

    Callers pass power-of-two row counts (every NTT/sumcheck buffer is one),
    where this is a short shift loop ending at a large chunk.  A
    non-power-of-two odd row count would legally degrade to chunk=1 (one
    device round-trip per row) — assert instead so a misuse fails loudly."""
    chunk = min(chunk_rows, rows)
    while rows % chunk:
        chunk //= 2
    chunk = max(chunk, 1)
    assert rows <= chunk_rows or chunk >= chunk_rows // 2, (
        f"streamed transpose needs power-of-two rows, got {rows}")
    return chunk


# Jitted wrappers hoisted to module scope: a fresh jax.jit(fn) per call
# would re-trace and re-compile on every streamed invocation.  Built lazily so importing this module never imports jax.
@functools.lru_cache(maxsize=None)
def _jit_transpose():
    import jax

    return jax.jit(bitslice_transpose)


@functools.lru_cache(maxsize=None)
def _jit_untranspose():
    import jax

    return jax.jit(bitslice_untranspose)


@functools.lru_cache(maxsize=None)
def _jit_write_rows():
    import jax

    @functools.partial(jax.jit, donate_argnums=0)
    def _write(buf, part, ri):
        return jax.lax.dynamic_update_slice(buf, part, (ri, 0))

    return _write


@functools.lru_cache(maxsize=None)
def _jit_write_cols():
    import jax

    @functools.partial(jax.jit, donate_argnums=0)
    def _write(buf, part, ci, ri):
        return jax.lax.dynamic_update_slice(buf, part[None], (ci, ri, 0))

    return _write


def bitslice_transpose_streamed(x, chunk_rows: int = 1 << 18):
    """Host (rows, W) unbitsliced -> DEVICE (rows, W) bitsliced, chunked.

    Whole-array on-device transposes allocate HLO temps ~4x the array
    (measured 16 GB at a 4 GB array), and the host numpy fallback is
    minutes of single-core work at capacity sizes (the 2^28 golden run
    spent ~50 min in it).  Each 32-element batch row transposes
    independently, so stream: upload a chunk, transpose on device, write
    into a donated output buffer via dynamic_update_slice.  Peak device
    footprint = the output buffer + one chunk (the previous concatenate
    peaked at 2x the array, which OOMs a 2^29 r0 8.6 GB input on a
    15.75 GB chip).
    """
    import jax.numpy as jnp

    x = np.ascontiguousarray(x, dtype=np.uint32)
    rows = x.shape[0]
    fn = _jit_transpose()
    if rows <= chunk_rows:
        return fn(jnp.asarray(x))
    chunk = _pick_chunk(rows, chunk_rows)
    write = _jit_write_rows()
    buf = jnp.zeros((rows, x.shape[-1]), dtype=jnp.uint32)
    for i in range(0, rows, chunk):
        buf = write(buf, fn(jnp.asarray(x[i:i + chunk])), jnp.int32(i))
    return buf


def bitslice_untranspose_streamed(dev, chunk_rows: int = 1 << 18):
    """DEVICE (rows, W) bitsliced -> HOST (rows, W) unbitsliced, chunked
    (see bitslice_transpose_streamed — same rationale, reverse direction)."""
    import jax.numpy as jnp

    rows = dev.shape[0]
    fn = _jit_untranspose()
    if rows <= chunk_rows:
        return np.asarray(fn(dev))
    chunk = _pick_chunk(rows, chunk_rows)
    out = np.empty((rows, dev.shape[-1]), dtype=np.uint32)
    for i in range(0, rows, chunk):
        out[i:i + chunk] = np.asarray(fn(jnp.asarray(dev[i:i + chunk])))
    return out


def bitslice_transpose_streamed_cols(cols, chunk_rows: int = 1 << 18):
    """Host (C, rows, W) unbitsliced -> DEVICE (C, rows, W) bitsliced with
    peak device footprint = the output buffer + one chunk.

    Same donated-buffer pattern as bitslice_transpose_streamed, with a
    column axis: the 2^28-evaluation sumcheck ctor (8.6 GB at C=2) must
    not form a 2x transient on the device.
    """
    import jax.numpy as jnp

    cols = np.ascontiguousarray(cols, dtype=np.uint32)
    c, rows, w = cols.shape
    chunk = _pick_chunk(rows, chunk_rows)
    tfn = _jit_transpose()
    write = _jit_write_cols()

    buf = jnp.zeros((c, rows, w), dtype=jnp.uint32)
    for ci in range(c):
        for ri in range(0, rows, chunk):
            part = tfn(jnp.asarray(cols[ci, ri:ri + chunk]))
            buf = write(buf, part, jnp.int32(ci), jnp.int32(ri))
    return buf


def repeat_value_bitsliced(value, bits_width: int):
    """Broadcast one value (IPV uint32 words) into a bitsliced batch.

    cf. bitslicing.cuh:66-74.  `value` is a length-IPV uint32 sequence.
    Returns a (bits_width,) numpy array.
    """
    value = np.asarray(value, dtype=np.uint32)
    ipv = bits_width // 32
    assert value.shape == (ipv,)
    batch = np.tile(value, 32)
    return bitslice_transpose(batch)
