"""ctypes bindings for the native host oracle (tools/native/oracle.cpp).

Builds the shared library on first use (g++ is part of the environment).
Used to generate golden vectors at sizes the Python scalar oracle cannot
reach, and as an implementation-independent cross-check of the JAX
pipelines (separate codebase and language).
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parents[2] / "tools" / "native"
_LIB = _SRC / "liboracle.so"

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB.exists() or _LIB.stat().st_mtime < (_SRC / "oracle.cpp").stat().st_mtime:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", str(_LIB),
             str(_SRC / "oracle.cpp")],
            check=True,
        )
    lib = ctypes.CDLL(str(_LIB))
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.mt19937_fill.argtypes = [ctypes.c_uint32, u32p, ctypes.c_size_t]
    lib.tower_mul128.argtypes = [u32p, u32p, u32p, ctypes.c_size_t]
    lib.additive_ntt32.argtypes = [u32p, ctypes.c_int, ctypes.c_int, u32p]
    lib.additive_ntt128.argtypes = [u32p, ctypes.c_int, ctypes.c_int, u32p]
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def mt19937_fill(seed: int, n: int) -> np.ndarray:
    out = np.empty(n, dtype=np.uint32)
    _load().mt19937_fill(seed & 0xFFFFFFFF, _ptr(out), n)
    return out


def tower_mul128(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.uint32)
    b = np.ascontiguousarray(b, dtype=np.uint32)
    assert a.size == b.size and a.size % 4 == 0
    out = np.empty_like(a)
    _load().tower_mul128(_ptr(a), _ptr(b), _ptr(out), a.size // 4)
    return out


def additive_ntt32(x: np.ndarray, log_h: int, log_rate: int) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.uint32)
    assert x.size == 1 << log_h
    out = np.empty((1 << (log_h + log_rate)), dtype=np.uint32)
    _load().additive_ntt32(_ptr(x), log_h, log_rate, _ptr(out))
    return out


def additive_ntt128(x_words: np.ndarray, log_h: int, log_rate: int) -> np.ndarray:
    """x_words: (2^log_h * 4,) little-endian element-major words."""
    x = np.ascontiguousarray(x_words, dtype=np.uint32)
    assert x.size == (1 << log_h) * 4
    out = np.empty((1 << (log_h + log_rate)) * 4, dtype=np.uint32)
    _load().additive_ntt128(_ptr(x), log_h, log_rate, _ptr(out))
    return out
