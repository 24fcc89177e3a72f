"""Helpers shared by bench.py, chip_smoke.py and the tests: the persistent
compilation cache and steady-state device timing."""

from __future__ import annotations

import os
import statistics
import time

__all__ = ["setup_compile_cache", "first_and_steady"]

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def setup_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    ``$JAX_COMPILATION_CACHE_DIR`` if set — JAX reads it itself, so the
    code sets no location of its own — else ``<checkout>/.jax_cache`` (a
    fixed path: the path is part of the cache key, so a moving directory
    never hits)."""
    import jax

    jax.config.update("jax_enable_compilation_cache", True)
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(_CHECKOUT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path


def first_and_steady(fn, reps: int = 5):
    """(result, first-call seconds, median steady seconds) of ``fn()``.

    Every call ends in ``block_until_ready``: JAX dispatch is asynchronous,
    so a time without it measures the enqueue.  The first call includes
    tracing and compilation; the median is over ``reps`` later calls."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return out, first, statistics.median(times)
