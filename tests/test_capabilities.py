"""The platform check, the device-memory capacity cut and the compile-cache
placement (utils/capabilities.py, utils/benchlib.py)."""

import os

import numpy as np
import pytest

from binius_ntt_tpu.ntt import additive_bitsliced as ab
from binius_ntt_tpu.utils import benchlib
from binius_ntt_tpu.utils import capabilities as cap


@pytest.mark.parametrize("platform", cap.PLATFORMS)
def test_measured_platform_passes(platform):
    assert cap.check_platform(platform) == platform


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_unmeasured_platform_raises(platform):
    with pytest.raises(RuntimeError, match="unsupported platform"):
        cap.check_platform(platform)


def test_platform_defaults_to_jax_backend():
    assert cap.check_platform() == "cpu"        # the tests run on the CPU


def _make_ntt128():
    return ab.AdditiveNTT128(8, 0)


def _make_sumcheck():
    from binius_ntt_tpu.sumcheck.prover import Sumcheck

    return Sumcheck(np.zeros(4 * 128 * 2, np.uint32), 2, 7)


def _make_sharded_ntt128():
    from binius_ntt_tpu.parallel.mesh import make_mesh
    from binius_ntt_tpu.parallel.ntt128_sharded import ShardedAdditiveNTT128

    return ShardedAdditiveNTT128(8, 0, make_mesh(2))


@pytest.mark.parametrize("make", [_make_ntt128, _make_sumcheck,
                                  _make_sharded_ntt128])
def test_classes_refuse_unmeasured_platform(make, monkeypatch):
    import jax

    make()                                   # the CPU is measured
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported platform"):
        make()


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_memory_limit_from_memory_stats():
    assert cap.device_memory_limit(_FakeDevice(
        {"bytes_limit": 60 << 30, "peak_bytes_in_use": 1})) == 60 << 30
    assert cap.device_memory_limit(_FakeDevice(None)) is None


@pytest.mark.parametrize("nbytes,limit,host", [
    (1 << 30, 60 << 30, False),        # 2^26 x 16 B on a 60 GiB budget
    (16 << 30, 60 << 30, True),        # 2^30 x 16 B needs the host layout
    (4 << 30, 16 << 30, True),         # a smaller card cuts over sooner
    (16 << 30, None, False),           # no reported limit: device layout
])
def test_layout_capacity_cut(nbytes, limit, host):
    got = ab.layout_on_host(
        nbytes, cap.device_memory_limit(_FakeDevice(
            None if limit is None else {"bytes_limit": limit})))
    assert got is host


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert benchlib.setup_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: the code sets no location of its own
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(checkout, ".jax_cache")
    old = jax.config.jax_compilation_cache_dir
    try:
        assert benchlib.setup_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
