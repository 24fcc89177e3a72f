"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding is validated on simulated devices (the facility the
CUDA reference lacks entirely — it is single-GPU only).  Device timing is
done on the card by chip_smoke.py and bench.py, not by the test suite.
Tests that need the card itself carry the ``gpu`` marker and skip
without one.
"""

import os

# Must be set before the CPU client is created.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from binius_ntt_tpu.utils.benchlib import setup_compile_cache  # noqa: E402

setup_compile_cache()


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked ``gpu`` skip unless JAX sees a GPU — decided when the
    test runs, never at import or collection time (xdist workers must all
    collect the same tests)."""
    if (request.node.get_closest_marker("gpu")
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs a GPU; chip_smoke.py runs this path on the card")
