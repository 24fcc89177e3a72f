"""The device-metric scripts refuse to report without a GPU: chip_smoke.py
(non-zero exit, no ok line — from the checkout, and from a directory
holding the script alone) and bench.py (non-zero exit, no result line)."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(alone, tmp_path):
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_fails_without_gpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, os.path.join(ROOT, "bench.py"), "8"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "metric" not in r.stdout


def test_first_and_steady_times_every_call():
    from binius_ntt_tpu.utils.benchlib import first_and_steady

    calls = []

    def fn():
        calls.append(1)
        return len(calls)

    out, first, steady = first_and_steady(fn, reps=4)
    assert out == 1 and len(calls) == 5
    assert first >= 0 and steady >= 0
