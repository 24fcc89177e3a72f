"""initialize_distributed(): configuration resolution (SCALING.md §1).

jax.distributed.initialize is monkeypatched to a recorder — these tests
pin WHICH configuration reaches it, not the runtime itself (a real
multi-process bring-up needs multi-host hardware).
"""

import jax
import pytest

from binius_ntt_tpu.parallel import mesh as pm


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    calls = []

    def fake_init(*a, **kw):
        calls.append((a, kw))

    monkeypatch.setattr(pm, "_initialized", False)
    monkeypatch.setattr(jax.distributed, "initialize", fake_init)
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("JAX_PROCESS_ID", raising=False)
    yield calls


def test_single_process_noop(_fresh):
    assert pm.initialize_distributed() is False
    assert _fresh == []


def test_env_explicit_config(_fresh, monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "host0:8476")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    assert pm.initialize_distributed() is True
    (a, kw), = _fresh
    assert kw == dict(coordinator_address="host0:8476", num_processes=4,
                      process_id=2)


def test_args_override_env(_fresh, monkeypatch):
    monkeypatch.setenv("JAX_NUM_PROCESSES", "8")
    assert pm.initialize_distributed("c:1", num_processes=2,
                                     process_id=1) is True
    (a, kw), = _fresh
    assert kw == dict(coordinator_address="c:1", num_processes=2,
                      process_id=1)


def test_idempotent(_fresh, monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "host0:8476")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    assert pm.initialize_distributed() is True
    assert pm.initialize_distributed() is True
    assert len(_fresh) == 1
