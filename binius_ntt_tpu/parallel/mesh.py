"""Device mesh helpers + multi-host initialisation.

The reference is single-GPU/single-process (SURVEY.md §5); all multi-device
structure here is new design: a 1-D mesh over the element axis.  The cards
of one host reach each other all to all at one rate, so the mesh follows
the algorithm alone: ``jax.devices()`` in order.

Multi-host bring-up is ``initialize_distributed()`` below — call it once
per process before touching devices, then build the mesh over
``jax.devices()`` (which, after initialisation, enumerates the devices of
EVERY process).  Launch recipe (one command per host)::

    # host 0                                    # host i of N
    JAX_COORDINATOR_ADDRESS=host0:8476 \\
    JAX_NUM_PROCESSES=N JAX_PROCESS_ID=i  python your_driver.py
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "initialize_distributed", "AXIS"]

AXIS = "x"

_initialized = False


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> bool:
    """Wire up ``jax.distributed`` for multi-host runs; returns True if a
    multi-process runtime was initialised.

    Arguments default to the ``JAX_COORDINATOR_ADDRESS`` /
    ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` environment variables.  A
    single-process configuration (no env, num_processes in (None, 1)) is a
    no-op — the whole single-chip and virtual-mesh test surface runs
    unchanged.  Idempotent.
    """
    global _initialized
    if _initialized:
        return True

    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    env_np = os.environ.get("JAX_NUM_PROCESSES")
    env_pid = os.environ.get("JAX_PROCESS_ID")
    if num_processes is None and env_np is not None:
        num_processes = int(env_np)
    if process_id is None and env_pid is not None:
        process_id = int(env_pid)

    if coordinator_address is None and num_processes in (None, 1):
        return False                     # single-process: nothing to do

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True
    return True


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the first `n_devices` devices (default: all), in
    ``jax.devices()`` order.  In a multi-process runtime this mesh spans
    ALL processes' devices (each process addresses its local shard only).
    """
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS,))
