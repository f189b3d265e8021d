"""Device mesh construction and multi-host initialization.

The solver's parallelism is a 1-D row partition, so the canonical mesh is
``Mesh(devices, ("rows",))`` over every local/global device: the mesh
follows the algorithm, not the interconnect (on one host of GPUs every card
reaches every other at the same rate). Across processes the same code runs
unchanged after :func:`initialize_distributed`.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "initialize_distributed"]

DEFAULT_AXIS = "rows"


def make_mesh(n_devices: Optional[int] = None, axis: str = DEFAULT_AXIS, devices=None) -> Mesh:
    """1-D mesh over ``n_devices`` (default: all available devices)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize ``jax.distributed`` for multi-host runs.

    Arguments default to the standard env vars (``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``); nothing is auto-detected.
    Returns True if multi-process mode was initialized, False when running
    single-process (no-op).
    """
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    num_processes = num_processes or _int_env("JAX_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env("JAX_PROCESS_ID")
    if coordinator_address is None and num_processes is None:
        return False  # single process: nothing to join
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def _int_env(name: str):
    v = os.environ.get(name)
    return int(v) if v is not None else None
