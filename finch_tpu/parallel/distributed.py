"""Multi-host initialization and global meshes.

The reference is a single-process CLI (its only concurrency is a rayon
thread pool over files, lib/src/lib.rs:34-47). This framework can span
processes with jax.distributed: every process runs the same program, JAX
wires the collectives, and the sharded sketch / distance programs
(finch_tpu.parallel) run unchanged over the global mesh.

Usage (same command in every process):

    import finch_tpu.parallel.distributed as dist
    dist.initialize("host0:1234", num_processes=2, process_id=rank)
    mesh = dist.global_mesh()    # 1-D "data" mesh over all devices
    eng = ShardedSketchEngine(params, mesh, process_local=True)
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed for multi-host execution.

    Pass coordinator_address ("host:port"), num_processes and this
    process's process_id; nothing discovers them from the environment on a
    GPU cluster. Call once per process, before any other JAX call.
    """
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_mesh(axis: str = "data"):
    """1-D mesh over every addressable device across all hosts."""
    import jax
    from jax.sharding import Mesh

    devices = np.asarray(jax.devices())
    return Mesh(devices, (axis,))


def is_primary() -> bool:
    """True on the process that should do I/O (rank 0)."""
    import jax

    return jax.process_index() == 0
