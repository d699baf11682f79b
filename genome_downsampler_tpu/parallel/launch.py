"""Multi-process (multi-host) runtime initialization.

The reference has no distributed communication backend at all (SURVEY.md
section 5.8); this module is the new component: ``jax.distributed`` process
bootstrap + global-mesh construction + host-local data placement for the
window solver. Across GPU hosts the same code runs over NCCL; in tests it
runs as N local processes with virtual CPU devices.

Run ONE process per host: it drives all of that host's cards. A JAX
process opens every visible card and reserves most of each card's memory,
so a second process on the same host would fail for want of memory.

Environment contract (matches common launchers):
    GD_COORDINATOR   host:port of process 0      (default 127.0.0.1:9911)
    GD_NUM_PROCESSES world size                  (default 1)
    GD_PROCESS_ID    this process's rank         (default 0)
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed from args or the GD_* environment."""
    import jax

    coordinator = coordinator or os.environ.get("GD_COORDINATOR", "127.0.0.1:9911")
    num_processes = int(
        num_processes
        if num_processes is not None
        else os.environ.get("GD_NUM_PROCESSES", "1")
    )
    process_id = int(
        process_id if process_id is not None else os.environ.get("GD_PROCESS_ID", "0")
    )
    if num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_window_mesh():
    """1-D mesh over every device in the job (all hosts), genome axis "x"."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), ("x",))


def shard_rows_globally(rows_host: np.ndarray, target_host: np.ndarray, mesh):
    """Place the (n, L) histogram and (n,) target across the global mesh.

    Each process materializes only its addressable window shards (the
    callback receives per-shard indices), which is how a multi-host run
    avoids ever holding the whole genome on one host.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    rows_sh = NamedSharding(mesh, P("x", None))
    tgt_sh = NamedSharding(mesh, P("x"))
    rows = jax.make_array_from_callback(
        rows_host.shape, rows_sh, lambda idx: rows_host[idx]
    )
    target = jax.make_array_from_callback(
        target_host.shape, tgt_sh, lambda idx: target_host[idx]
    )
    return rows, target
