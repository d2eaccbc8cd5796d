"""Multi-host (pod-slice) helpers.

The same sampling program runs unchanged across hosts: each process
initializes the distributed runtime, builds a global ``chains`` mesh over
all devices, and ``sample(..., mesh=global_chain_mesh())`` shards chains
across the slice. Traces come back as globally-sharded arrays; use
``jax.experimental.multihost_utils`` to gather if a single host needs the
full trace (usually unnecessary — reduce to summary statistics on device
instead).

Single-host virtual testing: set
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` and everything
here works on one process with N virtual CPU devices.
"""

from __future__ import annotations

from typing import Optional

import jax

from .mesh import chain_mesh

__all__ = ["initialize_distributed", "global_chain_mesh", "process_local_chains"]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize JAX's distributed runtime (no-op if already initialized).

    Where the cluster environment describes the processes, the arguments
    may be omitted; otherwise pass all three.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as err:  # already initialized
        if "already" not in str(err).lower():
            raise


def global_chain_mesh(axis: str = "chains"):
    """1-D mesh over *all* devices in the (possibly multi-host) runtime."""
    return chain_mesh(None, axis)


def process_local_chains(total_chains: int) -> int:
    """How many of ``total_chains`` this process hosts (chains mesh evenly split)."""
    n_proc = jax.process_count()
    if total_chains % n_proc != 0:
        raise ValueError(
            f"total_chains ({total_chains}) must be divisible by process count ({n_proc})"
        )
    return total_chains // n_proc
