"""Parallel runtime: mesh sharding and multi-host utilities.

Replacement for the reference's process-based chain executor
(``parallel_sampling.py``): instead of one OS process per chain with a
lock-step pipe protocol and shared-memory draw transfer, chains are a
batch dimension sharded over a ``chains`` mesh axis; XLA inserts any
needed collectives, and the lock-step per-draw protocol disappears into
``lax.scan`` on device.
"""

from .mesh import chain_mesh, shard_chains
from .cross_chain import cross_chain_potential_pool
from .distributed import initialize_distributed, global_chain_mesh, process_local_chains

__all__ = [
    "chain_mesh",
    "shard_chains",
    "cross_chain_potential_pool",
    "initialize_distributed",
    "global_chain_mesh",
    "process_local_chains",
]
