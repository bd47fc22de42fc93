"""Multi-host initialization and scaling helpers.

The reference is strictly single-node shared-memory (SURVEY §2 row 15);
this framework scales across hosts with ``jax.distributed`` + the mesh in
rawalign_tpu.parallel.mesh. Each host ingests its own shard of the signal
files (read-level data parallelism — the cross-host analog of kt_for) and
participates in the global device mesh for sharded-index lookups.

Usage (one process per host):

    from rawalign_tpu.parallel import distributed
    distributed.init()                      # from JAX_* variables
    files = distributed.shard_files(files)  # this host's input shard
    ... build engine with a mesh over jax.devices() ...

Failure/elastic model (the reference has none; errors were fprintf+exit):
the index file is the unit of precomputation; mapping restarts are
read-granular via the CLI's --resume, so a failed host's shard can be
re-run on any other host against the same index and the PAFs
concatenated.
"""

from __future__ import annotations

import os


def init(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed over GPU hosts. Nothing on a GPU host
    describes the cluster to JAX, so every argument is given here or by
    JAX_COORDINATOR_ADDRESS (host:port of process 0), JAX_NUM_PROCESSES
    and JAX_PROCESS_ID; a missing one raises."""
    import jax

    env = os.environ
    coordinator_address = coordinator_address or env.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and env.get("JAX_NUM_PROCESSES"):
        num_processes = int(env["JAX_NUM_PROCESSES"])
    if process_id is None and env.get("JAX_PROCESS_ID"):
        process_id = int(env["JAX_PROCESS_ID"])
    missing = [
        name
        for name, v in (
            ("coordinator_address", coordinator_address),
            ("num_processes", num_processes),
            ("process_id", process_id),
        )
        if v is None
    ]
    if missing:
        raise ValueError(f"distributed.init: missing {', '.join(missing)}")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def process_info() -> tuple[int, int]:
    """(process_id, num_processes); (0, 1) when not distributed."""
    import jax

    try:
        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1


def shard_files(files: list[str]) -> list[str]:
    """Deterministic round-robin assignment of input files to this host."""
    pid, n = process_info()
    return [f for i, f in enumerate(files) if i % n == pid]
