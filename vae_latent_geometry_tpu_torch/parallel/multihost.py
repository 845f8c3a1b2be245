"""Multi-process execution: process-group bring-up and result gathering.

- :func:`init_multihost` starts ``torch.distributed`` from its arguments or
  the ``VLG_COORDINATOR`` / ``VLG_NUM_PROCESSES`` / ``VLG_PROCESS_ID``
  environment variables (the names the JAX package reads), one process per
  mesh position.
- :func:`is_primary`: rank-0 predicate for artifact writes (every process
  computes, exactly one persists).
- :func:`gather_global`: the dp-sharded rows of a result, reassembled on
  every rank.
- :func:`broadcast_from_primary`: rank 0's host values (a resumed
  checkpoint's state) on every rank.

The JAX package's ``put_global`` has no counterpart: every rank holds the
whole input and slices its own rows (``parallel/shard.py``).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from vae_latent_geometry_tpu_torch.parallel.collectives import all_gather_cat


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None) -> Tuple[int, int]:
    """Initialize the default process group; returns (rank, world size).

    Argument resolution, in priority order: explicit arguments; the
    ``VLG_COORDINATOR`` (``host:port``, or any ``torch.distributed`` init
    URL), ``VLG_NUM_PROCESSES``, ``VLG_PROCESS_ID`` environment variables;
    none of them: a single process, and no group is created.  ``backend``
    defaults to NCCL where a GPU is present (one rank per device: rank r
    takes device r modulo the device count), else gloo.  A second call is a
    no-op, so a CLI flag and a library caller can both request it."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coordinator_address = coordinator_address or os.environ.get(
        "VLG_COORDINATOR")
    if num_processes is None and "VLG_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["VLG_NUM_PROCESSES"])
    if process_id is None and "VLG_PROCESS_ID" in os.environ:
        process_id = int(os.environ["VLG_PROCESS_ID"])
    if coordinator_address is None:
        if num_processes not in (None, 1):
            raise ValueError(
                f"{num_processes} processes requested but no coordinator "
                "address (VLG_COORDINATOR) to meet at")
        return 0, 1
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs num_processes and "
                         "process_id (VLG_NUM_PROCESSES, VLG_PROCESS_ID)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        n_dev = torch.cuda.device_count()
        if num_processes > n_dev:
            raise ValueError(
                f"NCCL takes one rank per device: {num_processes} processes "
                f"but {n_dev} device(s); use backend='gloo' to share a card")
        torch.cuda.set_device(process_id % n_dev)
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def shutdown_multihost() -> None:
    """Destroy the default process group, if one was created."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def is_primary() -> bool:
    """True on the process that owns artifact writes."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def gather_global(x: torch.Tensor, mesh) -> torch.Tensor:
    """Rows sharded over the mesh's 'dp' axis, reassembled in dp order on
    every rank."""
    return all_gather_cat(x, mesh.group("dp"))


def broadcast_from_primary(values):
    """Rank 0's ``values`` (any picklable object) on every rank of the
    default process group; unchanged without one."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return values
    box = [values if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]
