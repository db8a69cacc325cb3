"""The split over processes: the counterpart of
``awry_tpu/parallel/distributed.py``.

One process runs per host and serves its own slice of a global query
batch on a mesh of its own devices:

* ``init_distributed`` joins the processes in one ``torch.distributed``
  process group (gloo for CPU devices, NCCL for CUDA); a no-op for one
  process without an address, and a second call is ignored.
* ``make_global_mesh`` builds the ``('data', 'shard')`` mesh over this
  process's devices.  The JAX mesh spans every process's devices and keeps
  the shard axis inside one host so that its collectives ride the fast
  links; here the shard axis is inside the process by construction, so
  across processes only the data axis is split and the hot path needs no
  collective between processes.
* ``process_local_queries`` names this process's contiguous slice of the
  global list (process-major, as the JAX data axis maps it).

``global_query_batch`` has no counterpart: JAX assembles one global array
from every process's slice because one program runs on the global mesh;
here each process feeds its own engine its own slice, and the engine
returns that slice's answers.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh, cuda_devices, grid


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Processes in the process group (1 without one)."""
    return dist.get_world_size() if _joined() else 1


def process_index() -> int:
    """This process's rank in the process group (0 without one)."""
    return dist.get_rank() if _joined() else 0


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, *, backend: str | None = None) -> None:
    """Join the process group (no-op for one process without an address;
    a second call is ignored).  ``coordinator_address``: ``host:port`` of
    process 0 (``tcp://`` is added), or None to read the ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` environment variables.
    ``backend`` None takes NCCL when a CUDA device exists, else gloo."""
    if num_processes is not None and num_processes <= 1 and coordinator_address is None:
        return
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this build of torch")
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend=backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes, rank=-1 if process_id is None else process_id,
    )


def make_global_mesh(*, shard_size: int = 1, devices=None) -> Mesh:
    """The ``('data', 'shard')`` mesh over this process's devices (every
    CUDA device when ``devices`` is None, raising without one).  Raises
    ValueError when their count is not divisible by ``shard_size``, or when
    ``shard_size`` exceeds the devices of this process in a run of several
    processes (range-shard sums would cross processes)."""
    devices = list(devices if devices is not None else cuda_devices())
    arr = grid(devices, shard_size)
    if shard_size > len(devices) and process_count() > 1:
        raise ValueError(
            f"shard_size={shard_size} exceeds devices per process ({len(devices)}); range-shard sums would cross "
            "processes"
        )
    return Mesh(arr)


def process_local_queries(queries, mesh: Mesh) -> list:
    """The contiguous slice of a global query list this process serves
    (the whole list for one process)."""
    pc, pi = process_count(), process_index()
    if pc == 1:
        return list(queries)
    per = -(-len(queries) // pc)
    return list(queries[pi * per : (pi + 1) * per])
