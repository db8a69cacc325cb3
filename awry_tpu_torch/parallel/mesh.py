"""Device meshes: the counterpart of ``awry_tpu/parallel/mesh.py``.

A mesh is a 2-D grid of ``torch.device`` slots with axes ``('data',
'shard')``: the ``data`` axis splits query batches (each row serves its own
slice), the ``shard`` axis range-splits one index's blocks (Mode B,
parallel/sharding.py) for an index too large for one card.  A device may
fill several slots (``["cuda:0"] * 4`` on a one-card machine, ``["cpu"] *
8`` in the tests): slots on one device share one shipped copy of every
table.
"""

from __future__ import annotations

import numpy as np
import torch

DATA_AXIS = "data"
SHARD_AXIS = "shard"


class Mesh:
    """``devices``: a numpy object array [data, shard] of ``torch.device``;
    ``shape``: ``{"data": rows, "shard": columns}``, as the JAX mesh reports
    it."""

    axis_names = (DATA_AXIS, SHARD_AXIS)

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty [data, shard] grid of devices, got shape {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.devices.shape[0], SHARD_AXIS: self.devices.shape[1]}

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def cuda_devices() -> list[torch.device]:
    """Every CUDA device; raises when there is none (no CPU fallback)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError("no CUDA device is available; name the devices (devices=['cpu'] * n) to run on the host")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def grid(devices, shard_size: int) -> np.ndarray:
    """The [n // shard_size, shard_size] grid of ``devices`` (names or
    ``torch.device``), in order; raises ValueError when n is not divisible
    by ``shard_size``."""
    devs = [torch.device(d) for d in devices]
    n = len(devs)
    if shard_size < 1 or n % shard_size != 0:
        raise ValueError(f"{n} devices not divisible by shard_size={shard_size}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return arr.reshape(n // shard_size, shard_size)


def make_mesh(num_devices: int | None = None, *, shard_size: int = 1, devices=None) -> Mesh:
    """Build a ``('data', 'shard')`` mesh.

    ``shard_size`` slots cooperate on one range-sharded index copy; the
    remaining factor is data parallelism over query batches (shard_size=1:
    the replicated-index mesh).  ``devices=None`` takes every CUDA device
    and raises when there is none; a list may repeat a device."""
    devices = list(devices if devices is not None else cuda_devices())
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(grid(devices, shard_size))
