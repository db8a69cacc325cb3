"""Serving across devices and indexes: device meshes (``mesh.py``), the
replicated and range-sharded engines (``sharding.py``), the split over
processes (``distributed.py``) and the partitioned federation
(``partitioned.py``).

The federation's spawned build workers import this package, so every name
that needs torch loads on first use."""

import importlib

from .partitioned import PartitionedFmIndex

_LAZY = {
    "make_mesh": ".mesh",
    "DATA_AXIS": ".mesh",
    "SHARD_AXIS": ".mesh",
    "ShardedFmEngine": ".sharding",
}


def __getattr__(name: str):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["make_mesh", "ShardedFmEngine", "PartitionedFmIndex", "DATA_AXIS", "SHARD_AXIS"]
