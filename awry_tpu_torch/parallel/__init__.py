"""Serving across indexes: the partitioned federation (``partitioned.py``)."""

from .partitioned import PartitionedFmIndex

__all__ = ["PartitionedFmIndex"]
