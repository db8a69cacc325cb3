"""Rank (occurrence) primitives over the fused block rows.

Occ(pos, sym) = count of sym in BWT[0..=pos]: the block's milestone for
sym plus an inclusive masked popcount of the AND over XOR-polarity planes.
The LF range update ranks both endpoints through the ``occ_pair`` kernel.
Positions, ranges and counts are int64; symbols int32.
"""

from __future__ import annotations

import torch

from . import kernels
from .device_index import FmDeviceIndex

_FULL = 0xFFFFFFFF


def occurrence_plain(dev: FmDeviceIndex, pos: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
    """Occ(pos, sym) as int64 by plain PyTorch (gather + SWAR popcount),
    whatever device the index lives on."""
    s = sym.clamp(0, dev.alphabet.cardinality - 1)
    return kernels._occ_plain(dev.blocks, pos, s, dev.codes, dev.num_planes)


def prefix_sum_select(dev: FmDeviceIndex, sym: torch.Tensor) -> torch.Tensor:
    """C[sym] (int64)."""
    return dev.prefix_sums[sym.to(torch.int64)]


def seed_range(dev: FmDeviceIndex, sym: torch.Tensor):
    """Initial range for a single symbol: [C[sym], C[sym+1] - 1]."""
    return prefix_sum_select(dev, sym), prefix_sum_select(dev, sym + 1) - 1


def update_range(dev: FmDeviceIndex, starts: torch.Tensor, ends: torch.Tensor, sym: torch.Tensor):
    """One LF-mapping range update: both endpoint ranks from one occ_pair
    launch (pos_a = start - 1, pos_b = end)."""
    occ_a, occ_b = kernels.occ_pair(
        dev.blocks, starts - 1, ends, sym.to(torch.int32), dev.codes, dev.num_planes
    )
    c = prefix_sum_select(dev, sym)
    return c + (occ_a.to(torch.int64) & _FULL), c + (occ_b.to(torch.int64) & _FULL) - 1
