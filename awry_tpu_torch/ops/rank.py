"""Rank (occurrence) primitives over the fused block rows.

Occ(pos, sym) = count of sym in BWT[0..=pos]: the block's milestone for
sym plus an inclusive masked popcount of the AND over XOR-polarity planes.
The LF range update ranks both endpoints through the ``occ_pair`` kernel;
a batch of single ranks (the device k-mer build) goes through ``occ``; one
LF step of single rows with their mark bit and mark rank goes through the
``backstep`` kernel (the locate walk runs ``marked_walk``, ops/locate.py).
On a wide index (ops/wide.py) the range update, the single ranks and the LF
step take the kernels' wide variants (``occ_pair_wide``, ``occ_wide``,
``backstep_wide``), whose ranks are int64 already.  Positions, ranges and
counts are int64; symbols int32.
"""

from __future__ import annotations

import torch

from . import kernels
from .device_index import FmDeviceIndex

_FULL = 0xFFFFFFFF


def occurrence_plain(dev: FmDeviceIndex, pos: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
    """Occ(pos, sym) as int64 by plain PyTorch (gather + SWAR popcount),
    whatever device the index lives on."""
    if dev.wide:
        return kernels.occ_wide_plain(dev.blocks, dev.bases, pos, sym, dev.codes, dev.num_planes)
    s = sym.clamp(0, dev.alphabet.cardinality - 1)
    return kernels._occ_plain(dev.blocks, pos, s, dev.codes, dev.num_planes)


def occurrence(dev: FmDeviceIndex, pos: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
    """Occ(pos, sym) as int64 from one ``occ`` launch (``occ_wide`` on a
    wide index; the plain version for CPU tensors).  Every lane is exact:
    the port has no coverage flags."""
    if dev.wide:
        return kernels.occ_wide(dev.blocks, dev.bases, pos, sym.to(torch.int32), dev.codes, dev.num_planes)
    occ = kernels.occ(dev.blocks, pos, sym.to(torch.int32), dev.codes, dev.num_planes)
    return occ.to(torch.int64) & _FULL


def prefix_sum_select(dev: FmDeviceIndex, sym: torch.Tensor) -> torch.Tensor:
    """C[sym] (int64)."""
    return dev.prefix_sums[sym.to(torch.int64)]


def seed_range(dev: FmDeviceIndex, sym: torch.Tensor):
    """Initial range for a single symbol: [C[sym], C[sym+1] - 1]."""
    return prefix_sum_select(dev, sym), prefix_sum_select(dev, sym + 1) - 1


def update_range(dev: FmDeviceIndex, starts: torch.Tensor, ends: torch.Tensor, sym: torch.Tensor):
    """One LF-mapping range update: both endpoint ranks from one occ_pair
    launch (pos_a = start - 1, pos_b = end; occ_pair_wide on a wide index)."""
    if dev.wide:
        occ_a, occ_b = kernels.occ_pair_wide(
            dev.blocks, dev.bases, starts - 1, ends, sym.to(torch.int32), dev.codes, dev.num_planes
        )
        c = prefix_sum_select(dev, sym)
        return c + occ_a, c + occ_b - 1
    occ_a, occ_b = kernels.occ_pair(
        dev.blocks, starts - 1, ends, sym.to(torch.int32), dev.codes, dev.num_planes
    )
    c = prefix_sum_select(dev, sym)
    return c + (occ_a.to(torch.int64) & _FULL), c + (occ_b.to(torch.int64) & _FULL) - 1


def symbol_at(dev: FmDeviceIndex, pos: torch.Tensor) -> torch.Tensor:
    """BWT symbol index (int64) at each row, by plain PyTorch."""
    p, rows = kernels._fetch_rows(dev.blocks, pos)
    return kernels._symbol_rows(rows, p, dev.c2i, dev.num_planes)


def backstep_mark(dev: FmDeviceIndex, pos: torch.Tensor):
    """One marked-walk visit per row from one ``backstep`` launch:
    (LF-stepped row int64 (sentinel rows -> 0), mark bit bool, mark rank
    int64 = marked rows strictly before the row); backstep_wide on a wide
    index."""
    if dev.wide:
        stepped, packed = kernels.backstep_wide(
            dev.blocks, dev.bases, pos, dev.prefix_sums, dev.codes, dev.c2i, dev.num_planes, dev.mark_offset,
            dev.alphabet.ambiguity_idx,
        )
        return stepped, (packed & 1) == 1, packed >> 1
    stepped, packed = kernels.backstep(
        dev.blocks, pos, dev.prefix_sums, dev.codes, dev.c2i, dev.num_planes,
        dev.mark_offset, dev.alphabet.ambiguity_idx,
    )
    packed = packed.to(torch.int64) & _FULL
    return stepped, (packed & 1) == 1, packed >> 1


def backstep(dev: FmDeviceIndex, pos: torch.Tensor) -> torch.Tensor:
    """One LF step per row (sentinel rows -> 0)."""
    return backstep_mark(dev, pos)[0]
