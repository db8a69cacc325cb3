"""Batched locate on the card (mark ratio 1).

Every BWT row is marked at mark ratio 1, so the LF walk to a sampled row
takes no steps: a row's text position is its SA value, one ``window_read``
of the SA per row.  Larger mark ratios need the marked walk (the backstep
kernel), which this package does not have yet; to_device refuses them.

Ragged per-query outputs are two-phase: counts -> offsets -> flat fill.
"""

from __future__ import annotations

import torch

from . import kernels
from .device_index import FmDeviceIndex
from .search import counts_from_ranges, search_ranges_t

_FULL = 0xFFFFFFFF


def lf_walk(dev: FmDeviceIndex, rows: torch.Tensor) -> torch.Tensor:
    """int64 text position of each BWT row (int64[N] rows)."""
    return kernels.window_read(dev.text_sampled_sa, rows, 2)[:, 0].to(torch.int64) & _FULL


def count_locate_capped_t(
    dev: FmDeviceIndex,
    qt: torch.Tensor,
    qlens: torch.Tensor,
    cap: int,
    *,
    no_sentinel: bool = False,
    seeded_floor: bool = False,
):
    """Full-depth count + up to ``cap`` hits per query in one pass.

    Returns (counts int64[B], text_pos int64[B, cap], starts, ends); entries
    of text_pos past counts[b] are meaningless.  Queries with more than
    ``cap`` hits report their true count and their range, so the engine
    expands their remaining rows without a second search."""
    starts, ends = search_ranges_t(
        dev, qt, qlens, no_sentinel=no_sentinel, seeded_floor=seeded_floor
    )
    counts = counts_from_ranges(starts, ends)
    offs = torch.arange(cap, device=qt.device)
    rows = starts[:, None] + offs[None, :]  # [B, cap]
    valid = offs[None, :] < counts.clamp_max(cap)[:, None]
    flat_rows = torch.where(valid, rows, 0).reshape(-1)
    text_pos = lf_walk(dev, flat_rows)
    return counts, text_pos.reshape(-1, cap), starts, ends
