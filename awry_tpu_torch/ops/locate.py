"""Batched locate on the card: the LF walk from BWT rows to text positions.

Rows whose SA value is a multiple of the mark ratio are marked (mark words
and a mark milestone ride in the fused block rows), and ``text_sampled_sa``
holds the SA values of the marked rows in row order.  Walking back one LF
step lowers the text position by one, so a marked row is reached within
``mark_ratio - 1`` steps: the walk is one ``marked_walk`` launch, each row
walked to its mark by one thread, which then reads the marked SA value at
the final row's mark rank (awry_tpu/ops/locate.py _marked_walk, sweep.py
marked_walk_sweep).  At mark ratio 1 every row is marked and the mark rank
is the row: the walk is one SA read.

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
    if dev.mark_ratio == 1:
        return kernels.window_read(dev.text_sampled_sa, rows, 2)[:, 0].to(torch.int64) & _FULL
    return kernels.marked_walk(
        dev.blocks, rows, dev.prefix_sums, dev.codes, dev.c2i, dev.num_planes, dev.mark_offset,
        dev.alphabet.ambiguity_idx, dev.mark_ratio, dev.text_sampled_sa, dev.bwt_len,
    )


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
