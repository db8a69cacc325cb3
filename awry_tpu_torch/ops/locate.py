"""Batched locate on the card: the LF walk from BWT rows to text positions.

Rows whose SA value is a multiple of the mark ratio are marked (mark words
and a mark milestone ride in the fused block rows), and ``text_sampled_sa``
holds the SA values of the marked rows in row order.  Walking back one LF
step lowers the text position by one, so a marked row is reached within
``mark_ratio - 1`` steps: ``lf_walk`` walks given rows in one
``marked_walk`` launch, whose lanes each walk a row to its mark and read the
marked SA value at the final row's mark rank, then take the next row
(awry_tpu/ops/locate.py _marked_walk, sweep.py marked_walk_sweep); the
classic path's capped locate walks its ranges' live slots in one
``marked_walk_ranges`` launch.  At mark ratio 1 every row is marked and the
mark rank is the row: the walk is one SA read.

An index without marks (loaded from a ``.awry`` file) locates by the
reference's row-sampled walk instead: each row walked by LF steps until its
row is a multiple of sa_ratio, whose SA value ``sampled_sa`` holds
(awry_tpu/ops/locate.py _row_sampled_walk).  ``lf_walk`` walks given rows
in one ``sampled_walk`` launch; the classic path's capped locate walks its
ranges' live slots in one ``sampled_walk_ranges`` launch, with no device
sync: a walk that cannot end (a corrupt index) writes -1, which the
engine's assembly refuses.

On a wide index (ops/wide.py) the walks take the kernels' wide variants
(``marked_walk_wide``, ``marked_walk_ranges_wide``, ``sampled_walk_wide``),
and the mark-1 SA read is a window_read of two int32 words per int64 SA
value.

Ragged per-query outputs are two-phase: counts -> offsets -> flat fill.
"""

from __future__ import annotations

import torch

from . import kernels
from .device_index import FmDeviceIndex
from .search import counts_from_ranges, search_ranges_t
from .wide import join_words

_FULL = 0xFFFFFFFF


def lf_walk(dev: FmDeviceIndex, rows: torch.Tensor) -> torch.Tensor:
    """int64 text position of each BWT row (int64[N] rows)."""
    if dev.wide:
        return _lf_walk_wide(dev, rows)
    if not dev.has_marks:
        return kernels.sampled_walk(
            dev.blocks, rows, dev.prefix_sums, dev.codes, dev.c2i, dev.num_planes, dev.alphabet.ambiguity_idx,
            dev.sa_ratio, dev.sampled_sa, dev.bwt_len,
        )
    if dev.mark_ratio == 1:
        return kernels.window_read(dev.text_sampled_sa, rows, 2)[:, 0].to(torch.int64) & _FULL
    return kernels.marked_walk(
        dev.blocks, rows, dev.prefix_sums, dev.codes, dev.c2i, dev.num_planes, dev.mark_offset,
        dev.alphabet.ambiguity_idx, dev.mark_ratio, dev.text_sampled_sa, dev.bwt_len,
    )


def _lf_walk_wide(dev: FmDeviceIndex, rows: torch.Tensor) -> torch.Tensor:
    if not dev.has_marks:
        out = kernels.sampled_walk_wide(
            dev.blocks, dev.bases, rows, dev.prefix_sums, dev.codes, dev.c2i, dev.num_planes,
            dev.alphabet.ambiguity_idx, dev.sa_ratio, dev.sampled_sa, dev.bwt_len,
        )
        if out.numel() and bool((out < 0).any()):
            raise RuntimeError(
                f"sampled_walk_wide: a row took {dev.bwt_len} LF steps without reaching a sampled row (a corrupt "
                "index)"
            )
        return out
    if dev.mark_ratio == 1:
        return join_words(kernels.window_read(dev.text_sampled_sa.view(torch.int32), (rows << 1) | 1, 2))
    return kernels.marked_walk_wide(
        dev.blocks, dev.bases, rows, dev.prefix_sums, dev.codes, dev.c2i, dev.num_planes, dev.mark_offset,
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
    stats=None,
):
    """Full-depth count + up to ``cap`` hits per query in one pass.

    Returns (counts int64[B], text_pos int64[B, cap], starts, ends); entries
    of text_pos past counts[b] are meaningless; on an index without marks a
    -1 among the others marks a walk that could not end (a corrupt index).
    Queries with more than ``cap`` hits report their true count and their
    range, so the engine expands their remaining rows without a second
    search.  ``stats``: search_ranges_t's."""
    starts, ends = search_ranges_t(
        dev, qt, qlens, no_sentinel=no_sentinel, seeded_floor=seeded_floor, stats=stats
    )
    counts = counts_from_ranges(starts, ends)
    if not dev.has_marks and dev.wide:
        text_pos = kernels.sampled_walk_ranges_wide(
            dev.blocks, dev.bases, starts, counts, cap, dev.prefix_sums, dev.codes, dev.c2i, dev.num_planes,
            dev.alphabet.ambiguity_idx, dev.sa_ratio, dev.sampled_sa, dev.bwt_len,
        )
        return counts, text_pos, starts, ends
    if not dev.has_marks:
        text_pos = kernels.sampled_walk_ranges(
            dev.blocks, starts, counts, cap, dev.prefix_sums, dev.codes, dev.c2i, dev.num_planes,
            dev.alphabet.ambiguity_idx, dev.sa_ratio, dev.sampled_sa, dev.bwt_len,
        )
        return counts, text_pos, starts, ends
    if dev.mark_ratio == 1:
        text_pos = lf_walk(dev, kernels.slot_rows(starts, counts, cap).reshape(-1))
        return counts, text_pos.reshape(-1, cap), starts, ends
    walk = (dev.prefix_sums, dev.codes, dev.c2i, dev.num_planes, dev.mark_offset, dev.alphabet.ambiguity_idx,
            dev.mark_ratio, dev.text_sampled_sa, dev.bwt_len)
    if dev.wide:
        text_pos = kernels.marked_walk_ranges_wide(dev.blocks, dev.bases, starts, counts, cap, *walk)
    else:
        text_pos = kernels.marked_walk_ranges(dev.blocks, starts, counts, cap, *walk)
    return counts, text_pos, starts, ends
