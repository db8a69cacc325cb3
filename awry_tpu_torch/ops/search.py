"""Batched backward search on the card.

Queries arrive as a TRANSPOSED, right-aligned symbol matrix qt int32[L, B]
(batch in the minor dimension): row L-1-i holds the symbol at distance i
from each query's end, so every step reads one static row.  The k-mer seed
table supplies the range after k steps whenever a query's last k symbols
are all encoding symbols; the remaining steps are LF range updates through
the ``occ_pair`` kernel, each lane starting at its own step (k when seeded,
1 otherwise) and freezing at its length or when its range empties.
"""

from __future__ import annotations

import torch

from . import kernels
from .device_index import FmDeviceIndex
from .rank import seed_range, update_range

_FULL = 0xFFFFFFFF


def unpack_crumbs_t(qwire: torch.Tensor, dense_to_index: torch.Tensor) -> torch.Tensor:
    """Crumb wire int8[B, L//4] (2 bits per dense symbol; crumb j of a byte
    at bits 2j is column 4*byte + j) -> int32[L, B] symbol indices.
    ``dense_to_index`` int32[num_encoding_symbols] maps A,C,G,T -> 1,2,3,5;
    padding crumbs decode to 'A' and are masked by qlens downstream."""
    w = qwire.view(torch.uint8).to(torch.int32).T  # [L//4, B]
    crumbs = torch.stack([(w >> (2 * j)) & 3 for j in range(4)], dim=1)
    return dense_to_index[crumbs.reshape(-1, qwire.shape[0])]


def unpack_nibbles_t(qwire: torch.Tensor) -> torch.Tensor:
    """Nibble wire uint8[B, L//2] (low nibble = even column) -> int32[L, B]."""
    w = qwire.to(torch.int32).T  # [L//2, B]
    return torch.stack([w & 0xF, w >> 4], dim=1).reshape(-1, qwire.shape[0])


def search_ranges_t(
    dev: FmDeviceIndex,
    qt: torch.Tensor,
    qlens: torch.Tensor,
    *,
    num_steps: int | None = None,
    no_sentinel: bool = False,
    seeded_floor: bool = False,
):
    """Final (or step-``num_steps``) BWT ranges of a query batch.

    qt: int32[L, B]; qlens: int64[B] (0 allowed -> empty range).
    ``num_steps`` caps the consumed symbols (the verify path stops early).
    ``no_sentinel``: the caller guarantees qt holds no sentinel symbol (the
    crumb wire cannot encode one).  ``seeded_floor``: the caller guarantees
    no lane is live before step k (every lane k-mer-seeds or is shorter than
    2), so the loop starts at k; otherwise steps with no live lane are
    skipped after a device->host check of the live mask.

    Returns (starts, ends) int64[B], inclusive; empty iff start > end.
    """
    L, B = qt.shape
    starts, ends = seed_range(dev, qt[L - 1])
    steps_done = torch.ones(B, dtype=torch.int64, device=qt.device)

    k = dev.kmer_len
    seeded = k > 0 and L >= k
    if seeded:
        # Dense radix address over the last k symbols (distance j weighted
        # base**j), read as a [end, start] pair from the flat table.
        base = dev.alphabet.num_encoding_symbols
        addr = torch.zeros(B, dtype=torch.int64, device=qt.device)
        all_dense = qlens >= k
        for j in range(k):
            d = dev.dense[qt[L - 1 - j]]
            all_dense &= d >= 0
            addr += d.clamp_min(0) * base**j
        pair = kernels.window_read(dev.kmer_flat, (addr << 1) | 1, 2).to(torch.int64) & _FULL
        starts = torch.where(all_dense, pair[:, 1], starts)
        ends = torch.where(all_dense, pair[:, 0], ends)
        steps_done = torch.where(all_dense, k, steps_done)

    upper = L if num_steps is None else min(L, num_steps)
    lower = k if (seeded_floor and seeded) else 1
    for i in range(lower, upper):
        active = (i >= steps_done) & (i < qlens) & (starts <= ends)
        if not seeded_floor and not bool(active.any()):
            continue
        new_starts, new_ends = update_range(dev, starts, ends, qt[L - 1 - i])
        starts = torch.where(active, new_starts, starts)
        ends = torch.where(active, new_ends, ends)

    # Zero-length queries and queries holding the sentinel symbol yield the
    # canonical empty range (1, 0).
    invalid = qlens <= 0
    if not no_sentinel:
        col = torch.arange(L, device=qt.device)[:, None]
        in_query = col >= (L - qlens)[None, :]
        invalid |= ((qt == 0) & in_query).any(dim=0)
    starts = torch.where(invalid, 1, starts)
    ends = torch.where(invalid, 0, ends)
    return starts, ends


def counts_from_ranges(starts: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Range length; 0 for empty ranges."""
    return torch.where(starts <= ends, ends - starts + 1, 0)


def count_batch_kernel_t(
    dev: FmDeviceIndex, qt, qlens, *, no_sentinel: bool = False, seeded_floor: bool = False
) -> torch.Tensor:
    starts, ends = search_ranges_t(dev, qt, qlens, no_sentinel=no_sentinel, seeded_floor=seeded_floor)
    return counts_from_ranges(starts, ends)
