"""K-mer seed-table construction on the card (awry_tpu/ops/kmer.py).

The table is built breadth-wise: level 1 holds the seed range of every
encoding symbol, and level l + 1 extends all base**l ranges of level l by
every encoding symbol in range updates over the whole level.  Each chunk of
a level ranks the concatenation ``[starts - 1, ends]`` of its updates with
one ``rank.occurrence`` call, so the build is a batch of single ranks
through the ``occ`` kernel.

Addressing matches the host tables (build/kmer_count.py): address = sum of
dense(symbol at distance j from the k-mer end) * base**j, so entry
``off + i`` of level l + 1 extends entry ``(off + i) % size`` of level l by
the symbol of dense rank ``(off + i) // size``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..alphabet import index_to_dense_table
from .device_index import FmDeviceIndex
from .rank import occurrence, prefix_sum_select, seed_range

# Largest number of range updates ranked at once (2 * _LEVEL_CHUNK occ
# requests); the temporaries of one chunk take about 0.5 GB on the card.
_LEVEL_CHUNK = 1 << 22


def _level_chunk(base: int, total: int) -> int:
    """Chunk size of the level loop: base**m * 2**j with 2**j dividing base,
    the largest such number under _LEVEL_CHUNK (at most ``total``).  It
    divides every level larger than itself (base**l = base**m *
    base**(l - m)), so every chunk of such a level is full; halving from the
    total instead would leave a 5**k factor at base 20 that 20**(k - 1)
    lacks."""
    chunk = 1
    while chunk * base <= _LEVEL_CHUNK:
        chunk *= base
    twos = base & -base
    while twos > 1 and chunk * 2 <= _LEVEL_CHUNK:
        chunk *= 2
        twos //= 2
    return min(chunk, total)


def populate_kmer_table_device(dev: FmDeviceIndex, kmer_len: int | None = None) -> np.ndarray:
    """Build the dense k-mer seed table on ``dev``'s device.

    Returns uint64[base**k, 2], equal to the host tables (empty ranges as
    the canonical (1, 0)).  ``kmer_len`` defaults to the index's; a minimal
    device index (to_device(minimal=True)) carries 0 there, so it must be
    passed."""
    if kmer_len is None and dev.kmer_len == 0:
        raise ValueError("device index has no k-mer table (kmer_len=0); pass kmer_len explicitly to build one")
    k = dev.kmer_len if kmer_len is None else kmer_len
    if k == 0:  # table disabled: a single canonical-empty entry, never read
        return np.array([[1, 0]], dtype=np.uint64)
    alphabet = dev.alphabet
    base = alphabet.num_encoding_symbols
    # Dense rank -> symbol index (the dense ranks follow the index order).
    syms = torch.from_numpy(np.flatnonzero(index_to_dense_table(alphabet) >= 0)).to(dev.device)

    total = base**k
    chunk = _level_chunk(base, total)
    starts, ends = seed_range(dev, syms)
    size = base
    for _ in range(1, k):
        new_size = size * base
        assert new_size <= chunk or new_size % chunk == 0, (new_size, chunk)
        # A new buffer per level: the reads of the level below never alias its writes.
        dst_s = torch.empty(new_size, dtype=torch.int64, device=dev.device)
        dst_e = torch.empty_like(dst_s)
        for off in range(0, new_size, chunk):
            idx = torch.arange(off, min(off + chunk, new_size), device=dev.device)
            old = idx % size
            sym = syms[idx // size]
            n = idx.shape[0]
            occ = occurrence(dev, torch.cat([starts[old] - 1, ends[old]]), torch.cat([sym, sym]))
            c = prefix_sum_select(dev, sym)
            dst_s[off : off + n] = c + occ[:n]
            dst_e[off : off + n] = c + occ[n:] - 1
        starts, ends, size = dst_s, dst_e, new_size

    empty = starts > ends  # canonical empty range (1, 0)
    table = torch.stack([torch.where(empty, 1, starts.clamp_min(0)), torch.where(empty, 0, ends.clamp_min(0))], dim=1)
    return table.cpu().numpy().view(np.uint64)  # non-negative int64: the same bits
