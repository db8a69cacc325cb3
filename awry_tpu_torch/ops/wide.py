"""The 64-bit ("wide") device index: single texts of 2**32 symbols and more.

The port's counterpart of ``awry_tpu/ops/wide.py``.  The narrow device
index (ops/device_index.py) keeps milestones, mark milestones, SA values and
the k-mer table as uint32 bits; past 2**32 symbols they overflow.  Here:

* The fused rows keep the narrow layout (V*8 plane words, the per-symbol
  milestones, 8 mark words and the mark milestone; 40 words nucleotide, 72
  amino), and plane and mark words stay uint32 bits in int32.  Block
  indexes fit 32 bits up to 2**40 symbols.
* A row's milestones and mark milestone count from the first block of its
  group of 2**GROUP_SHIFT blocks (2**24 symbols), so they fit 32 bits; each
  group's absolute counts sit in two small int64 tables
  (``kernels.WideBases``: ``milestones`` [groups, cardinality] and
  ``marks`` [groups], a few KB that stay in L2).  The kernels' wide
  variants (``occ_pair_wide``, ``backstep_wide``, ``marked_walk_wide``,
  ``sampled_walk_wide``) add the group's base to what the row holds: one row
  read per rank as in the narrow kernels.
* Positions, prefix sums, SA values (``text_sampled_sa``, ``sampled_sa``)
  and the k-mer table are int64 (torch has no uint64 arithmetic).  The mark
  milestones are recomputed in 64 bits from the mark words: the host
  index's ``mark_milestones`` are uint32 and overflow past 2**32 marked rows.
* The k-mer seed and the mark-1 SA read stay on ``window_read``, over the
  int64 tables' int32 words (a pair of int64 values is 4 words).
* ``to_device_wide(index, device, minimal=True)`` ships only what a rank
  reads (fused rows, bases, prefix sums, codes), as ``to_device(minimal=
  True)`` does for the narrow layout: the device k-mer build
  (ops/kmer.py, through ``occ_wide``), which ``load_awry`` of a file of
  2**32 symbols and more runs.

The reference's transposed blocks and flat uint64 side arrays work around
XLA's tile padding and are not copied.  The wide index serves the classic
path only, as the reference's does: no verify path, no slot rows, no packed
text.  ``FmQueryEngine(index)`` ships through here exactly when
``bwt_len >= 2**32``; ``wide=True`` forces it on a smaller index.
"""

from __future__ import annotations

import numpy as np
import torch

from ..alphabet import code_to_index_table, index_to_code_table, index_to_dense_table
from ..index import FmIndexData
from .device_index import FmDeviceIndex, fused_row_words, resolve_device
from .kernels import WideBases

GROUP_SHIFT = 16  # log2 of the blocks per milestone group (2**24 symbols)
_FULL = 0xFFFFFFFF


def _popcount_rows(words: np.ndarray) -> np.ndarray:
    """Set bits per row of a uint32 [n, w] array, as int64 (SWAR)."""
    x = words.astype(np.uint32)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * np.uint32(0x01010101)) >> 24).sum(axis=1, dtype=np.int64)


def build_wide_blocks(index: FmIndexData, group_shift: int = GROUP_SHIFT) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fused uint32 [num_blocks, row_words], milestone bases int64
    [groups, cardinality], mark bases int64 [groups]): the narrow fused row
    layout with each row's milestones and mark milestone relative to the
    first block of its group of 2**group_shift blocks."""
    if not 0 <= group_shift <= 24:
        raise ValueError(f"group_shift={group_shift}: relative counts fit 32 bits only up to 24")
    nb = index.num_blocks
    v = index.alphabet.num_planes
    c = index.alphabet.cardinality
    group = np.arange(nb) >> group_shift
    first = np.arange(0, nb, 1 << group_shift)
    fused = np.zeros((nb, fused_row_words(index.alphabet)), dtype=np.uint32)
    fused[:, : v * 8] = index.planes.reshape(nb, v * 8)
    ms = index.milestones.astype(np.int64)
    ms_base = np.ascontiguousarray(ms[first])
    fused[:, v * 8 : v * 8 + c] = ms - ms_base[group]
    mark_base = np.zeros(first.shape[0], dtype=np.int64)  # zero mark words without marks
    if index.has_marks:
        off = v * 8 + c
        fused[:, off : off + 8] = index.mark_bits
        mark_ms = np.zeros(nb, dtype=np.int64)
        np.cumsum(_popcount_rows(index.mark_bits)[:-1], out=mark_ms[1:])
        mark_base = np.ascontiguousarray(mark_ms[first])
        fused[:, off + 8] = mark_ms - mark_base[group]
    return fused, ms_base, mark_base


def join_words(words: torch.Tensor) -> torch.Tensor:
    """int64 values from window_read's [R, 2] (high word, low word) rows."""
    return (words[:, 0].to(torch.int64) << 32) | (words[:, 1].to(torch.int64) & _FULL)


def to_device_wide(index: FmIndexData, device=None, *, minimal: bool = False) -> FmDeviceIndex:
    """Ship a host index of any length to ``device`` (None: the card, see
    resolve_device) in the 64-bit layout (module docstring): the classic
    path's tables, with ``bases`` set.  ``text_sampled_sa`` (with marks) or
    ``sampled_sa`` (without) and ``kmer_flat`` hold int64 values, the
    k-mer table as int32 words (entry a: words 4a .. 4a + 3 = start low,
    start high, end low, end high).  Groups of 2**GROUP_SHIFT blocks (read
    at each call, so that tests can shrink them).  ``minimal``: only the
    fused rows, bases, prefix sums and codes (the other tables one-word
    placeholders, kmer_len 0), for the device k-mer build."""
    device = resolve_device(device)
    group_shift = GROUP_SHIFT

    def put(arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    fused, ms_base, mark_base = build_wide_blocks(index, group_shift)
    placeholder = put(np.zeros(1, dtype=np.int64))
    tables = dict(
        blocks=put(fused.view(np.int32)),
        prefix_sums=put(index.prefix_sums.astype(np.int64)),
        seq_starts=put(index.seq_starts.astype(np.int64)),
        codes=put(index_to_code_table(index.alphabet).astype(np.int32)),
        c2i=put(code_to_index_table(index.alphabet).astype(np.int32)),
        dense=put(index_to_dense_table(index.alphabet).astype(np.int64)),
        alphabet=index.alphabet,
        bwt_len=int(index.bwt_len),
        mark_ratio=int(index.resolved_mark_ratio),
        has_marks=index.has_marks,
        sa_ratio=int(index.sa_ratio),
        bases=WideBases(put(ms_base), put(mark_base), group_shift),
    )
    if minimal:
        return FmDeviceIndex(
            **tables, kmer_flat=put(np.zeros(1, dtype=np.int32)), text_packed=put(np.zeros(1, dtype=np.int32)),
            text_sampled_sa=placeholder, sampled_sa=placeholder, kmer_len=0,
        )
    kmer = np.asarray(index.kmer_table).astype(np.int64).reshape(-1)
    return FmDeviceIndex(
        **tables,
        kmer_flat=put(kmer.view(np.int32)),
        text_packed=put(np.zeros(1, dtype=np.int32)),
        text_sampled_sa=put(index.text_sampled_sa.astype(np.int64)) if index.has_marks else placeholder,
        kmer_len=int(index.kmer_len),
        sampled_sa=placeholder if index.has_marks else put(index.sampled_sa.astype(np.int64)),
    )
