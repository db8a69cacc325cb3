"""Index construction: text -> suffix array -> FM-index arrays (host).

The port's copy of ``awry_tpu/build/builder.py``.  Every component comes
from whole-array NumPy passes: bit-plane packing via np.packbits, milestones
via per-block sums + an exclusive cumsum, the k-mer table by counting
(build/kmer_count.py), or, with ``build_kmer_table_on_device``, breadth-wise
on a device through the ``occ`` kernel (ops/kmer.py).
"""

from __future__ import annotations

import logging
import time

import numpy as np

from ..alphabet import Alphabet, encode_ascii, index_to_code_table
from ..index import SYMBOLS_PER_BLOCK, WORDS_PER_WINDOW, FmBuildArgs, FmIndexData
from ..io.sequence_io import SequenceData, concat_records, read_sequence_file
from .kmer_count import populate_kmer_table_counting
from .suffix_array import build_suffix_array, gather_u8

_log = logging.getLogger("awry_tpu_torch.build")


def bwt_symbols_from_sa(text_syms: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """BWT[i] = text'[SA[i]-1] with text' = text + sentinel; the row with
    SA == 0 gets the sentinel (index n of the extended text)."""
    n = text_syms.shape[0]
    ext = np.empty(n + 1, dtype=np.uint8)
    ext[:-1] = text_syms
    ext[-1] = 0
    # Unsigned-safe prev-position in the SA's own dtype: the single sa == 0
    # row maps to n (the appended sentinel).
    idx = sa - sa.dtype.type(1)
    idx[int(np.argmin(sa))] = sa.dtype.type(n)
    return gather_u8(ext, idx)


def pack_bit_planes(bwt_syms: np.ndarray, alphabet: Alphabet) -> np.ndarray:
    """Pack per-position symbol codes into uint32[num_blocks, V, 8] planes:
    bit v of a symbol's code goes into plane v at its in-block bit position,
    little-endian over the 8 u32 words of a 256-bit window."""
    n = bwt_syms.shape[0]
    num_blocks = -(-n // SYMBOLS_PER_BLOCK)
    codes = np.zeros(num_blocks * SYMBOLS_PER_BLOCK, dtype=np.uint8)
    codes[:n] = index_to_code_table(alphabet)[bwt_syms]
    nv = alphabet.num_planes
    planes = np.empty((num_blocks, nv, WORDS_PER_WINDOW), dtype=np.uint32)
    for v in range(nv):
        plane_bits = (codes >> np.uint8(v)) & np.uint8(1)
        packed = np.packbits(plane_bits, bitorder="little")
        planes[:, v, :] = packed.view("<u4").reshape(num_blocks, WORDS_PER_WINDOW)
    return planes


def compute_milestones(bwt_syms: np.ndarray, alphabet: Alphabet) -> tuple[np.ndarray, np.ndarray]:
    """Milestones[b, c] = count of c in BWT[0 : 256*b], plus the prefix sums C."""
    n = bwt_syms.shape[0]
    c = alphabet.cardinality
    num_blocks = -(-n // SYMBOLS_PER_BLOCK)
    padded = np.full(num_blocks * SYMBOLS_PER_BLOCK, 255, dtype=np.uint8)
    padded[:n] = bwt_syms
    rows = padded.reshape(num_blocks, SYMBOLS_PER_BLOCK)
    per_block = np.empty((num_blocks, c), dtype=np.uint64)
    for s in range(c):
        per_block[:, s] = (rows == s).sum(axis=1, dtype=np.uint32)
    cum = np.cumsum(per_block, axis=0, dtype=np.uint64)
    milestones = np.zeros_like(cum)
    milestones[1:] = cum[:-1]
    prefix_sums = np.zeros(c + 1, dtype=np.uint64)
    prefix_sums[1:] = np.cumsum(cum[-1], dtype=np.uint64)
    return milestones, prefix_sums


def build_from_sequence_data(seq_data: SequenceData, args: FmBuildArgs, *, device=None) -> FmIndexData:
    """Assemble the full FM-index from canonical concatenated text.

    ``device`` is where ``args.build_kmer_table_on_device`` builds the k-mer
    table: None means the card (cuda:0; raises without one), "cpu" runs the
    kernels' plain versions."""
    alphabet = args.alphabet
    t_phase = time.perf_counter()

    def phase(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        _log.info("build phase %-18s %.1fs", name, now - t_phase)
        t_phase = now

    sa = build_suffix_array(seq_data.text)
    phase("SA-IS")
    bwt_len = sa.shape[0]  # text_len + 1
    text_syms = encode_ascii(alphabet, seq_data.text)  # uint8
    bwt_syms = bwt_symbols_from_sa(text_syms, sa)
    phase("BWT gather")

    planes = pack_bit_planes(bwt_syms, alphabet)
    milestones, prefix_sums = compute_milestones(bwt_syms, alphabet)
    del bwt_syms
    phase("planes+milestones")

    sa_ratio = args.resolved_sa_ratio()
    pos_dtype = np.uint32 if bwt_len <= (1 << 32) else np.uint64
    sampled_sa = sa[::sa_ratio].astype(pos_dtype)  # sampling by BWT row

    # Text-order sampling marks: text positions that are multiples of
    # mark_ratio are marked; text_sampled_sa holds their SA values.
    mark_ratio = args.resolved_mark_ratio()
    num_blocks = planes.shape[0]
    marked = np.zeros(num_blocks * SYMBOLS_PER_BLOCK, dtype=np.uint8)
    marked[: sa.shape[0]] = 1 if mark_ratio == 1 else (sa % mark_ratio) == 0
    mark_bits = np.packbits(marked, bitorder="little").view("<u4").reshape(num_blocks, 8)
    per_block_marked = marked.reshape(num_blocks, SYMBOLS_PER_BLOCK).sum(axis=1, dtype=np.uint32)
    mark_milestones = np.zeros(num_blocks, dtype=np.uint32)
    np.cumsum(per_block_marked[:-1], out=mark_milestones[1:], dtype=np.uint32)
    if mark_ratio == 1:  # every row marked: skip the boolean index
        text_sampled_sa = sa.astype(pos_dtype)
    else:
        text_sampled_sa = sa[marked[: sa.shape[0]].astype(bool)].astype(pos_dtype)
    del sa, marked
    phase("marks")

    # Packed text for the verify path: symbol indices at 4 (nucleotide) or
    # 8 (amino) bits, little-endian within uint32 words.
    bits = 4 if alphabet.cardinality <= 16 else 8
    spw = 32 // bits
    n_words = -(-(len(text_syms) + 1) // spw)
    padded_syms = np.zeros(n_words * spw, dtype=np.uint32)
    padded_syms[: len(text_syms)] = text_syms
    text_packed = np.zeros(n_words, dtype=np.uint32)
    for j in range(spw):
        text_packed |= padded_syms[j::spw] << np.uint32(bits * j)
    phase("text pack")

    kmer_len = args.resolved_kmer_len()
    index = FmIndexData(
        alphabet=alphabet,
        planes=planes,
        milestones=milestones,
        prefix_sums=prefix_sums,
        sampled_sa=sampled_sa,
        sa_ratio=sa_ratio,
        bwt_len=int(bwt_len),
        kmer_table=np.zeros((1, 2), dtype=np.uint32),  # placeholder until the table below
        kmer_len=kmer_len,
        seq_starts=seq_data.start_positions.astype(np.int64),
        headers=list(seq_data.headers),
        mark_bits=mark_bits,
        mark_milestones=mark_milestones,
        text_sampled_sa=text_sampled_sa,
        mark_ratio=mark_ratio,
        text_packed=text_packed,
    )
    if args.build_kmer_table_on_device:
        from ..ops.device_index import to_device
        from ..ops.kmer import populate_kmer_table_device

        # minimal: the build only ranks, so only the rank tables ship.
        table = populate_kmer_table_device(to_device(index, device, minimal=True), kmer_len)
        # The dtype of the counting table, so that both builds give one index.
        index.kmer_table = table.astype(np.uint32) if bwt_len <= (1 << 32) and kmer_len else table
    else:
        index.kmer_table = populate_kmer_table_counting(text_syms, alphabet, kmer_len)
    phase("kmer table")
    index.validate()
    return index


def build_index(args: FmBuildArgs, *, device=None) -> FmIndexData:
    """Read the input file named by ``args`` and build the index."""
    if args.input_file_src is None:
        raise ValueError("input_file_src is required")
    seq_data = read_sequence_file(args.input_file_src, args.alphabet)
    return build_from_sequence_data(seq_data, args, device=device)


def build_from_records(records: list[tuple[str, bytes]], args: FmBuildArgs, *, device=None) -> FmIndexData:
    """Build directly from in-memory (header, sequence) records."""
    return build_from_sequence_data(concat_records(records, args.alphabet), args, device=device)
