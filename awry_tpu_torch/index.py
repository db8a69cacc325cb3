"""FM-index data model (host, NumPy): the port's copy of ``awry_tpu/index.py``.

Every component is a dense array so the index ships to the card as a few
tensors (ops/device_index.py):

* ``planes``    uint32[num_blocks, num_planes, 8] - the strided occurrence
  bit-vectors; one 256-bit window per (block, plane) as 8 little-endian u32.
* ``milestones`` uint64[num_blocks, cardinality] - per-symbol cumulative
  counts at each block start.
* ``prefix_sums`` uint64[cardinality+1] - the C array.
* ``sampled_sa`` - every sa_ratio-th suffix-array entry by BWT row.
* ``kmer_table`` [base**k, 2] - seed ranges addressed by a dense radix over
  the encoding symbols (A,C,G,T -> 0..3 etc.).
* ``seq_starts`` int64[num_records] - record start offsets for localization.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .alphabet import Alphabet

SYMBOLS_PER_BLOCK = 256
WORDS_PER_WINDOW = 8  # 256 bits as 8 x u32 lanes
FM_VERSION_NUMBER = 1


@dataclasses.dataclass
class FmBuildArgs:
    """Build configuration (awry_tpu.FmBuildArgs's fields and defaults, less
    the intermediate suffix-array file options and max_query_len)."""

    input_file_src: str | None = None
    alphabet: Alphabet = Alphabet.NUCLEOTIDE
    suffix_array_compression_ratio: int | None = None  # default 8
    lookup_table_kmer_len: int | None = None  # defaults 10 / 4
    # Text-order sampling density of the locate marks; None -> min(4,
    # sa_ratio).  Ratio 1 stores every row's SA value (locate is one read);
    # ratio r stores 1/r of them and locate walks at most r - 1 LF steps.
    locate_mark_ratio: int | None = None
    # Build the k-mer table breadth-wise on a device (ops/kmer.py) instead
    # of by counting on the host; the builders' ``device=`` names it.
    build_kmer_table_on_device: bool = False

    def resolved_sa_ratio(self) -> int:
        return self.suffix_array_compression_ratio or 8

    def resolved_mark_ratio(self) -> int:
        if self.locate_mark_ratio is not None:
            if self.locate_mark_ratio < 1:
                raise ValueError("locate_mark_ratio must be >= 1")
            return self.locate_mark_ratio
        return min(4, self.resolved_sa_ratio())

    def resolved_kmer_len(self) -> int:
        """None -> alphabet default (10/4); explicit 0 disables the table."""
        if self.lookup_table_kmer_len is None:
            return self.alphabet.default_kmer_len
        return self.lookup_table_kmer_len


@dataclasses.dataclass
class FmIndexData:
    """Host-resident (NumPy) FM-index; ops.device_index.to_device ships it."""

    alphabet: Alphabet
    planes: np.ndarray  # uint32 [num_blocks, num_planes, 8]
    milestones: np.ndarray  # uint64 [num_blocks, cardinality]
    prefix_sums: np.ndarray  # uint64 [cardinality + 1]
    sampled_sa: np.ndarray  # uint32|uint64 [ceil(bwt_len / sa_ratio)]
    sa_ratio: int
    bwt_len: int
    kmer_table: np.ndarray  # uint32|uint64 [base**kmer_len, 2]
    kmer_len: int
    seq_starts: np.ndarray  # int64 [num_records]
    headers: list[str]
    version_number: int = FM_VERSION_NUMBER
    # Text-order sampling marks: rows whose SA value is a multiple of
    # mark_ratio are marked; text_sampled_sa holds their SA values in row
    # order (the whole SA at mark_ratio 1).
    mark_bits: np.ndarray | None = None  # uint32 [num_blocks, 8]
    mark_milestones: np.ndarray | None = None  # uint32 [num_blocks]
    text_sampled_sa: np.ndarray | None = None  # uint32|uint64 [num marked rows]
    mark_ratio: int = 0  # 0 = legacy: equal to sa_ratio
    # Packed original text (symbol indices; 4 bits/symbol when cardinality
    # <= 16, else 8), little-endian within each uint32 word: the verify
    # path's text compare reads it (ops/verify.py).
    text_packed: np.ndarray | None = None

    @property
    def resolved_mark_ratio(self) -> int:
        return self.mark_ratio or self.sa_ratio

    @property
    def has_marks(self) -> bool:
        return self.mark_bits is not None

    @property
    def num_blocks(self) -> int:
        return self.planes.shape[0]

    def validate(self) -> None:
        """Shape/dtype invariants; raises ValueError on the first one broken
        (from_numpy_index runs it on arrays built elsewhere)."""
        c = self.alphabet.cardinality
        v = self.alphabet.num_planes
        nb = -(-self.bwt_len // SYMBOLS_PER_BLOCK)
        base = self.alphabet.num_encoding_symbols
        checks = [
            ("planes shape", self.planes.shape == (nb, v, WORDS_PER_WINDOW)),
            ("planes dtype", self.planes.dtype == np.uint32),
            ("milestones shape", self.milestones.shape == (nb, c)),
            ("prefix_sums shape", self.prefix_sums.shape == (c + 1,)),
            ("prefix_sums total", int(self.prefix_sums[-1]) == self.bwt_len),
            ("sampled_sa shape", self.sampled_sa.shape == (-(-self.bwt_len // self.sa_ratio),)),
            ("kmer_table shape", self.kmer_table.shape == (base**self.kmer_len, 2)),
            ("seq_starts shape", self.seq_starts.shape == (len(self.headers),)),
        ]
        for name, ok in checks:
            if not ok:
                raise ValueError(f"FmIndexData: bad {name}")
