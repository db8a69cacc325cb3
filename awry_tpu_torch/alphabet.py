"""Alphabet codecs: ASCII <-> symbol-index <-> occurrence-bit-vector code.

The PyTorch port's own copy of ``awry_tpu/alphabet.py`` (the port imports
nothing of the JAX package).  Every conversion is a NumPy lookup table so
whole texts and query batches convert in one vectorized pass; the code table
also ships to the card for the rank kernel (ops/kernels.py).

Semantics pinned to the reference (bit-exactness contract, SURVEY.md 2.2):

* Nucleotide (cardinality 6, src/alphabet.rs:87-92): ``$``/``#`` -> 0,
  A -> 1, C -> 2, G -> 3, any-other-char (ambiguity, N) -> 4, T/U -> 5.
  Case-insensitive (src/alphabet.rs:109-114); RNA handled by U == T.
* Amino (cardinality 22): ``$``/``#`` -> 0, A..W -> 1..19 (skipping the
  non-amino letters), X (ambiguity, any other char) -> 20, Y -> 21
  (src/alphabet.rs:174-196).
* Occurrence bit-vector codes: nucleotide 3-bit codes ``$=0b100 A=0b110
  C=0b101 G=0b011 N=0b010 T=0b001`` (src/alphabet.rs:310-317); amino 5-bit
  codes (src/alphabet.rs:256-279).  Bit *v* of the code is stored in
  occurrence bit-plane *v* (src/bwt.rs:65-77).

A crucial property this module relies on (and asserts in tests): the ASCII
order of the canonical symbols equals the symbol-index order, so a byte-level
suffix sort of the *canonical* text produces a suffix array consistent with
the index-order prefix sums used by backward search.
"""

from __future__ import annotations

import enum
from functools import lru_cache

import numpy as np

SENTINEL_IDX = 0


class Alphabet(enum.Enum):
    """Symbol alphabet (reference: SymbolAlphabet, src/alphabet.rs:28-31)."""

    NUCLEOTIDE = 0
    AMINO = 1

    @property
    def cardinality(self) -> int:
        """Number of distinct symbol indices (src/alphabet.rs:87-92)."""
        return 6 if self is Alphabet.NUCLEOTIDE else 22

    @property
    def num_encoding_symbols(self) -> int:
        """cardinality - 2: excludes sentinel and ambiguity symbol
        (src/alphabet.rs:95-98). Used for k-mer table sizing."""
        return self.cardinality - 2

    @property
    def num_planes(self) -> int:
        """Number of occurrence bit-planes = bits per symbol code
        (src/bwt.rs:30, :140)."""
        return 3 if self is Alphabet.NUCLEOTIDE else 5

    @property
    def ambiguity_idx(self) -> int:
        """Symbol index of the searchable ambiguity character (N / X)."""
        return 4 if self is Alphabet.NUCLEOTIDE else 20

    @property
    def delimiter(self) -> bytes:
        """Inter-record padding character used when concatenating multi-record
        inputs (reference: fm_index.rs:148-152)."""
        return b"N" if self is Alphabet.NUCLEOTIDE else b"X"

    @property
    def default_kmer_len(self) -> int:
        """Default k-mer lookup-table depth (kmer_lookup_table.rs:23-24;
        note README.md claims 13/5 but the code wins)."""
        return 10 if self is Alphabet.NUCLEOTIDE else 4


# index -> canonical ASCII, position i gives the canonical letter of index i.
_INDEX_TO_ASCII = {
    Alphabet.NUCLEOTIDE: b"$ACGNT",
    Alphabet.AMINO: b"$ACDEFGHIKLMNPQRSTVWXY",
}

# index -> occurrence bit-vector code (src/alphabet.rs:280-303, :318-325).
_INDEX_TO_CODE = {
    Alphabet.NUCLEOTIDE: np.array([0b100, 0b110, 0b101, 0b011, 0b010, 0b001], dtype=np.uint8),
    Alphabet.AMINO: np.array(
        [
            0b00000,  # $
            0b01100,  # A
            0b10111,  # C
            0b00011,  # D
            0b00110,  # E
            0b11110,  # F
            0b11010,  # G
            0b11011,  # H
            0b11001,  # I
            0b10101,  # K
            0b11100,  # L
            0b11101,  # M
            0b01000,  # N
            0b01001,  # P
            0b00100,  # Q
            0b10011,  # R
            0b01010,  # S
            0b00101,  # T
            0b10110,  # V
            0b00001,  # W
            0b11111,  # X (ambiguity)
            0b00010,  # Y
        ],
        dtype=np.uint8,
    ),
}


@lru_cache(maxsize=None)
def ascii_to_index_table(alphabet: Alphabet) -> np.ndarray:
    """uint8[256] LUT: ASCII byte -> symbol index.

    Mirrors Symbol::to_index on Ascii encodings (src/alphabet.rs:174-196,
    :228-234): case-insensitive, ``$``/``#`` -> sentinel, unknown chars ->
    ambiguity index.
    """
    table = np.full(256, alphabet.ambiguity_idx, dtype=np.uint8)
    for idx, ch in enumerate(_INDEX_TO_ASCII[alphabet]):
        table[ch] = idx
        table[ch | 0x20] = idx  # lowercase alias
    if alphabet is Alphabet.NUCLEOTIDE:
        table[ord("U")] = 5  # RNA: U == T (src/alphabet.rs:233)
        table[ord("u")] = 5
    # but canonical ambiguity letters keep their own index, re-set in loop above
    table[ord("#")] = SENTINEL_IDX  # src/alphabet.rs:229
    table[ord("$")] = SENTINEL_IDX
    table.setflags(write=False)
    return table


@lru_cache(maxsize=None)
def index_to_ascii_table(alphabet: Alphabet) -> np.ndarray:
    """uint8[cardinality] LUT: symbol index -> canonical ASCII byte."""
    table = np.frombuffer(_INDEX_TO_ASCII[alphabet], dtype=np.uint8).copy()
    table.setflags(write=False)
    return table


@lru_cache(maxsize=None)
def index_to_code_table(alphabet: Alphabet) -> np.ndarray:
    """uint8[cardinality] LUT: symbol index -> occurrence bit-vector code."""
    table = _INDEX_TO_CODE[alphabet].copy()
    table.setflags(write=False)
    return table


@lru_cache(maxsize=None)
def code_to_index_table(alphabet: Alphabet) -> np.ndarray:
    """uint8[2**num_planes] LUT: bit-vector code -> symbol index; codes no
    symbol has map to the ambiguity index (src/alphabet.rs:199-222)."""
    table = np.full(1 << alphabet.num_planes, alphabet.ambiguity_idx, dtype=np.uint8)
    for idx, code in enumerate(_INDEX_TO_CODE[alphabet]):
        table[code] = idx
    table.setflags(write=False)
    return table


@lru_cache(maxsize=None)
def normalize_table(alphabet: Alphabet) -> np.ndarray:
    """uint8[256] LUT: raw input byte -> canonical text byte.

    Ingestion-time text normalization: uppercase, U->T (nucleotide), every
    non-alphabet char -> ambiguity letter (N/X).  Bytes that would map to the
    sentinel ('$', '#') are ALSO normalized to ambiguity: the sentinel may
    never occur inside the stored text (it is virtual, appended by the suffix
    sort).  This guarantees canonical-byte order == symbol-index order, which
    backward search requires.  The reference gets the equivalent guarantee
    from libsufr's DNA/protein normalization (fm_index.rs:156-169).
    """
    a2i = ascii_to_index_table(alphabet)
    i2a = index_to_ascii_table(alphabet)
    idx = a2i.copy()
    idx[idx == SENTINEL_IDX] = alphabet.ambiguity_idx
    table = i2a[idx]
    table.setflags(write=False)
    return table


@lru_cache(maxsize=None)
def index_to_dense_table(alphabet: Alphabet) -> np.ndarray:
    """int8[cardinality] LUT: symbol index -> dense k-mer rank, or -1.

    The k-mer lookup table addresses entries by a dense radix over the
    *encoding* symbols only (A,C,G,T -> 0..3; the 20 aminos -> 0..19).  The
    reference intended the same (kmer_lookup_table.rs:113-118) but its
    addressing used raw symbol indices and skipped T / Y entirely
    (SURVEY.md 2.3 quirks #1/#3); we use a correct dense mapping, which is
    result-equivalent because a correct table lookup equals the recomputed
    seed range.
    """
    table = np.full(alphabet.cardinality, -1, dtype=np.int8)
    dense = 0
    for idx in range(alphabet.cardinality):
        if idx in (SENTINEL_IDX, alphabet.ambiguity_idx):
            continue
        table[idx] = dense
        dense += 1
    assert dense == alphabet.num_encoding_symbols
    table.setflags(write=False)
    return table


def encode_ascii(alphabet: Alphabet, data: bytes | np.ndarray) -> np.ndarray:
    """Vectorized ASCII -> symbol-index conversion."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    return ascii_to_index_table(alphabet)[arr]


def normalize_text(alphabet: Alphabet, data: bytes | np.ndarray) -> np.ndarray:
    """Vectorized raw-bytes -> canonical-text-bytes conversion."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    return normalize_table(alphabet)[arr]
