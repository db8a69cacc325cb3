"""Reader and writer of the reference's binary ``.awry`` index format.

The port's copy of ``awry_tpu/io/awry_format.py``: ``save_awry`` writes the
same bytes as the JAX package's for the same index.  Byte layout
(src/fm_index_file.rs:42-287), everything little-endian, no checksums:

  magic            11 bytes  b"AWRY-Index\\n"
  header           4 x u64   [version, sa_ratio, bwt_len, alphabet_idx]
  per block        V x 32 B bit-vectors, then 8 (nucleotide) / 24 (amino)
                   u64 milestones
  prefix sums      (cardinality+1) x u64
  packed SA        packed_word_len u64 words (utils/bitpack.py)
  k-mer table      u8 k, then base**k (start, end) u64 pairs
  sequence index   u64 count, then per record (u64 start, u64 header_len,
                   header bytes)

The uint32-lane planes are byte-identical to the reference's [u64; 4]
windows viewed little-endian, so block IO is a reinterpret.

The k-mer section written holds this package's dense-radix ranges (the
reference never reads its table's entries).  On load the stored table is
skipped and the table is re-derived from the index on a device by the
build's own breadth-wise path (ops/kmer.py, through the ``occ`` kernel on
the card), so a loaded table is right whoever wrote the file; a file of
2**32 symbols and more derives it in the 64-bit layout (ops/wide.py,
through ``occ_wide``).  A ``.awry`` index carries no locate marks and no packed text: the engine serves it by
the classic path and the row-sampled walk (ops/locate.py).
"""

from __future__ import annotations

import io
import os
import struct

import numpy as np

from ..alphabet import Alphabet
from ..index import SYMBOLS_PER_BLOCK, WORDS_PER_WINDOW, FmIndexData
from ..ops.device_index import to_device
from ..ops.kmer import populate_kmer_table_device
from ..utils.bitpack import pack, packed_word_len, unpack

MAGIC = b"AWRY-Index\n"  # src/fm_index_file.rs:18

_MILESTONE_SLOTS = {Alphabet.NUCLEOTIDE: 8, Alphabet.AMINO: 24}  # src/bwt.rs:29,139


def save_awry(index: FmIndexData, path: str) -> None:
    """Serialize ``index`` to the reference's ``.awry`` layout."""
    alphabet = index.alphabet
    nv = alphabet.num_planes
    slots = _MILESTONE_SLOTS[alphabet]
    nb = index.num_blocks
    if index.kmer_len == 0:
        # The reference never writes kmer_len=0 and its loader mis-reads such
        # a file: get_range_for_kmer computes take((0u8 - 1) as usize), a u8
        # underflow that searches the query twice (src/kmer_lookup_table.rs:90-110).
        raise ValueError(
            "cannot save a kmer_len=0 index to .awry: the reference loader"
            " mis-searches such files; rebuild with kmer_len >= 1 or use the"
            " .npz artifact format"
        )

    with open(path, "wb") as f:
        f.write(MAGIC)
        header = np.array([index.version_number, index.sa_ratio, index.bwt_len, alphabet.value], dtype="<u8")
        f.write(header.tobytes())

        # Blocks: the bit-vectors, then the padded milestones, per block.
        planes = index.planes.astype("<u4").reshape(nb, nv * WORDS_PER_WINDOW)
        milestones = np.zeros((nb, slots), dtype="<u8")
        milestones[:, : alphabet.cardinality] = index.milestones.astype("<u8")
        block_bytes = np.empty((nb, nv * 32 + slots * 8), dtype=np.uint8)
        block_bytes[:, : nv * 32] = planes.view(np.uint8).reshape(nb, nv * 32)
        block_bytes[:, nv * 32 :] = milestones.view(np.uint8).reshape(nb, slots * 8)
        f.write(block_bytes)

        f.write(index.prefix_sums.astype("<u8"))
        f.write(pack(index.sampled_sa, index.bwt_len, index.sa_ratio).astype("<u8"))

        f.write(struct.pack("<B", index.kmer_len))
        f.write(np.ascontiguousarray(index.kmer_table, dtype="<u8"))  # (start, end) pairs, row-major

        f.write(struct.pack("<Q", len(index.headers)))
        for start, header_str in zip(index.seq_starts, index.headers):
            hb = header_str.encode()
            f.write(struct.pack("<QQ", int(start), len(hb)))
            f.write(hb)


def load_awry(path: str, *, device=None, strict: bool = False) -> FmIndexData:
    """Parse a ``.awry`` file (this package's, the JAX package's or AWRY's).

    The k-mer table is re-derived on ``device`` (None: the card, cuda:0,
    which raises without one; "cpu" runs the ``occ`` kernel's plain
    version), as the module docstring says.  Structural damage (truncation,
    absurd header fields, short sections) raises ValueError; ``strict=True``
    also runs the value-level checks (FmIndexData.validate(strict=True)) and
    refuses trailing bytes.  The format has no checksums, so a flipped bit
    in the planes is found by no loader."""
    index = _read_index(path, strict)
    # A text of 2**32 symbols and more ships in the 64-bit layout here.
    index.kmer_table = populate_kmer_table_device(to_device(index, device, minimal=True), index.kmer_len)
    index.validate(strict=strict)
    return index


def _read_index(path: str, strict: bool) -> FmIndexData:
    """The file's sections as an FmIndexData whose k-mer table is empty."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:

        def read_exact(n: int, what: str) -> bytes:
            b = f.read(n)
            if len(b) != n:
                raise ValueError(f"truncated .awry file: {what} needs {n} bytes, got {len(b)}")
            return b

        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError("not an .awry index file (bad magic)")
        version, sa_ratio, bwt_len, alphabet_idx = struct.unpack("<4Q", read_exact(32, "header"))
        alphabet = Alphabet(alphabet_idx)
        if sa_ratio < 1 or bwt_len < 1:
            raise ValueError(f".awry header out of range: sa_ratio={sa_ratio}, bwt_len={bwt_len}")
        nv = alphabet.num_planes
        slots = _MILESTONE_SLOTS[alphabet]
        nb = -(-bwt_len // SYMBOLS_PER_BLOCK)
        block_stride = nv * 32 + slots * 8
        if nb * block_stride > size:
            raise ValueError(f"truncated .awry file: {nb} blocks x {block_stride} B exceed the file")
        raw = np.frombuffer(read_exact(nb * block_stride, "block section"), dtype=np.uint8).reshape(nb, block_stride)
        planes = raw[:, : nv * 32].copy().view("<u4").reshape(nb, nv, WORDS_PER_WINDOW).astype(np.uint32)
        milestones = raw[:, nv * 32 :].copy().view("<u8")[:, : alphabet.cardinality].astype(np.uint64)
        del raw

        c = alphabet.cardinality
        prefix_sums = np.frombuffer(read_exact((c + 1) * 8, "prefix sums"), dtype="<u8").astype(np.uint64)
        n_words = packed_word_len(bwt_len, sa_ratio)
        packed = np.frombuffer(read_exact(n_words * 8, "packed suffix array"), dtype="<u8")
        sampled_sa = unpack(packed, bwt_len, sa_ratio)

        (kmer_len,) = struct.unpack("<B", read_exact(1, "kmer length"))
        n_entries = alphabet.num_encoding_symbols**kmer_len
        if f.tell() + n_entries * 16 > size:
            raise ValueError(f"truncated .awry file: kmer_len={kmer_len} table exceeds the file")
        f.seek(n_entries * 16, io.SEEK_CUR)  # the stored table: re-derived below

        (num_seqs,) = struct.unpack("<Q", read_exact(8, "sequence count"))
        if num_seqs * 16 > size - f.tell():
            raise ValueError(f"truncated .awry file: {num_seqs} sequence records")
        seq_starts = np.zeros(num_seqs, dtype=np.int64)
        headers: list[str] = []
        for i in range(num_seqs):
            start, hlen = struct.unpack("<QQ", read_exact(16, f"sequence record {i}"))
            seq_starts[i] = start
            headers.append(read_exact(hlen, f"header {i}").decode("utf-8", errors="replace"))
        if strict and f.read(1):
            raise ValueError("trailing bytes after the .awry sequence index")

    return FmIndexData(
        alphabet=alphabet,
        planes=planes,
        milestones=milestones,
        prefix_sums=prefix_sums,
        sampled_sa=sampled_sa,
        sa_ratio=int(sa_ratio),
        bwt_len=int(bwt_len),
        kmer_table=np.zeros((0, 2), dtype=np.uint64),  # filled by load_awry
        kmer_len=int(kmer_len),
        seq_starts=seq_starts,
        headers=headers,
        version_number=int(version),
    )
