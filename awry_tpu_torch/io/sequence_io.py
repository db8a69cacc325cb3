"""FASTA/FASTQ ingestion with the reference's concatenation semantics.

The port's copy of the in-memory parsers of ``awry_tpu/io/sequence_io.py``:
multi-record inputs are concatenated into one canonical text with a single
delimiter character between records ('N' for nucleotide, 'X' for amino), and
the per-record start offsets + headers are kept for localizing results.  The
virtual sentinel is NOT part of the text; the suffix-array builder appends it
(bwt_len == len(text) + 1).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..alphabet import Alphabet, normalize_text


@dataclasses.dataclass
class SequenceData:
    """Concatenated canonical text plus per-record metadata."""

    text: np.ndarray  # uint8, canonical bytes, no sentinel
    start_positions: np.ndarray  # int64[num_records]
    headers: list[str]


# Whitespace removed from FASTA sequence bodies.
_SEQ_WHITESPACE = b" \t\x0b\x0c\r"


def parse_fasta(data: bytes) -> list[tuple[str, bytes]]:
    """Parse FASTA bytes into (header, sequence) records: a header is a line
    whose FIRST byte is '>', headers are whitespace-stripped, and all ASCII
    whitespace inside sequence regions is dropped."""
    records: list[tuple[str, bytes]] = []
    header: str | None = None
    chunks: list[bytes] = []
    for line in data.split(b"\n"):
        if line.startswith(b">"):
            if header is not None:
                records.append((header, b"".join(chunks)))
            header = line[1:].strip().decode("utf-8", errors="replace")
            chunks = []
        else:
            body = line.translate(None, _SEQ_WHITESPACE)
            if not body:
                continue
            if header is None:
                raise ValueError("FASTA data before first '>' header")
            chunks.append(body)
    if header is not None:
        records.append((header, b"".join(chunks)))
    return records


def parse_fastq(data: bytes) -> list[tuple[str, bytes]]:
    """Parse FASTQ bytes into (header, sequence) records (4-line records)."""
    lines = [ln for ln in data.split(b"\n") if ln.strip()]
    if len(lines) % 4 != 0:
        raise ValueError("FASTQ record count is not a multiple of 4 lines")
    records: list[tuple[str, bytes]] = []
    for i in range(0, len(lines), 4):
        head, seq, plus, _qual = lines[i : i + 4]
        if not head.startswith(b"@") or not plus.startswith(b"+"):
            raise ValueError(f"malformed FASTQ record at line {i}")
        records.append((head[1:].decode("utf-8", errors="replace").strip(), seq.strip()))
    return records


def _looks_like_fastq(path: str, data: bytes) -> bool:
    lower = os.path.basename(path).lower()
    if lower.endswith((".fq", ".fastq")):
        return True
    if lower.endswith((".fa", ".fasta", ".fna", ".faa")):
        return False
    return data[:1] == b"@"


def concat_records(records: list[tuple[str, bytes]], alphabet: Alphabet) -> SequenceData:
    """Join records with one delimiter char between them and normalize bytes."""
    if not records:
        raise ValueError("input contains no sequence records")
    delim = alphabet.delimiter
    headers = [h for h, _ in records]
    starts = np.empty(len(records), dtype=np.int64)
    pieces: list[bytes] = []
    offset = 0
    for i, (_, seq) in enumerate(records):
        if i > 0:
            pieces.append(delim)
            offset += 1
        starts[i] = offset
        pieces.append(seq)
        offset += len(seq)
    raw = b"".join(pieces)
    return SequenceData(text=normalize_text(alphabet, raw), start_positions=starts, headers=headers)


def read_sequence_file(path: str, alphabet: Alphabet) -> SequenceData:
    """Read a FASTA or FASTQ file (whole file in memory) into concatenated
    canonical text."""
    with open(path, "rb") as f:
        data = f.read()
    records = parse_fastq(data) if _looks_like_fastq(path, data) else parse_fasta(data)
    return concat_records(records, alphabet)
