import importlib

from .artifact import load_artifact, save_artifact
from .sequence_io import (
    STREAM_THRESHOLD_BYTES,
    SequenceData,
    concat_records,
    parse_fasta,
    parse_fastq,
    read_sequence_file,
    stream_fasta,
    stream_fastq,
)

__all__ = [
    "STREAM_THRESHOLD_BYTES",
    "SequenceData",
    "concat_records",
    "load_artifact",
    "load_awry",
    "parse_fasta",
    "parse_fastq",
    "read_sequence_file",
    "save_artifact",
    "save_awry",
    "stream_fasta",
    "stream_fastq",
]


def __getattr__(name: str):
    # The .awry reader re-derives its k-mer table on a device: it loads torch
    # on first use, so that the artifact and the readers import without it.
    if name in ("load_awry", "save_awry"):
        return getattr(importlib.import_module(".awry_format", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
