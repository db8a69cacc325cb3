from .sequence_io import SequenceData, concat_records, parse_fasta, parse_fastq, read_sequence_file

__all__ = [
    "SequenceData",
    "concat_records",
    "parse_fasta",
    "parse_fastq",
    "read_sequence_file",
]
