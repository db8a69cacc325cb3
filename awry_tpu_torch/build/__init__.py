from .builder import build_from_records, build_from_sequence_data, build_index
from .suffix_array import build_suffix_array

__all__ = [
    "build_index",
    "build_from_records",
    "build_from_sequence_data",
    "build_suffix_array",
]
