from .device_index import (
    FmDeviceIndex,
    build_fused_blocks,
    build_verify_windows,
    from_numpy_index,
    fused_row_words,
    slot_regime_capable,
    to_device,
)
from .engine import FmQueryEngine
from .kernels import (
    backstep,
    backstep_plain,
    marked_walk,
    marked_walk_plain,
    occ,
    occ_pair,
    occ_pair_plain,
    occ_plain,
    window_read,
    window_read_plain,
)
from .kmer import populate_kmer_table_device
from .locate import count_locate_capped_t, lf_walk
from .rank import backstep_mark, occurrence, occurrence_plain, seed_range, symbol_at, update_range
from .search import count_batch_kernel_t, counts_from_ranges, search_ranges_t
from .verify import count_locate_slots_t, count_locate_verify_t, switch_step

__all__ = [
    "FmDeviceIndex",
    "FmQueryEngine",
    "backstep",
    "backstep_mark",
    "backstep_plain",
    "build_fused_blocks",
    "build_verify_windows",
    "count_batch_kernel_t",
    "count_locate_capped_t",
    "count_locate_slots_t",
    "count_locate_verify_t",
    "counts_from_ranges",
    "from_numpy_index",
    "fused_row_words",
    "lf_walk",
    "marked_walk",
    "marked_walk_plain",
    "occ",
    "occ_pair",
    "occ_pair_plain",
    "occ_plain",
    "occurrence",
    "occurrence_plain",
    "populate_kmer_table_device",
    "search_ranges_t",
    "seed_range",
    "slot_regime_capable",
    "switch_step",
    "symbol_at",
    "to_device",
    "update_range",
    "window_read",
    "window_read_plain",
]
