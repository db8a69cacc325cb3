"""FmIndex facade: the reference library's public API over the port's engine.

The port's copy of ``awry_tpu/fm_index.py``.  Everything AWRY exports has a
named equivalent here:

  FmIndex::new(args)               -> FmIndex.new(args)
  FmIndex::load / save             -> FmIndex.load / FmIndex.save (.awry or .npz)
  count_string / locate_string     -> count_string / locate_string
  parallel_count / parallel_locate -> parallel_count / parallel_locate
  update_range_with_symbol         -> update_range_with_symbol
  backstep                         -> backstep
  initial_search_range             -> initial_search_range
  alphabet/bwt_len/prefix_sums/suffix_array_compression_ratio/version_number
                                   -> the same names
  SearchRange (src/search.rs)      -> SearchRange
  LocalizedSequencePosition        -> LocalizedSequencePosition

Every query runs on ``device`` (None: the card, cuda:0, which raises
without one; "cpu" runs the kernels' plain versions): the batch calls and
the scalar string calls through the FmQueryEngine built with the facade,
the search primitives through ops.rank on one-element tensors.  A failed
engine construction raises; nothing falls back to another device.  An index
of 2**32 symbols and more is served in the 64-bit layout (ops/wide.py):
``update_range_with_symbol`` and ``backstep`` then launch the wide variants
of ``occ_pair`` and ``backstep``; ``wide=True`` forces that on any index.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .alphabet import Alphabet, Symbol
from .index import FmBuildArgs, FmIndexData
from .io.artifact import load_artifact, save_artifact
from .io.awry_format import MAGIC, load_awry, save_awry
from .ops import rank
from .ops.engine import FmQueryEngine


@dataclasses.dataclass
class SearchRange:
    """Inclusive BWT interval [start_ptr, end_ptr]; empty iff start > end
    (reference: src/search.rs:22-80)."""

    start_ptr: int
    end_ptr: int

    @classmethod
    def zero(cls) -> "SearchRange":
        return cls(start_ptr=1, end_ptr=0)

    def is_empty(self) -> bool:
        return self.start_ptr > self.end_ptr

    def len(self) -> int:
        return 0 if self.is_empty() else self.end_ptr - self.start_ptr + 1

    def __len__(self) -> int:
        return self.len()

    def range_iter(self) -> range:
        return range(0, 0) if self.is_empty() else range(self.start_ptr, self.end_ptr + 1)


@dataclasses.dataclass(frozen=True, order=True)
class LocalizedSequencePosition:
    """(record index, position within the record) of a hit (reference:
    src/sequence_index.rs:31-78)."""

    _sequence_idx: int
    _local_position: int

    @classmethod
    def new(cls, sequence_idx: int, local_position: int) -> "LocalizedSequencePosition":
        return cls(sequence_idx, local_position)

    def sequence_idx(self) -> int:
        return self._sequence_idx

    def local_position(self) -> int:
        return self._local_position


def save_index(data: FmIndexData, path: str) -> None:
    """Save to ``.awry`` (the reference's format) when the path ends so,
    else as the native ``.npz`` artifact."""
    if path.endswith(".awry"):
        save_awry(data, path)
    else:
        save_artifact(data, path)


def load_index(path: str, *, device=None) -> FmIndexData:
    """Load an index file, by its magic: ``.awry`` (its k-mer table
    re-derived on ``device``) or the ``.npz`` artifact."""
    with open(path, "rb") as f:
        head = f.read(len(MAGIC))
    if head == MAGIC:
        return load_awry(path, device=device)
    return load_artifact(path)


class FmIndex:
    """The reference's FM-index handle over FmIndexData, served by an
    FmQueryEngine on ``device``."""

    def __init__(self, data: FmIndexData, *, device=None, wide: bool | None = None):
        self.data = data
        self.engine = FmQueryEngine(data, device=device, wide=wide)

    @property
    def device(self) -> torch.device:
        return self.engine.device

    # -- construction / persistence ---------------------------------------
    @classmethod
    def new(cls, args: FmBuildArgs, *, device=None) -> "FmIndex":
        """Build from a FASTA/FASTQ file (reference: FmIndex::new)."""
        from .build.builder import build_index

        return cls(build_index(args, device=device), device=device)

    @classmethod
    def load(cls, path: str, *, device=None) -> "FmIndex":
        """Load a ``.awry`` or ``.npz`` index file, chosen by sniffing it."""
        return cls(load_index(path, device=device), device=device)

    def save(self, path: str) -> None:
        """Save as ``.awry`` when the path ends so, else as ``.npz``."""
        save_index(self.data, path)

    # -- queries -----------------------------------------------------------
    def count_string(self, query) -> int:
        """Occurrences of one query (src/fm_index.rs:499-501)."""
        return self.engine.count(query)

    def locate_string(self, query) -> list[LocalizedSequencePosition]:
        """Hits of one query in BWT-row order (src/fm_index.rs:516-544)."""
        return [LocalizedSequencePosition(s, p) for s, p in self.engine.locate(query)]

    def parallel_count(self, queries) -> np.ndarray:
        """Counts of a batch (the reference's rayon par_iter; here one
        batch on the device)."""
        return self.engine.count_batch(list(queries))

    def parallel_locate(self, queries) -> list[list[LocalizedSequencePosition]]:
        """Hits of each query of a batch, in BWT-row order."""
        return [
            [LocalizedSequencePosition(s, p) for s, p in hits] for hits in self.engine.locate_batch(list(queries))
        ]

    # -- search primitives (the reference's public surface) ----------------
    def _one(self, value: int) -> torch.Tensor:
        return torch.tensor([value], dtype=torch.int64, device=self.device)

    def initial_search_range(self, symbol: Symbol) -> SearchRange:
        """The range of one symbol (src/fm_index.rs:383-385)."""
        s, e = rank.seed_range(self.engine.device_index, self._one(symbol.index()))
        return SearchRange(int(s[0]), int(e[0]))

    def update_range_with_symbol(self, search_range: SearchRange, symbol: Symbol) -> SearchRange:
        """One LF-mapping step of a range (src/fm_index.rs:559-582): an
        ``occ_pair`` launch on the card (``occ_pair_wide`` on a wide index)."""
        s, e = rank.update_range(
            self.engine.device_index,
            self._one(search_range.start_ptr),
            self._one(search_range.end_ptr),
            self._one(symbol.index()),
        )
        return SearchRange(int(s[0]), int(e[0]))

    def backstep(self, search_pointer: int) -> int:
        """One LF step of a row (src/fm_index.rs:585-593): a ``backstep``
        launch on the card (``backstep_wide`` on a wide index)."""
        return int(rank.backstep(self.engine.device_index, self._one(search_pointer))[0])

    # -- accessors ----------------------------------------------------------
    def alphabet(self) -> Alphabet:
        return self.data.alphabet

    def bwt_len(self) -> int:
        return self.data.bwt_len

    def prefix_sums(self) -> np.ndarray:
        return self.data.prefix_sums

    def suffix_array_compression_ratio(self) -> int:
        return self.data.sa_ratio

    def version_number(self) -> int:
        return self.data.version_number

    def memory_report(self) -> dict[str, int]:
        return self.data.memory_report()
