"""awry_tpu_torch: the FM-index engine in PyTorch with CUDA kernels for Hopper.

A port of ``awry_tpu`` (JAX on a TPU) that imports nothing of it.  The host
layer (alphabet, index, FASTA/FASTQ readers, SA-IS builder, k-mer table,
the ``.npz`` and ``.awry`` index files) is the port's own copy; the query
engine (``awry_tpu_torch.ops``) serves count+locate on one NVIDIA H100
through six hand-written CUDA kernels (``ops/kernels.py``, ``csrc/``):
``window_read``, ``occ_pair``, ``occ``, ``backstep``, ``marked_walk`` and
``sampled_walk``.  ``FmIndex`` is the reference's public surface over that
engine, and ``python -m awry_tpu_torch`` its command line.

Entry points run on the card unless the caller passes ``device="cpu"``.
``awry_tpu_torch.parallel.PartitionedFmIndex`` federates indexes of record
groups (the partitioned pan-genome configuration).

The names that need torch (the facade and the ``.awry`` format, which
re-derives its k-mer table on a device) load on first use, so the host
layer (alphabet, index, builder, ``.npz`` artifact) imports without torch:
the federation's spawned build workers use only it.
"""

import importlib

from .alphabet import Alphabet, Symbol
from .build.builder import build_from_records, build_index
from .index import FmBuildArgs, FmIndexData
from .io.artifact import load_artifact, save_artifact

_LAZY = {
    "FmIndex": ".fm_index",
    "LocalizedSequencePosition": ".fm_index",
    "SearchRange": ".fm_index",
    "load_awry": ".io.awry_format",
    "save_awry": ".io.awry_format",
}


def __getattr__(name: str):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Alphabet",
    "Symbol",
    "FmIndex",
    "SearchRange",
    "LocalizedSequencePosition",
    "FmBuildArgs",
    "FmIndexData",
    "build_index",
    "build_from_records",
    "save_awry",
    "load_awry",
    "save_artifact",
    "load_artifact",
]
