"""awry_tpu_torch: the FM-index engine in PyTorch with CUDA kernels for Hopper.

A port of ``awry_tpu`` (JAX on a TPU) that imports nothing of it.  The host
layer (alphabet, index, FASTA/FASTQ reader, SA-IS builder, k-mer table) is
the port's own copy; the query engine (``awry_tpu_torch.ops``) serves the
seed-walk-verify count+locate path on one NVIDIA H100 through two
hand-written CUDA kernels (``ops/kernels.py``, ``csrc/``).

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from .alphabet import Alphabet
from .build.builder import build_from_records, build_index
from .index import FmBuildArgs, FmIndexData

__all__ = [
    "Alphabet",
    "FmBuildArgs",
    "FmIndexData",
    "build_index",
    "build_from_records",
]
