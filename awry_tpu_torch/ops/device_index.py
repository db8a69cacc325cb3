"""The FM-index on the card: the few tensors the seed-walk-verify path reads.

``to_device(index, device)`` ships only what that path touches:

* ``blocks`` - fused block rows: V*8 occurrence-plane words, the
  per-symbol milestones, then the 8 mark words and the mark milestone,
  padded to a multiple of 8 words (40 for nucleotide, 72 for amino);
* ``prefix_sums`` - the C array;
* ``kmer_flat`` - the k-mer seed table, flat (word 2a = start, 2a+1 = end);
* ``text_packed`` - the packed text with TEXT_PAD_WORDS zero words in
  front, so the verify compare's backward window read never clamps into
  real text;
* ``text_sampled_sa`` - the SA values of the marked rows in row order
  (ceil(bwt_len / mark_ratio) of them; every row at mark ratio 1);
* ``seq_starts`` - record starts, for localization;
* ``codes`` / ``c2i`` / ``dense`` - the symbol -> occurrence code, code ->
  symbol and symbol -> dense k-mer digit tables.

Tables are int32 tensors holding the uint32 bit patterns (numpy views, not
value casts); prefix sums and record starts are int64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..alphabet import Alphabet, code_to_index_table, index_to_code_table, index_to_dense_table
from ..index import FmIndexData

TEXT_PAD_WORDS = 64  # zero words prepended to the device text (ops/verify.py)


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names a device: None -> cuda:0, and with
    no CUDA device that raises instead of continuing on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the host"
            )
        device = "cuda:0"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def fused_row_words(alphabet: Alphabet) -> int:
    """uint32 words per fused block row: V*8 plane words + cardinality
    milestone words + 8 mark words + 1 mark milestone, padded to a multiple
    of 8 (40 words nucleotide, 72 amino)."""
    raw = alphabet.num_planes * 8 + alphabet.cardinality + 9
    return -(-raw // 8) * 8


def build_fused_blocks(index: FmIndexData) -> np.ndarray:
    """Assemble the fused uint32[num_blocks, row_words] block array."""
    nb = index.num_blocks
    v = index.alphabet.num_planes
    c = index.alphabet.cardinality
    fused = np.zeros((nb, fused_row_words(index.alphabet)), dtype=np.uint32)
    fused[:, : v * 8] = index.planes.reshape(nb, v * 8)
    fused[:, v * 8 : v * 8 + c] = index.milestones.astype(np.uint32)
    off = v * 8 + c
    fused[:, off : off + 8] = index.mark_bits
    fused[:, off + 8] = index.mark_milestones
    return fused


@dataclasses.dataclass(frozen=True)
class FmDeviceIndex:
    blocks: torch.Tensor  # int32 [num_blocks, row_words]
    prefix_sums: torch.Tensor  # int64 [cardinality + 1]
    kmer_flat: torch.Tensor  # int32 [2 * base**kmer_len]
    text_packed: torch.Tensor  # int32 [TEXT_PAD_WORDS + text words]
    text_sampled_sa: torch.Tensor  # int32 [ceil(bwt_len / mark_ratio)]
    seq_starts: torch.Tensor  # int64 [num_records]
    codes: torch.Tensor  # int32 [cardinality]: symbol index -> occurrence code
    c2i: torch.Tensor  # int32 [2**num_planes]: occurrence code -> symbol index
    dense: torch.Tensor  # int64 [cardinality]: symbol index -> dense k-mer digit or -1
    alphabet: Alphabet
    bwt_len: int
    kmer_len: int
    mark_ratio: int  # the LF walk takes at most mark_ratio - 1 steps

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @property
    def num_planes(self) -> int:
        return self.alphabet.num_planes

    @property
    def mark_offset(self) -> int:
        """Word of the 8 mark words in a fused row (the mark milestone follows)."""
        return self.num_planes * 8 + self.alphabet.cardinality


def _u32_bits(arr: np.ndarray) -> np.ndarray:
    """uint32 values -> the same bits as int32 (a view when already uint32)."""
    return np.ascontiguousarray(np.asarray(arr, dtype=np.uint32)).view(np.int32)


def to_device(index: FmIndexData, device=None) -> FmDeviceIndex:
    """Ship a host index to ``device`` (None: the card, see resolve_device)."""
    device = resolve_device(device)
    if index.bwt_len >= 2**32:
        raise NotImplementedError(
            "texts of 4 Gbp and more need the 64-bit engine, not ported yet (ROADMAP Queue 1 item 11)"
        )
    if not index.has_marks or index.text_packed is None:
        raise NotImplementedError(
            "indexes without locate marks or packed text (loaded from AWRY's own "
            "files) need the row-sampled walk and the classic-only engine, not "
            "ported yet (ROADMAP Queue 1 item 14)"
        )

    def put(arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(device)

    text = np.concatenate(
        [np.zeros(TEXT_PAD_WORDS, dtype=np.uint32), np.asarray(index.text_packed, dtype=np.uint32)]
    )
    return FmDeviceIndex(
        blocks=put(build_fused_blocks(index).view(np.int32)),
        prefix_sums=put(index.prefix_sums.astype(np.int64)),
        kmer_flat=put(_u32_bits(index.kmer_table).reshape(-1)),
        text_packed=put(text.view(np.int32)),
        text_sampled_sa=put(_u32_bits(index.text_sampled_sa)),
        seq_starts=put(index.seq_starts.astype(np.int64)),
        codes=put(index_to_code_table(index.alphabet).astype(np.int32)),
        c2i=put(code_to_index_table(index.alphabet).astype(np.int32)),
        dense=put(index_to_dense_table(index.alphabet).astype(np.int64)),
        alphabet=index.alphabet,
        bwt_len=int(index.bwt_len),
        kmer_len=int(index.kmer_len),
        mark_ratio=int(index.resolved_mark_ratio),
    )


def from_numpy_index(arrays: dict[str, np.ndarray], meta: dict) -> FmIndexData:
    """Carry an index built elsewhere (for example by the JAX package) into
    the port's FmIndexData: ``arrays`` holds its FmIndexData array fields as
    numpy arrays, ``meta`` the scalar fields and headers, with ``alphabet``
    given by name ("NUCLEOTIDE" / "AMINO") or as an Alphabet."""
    meta = dict(meta)
    alphabet = meta.pop("alphabet")
    if isinstance(alphabet, str):
        alphabet = Alphabet[alphabet]
    names = {f.name for f in dataclasses.fields(FmIndexData)}
    fields = {k: np.asarray(v) for k, v in arrays.items()}
    fields.update(meta)
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"not FmIndexData fields: {sorted(unknown)}")
    index = FmIndexData(alphabet=alphabet, **fields)
    index.validate()
    return index
