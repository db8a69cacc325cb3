"""The FM-index on the card: the few tensors the serving paths read.

``to_device(index, device)`` ships only what those paths touch:

* ``blocks`` - fused block rows: V*8 occurrence-plane words, the
  per-symbol milestones, then the 8 mark words and the mark milestone
  (zero on an index without marks), padded to a multiple of 8 words (40
  for nucleotide, 72 for amino);
* ``prefix_sums`` - the C array;
* ``kmer_flat`` - the k-mer seed table, flat (word 2a = start, 2a+1 = end);
* ``text_packed`` - the packed text with TEXT_PAD_WORDS zero words in
  front, so the verify compare's backward window read never clamps into
  real text;
* ``text_sampled_sa`` - the SA values of the marked rows in row order
  (ceil(bwt_len / mark_ratio) of them; every row at mark ratio 1);
* ``sampled_sa`` - indexes without marks only (loaded from ``.awry``
  files): the SA at every sa_ratio-th row, which the row-sampled walk reads;
* ``seq_starts`` - record starts, for localization;
* ``codes`` / ``c2i`` / ``dense`` - the symbol -> occurrence code, code ->
  symbol and symbol -> dense k-mer digit tables;
* ``vw_flat`` - slot-capable indexes only (slot_regime_capable): the slim
  fat rows of the slot-verify regime, flat (build_verify_windows).

A table the index lacks ships as a one-word placeholder: text_packed
without packed text, text_sampled_sa without marks, sampled_sa with them.
``to_device(index, device, minimal=True)`` ships only what a rank reads
(fused rows, prefix sums, codes): the device k-mer build (ops/kmer.py); a
text of 2**32 symbols and more takes the 64-bit layout's minimal ship
(``to_device_wide(minimal=True)``).

Tables are int32 tensors holding the uint32 bit patterns (numpy views, not
value casts); prefix sums and record starts are int64.  A text of 2**32
symbols and more ships through ops/wide.py instead (``to_device_wide``):
the same fields, SA values and the k-mer table int64, and ``bases`` set.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..alphabet import Alphabet, code_to_index_table, index_to_code_table, index_to_dense_table
from ..index import FmIndexData
from .kernels import WideBases, as_int32_bits

TEXT_PAD_WORDS = 64  # zero words prepended to the device text (ops/verify.py)

# Slot-verify regime (ops/verify.py count_locate_slots_t): when the k-mer
# seed alone narrows the expected range width to ~1, every lane's candidate
# rows are verified straight off slim fat rows, with no post-seed rank step.
# Capable when every row is marked (the fat row carries its SA value), the
# expected seed width bwt_len / base^k is small enough that few lanes
# exceed WIDE_CAP candidates, and the 16 B/row fat table stays affordable.
SLOT_REGIME_MAX_ROWS = 1 << 28
SLOT_WIDTH_MAX = 1.6
SLOT_ROW_WORDS = 4  # slim fat row: 3 window words + the row's SA value
_BUILD_CHUNK = 1 << 22  # fat rows assembled per pass (bounds the temporaries)


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
    """Assemble the fused uint32[num_blocks, row_words] block array (the
    mark words and milestone stay zero on an index without marks)."""
    nb = index.num_blocks
    v = index.alphabet.num_planes
    c = index.alphabet.cardinality
    fused = np.zeros((nb, fused_row_words(index.alphabet)), dtype=np.uint32)
    fused[:, : v * 8] = index.planes.reshape(nb, v * 8)
    fused[:, v * 8 : v * 8 + c] = index.milestones.astype(np.uint32)
    if index.has_marks:
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
    text_sampled_sa: torch.Tensor  # int32 [ceil(bwt_len / mark_ratio)] (marked indexes)
    seq_starts: torch.Tensor  # int64 [num_records]
    codes: torch.Tensor  # int32 [cardinality]: symbol index -> occurrence code
    c2i: torch.Tensor  # int32 [2**num_planes]: occurrence code -> symbol index
    dense: torch.Tensor  # int64 [cardinality]: symbol index -> dense k-mer digit or -1
    alphabet: Alphabet
    bwt_len: int
    kmer_len: int
    mark_ratio: int  # the marked walk takes at most mark_ratio - 1 steps (sa_ratio without marks)
    has_marks: bool  # False: lf_walk takes the row-sampled walk over sampled_sa
    sa_ratio: int
    sampled_sa: torch.Tensor  # int32 [ceil(bwt_len / sa_ratio)] (indexes without marks)
    # Slot regime: int32 [(bwt_len + pad) * vw_row_words] fat rows aligned
    # at the seed step verify_windows_s = kmer_len, with verify_windows_w
    # window words each; None when the index is served by the switch step.
    vw_flat: torch.Tensor | None = None
    verify_windows_s: int = 0
    verify_windows_w: int = 0
    vw_row_words: int = SLOT_ROW_WORDS
    # The 64-bit index (ops/wide.py): the group bases its rows' milestones
    # and mark milestones are relative to; None on the narrow index.
    bases: WideBases | None = None

    @property
    def wide(self) -> bool:
        return self.bases is not None

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


def slot_regime_capable(index: FmIndexData) -> bool:
    """The index can be served by the slot-verify regime (see SLOT_WIDTH_MAX)."""
    base = index.alphabet.num_encoding_symbols
    return (
        index.resolved_mark_ratio == 1
        and index.has_marks
        and index.text_packed is not None
        and index.kmer_len >= 2
        and index.bwt_len <= SLOT_REGIME_MAX_ROWS
        and index.bwt_len <= SLOT_WIDTH_MAX * base**index.kmer_len
    )


def build_verify_windows(text_packed: torch.Tensor, sa: torch.Tensor, bits: int,
                         row_words: int = SLOT_ROW_WORDS) -> torch.Tensor:
    """The slot regime's fat rows, flat: int32[(rows + pad) * row_words] on
    the tensors' device, built by plain tensor ops.

    Row r, with SA value p = sa[r], holds in word i < w = row_words - 1 the
    symbols at text positions p - 1 - spw*i - t at bits bits*t (t < spw =
    32 // bits; positions below 0 read the zero padding), and p in word w:
    the symbol at query-end distance d >= s sits at a fixed bit of word
    (d - s) // spw when the search stopped at step s on this row.  A zero
    row pads the row count so that the flat length is a multiple of 8 words.

    text_packed: int32 packed text with TEXT_PAD_WORDS zero words in front
    (as shipped); sa: int32 bit patterns, the SA value of every BWT row
    (text_sampled_sa at mark ratio 1)."""
    spw = 32 // bits
    w = row_words - 1
    device = text_packed.device
    shifts = torch.arange(0, 32, bits, device=device)
    # Symbols of the padded text: text position x sits at x + TEXT_PAD_WORDS * spw.
    syms = ((text_packed[:, None] >> shifts.to(torch.int32)) & ((1 << bits) - 1)).reshape(-1).to(torch.uint8)
    back = torch.arange(spw * w, device=device)  # position p - 1 - j in column j
    n = sa.shape[0]
    pad = 1 if (n * row_words) % 8 else 0
    fat = torch.zeros((n + pad, row_words), dtype=torch.int32, device=device)
    for lo in range(0, n, _BUILD_CHUNK):
        p = sa[lo : lo + _BUILD_CHUNK].to(torch.int64) & 0xFFFFFFFF
        g = syms[(p + TEXT_PAD_WORDS * spw - 1)[:, None] - back].to(torch.int64)
        words = (g.reshape(-1, w, spw) << shifts).sum(dim=2)  # disjoint bits: the sum is the OR
        fat[lo : lo + p.shape[0], :w] = as_int32_bits(words)
        fat[lo : lo + p.shape[0], w] = sa[lo : lo + _BUILD_CHUNK]
    return fat.reshape(-1)


def to_device(index: FmIndexData, device=None, *, minimal: bool = False, slots: bool = True) -> FmDeviceIndex:
    """Ship a host index to ``device`` (None: the card, see resolve_device).
    An index without marks or packed text (loaded from a ``.awry`` file)
    ships for the classic path and the row-sampled walk.

    ``minimal``: ship only the fused rows, prefix sums and codes (the other
    tables are one-word placeholders and kmer_len is 0); past 2**32 symbols
    in the 64-bit layout (ops/wide.py), whose ranks go through ``occ_wide``.
    ``slots``: ship the slot regime's fat rows when slot_regime_capable
    holds (False: never)."""
    device = resolve_device(device)
    if index.bwt_len >= 2**32:
        if minimal:
            from .wide import to_device_wide

            return to_device_wide(index, device, minimal=True)
        raise NotImplementedError(
            f"bwt_len={index.bwt_len}: a text of 2**32 symbols and more ships through the 64-bit layout: "
            "FmQueryEngine(index, wide=True) or ops.wide.to_device_wide"
        )

    def put(arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(device)

    placeholder = put(np.zeros(1, dtype=np.int32))
    rank_tables = dict(
        blocks=put(build_fused_blocks(index).view(np.int32)),
        prefix_sums=put(index.prefix_sums.astype(np.int64)),
        codes=put(index_to_code_table(index.alphabet).astype(np.int32)),
        c2i=put(code_to_index_table(index.alphabet).astype(np.int32)),
        dense=put(index_to_dense_table(index.alphabet).astype(np.int64)),
        seq_starts=put(index.seq_starts.astype(np.int64)),
        alphabet=index.alphabet,
        bwt_len=int(index.bwt_len),
        mark_ratio=int(index.resolved_mark_ratio),
        has_marks=index.has_marks,
        sa_ratio=int(index.sa_ratio),
    )
    if minimal:
        return FmDeviceIndex(
            **rank_tables, kmer_flat=placeholder, text_packed=placeholder, text_sampled_sa=placeholder,
            sampled_sa=placeholder, kmer_len=0,
        )
    text_packed = placeholder
    if index.text_packed is not None:
        text = np.concatenate(
            [np.zeros(TEXT_PAD_WORDS, dtype=np.uint32), np.asarray(index.text_packed, dtype=np.uint32)]
        )
        text_packed = put(text.view(np.int32))
    sa = put(_u32_bits(index.text_sampled_sa)) if index.has_marks else placeholder
    slot_rows = {}
    if slots and slot_regime_capable(index):
        bits = 4 if index.alphabet.cardinality <= 16 else 8
        slot_rows = dict(
            vw_flat=build_verify_windows(text_packed, sa, bits),
            verify_windows_s=int(index.kmer_len),
            verify_windows_w=SLOT_ROW_WORDS - 1,
        )
    return FmDeviceIndex(
        **rank_tables,
        kmer_flat=put(_u32_bits(index.kmer_table).reshape(-1)),
        text_packed=text_packed,
        text_sampled_sa=sa,
        sampled_sa=placeholder if index.has_marks else put(_u32_bits(index.sampled_sa)),
        kmer_len=int(index.kmer_len),
        **slot_rows,
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
