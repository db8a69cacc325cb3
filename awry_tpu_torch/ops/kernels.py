"""The hand-written Hopper kernels, their plain PyTorch versions, the nvcc
build and the ctypes binding.

Six kernels (sources under ``csrc/``, each with a note on the TPU kernel
it replaces, its bound and its design):

* ``window_read(flat, wbase, k)`` - ``words[i, j] = flat[clamp(wbase[i],
  k-1, len-1) - j]``: the k-mer seed pair, the SA reads (mark=1: the row's
  SA value; mark>1: the marked SA value at the mark rank, k=1) and the
  verify text window.
* ``occ_pair(blocks, pos_a, pos_b, sym, codes, nplanes)`` - both endpoint
  ranks of an LF range update from the fused block rows.
* ``occ(blocks, pos, sym, codes, nplanes)`` - one rank per request (the
  device k-mer build ranks every range update's two endpoints as one batch).
* ``backstep(blocks, rows, prefix_sums, codes, c2i, nplanes, mark_offset,
  ambiguity_idx)`` - one marked-walk visit per row: the LF-stepped row and
  the packed (mark_rank << 1) | mark_bit.
* ``marked_walk(blocks, rows, prefix_sums, codes, c2i, nplanes,
  mark_offset, ambiguity_idx, mark_ratio, sampled_sa, bwt_len)`` - the
  whole marked LF walk of each row to its text position in one launch
  (the locate walk at mark ratio > 1); ``marked_walk_ranges(blocks, starts,
  counts, cap, ...)`` the same walks fed by query ranges into a ``[B,
  cap]`` output, as the classic path asks for them (one kernel, the
  sampled walk's refill schedule with the marked stop rule; counted under
  ``marked_walk``).
* ``sampled_walk(blocks, rows, prefix_sums, codes, c2i, nplanes,
  ambiguity_idx, sa_ratio, sampled_sa, bwt_len)`` - the reference's
  row-sampled LF walk of each row to its text position in one launch (the
  locate walk of an index without marks, loaded from a ``.awry`` file);
  ``sampled_walk_ranges(blocks, starts, counts, cap, ...)`` the same walks
  fed by query ranges into a ``[B, cap]`` output, as the classic path asks
  for them (one kernel for both, counted under ``sampled_walk``).

The 64-bit engine (ops/wide.py) runs four wide variants, each its narrow
twin's CUDA template instantiated over the group bases (``WideBases``: a
wide index's rows hold milestones and mark milestones relative to their
group of blocks) and 64-bit values: ``occ_pair_wide`` (int64 ranks),
``backstep_wide`` (int64 step and whole mark rank), ``marked_walk_wide`` /
``marked_walk_ranges_wide`` (int64 SA values) and ``sampled_walk_wide`` /
``sampled_walk_ranges_wide``
(64-bit rows, steps and SA values; a 64-bit quotient for an sa_ratio that is
no power of two), and ``occ_wide`` (int64 ranks: the device k-mer build of a
wide index).  Each keeps its plain version beside it, in int64.

The range-sharded engine (parallel/sharding.py, Mode B) runs two shard
kernels, each over one shard's window of blocks (the shard's rows, the
global index of its first block and the block count of the whole table),
each writing only what its window owns, in place: ``occ_pair_shard``
finishes an LF range update (``rank.update_range``) for the endpoints whose
(clamped) block lies in the window, so the shards together write every
entry once; ``sampled_walk_shard`` (the sampled walk's template) walks a
round's rows while they stay unsampled in the window.

Tables are int32 tensors holding uint32 bit patterns; positions are int64;
outputs are int32 bit patterns (callers widen with ``& 0xFFFFFFFF``), but
for backstep's stepped rows, the walks' text positions and every output of
the wide and shard variants, which are int64.

``chip_smoke.py`` holds every kernel against its plain version on the card;
``scripts/rank_kernel_study.py --kernels window_read,marked_walk,sampled_walk``
(or ``occ_pair,occ``) times them against other builds of their sources.

A wrapper takes its plain version only when its inputs are CPU tensors; on
CUDA tensors it launches the kernel or raises.  Each wrapper counts its
launches in a ``launches`` attribute, under a lock.  The kernels build on
first use with ``nvcc -gencode arch=compute_90a,code=sm_90a`` (one nvcc per
source, all started together, then one link) into ``awry_tpu_torch/_build/``;
the library is named by a hash of the sources and flags, so an edited
source rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import NamedTuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("window_read.cu", "occ_pair.cu", "backstep.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib_handle = None

_FULL = 0xFFFFFFFF


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def library_path() -> str:
    """Path of the kernel library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libawry_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if the library for these sources is missing, and
    return its path.  The compiler's per-kernel register and shared-memory
    report (``-Xptxas=-v``) is kept beside the library as ``<lib>.log``."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for name in SOURCES:
        obj = os.path.join(BUILD_DIR, f"{name}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC_DIR, name), "-o", obj]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        objs.append(obj)
    log = []
    failed = []
    for name, proc in procs:
        out = proc.communicate()[0].decode(errors="replace")
        log.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = f"{path}.tmp.{tag}"
    link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    with open(path + ".log", "w") as f:
        f.write("\n".join(log))
    os.replace(tmp, path)
    for obj in objs:
        os.remove(obj)
    return path


def _lib():
    global _lib_handle
    with _lock:
        if _lib_handle is None:
            lib = ctypes.CDLL(build())
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            lib.awry_window_read.restype = i32
            lib.awry_window_read.argtypes = [i32, p, i64, p, i64, i32, p, p]
            lib.awry_occ_pair.restype = i32
            lib.awry_occ_pair.argtypes = [i32, p, i64, i32, i32, i32, p, p, p, p, i64, p, p, p]
            lib.awry_occ.restype = i32
            lib.awry_occ.argtypes = [i32, p, i64, i32, i32, i32, p, p, p, i64, p, p]
            lib.awry_backstep.restype = i32
            lib.awry_backstep.argtypes = [i32, p, i64, i32, i32, p, p, p, i32, i32, p, i64, p, p, p]
            lib.awry_marked_walk.restype = i32
            lib.awry_marked_walk.argtypes = [i32, p, i64, i32, i32, p, p, p, i32, i32, i32, p, i64, i64, p, i64, p, p]
            lib.awry_marked_walk_ranges.restype = i32
            lib.awry_marked_walk_ranges.argtypes = [i32, p, i64, i32, i32, p, p, p, i32, i32, i32, i32, p, i64, i64,
                                                    p, p, i64, i32, p, p, p]
            walk = [i32, p, i64, i32, i32, p, p, p, i32, ctypes.c_uint32, p, i64, i64]
            lib.awry_sampled_walk.restype = i32
            lib.awry_sampled_walk.argtypes = [*walk, p, i64, p, p, p]
            lib.awry_sampled_walk_ranges.restype = i32
            lib.awry_sampled_walk_ranges.argtypes = [*walk, p, p, i64, i32, p, p, p]
            # The wide variants: the narrow heads with card, the group bases
            # and group_shift after c2i.
            lib.awry_occ_pair_wide.restype = i32
            lib.awry_occ_pair_wide.argtypes = [i32, p, i64, i32, i32, i32, p, p, i32, p, p, p, i64, p, p, p]
            head = [i32, p, i64, i32, i32, p, p, p, i32, p]
            lib.awry_backstep_wide.restype = i32
            lib.awry_backstep_wide.argtypes = [*head, p, i32, i32, i32, p, i64, p, p, p]
            lib.awry_marked_walk_wide.restype = i32
            lib.awry_marked_walk_wide.argtypes = [*head, p, i32, i32, i32, i32, p, i64, i64, p, i64, p, p]
            lib.awry_marked_walk_ranges_wide.restype = i32
            lib.awry_marked_walk_ranges_wide.argtypes = [*head, p, i32, i32, i32, i32, i32, p, i64, i64, p, p, i64, i32,
                                                         p, p, p]
            wide_walk = [*head, i32, i32, ctypes.c_uint64, p, i64, i64]
            lib.awry_sampled_walk_wide.restype = i32
            lib.awry_sampled_walk_wide.argtypes = [*wide_walk, p, i64, p, p, p]
            lib.awry_sampled_walk_ranges_wide.restype = i32
            lib.awry_sampled_walk_ranges_wide.argtypes = [*wide_walk, p, p, i64, i32, p, p, p]
            lib.awry_occ_wide.restype = i32
            lib.awry_occ_wide.argtypes = [i32, p, i64, i32, i32, i32, p, p, i32, p, p, i64, p, p]
            # The shard variants: the shard's rows, local, first and total
            # block counts, row words and planes, then their own arguments.
            window = [i32, p, i64, i64, i64, i32, i32]
            lib.awry_occ_pair_shard.restype = i32
            lib.awry_occ_pair_shard.argtypes = [*window, i32, p, p, p, p, p, i64, p, p, p]
            lib.awry_sampled_walk_shard.restype = i32
            lib.awry_sampled_walk_shard.argtypes = [*window, p, p, p, i32, ctypes.c_uint32, i64, p, p, i64, p, p]
            _lib_handle = lib
        return _lib_handle


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; False when every one lies on
    a CUDA device; raises on anything else (mixed or other devices)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"kernel inputs must lie on one CUDA device or all on the CPU, got {[str(t.device) for t in tensors]}")


_launch_lock = threading.Lock()


def _count_launch(*wrappers) -> None:
    """One launch on each wrapper's ``launches``, under a lock: client
    threads launch at once.  Callers name the wrappers by the module's
    bindings, so that a stand-in bound there counts in their place."""
    with _launch_lock:
        for w in wrappers:
            w.launches += 1


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {ndim}-d {dtype} tensor, got "
            f"{t.dtype} shape {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def _check_rank_args(kernel: str, blocks, pos, sym, codes, nplanes: int) -> None:
    """The checks occ_pair and occ share: dtypes, one request length, and a
    fused row layout the kernel's uint4 plane loads can read."""
    _check("blocks", blocks, torch.int32, 2)
    for name, t, dt in (("pos", pos, torch.int64), ("sym", sym, torch.int32), ("codes", codes, torch.int32)):
        _check(name, t, dt, 1)
    if sym.shape[0] != pos.shape[0]:
        raise ValueError(f"{kernel}: positions and sym must have one length")
    row_words, card = blocks.shape[1], codes.shape[0]
    if nplanes not in (3, 5) or row_words % 4 or row_words < nplanes * 8 + card:
        raise ValueError(f"{kernel}: bad row layout (row_words={row_words}, nplanes={nplanes}, card={card})")
    if blocks.data_ptr() % 16:
        raise ValueError(f"{kernel}: blocks must be 16-byte aligned (uint4 loads)")


def _launch_check(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same low 32 bits."""
    x = x & _FULL
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values in [0, 2**32) (torch has no popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _FULL) >> 24


# -- window_read ---------------------------------------------------------------


def window_read_plain(flat: torch.Tensor, wbase: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of window_read (advanced indexing)."""
    wb = wbase.clamp(k - 1, flat.shape[0] - 1)
    return flat[wb[:, None] - torch.arange(k, device=flat.device)]


def window_read(flat: torch.Tensor, wbase: torch.Tensor, k: int) -> torch.Tensor:
    """int32[R, k]: ``flat[clamp(wbase[i], k-1, len-1) - j]`` for j < k.
    flat: int32[N] (uint32 bit patterns), wbase: int64[R]."""
    if _on_cpu(flat, wbase):
        return window_read_plain(flat, wbase, k)
    _check("flat", flat, torch.int32, 1)
    _check("wbase", wbase, torch.int64, 1)
    if not 1 <= k <= flat.shape[0]:
        raise ValueError(f"window_read: k={k} outside [1, {flat.shape[0]}]")
    r = wbase.shape[0]
    out = torch.empty((r, k), dtype=torch.int32, device=flat.device)
    if r:
        rc = _lib().awry_window_read(
            flat.device.index, flat.data_ptr(), flat.shape[0], wbase.data_ptr(), r, k,
            out.data_ptr(), _stream(flat.device),
        )
        _launch_check(rc, "window_read")
        _count_launch(window_read)
    return out


window_read.launches = 0


# -- occ_pair ------------------------------------------------------------------


def _fetch_rows(blocks, pos):
    """(clamped pos, the fused rows holding it as int64 values in [0, 2**32))."""
    p = pos.clamp(0, blocks.shape[0] * 256 - 1)
    return p, blocks[p >> 8].to(torch.int64) & _FULL  # [R, row_words]


def _word_masks(local: torch.Tensor, in_word: torch.Tensor) -> torch.Tensor:
    """[R, 8] masks over a block's 8 words: all ones below the word of
    ``local``, ``in_word`` at it, zero above."""
    word = (local >> 5)[:, None]
    lane = torch.arange(8, device=local.device)[None, :]
    return torch.where(lane < word, _FULL, torch.where(lane == word, in_word[:, None], 0))


def _occ_rows(rows, p, sym, codes, nplanes: int) -> torch.Tensor:
    """Occ(p, sym) as int64 from already fetched rows: XOR-polarity AND +
    inclusive masked SWAR popcount + milestone."""
    code = codes[sym].to(torch.int64)
    occv = torch.full((p.shape[0], 8), _FULL, dtype=torch.int64, device=p.device)
    for v in range(nplanes):
        pol = (((code >> v) & 1) - 1) & _FULL  # bit set -> 0, clear -> all ones
        occv &= rows[:, v * 8 : (v + 1) * 8] ^ pol[:, None]
    local = p & 255
    pop = popcount32(occv & _word_masks(local, _FULL >> (31 - (local & 31)))).sum(dim=1)
    milestone = rows.gather(1, (nplanes * 8 + sym.to(torch.int64))[:, None])[:, 0]
    return milestone + pop


def _occ_plain(blocks, pos, sym, codes, nplanes: int) -> torch.Tensor:
    """Occ(pos, sym) as int64 from the fused rows (the arithmetic of one
    occ_pair endpoint)."""
    p, rows = _fetch_rows(blocks, pos)
    return _occ_rows(rows, p, sym, codes, nplanes)


def _bit_at(rows, offset: int, p) -> torch.Tensor:
    """Bit (p & 255) of the 256-bit field at word ``offset`` of each row."""
    local = p & 255
    word = rows.gather(1, (offset + (local >> 5))[:, None])[:, 0]
    return (word >> (local & 31)) & 1


def _symbol_rows(rows, p, c2i, nplanes: int) -> torch.Tensor:
    """BWT symbol index (int64) at p: its plane bits form the code."""
    code = sum(_bit_at(rows, v * 8, p) << v for v in range(nplanes))
    return c2i[code].to(torch.int64)


def occ_pair_plain(blocks, pos_a, pos_b, sym, codes, nplanes: int):
    """Plain version of occ_pair (gather + SWAR popcount)."""
    s = sym.clamp(0, codes.shape[0] - 1)
    return (
        as_int32_bits(_occ_plain(blocks, pos_a, s, codes, nplanes)),
        as_int32_bits(_occ_plain(blocks, pos_b, s, codes, nplanes)),
    )


def occ_pair(blocks, pos_a, pos_b, sym, codes, nplanes: int):
    """(int32[R], int32[R]): Occ(pos_a, sym) and Occ(pos_b, sym).

    blocks: int32[num_blocks, row_words] fused rows; pos_a, pos_b: int64[R]
    (clamped into the table); sym: int32[R] symbol indices (clamped to the
    alphabet); codes: int32[cardinality] symbol -> occurrence code; nplanes:
    3 (nucleotide) or 5 (amino)."""
    if _on_cpu(blocks, pos_a, pos_b, sym, codes):
        return occ_pair_plain(blocks, pos_a, pos_b, sym, codes, nplanes)
    _check("pos_a", pos_a, torch.int64, 1)
    _check_rank_args("occ_pair", blocks, pos_b, sym, codes, nplanes)
    r = pos_a.shape[0]
    if pos_b.shape[0] != r:
        raise ValueError("occ_pair: pos_a, pos_b and sym must have one length")
    row_words, card = blocks.shape[1], codes.shape[0]
    occ_a = torch.empty(r, dtype=torch.int32, device=blocks.device)
    occ_b = torch.empty(r, dtype=torch.int32, device=blocks.device)
    if r:
        rc = _lib().awry_occ_pair(
            blocks.device.index, blocks.data_ptr(), blocks.shape[0], row_words, nplanes, card,
            codes.data_ptr(), pos_a.data_ptr(), pos_b.data_ptr(), sym.data_ptr(), r,
            occ_a.data_ptr(), occ_b.data_ptr(), _stream(blocks.device),
        )
        _launch_check(rc, "occ_pair")
        _count_launch(occ_pair)
    return occ_a, occ_b


occ_pair.launches = 0


# -- occ -----------------------------------------------------------------------


def occ_plain(blocks, pos, sym, codes, nplanes: int) -> torch.Tensor:
    """Plain version of occ (gather + SWAR popcount)."""
    return as_int32_bits(_occ_plain(blocks, pos, sym.clamp(0, codes.shape[0] - 1), codes, nplanes))


def occ(blocks, pos, sym, codes, nplanes: int) -> torch.Tensor:
    """int32[R]: Occ(pos, sym) as uint32 bit patterns.

    blocks: int32[num_blocks, row_words] fused rows; pos: int64[R] (clamped
    into the table); sym: int32[R] symbol indices (clamped to the alphabet);
    codes: int32[cardinality] symbol -> occurrence code; nplanes: 3
    (nucleotide) or 5 (amino)."""
    if _on_cpu(blocks, pos, sym, codes):
        return occ_plain(blocks, pos, sym, codes, nplanes)
    _check_rank_args("occ", blocks, pos, sym, codes, nplanes)
    r = pos.shape[0]
    out = torch.empty(r, dtype=torch.int32, device=blocks.device)
    if r:
        rc = _lib().awry_occ(
            blocks.device.index, blocks.data_ptr(), blocks.shape[0], blocks.shape[1], nplanes,
            codes.shape[0], codes.data_ptr(), pos.data_ptr(), sym.data_ptr(), r, out.data_ptr(),
            _stream(blocks.device),
        )
        _launch_check(rc, "occ")
        _count_launch(occ)
    return out


occ.launches = 0


# -- backstep ------------------------------------------------------------------


def _lf_rows(r, p, prefix_sums, codes, c2i, nplanes: int, ambiguity_idx: int, bases=None):
    """LF of each fetched row (int64): 0 for sentinel rows, whose rank uses
    ``ambiguity_idx``; with ``bases`` (a wide index's WideBases) the row's
    milestone is relative to its group."""
    sym = _symbol_rows(r, p, c2i, nplanes)
    sentinel = sym == 0
    safe = torch.where(sentinel, ambiguity_idx, sym)
    stepped = prefix_sums[safe] + _occ_rows(r, p, safe, codes, nplanes) - 1
    if bases is not None:
        stepped = stepped + bases.milestones[p >> (8 + bases.shift), safe]
    return torch.where(sentinel, 0, stepped)


def _backstep_rows(blocks, rows, prefix_sums, codes, c2i, nplanes: int, mark_offset: int, ambiguity_idx: int,
                   bases=None):
    """(LF-stepped row, (mark_rank << 1) | mark_bit) as int64, the mark rank
    relative to the row's group plus its base with ``bases``."""
    p, r = _fetch_rows(blocks, rows)
    stepped = _lf_rows(r, p, prefix_sums, codes, c2i, nplanes, ambiguity_idx, bases)
    local = p & 255
    before = _word_masks(local, (1 << (local & 31)) - 1)
    marks = r[:, mark_offset : mark_offset + 8]
    mark_rank = r[:, mark_offset + 8] + popcount32(marks & before).sum(dim=1)
    if bases is not None:
        mark_rank = mark_rank + bases.marks[p >> (8 + bases.shift)]
    return stepped, (mark_rank << 1) | _bit_at(r, mark_offset, p)


def backstep_plain(blocks, rows, prefix_sums, codes, c2i, nplanes: int, mark_offset: int, ambiguity_idx: int):
    """Plain version of backstep (gather + SWAR popcounts)."""
    stepped, packed = _backstep_rows(blocks, rows, prefix_sums, codes, c2i, nplanes, mark_offset, ambiguity_idx)
    return stepped, as_int32_bits(packed)


def _check_walk_args(kernel: str, blocks, rows, prefix_sums, codes, c2i, nplanes: int, ambiguity_idx: int,
                     mark_offset: int | None = None) -> None:
    """The checks backstep and the walks share: dtypes and a fused row
    layout the kernel's uint4 plane loads can read; with ``mark_offset``,
    the mark words where its uint2 loads read them."""
    _check("blocks", blocks, torch.int32, 2)
    for name, t, dt in (("rows", rows, torch.int64), ("prefix_sums", prefix_sums, torch.int64),
                        ("codes", codes, torch.int32), ("c2i", c2i, torch.int32)):
        _check(name, t, dt, 1)
    row_words = blocks.shape[1]
    card = codes.shape[0]
    marks_ok = mark_offset is None or (
        mark_offset % 2 == 0 and mark_offset >= nplanes * 8 + card and mark_offset + 9 <= row_words
    )
    if (
        nplanes not in (3, 5) or row_words % 4 or row_words < nplanes * 8 + card
        or prefix_sums.shape[0] != card + 1 or c2i.shape[0] != 1 << nplanes
        or not marks_ok or not 0 < ambiguity_idx < card
    ):
        raise ValueError(
            f"{kernel}: bad row layout (row_words={row_words}, nplanes={nplanes}, card={card}, "
            f"mark_offset={mark_offset}, ambiguity_idx={ambiguity_idx})"
        )
    if blocks.data_ptr() % 16:
        raise ValueError(f"{kernel}: blocks must be 16-byte aligned (uint4 loads)")


def backstep(blocks, rows, prefix_sums, codes, c2i, nplanes: int, mark_offset: int, ambiguity_idx: int):
    """(int64[R], int32[R]): the LF-stepped row (0 for sentinel rows, whose
    rank uses ``ambiguity_idx``) and ``(mark_rank << 1) | mark_bit`` as a
    uint32 bit pattern, from one read of each row.

    blocks: int32[num_blocks, row_words] fused rows, with the 8 mark words
    at ``mark_offset`` (even) and the mark milestone after them; rows:
    int64[R] (clamped into the table); prefix_sums: int64[cardinality + 1];
    codes: int32[cardinality] symbol -> occurrence code; c2i:
    int32[2**nplanes] code -> symbol; nplanes: 3 (nucleotide) or 5 (amino)."""
    if _on_cpu(blocks, rows, prefix_sums, codes, c2i):
        return backstep_plain(blocks, rows, prefix_sums, codes, c2i, nplanes, mark_offset, ambiguity_idx)
    _check_walk_args("backstep", blocks, rows, prefix_sums, codes, c2i, nplanes, ambiguity_idx, mark_offset)
    r = rows.shape[0]
    stepped = torch.empty(r, dtype=torch.int64, device=blocks.device)
    mark = torch.empty(r, dtype=torch.int32, device=blocks.device)
    if r:
        rc = _lib().awry_backstep(
            blocks.device.index, blocks.data_ptr(), blocks.shape[0], blocks.shape[1], nplanes,
            prefix_sums.data_ptr(), codes.data_ptr(), c2i.data_ptr(), mark_offset, ambiguity_idx,
            rows.data_ptr(), r, stepped.data_ptr(), mark.data_ptr(), _stream(blocks.device),
        )
        _launch_check(rc, "backstep")
        _count_launch(backstep)
    return stepped, mark


backstep.launches = 0


# -- marked_walk ---------------------------------------------------------------


def _widen(x: torch.Tensor) -> torch.Tensor:
    """int32 uint32 bit patterns -> their int64 values; int64 unchanged."""
    return x if x.dtype == torch.int64 else x.to(torch.int64) & _FULL


def _sa_values(read, sa: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 SA values at idx, clamped into the table: one k=1 ``read``
    (window_read or its plain version) of an int32 table of uint32 bits, a
    plain gather of an int64 one (a wide index's)."""
    if sa.dtype == torch.int64:
        return sa[idx.clamp(0, sa.shape[0] - 1)]
    return _widen(read(sa, idx, 1)[:, 0])


def _text_pos_mod(sa_vals: torch.Tensor, steps: torch.Tensor, bwt_len: int) -> torch.Tensor:
    """(sa_vals + steps) % bwt_len for operands below bwt_len (int64: one
    conditional subtraction, no wraparound)."""
    t = sa_vals + steps
    return torch.where(t >= bwt_len, t - bwt_len, t)


def walk_by_visits(visit, read, blocks, rows, prefix_sums, codes, c2i, nplanes: int, mark_offset: int,
                   ambiguity_idx: int, mark_ratio: int, sampled_sa, bwt_len: int) -> torch.Tensor:
    """The marked walk as mark_ratio one-visit calls of ``visit`` (backstep
    or its plain version), lanes freezing once marked, then one k=1 ``read``
    (window_read or its plain version) of the marked SA at the final row's
    mark rank: marked_walk's function, composed."""
    args = (prefix_sums, codes, c2i, nplanes, mark_offset, ambiguity_idx)
    pos = rows
    steps = torch.zeros_like(rows)
    done = torch.zeros(rows.shape, dtype=torch.bool, device=rows.device)
    for _ in range(mark_ratio - 1):
        stepped, packed = visit(blocks, pos, *args)
        done |= (packed & 1) == 1
        pos = torch.where(done, pos, stepped)
        steps += (~done).to(torch.int64)
    # Final visit: the row is marked (or the walk hit its bound); its mark
    # rank indexes the marked SA values.  k=1 reads index 0 exactly.
    _, packed = visit(blocks, pos, *args)
    return _text_pos_mod(_sa_values(read, sampled_sa, _widen(packed) >> 1), steps, bwt_len)


def marked_walk_plain(blocks, rows, prefix_sums, codes, c2i, nplanes: int, mark_offset: int, ambiguity_idx: int,
                      mark_ratio: int, sampled_sa, bwt_len: int) -> torch.Tensor:
    """Plain version of marked_walk: the walk by visits of backstep_plain,
    then window_read_plain k=1."""
    return walk_by_visits(backstep_plain, window_read_plain, blocks, rows, prefix_sums, codes, c2i, nplanes,
                          mark_offset, ambiguity_idx, mark_ratio, sampled_sa, bwt_len)


# The range-fed marked walks read a row's planes with its mark word (eager:
# one round trip per LF step, the planes wasted on the walk's final visit)
# from this mark ratio on, and after it below (two per step): eager won at
# mark 32, lazy at mark 4 (PERF.md).
MARKED_EAGER_FROM = 8


def _check_marked(kernel: str, mark_ratio: int, sampled_sa, bwt_len: int) -> None:
    """The marked walks' arguments: a walk of at least one visit and SA
    values to read."""
    if mark_ratio < 1 or sampled_sa.shape[0] < 1 or bwt_len < 1:
        raise ValueError(f"{kernel}: mark_ratio={mark_ratio}, {sampled_sa.shape[0]} SA values, bwt_len={bwt_len}")


def _check_ranges(kernel: str, starts, counts, cap: int) -> None:
    _check("counts", counts, torch.int64, 1)
    if counts.shape[0] != starts.shape[0]:
        raise ValueError(f"{kernel}: {starts.shape[0]} starts, {counts.shape[0]} counts, cap={cap}")


def marked_walk(blocks, rows, prefix_sums, codes, c2i, nplanes: int, mark_offset: int, ambiguity_idx: int,
                mark_ratio: int, sampled_sa, bwt_len: int) -> torch.Tensor:
    """int64[R]: the text position of each BWT row by the marked LF walk.

    Up to ``mark_ratio - 1`` LF steps per row (sentinel rows step to 0),
    stopping at the first marked row; then ``sa = sampled_sa[mark_rank]``
    at the final row (31 bits of the rank, as backstep packs it; clamped
    into the table) and ``sa + steps``, less ``bwt_len`` when that reaches
    it.  blocks .. ambiguity_idx as for backstep; sampled_sa: int32[S] the
    SA values of the marked rows in row order (uint32 bit patterns);
    bwt_len: the BWT's length.  One launch, a thread per row."""
    if _on_cpu(blocks, rows, prefix_sums, codes, c2i, sampled_sa):
        return marked_walk_plain(blocks, rows, prefix_sums, codes, c2i, nplanes, mark_offset, ambiguity_idx,
                                 mark_ratio, sampled_sa, bwt_len)
    _check_walk_args("marked_walk", blocks, rows, prefix_sums, codes, c2i, nplanes, ambiguity_idx, mark_offset)
    _check("sampled_sa", sampled_sa, torch.int32, 1)
    _check_marked("marked_walk", mark_ratio, sampled_sa, bwt_len)
    r = rows.shape[0]
    out = torch.empty(r, dtype=torch.int64, device=blocks.device)
    if r:
        rc = _lib().awry_marked_walk(
            blocks.device.index, blocks.data_ptr(), blocks.shape[0], blocks.shape[1], nplanes,
            prefix_sums.data_ptr(), codes.data_ptr(), c2i.data_ptr(), mark_offset, ambiguity_idx, mark_ratio,
            sampled_sa.data_ptr(), sampled_sa.shape[0], bwt_len, rows.data_ptr(), r, out.data_ptr(),
            _stream(blocks.device),
        )
        _launch_check(rc, "marked_walk")
        _count_launch(marked_walk)
    return out


marked_walk.launches = 0


def marked_walk_ranges_plain(blocks, starts, counts, cap: int, prefix_sums, codes, c2i, nplanes: int,
                             mark_offset: int, ambiguity_idx: int, mark_ratio: int, sampled_sa,
                             bwt_len: int) -> torch.Tensor:
    """Plain version of marked_walk_ranges: the padded rows (slot_rows)
    walked by marked_walk_plain."""
    rows = slot_rows(starts, counts, cap).reshape(-1)
    return marked_walk_plain(blocks, rows, prefix_sums, codes, c2i, nplanes, mark_offset, ambiguity_idx, mark_ratio,
                             sampled_sa, bwt_len).reshape(-1, cap)


def marked_walk_ranges(blocks, starts, counts, cap: int, prefix_sums, codes, c2i, nplanes: int, mark_offset: int,
                       ambiguity_idx: int, mark_ratio: int, sampled_sa, bwt_len: int) -> torch.Tensor:
    """int64[B, cap]: slot (q, j) holds the marked walk of row ``starts[q]
    + j`` for j < min(counts[q], cap), and the walk of row 0 in every other
    slot: marked_walk over slot_rows, in one launch that walks only the live
    slots and row 0 once (counted under ``marked_walk.launches``, and under
    this entry's own ``launches``).

    starts, counts: int64[B] (counts 0 for an empty range; a query over
    ``cap`` fills its cap slots); the rest as for marked_walk."""
    if not 1 <= cap <= 1 << 20:
        raise ValueError(f"marked_walk_ranges: cap={cap}")
    if _on_cpu(blocks, starts, counts, prefix_sums, codes, c2i, sampled_sa):
        return marked_walk_ranges_plain(blocks, starts, counts, cap, prefix_sums, codes, c2i, nplanes, mark_offset,
                                        ambiguity_idx, mark_ratio, sampled_sa, bwt_len)
    _check_walk_args("marked_walk_ranges", blocks, starts, prefix_sums, codes, c2i, nplanes, ambiguity_idx,
                     mark_offset)
    _check("sampled_sa", sampled_sa, torch.int32, 1)
    _check_marked("marked_walk_ranges", mark_ratio, sampled_sa, bwt_len)
    if blocks.shape[0] * 256 > 2**32:
        raise ValueError(f"marked_walk_ranges: {blocks.shape[0]} blocks: rows past 32 bits take the wide entry")
    _check_ranges("marked_walk_ranges", starts, counts, cap)
    b = starts.shape[0]
    out = torch.empty((b, cap), dtype=torch.int64, device=blocks.device)
    if b:
        cursor = torch.zeros(4, dtype=torch.int64, device=blocks.device)
        rc = _lib().awry_marked_walk_ranges(
            blocks.device.index, blocks.data_ptr(), blocks.shape[0], blocks.shape[1], nplanes,
            prefix_sums.data_ptr(), codes.data_ptr(), c2i.data_ptr(), mark_offset, ambiguity_idx, mark_ratio,
            int(mark_ratio >= MARKED_EAGER_FROM), sampled_sa.data_ptr(), sampled_sa.shape[0], bwt_len,
            starts.data_ptr(), counts.data_ptr(), b, cap, cursor.data_ptr(), out.data_ptr(), _stream(blocks.device),
        )
        _launch_check(rc, "marked_walk_ranges")
        _count_launch(marked_walk, marked_walk_ranges)
    return out


marked_walk_ranges.launches = 0


# -- sampled_walk --------------------------------------------------------------


def sampled_walk_plain(blocks, rows, prefix_sums, codes, c2i, nplanes: int, ambiguity_idx: int, sa_ratio: int,
                       sampled_sa, bwt_len: int, bases=None) -> torch.Tensor:
    """Plain version of sampled_walk: LF steps of the live lanes (each a
    backstep_plain's LF), lanes freezing once their row is a multiple of
    sa_ratio, then the k=1 read of the sampled SA; -1 for a lane still
    walking after bwt_len steps.  ``bases``: a wide index's WideBases (its
    sampled SA int64)."""
    pos = rows.clamp(0, bwt_len - 1)
    steps = torch.zeros_like(pos)
    live = torch.nonzero(pos % sa_ratio != 0)[:, 0]
    for _ in range(bwt_len):
        if not live.numel():
            break
        p, r = _fetch_rows(blocks, pos[live])
        pos[live] = _lf_rows(r, p, prefix_sums, codes, c2i, nplanes, ambiguity_idx, bases).clamp(0, bwt_len - 1)
        steps[live] += 1
        live = live[pos[live] % sa_ratio != 0]
    out = _text_pos_mod(_sa_values(window_read_plain, sampled_sa, pos // sa_ratio), steps, bwt_len)
    out[live] = -1
    return out


def _check_sampled_args(kernel: str, blocks, rows, prefix_sums, codes, c2i, nplanes: int, ambiguity_idx: int,
                        sampled_sa, bwt_len: int) -> None:
    """The checks of the sampled walks' CUDA entries (``rows``: the rows or
    the range starts)."""
    _check_walk_args(kernel, blocks, rows, prefix_sums, codes, c2i, nplanes, ambiguity_idx)
    _check("sampled_sa", sampled_sa, torch.int32, 1)
    if bwt_len > blocks.shape[0] * 256:
        raise ValueError(f"{kernel}: bwt_len={bwt_len} exceeds the {blocks.shape[0]} blocks")


def _check_sampling(kernel: str, sa_ratio: int, sampled_sa, bwt_len: int) -> None:
    if not 1 <= bwt_len < 2**32 or not 1 <= sa_ratio < 2**32 or sampled_sa.shape[0] != -(-bwt_len // sa_ratio):
        raise ValueError(f"{kernel}: sa_ratio={sa_ratio}, {sampled_sa.shape[0]} SA values, bwt_len={bwt_len}")


def _walk_entry_args(blocks, prefix_sums, codes, c2i, nplanes: int, ambiguity_idx: int, sa_ratio: int, sampled_sa,
                     bwt_len: int) -> tuple:
    """The leading arguments the sampled walks' C entries share."""
    return (blocks.device.index, blocks.data_ptr(), blocks.shape[0], blocks.shape[1], nplanes,
            prefix_sums.data_ptr(), codes.data_ptr(), c2i.data_ptr(), ambiguity_idx, sa_ratio,
            sampled_sa.data_ptr(), sampled_sa.shape[0], bwt_len)


def sampled_walk_launch(blocks, rows, prefix_sums, codes, c2i, nplanes: int, ambiguity_idx: int, sa_ratio: int,
                        sampled_sa, bwt_len: int) -> torch.Tensor:
    """sampled_walk without its check of the walks' ends: one launch on
    CUDA tensors (the plain version on CPU tensors), -1 for a row still
    walking after bwt_len steps, no device sync."""
    _check_sampling("sampled_walk", sa_ratio, sampled_sa, bwt_len)
    if _on_cpu(blocks, rows, prefix_sums, codes, c2i, sampled_sa):
        return sampled_walk_plain(blocks, rows, prefix_sums, codes, c2i, nplanes, ambiguity_idx, sa_ratio,
                                  sampled_sa, bwt_len)
    _check_sampled_args("sampled_walk", blocks, rows, prefix_sums, codes, c2i, nplanes, ambiguity_idx, sampled_sa,
                        bwt_len)
    r = rows.shape[0]
    out = torch.empty(r, dtype=torch.int64, device=blocks.device)
    if r:
        cursor = torch.zeros(1, dtype=torch.int64, device=blocks.device)
        rc = _lib().awry_sampled_walk(
            *_walk_entry_args(blocks, prefix_sums, codes, c2i, nplanes, ambiguity_idx, sa_ratio, sampled_sa,
                              bwt_len),
            rows.data_ptr(), r, cursor.data_ptr(), out.data_ptr(), _stream(blocks.device),
        )
        _launch_check(rc, "sampled_walk")
        _count_launch(sampled_walk)
    return out


def sampled_walk(blocks, rows, prefix_sums, codes, c2i, nplanes: int, ambiguity_idx: int, sa_ratio: int,
                 sampled_sa, bwt_len: int) -> torch.Tensor:
    """int64[R]: the text position of each BWT row by the row-sampled LF
    walk (awry_tpu/ops/locate.py _row_sampled_walk).

    Rows are clamped into [0, bwt_len); while ``row % sa_ratio != 0`` a
    walk takes one LF step (sentinel rows step to 0; the stepped row is
    clamped likewise) and counts it; then ``sa = sampled_sa[row //
    sa_ratio]`` and the result is ``sa + steps``, less ``bwt_len`` when that
    reaches it.  blocks .. ambiguity_idx as for backstep (the mark words are
    not read); sampled_sa: int32[ceil(bwt_len / sa_ratio)] uint32 bit
    patterns.  A valid index ends every walk (row 0 is sampled and LF is
    one cycle over all rows); a row still walking after bwt_len steps makes
    this raise, a check that costs one device sync per call
    (sampled_walk_launch leaves it out)."""
    out = sampled_walk_launch(blocks, rows, prefix_sums, codes, c2i, nplanes, ambiguity_idx, sa_ratio, sampled_sa,
                              bwt_len)
    if out.numel() and bool((out < 0).any()):
        raise RuntimeError(
            f"sampled_walk: a row took {bwt_len} LF steps without reaching a sampled row (a corrupt index)"
        )
    return out


sampled_walk.launches = 0


def slot_rows(starts: torch.Tensor, counts: torch.Tensor, cap: int) -> torch.Tensor:
    """int64[B, cap]: row ``starts[q] + j`` in slot (q, j) for j <
    min(counts[q], cap), row 0 in every other slot (the classic path's
    padded walk rows)."""
    offs = torch.arange(cap, device=starts.device)
    valid = offs[None, :] < counts.clamp_max(cap)[:, None]
    return torch.where(valid, starts[:, None] + offs[None, :], 0)


def sampled_walk_ranges_plain(blocks, starts, counts, cap: int, prefix_sums, codes, c2i, nplanes: int,
                              ambiguity_idx: int, sa_ratio: int, sampled_sa, bwt_len: int) -> torch.Tensor:
    """Plain version of sampled_walk_ranges: the padded rows (slot_rows)
    walked by sampled_walk_plain."""
    rows = slot_rows(starts, counts, cap).reshape(-1)
    return sampled_walk_plain(blocks, rows, prefix_sums, codes, c2i, nplanes, ambiguity_idx, sa_ratio, sampled_sa,
                              bwt_len).reshape(-1, cap)


def sampled_walk_ranges(blocks, starts, counts, cap: int, prefix_sums, codes, c2i, nplanes: int, ambiguity_idx: int,
                        sa_ratio: int, sampled_sa, bwt_len: int) -> torch.Tensor:
    """int64[B, cap]: slot (q, j) holds the row-sampled walk of row
    ``starts[q] + j`` for j < min(counts[q], cap), and the walk of row 0
    (its SA value) in every other slot: sampled_walk over slot_rows, in one
    launch that walks only the live slots (counted under
    ``sampled_walk.launches``).

    starts, counts: int64[B] (counts 0 for an empty range; a query over
    ``cap`` fills its cap slots); the rest as for sampled_walk.  A walk
    still going after bwt_len steps writes -1 and nothing raises here: the
    caller checks the positions it reads (the engine does so at assembly),
    so no device sync sits between the launch and the results' copy."""
    _check_sampling("sampled_walk_ranges", sa_ratio, sampled_sa, bwt_len)
    if not 1 <= cap <= 1 << 20:
        raise ValueError(f"sampled_walk_ranges: cap={cap}")
    if _on_cpu(blocks, starts, counts, prefix_sums, codes, c2i, sampled_sa):
        return sampled_walk_ranges_plain(blocks, starts, counts, cap, prefix_sums, codes, c2i, nplanes,
                                         ambiguity_idx, sa_ratio, sampled_sa, bwt_len)
    _check_sampled_args("sampled_walk_ranges", blocks, starts, prefix_sums, codes, c2i, nplanes, ambiguity_idx,
                        sampled_sa, bwt_len)
    _check("counts", counts, torch.int64, 1)
    b = starts.shape[0]
    if counts.shape[0] != b:
        raise ValueError(f"sampled_walk_ranges: {b} starts, {counts.shape[0]} counts, cap={cap}")
    out = torch.empty((b, cap), dtype=torch.int64, device=blocks.device)
    if b:
        cursor = torch.zeros(1, dtype=torch.int64, device=blocks.device)
        rc = _lib().awry_sampled_walk_ranges(
            *_walk_entry_args(blocks, prefix_sums, codes, c2i, nplanes, ambiguity_idx, sa_ratio, sampled_sa,
                              bwt_len),
            starts.data_ptr(), counts.data_ptr(), b, cap, cursor.data_ptr(), out.data_ptr(),
            _stream(blocks.device),
        )
        _launch_check(rc, "sampled_walk_ranges")
        _count_launch(sampled_walk)
    return out


# -- the wide variants -----------------------------------------------------------


class WideBases(NamedTuple):
    """What a wide index's fused rows are relative to (ops/wide.py): its
    rows' milestones and mark milestones count from the start of their group
    of 2**shift blocks, and these tables hold each group's absolute counts."""

    milestones: torch.Tensor  # int64 [groups, cardinality]
    marks: torch.Tensor  # int64 [groups] (zeros on an index without marks)
    shift: int  # log2 of the blocks per group: at most 24, so relative counts fit 32 bits


def _check_bases(kernel: str, blocks, bases: WideBases, card: int, marks: bool) -> None:
    """The group tables cover every block's group, with ``card`` milestones
    each (and a mark base each when ``marks``)."""
    groups = -(-blocks.shape[0] // (1 << bases.shift)) if 0 <= bases.shift <= 24 else -1
    _check("bases.milestones", bases.milestones, torch.int64, 2)
    _check("bases.marks", bases.marks, torch.int64, 1)
    if groups < 1 or bases.milestones.shape[0] < groups or bases.milestones.shape[1] != card or (
        marks and bases.marks.shape[0] < groups
    ):
        raise ValueError(
            f"{kernel}: group tables {tuple(bases.milestones.shape)}, {tuple(bases.marks.shape)} at shift "
            f"{bases.shift} do not cover {blocks.shape[0]} blocks of {card} symbols"
        )


def _wide_head(blocks, bases: WideBases, prefix_sums, codes, c2i, nplanes: int) -> tuple:
    """The leading arguments the wide walks' and backstep's C entries share."""
    return (blocks.device.index, blocks.data_ptr(), blocks.shape[0], blocks.shape[1], nplanes,
            prefix_sums.data_ptr(), codes.data_ptr(), c2i.data_ptr(), codes.shape[0], bases.milestones.data_ptr())


def occ_pair_wide_plain(blocks, bases: WideBases, pos_a, pos_b, sym, codes, nplanes: int):
    """Plain version of occ_pair_wide (gather + SWAR popcount, int64)."""
    s = sym.clamp(0, codes.shape[0] - 1)

    def occ(pos):
        p, rows = _fetch_rows(blocks, pos)
        return _occ_rows(rows, p, s, codes, nplanes) + bases.milestones[p >> (8 + bases.shift), s.to(torch.int64)]

    return occ(pos_a), occ(pos_b)


def occ_pair_wide(blocks, bases: WideBases, pos_a, pos_b, sym, codes, nplanes: int):
    """(int64[R], int64[R]): occ_pair over a wide index's fused rows, whose
    milestones are relative to their group (``bases``); positions may pass
    2**32."""
    if _on_cpu(blocks, bases.milestones, pos_a, pos_b, sym, codes):
        return occ_pair_wide_plain(blocks, bases, pos_a, pos_b, sym, codes, nplanes)
    _check("pos_a", pos_a, torch.int64, 1)
    _check_rank_args("occ_pair_wide", blocks, pos_b, sym, codes, nplanes)
    _check_bases("occ_pair_wide", blocks, bases, codes.shape[0], marks=False)
    r = pos_a.shape[0]
    if pos_b.shape[0] != r:
        raise ValueError("occ_pair_wide: pos_a, pos_b and sym must have one length")
    occ_a = torch.empty(r, dtype=torch.int64, device=blocks.device)
    occ_b = torch.empty(r, dtype=torch.int64, device=blocks.device)
    if r:
        rc = _lib().awry_occ_pair_wide(
            blocks.device.index, blocks.data_ptr(), blocks.shape[0], blocks.shape[1], nplanes, codes.shape[0],
            codes.data_ptr(), bases.milestones.data_ptr(), bases.shift, pos_a.data_ptr(), pos_b.data_ptr(),
            sym.data_ptr(), r, occ_a.data_ptr(), occ_b.data_ptr(), _stream(blocks.device),
        )
        _launch_check(rc, "occ_pair_wide")
        _count_launch(occ_pair_wide)
    return occ_a, occ_b


occ_pair_wide.launches = 0


def occ_wide_plain(blocks, bases: WideBases, pos, sym, codes, nplanes: int) -> torch.Tensor:
    """Plain version of occ_wide: _occ_plain plus the group base, int64."""
    s = sym.clamp(0, codes.shape[0] - 1)
    p, rows = _fetch_rows(blocks, pos)
    return _occ_rows(rows, p, s, codes, nplanes) + bases.milestones[p >> (8 + bases.shift), s.to(torch.int64)]


def occ_wide(blocks, bases: WideBases, pos, sym, codes, nplanes: int) -> torch.Tensor:
    """int64[R]: occ over a wide index's fused rows, whose milestones are
    relative to their group (``bases``); positions may pass 2**32."""
    if _on_cpu(blocks, bases.milestones, pos, sym, codes):
        return occ_wide_plain(blocks, bases, pos, sym, codes, nplanes)
    _check_rank_args("occ_wide", blocks, pos, sym, codes, nplanes)
    _check_bases("occ_wide", blocks, bases, codes.shape[0], marks=False)
    r = pos.shape[0]
    out = torch.empty(r, dtype=torch.int64, device=blocks.device)
    if r:
        rc = _lib().awry_occ_wide(
            blocks.device.index, blocks.data_ptr(), blocks.shape[0], blocks.shape[1], nplanes, codes.shape[0],
            codes.data_ptr(), bases.milestones.data_ptr(), bases.shift, pos.data_ptr(), sym.data_ptr(), r,
            out.data_ptr(), _stream(blocks.device),
        )
        _launch_check(rc, "occ_wide")
        _count_launch(occ_wide)
    return out


occ_wide.launches = 0


def backstep_wide_plain(blocks, bases: WideBases, rows, prefix_sums, codes, c2i, nplanes: int, mark_offset: int,
                        ambiguity_idx: int):
    """Plain version of backstep_wide (gather + SWAR popcounts, int64)."""
    return _backstep_rows(blocks, rows, prefix_sums, codes, c2i, nplanes, mark_offset, ambiguity_idx, bases)


def backstep_wide(blocks, bases: WideBases, rows, prefix_sums, codes, c2i, nplanes: int, mark_offset: int,
                  ambiguity_idx: int):
    """(int64[R], int64[R]): backstep over a wide index's fused rows: the
    LF-stepped row and ``(mark_rank << 1) | mark_bit`` with the whole rank."""
    if _on_cpu(blocks, bases.milestones, bases.marks, rows, prefix_sums, codes, c2i):
        return backstep_wide_plain(blocks, bases, rows, prefix_sums, codes, c2i, nplanes, mark_offset,
                                   ambiguity_idx)
    _check_walk_args("backstep_wide", blocks, rows, prefix_sums, codes, c2i, nplanes, ambiguity_idx, mark_offset)
    _check_bases("backstep_wide", blocks, bases, codes.shape[0], marks=True)
    r = rows.shape[0]
    stepped = torch.empty(r, dtype=torch.int64, device=blocks.device)
    mark = torch.empty(r, dtype=torch.int64, device=blocks.device)
    if r:
        rc = _lib().awry_backstep_wide(
            *_wide_head(blocks, bases, prefix_sums, codes, c2i, nplanes), bases.marks.data_ptr(), bases.shift,
            mark_offset, ambiguity_idx, rows.data_ptr(), r, stepped.data_ptr(), mark.data_ptr(),
            _stream(blocks.device),
        )
        _launch_check(rc, "backstep_wide")
        _count_launch(backstep_wide)
    return stepped, mark


backstep_wide.launches = 0


def marked_walk_wide_plain(blocks, bases: WideBases, rows, prefix_sums, codes, c2i, nplanes: int, mark_offset: int,
                           ambiguity_idx: int, mark_ratio: int, sampled_sa, bwt_len: int) -> torch.Tensor:
    """Plain version of marked_walk_wide: the walk by visits of
    backstep_wide_plain, then the int64 marked SA value at the whole rank."""

    def visit(b, pos, *args):
        return backstep_wide_plain(b, bases, pos, *args)

    return walk_by_visits(visit, window_read_plain, blocks, rows, prefix_sums, codes, c2i, nplanes, mark_offset,
                          ambiguity_idx, mark_ratio, sampled_sa, bwt_len)


def marked_walk_wide(blocks, bases: WideBases, rows, prefix_sums, codes, c2i, nplanes: int, mark_offset: int,
                     ambiguity_idx: int, mark_ratio: int, sampled_sa, bwt_len: int) -> torch.Tensor:
    """int64[R]: marked_walk over a wide index: relative milestones and mark
    milestones (``bases``), the whole mark rank, sampled_sa int64[S]."""
    if _on_cpu(blocks, bases.milestones, bases.marks, rows, prefix_sums, codes, c2i, sampled_sa):
        return marked_walk_wide_plain(blocks, bases, rows, prefix_sums, codes, c2i, nplanes, mark_offset,
                                      ambiguity_idx, mark_ratio, sampled_sa, bwt_len)
    _check_walk_args("marked_walk_wide", blocks, rows, prefix_sums, codes, c2i, nplanes, ambiguity_idx, mark_offset)
    _check_bases("marked_walk_wide", blocks, bases, codes.shape[0], marks=True)
    _check("sampled_sa", sampled_sa, torch.int64, 1)
    _check_marked("marked_walk_wide", mark_ratio, sampled_sa, bwt_len)
    r = rows.shape[0]
    out = torch.empty(r, dtype=torch.int64, device=blocks.device)
    if r:
        rc = _lib().awry_marked_walk_wide(
            *_wide_head(blocks, bases, prefix_sums, codes, c2i, nplanes), bases.marks.data_ptr(), bases.shift,
            mark_offset, ambiguity_idx, mark_ratio, sampled_sa.data_ptr(), sampled_sa.shape[0], bwt_len,
            rows.data_ptr(), r, out.data_ptr(), _stream(blocks.device),
        )
        _launch_check(rc, "marked_walk_wide")
        _count_launch(marked_walk_wide)
    return out


marked_walk_wide.launches = 0


def marked_walk_ranges_wide_plain(blocks, bases: WideBases, starts, counts, cap: int, prefix_sums, codes, c2i,
                                  nplanes: int, mark_offset: int, ambiguity_idx: int, mark_ratio: int, sampled_sa,
                                  bwt_len: int) -> torch.Tensor:
    """Plain version of marked_walk_ranges_wide: the padded rows walked by
    marked_walk_wide_plain."""
    rows = slot_rows(starts, counts, cap).reshape(-1)
    return marked_walk_wide_plain(blocks, bases, rows, prefix_sums, codes, c2i, nplanes, mark_offset, ambiguity_idx,
                                  mark_ratio, sampled_sa, bwt_len).reshape(-1, cap)


def marked_walk_ranges_wide(blocks, bases: WideBases, starts, counts, cap: int, prefix_sums, codes, c2i,
                            nplanes: int, mark_offset: int, ambiguity_idx: int, mark_ratio: int, sampled_sa,
                            bwt_len: int) -> torch.Tensor:
    """int64[B, cap]: marked_walk_ranges over a wide index, in one launch
    (counted under ``marked_walk_wide.launches`` and this entry's own)."""
    if not 1 <= cap <= 1 << 20:
        raise ValueError(f"marked_walk_ranges_wide: cap={cap}")
    if _on_cpu(blocks, bases.milestones, bases.marks, starts, counts, prefix_sums, codes, c2i, sampled_sa):
        return marked_walk_ranges_wide_plain(blocks, bases, starts, counts, cap, prefix_sums, codes, c2i, nplanes,
                                             mark_offset, ambiguity_idx, mark_ratio, sampled_sa, bwt_len)
    _check_walk_args("marked_walk_ranges_wide", blocks, starts, prefix_sums, codes, c2i, nplanes, ambiguity_idx,
                     mark_offset)
    _check_bases("marked_walk_ranges_wide", blocks, bases, codes.shape[0], marks=True)
    _check("sampled_sa", sampled_sa, torch.int64, 1)
    _check_marked("marked_walk_ranges_wide", mark_ratio, sampled_sa, bwt_len)
    _check_ranges("marked_walk_ranges_wide", starts, counts, cap)
    b = starts.shape[0]
    out = torch.empty((b, cap), dtype=torch.int64, device=blocks.device)
    if b:
        cursor = torch.zeros(4, dtype=torch.int64, device=blocks.device)
        rc = _lib().awry_marked_walk_ranges_wide(
            *_wide_head(blocks, bases, prefix_sums, codes, c2i, nplanes), bases.marks.data_ptr(), bases.shift,
            mark_offset, ambiguity_idx, mark_ratio, int(mark_ratio >= MARKED_EAGER_FROM), sampled_sa.data_ptr(),
            sampled_sa.shape[0], bwt_len, starts.data_ptr(), counts.data_ptr(), b, cap, cursor.data_ptr(),
            out.data_ptr(), _stream(blocks.device),
        )
        _launch_check(rc, "marked_walk_ranges_wide")
        _count_launch(marked_walk_wide, marked_walk_ranges_wide)
    return out


marked_walk_ranges_wide.launches = 0


def _check_wide_sampling(kernel: str, blocks, bases: WideBases, codes, sa_ratio: int, sampled_sa, bwt_len: int):
    if not 1 <= bwt_len <= blocks.shape[0] * 256 or not 1 <= sa_ratio < 2**63 or (
        sampled_sa.shape[0] != -(-bwt_len // sa_ratio)
    ):
        raise ValueError(f"{kernel}: sa_ratio={sa_ratio}, {sampled_sa.shape[0]} SA values, bwt_len={bwt_len}, "
                         f"{blocks.shape[0]} blocks")
    _check("sampled_sa", sampled_sa, torch.int64, 1)
    _check_bases(kernel, blocks, bases, codes.shape[0], marks=False)


def sampled_walk_wide_plain(blocks, bases: WideBases, rows, prefix_sums, codes, c2i, nplanes: int,
                            ambiguity_idx: int, sa_ratio: int, sampled_sa, bwt_len: int) -> torch.Tensor:
    """Plain version of sampled_walk_wide (int64 rows, steps and SA values)."""
    return sampled_walk_plain(blocks, rows, prefix_sums, codes, c2i, nplanes, ambiguity_idx, sa_ratio, sampled_sa,
                              bwt_len, bases)


def sampled_walk_wide(blocks, bases: WideBases, rows, prefix_sums, codes, c2i, nplanes: int, ambiguity_idx: int,
                      sa_ratio: int, sampled_sa, bwt_len: int) -> torch.Tensor:
    """int64[R]: sampled_walk over a wide index (``bases``; sampled_sa
    int64, rows and the modulo in 64 bits), -1 for a row still walking after
    bwt_len steps; no check of the walks' ends (the caller's, as for
    sampled_walk_launch), no device sync."""
    if _on_cpu(blocks, bases.milestones, rows, prefix_sums, codes, c2i, sampled_sa):
        return sampled_walk_wide_plain(blocks, bases, rows, prefix_sums, codes, c2i, nplanes, ambiguity_idx,
                                       sa_ratio, sampled_sa, bwt_len)
    _check_walk_args("sampled_walk_wide", blocks, rows, prefix_sums, codes, c2i, nplanes, ambiguity_idx)
    _check_wide_sampling("sampled_walk_wide", blocks, bases, codes, sa_ratio, sampled_sa, bwt_len)
    r = rows.shape[0]
    out = torch.empty(r, dtype=torch.int64, device=blocks.device)
    if r:
        cursor = torch.zeros(1, dtype=torch.int64, device=blocks.device)
        rc = _lib().awry_sampled_walk_wide(
            *_wide_head(blocks, bases, prefix_sums, codes, c2i, nplanes), bases.shift, ambiguity_idx, sa_ratio,
            sampled_sa.data_ptr(), sampled_sa.shape[0], bwt_len, rows.data_ptr(), r, cursor.data_ptr(),
            out.data_ptr(), _stream(blocks.device),
        )
        _launch_check(rc, "sampled_walk_wide")
        _count_launch(sampled_walk_wide)
    return out


sampled_walk_wide.launches = 0


def sampled_walk_ranges_wide_plain(blocks, bases: WideBases, starts, counts, cap: int, prefix_sums, codes, c2i,
                                   nplanes: int, ambiguity_idx: int, sa_ratio: int, sampled_sa,
                                   bwt_len: int) -> torch.Tensor:
    """Plain version of sampled_walk_ranges_wide: the padded rows walked by
    sampled_walk_wide_plain."""
    rows = slot_rows(starts, counts, cap).reshape(-1)
    return sampled_walk_wide_plain(blocks, bases, rows, prefix_sums, codes, c2i, nplanes, ambiguity_idx, sa_ratio,
                                   sampled_sa, bwt_len).reshape(-1, cap)


def sampled_walk_ranges_wide(blocks, bases: WideBases, starts, counts, cap: int, prefix_sums, codes, c2i,
                             nplanes: int, ambiguity_idx: int, sa_ratio: int, sampled_sa, bwt_len: int) -> torch.Tensor:
    """int64[B, cap]: sampled_walk_ranges over a wide index, in one launch
    (counted under ``sampled_walk_wide.launches``); -1 marks a walk that
    could not end, which the caller checks."""
    if not 1 <= cap <= 1 << 20:
        raise ValueError(f"sampled_walk_ranges_wide: cap={cap}")
    if _on_cpu(blocks, bases.milestones, starts, counts, prefix_sums, codes, c2i, sampled_sa):
        return sampled_walk_ranges_wide_plain(blocks, bases, starts, counts, cap, prefix_sums, codes, c2i, nplanes,
                                              ambiguity_idx, sa_ratio, sampled_sa, bwt_len)
    _check_walk_args("sampled_walk_ranges_wide", blocks, starts, prefix_sums, codes, c2i, nplanes, ambiguity_idx)
    _check_wide_sampling("sampled_walk_ranges_wide", blocks, bases, codes, sa_ratio, sampled_sa, bwt_len)
    _check("counts", counts, torch.int64, 1)
    b = starts.shape[0]
    if counts.shape[0] != b:
        raise ValueError(f"sampled_walk_ranges_wide: {b} starts, {counts.shape[0]} counts")
    out = torch.empty((b, cap), dtype=torch.int64, device=blocks.device)
    if b:
        cursor = torch.zeros(1, dtype=torch.int64, device=blocks.device)
        rc = _lib().awry_sampled_walk_ranges_wide(
            *_wide_head(blocks, bases, prefix_sums, codes, c2i, nplanes), bases.shift, ambiguity_idx, sa_ratio,
            sampled_sa.data_ptr(), sampled_sa.shape[0], bwt_len, starts.data_ptr(), counts.data_ptr(), b, cap,
            cursor.data_ptr(), out.data_ptr(), _stream(blocks.device),
        )
        _launch_check(rc, "sampled_walk_ranges_wide")
        _count_launch(sampled_walk_wide)
    return out


# -- the shard kernels -------------------------------------------------------------


def _shard_window(kernel: str, blocks, first_block: int, total_blocks: int) -> None:
    """The shard's rows are blocks [first_block, first_block + local) of a
    table of total_blocks, all block indexes within 32 bits."""
    local = blocks.shape[0]
    if not (0 <= first_block and first_block + local <= total_blocks and 0 < total_blocks < 2**32):
        raise ValueError(f"{kernel}: window of {local} blocks at {first_block} outside a table of {total_blocks}")


def owned_by(pos: torch.Tensor, first_block: int, local_blocks: int, limit: int) -> torch.Tensor:
    """Whether the window of blocks [first_block, first_block +
    local_blocks) owns each position, clamped into [0, limit)."""
    blk = pos.clamp(0, limit - 1) >> 8
    return (blk >= first_block) & (blk < first_block + local_blocks)


def occ_pair_shard_plain(blocks, first_block: int, total_blocks: int, starts, ends, sym, codes, prefix_sums,
                         nplanes: int, new_starts, new_ends):
    """Plain version of occ_pair_shard: the owned endpoints' entries of
    rank.update_range, from occ on the window's rows, written in place."""
    _shard_window("occ_pair_shard", blocks, first_block, total_blocks)
    s = sym.clamp(0, codes.shape[0] - 1)
    for pos, out, less in ((starts - 1, new_starts, 0), (ends, new_ends, 1)):
        idx = torch.nonzero(owned_by(pos, first_block, blocks.shape[0], total_blocks * 256))[:, 0]
        local = pos[idx].clamp(0, total_blocks * 256 - 1) - first_block * 256
        occ = _occ_plain(blocks, local, s[idx], codes, nplanes) & _FULL
        out[idx] = prefix_sums[s[idx].to(torch.int64)] + occ - less
    return new_starts, new_ends


def occ_pair_shard(blocks, first_block: int, total_blocks: int, starts, ends, sym, codes, prefix_sums, nplanes: int,
                   new_starts, new_ends):
    """One shard's part of an LF range update (rank.update_range), written
    in place; returns (new_starts, new_ends).

    blocks: int32[local_blocks, row_words], the fused rows of blocks
    [first_block, first_block + local_blocks) of a table of total_blocks;
    starts, ends: int64[R] inclusive ranges; sym: int32[R] symbol indices
    (clamped to the alphabet); prefix_sums: int64[cardinality + 1].  Where
    the window owns the block of ``starts - 1`` (clamped into the whole
    table) it writes ``new_starts = C[sym] + Occ(starts - 1, sym)``, where
    it owns that of ``ends`` ``new_ends = C[sym] + Occ(ends, sym) - 1``
    (int64[R] each), and nothing else: each endpoint has one owner, so the
    shards of the table together write every entry once.  The rest as for
    occ_pair."""
    _shard_window("occ_pair_shard", blocks, first_block, total_blocks)
    if _on_cpu(blocks, starts, ends, sym, codes, prefix_sums, new_starts, new_ends):
        return occ_pair_shard_plain(blocks, first_block, total_blocks, starts, ends, sym, codes, prefix_sums,
                                    nplanes, new_starts, new_ends)
    _check_rank_args("occ_pair_shard", blocks, ends, sym, codes, nplanes)
    r, card = starts.shape[0], codes.shape[0]
    for name, t in (("starts", starts), ("new_starts", new_starts), ("new_ends", new_ends)):
        _check(name, t, torch.int64, 1)
        if t.shape[0] != r:
            raise ValueError("occ_pair_shard: starts, ends, sym and the outputs must have one length")
    _check("prefix_sums", prefix_sums, torch.int64, 1)
    if prefix_sums.shape[0] != card + 1 or card > 32:
        raise ValueError(f"occ_pair_shard: {prefix_sums.shape[0]} prefix sums for {card} symbols (at most 32)")
    if r and blocks.shape[0]:
        rc = _lib().awry_occ_pair_shard(
            blocks.device.index, blocks.data_ptr(), blocks.shape[0], first_block, total_blocks, blocks.shape[1],
            nplanes, card, codes.data_ptr(), prefix_sums.data_ptr(), starts.data_ptr(), ends.data_ptr(),
            sym.data_ptr(), r, new_starts.data_ptr(), new_ends.data_ptr(), _stream(blocks.device),
        )
        _launch_check(rc, "occ_pair_shard")
        _count_launch(occ_pair_shard)
    return new_starts, new_ends


occ_pair_shard.launches = 0


def sampled_walk_shard_plain(blocks, first_block: int, total_blocks: int, rows, steps, prefix_sums, codes, c2i,
                             nplanes: int, ambiguity_idx: int, sa_ratio: int, bwt_len: int):
    """Plain version of sampled_walk_shard: backstep_plain's LF steps of the
    live rows the window owns, each until it is sampled, leaves the window
    or has taken bwt_len steps; written in place."""
    _shard_window("sampled_walk_shard", blocks, first_block, total_blocks)
    lo, local_blocks = first_block * 256, blocks.shape[0]

    def walking(p, s):
        return (p % sa_ratio != 0) & owned_by(p, first_block, local_blocks, bwt_len) & (s < bwt_len)

    pos = rows.clamp(0, bwt_len - 1)
    idx = torch.nonzero(walking(pos, steps))[:, 0]
    p, s = pos[idx], steps[idx]
    while idx.numel():
        local, r = _fetch_rows(blocks, p - lo)
        p = _lf_rows(r, local, prefix_sums, codes, c2i, nplanes, ambiguity_idx).clamp(0, bwt_len - 1)
        s = s + 1
        rows[idx], steps[idx] = p, s
        keep = walking(p, s)
        idx, p, s = idx[keep], p[keep], s[keep]
    return rows, steps


def sampled_walk_shard(blocks, first_block: int, total_blocks: int, rows, steps, prefix_sums, codes, c2i,
                       nplanes: int, ambiguity_idx: int, sa_ratio: int, bwt_len: int, *, cursor=None):
    """One shard's part of the row-sampled walks of a round's rows, in
    place; returns (rows, steps).

    blocks, first_block, total_blocks as for occ_pair_shard; rows, steps:
    int64[R], each row clamped into [0, bwt_len).  A row the window owns
    that is not sampled (``row % sa_ratio != 0``) and has taken fewer than
    bwt_len steps takes LF steps (sentinel rows step to 0) until it is
    sampled, its block lies outside the window, or its steps reach bwt_len;
    its row and steps are written back.  Every other row stays as it is,
    and no SA value is read.  prefix_sums .. ambiguity_idx as for
    sampled_walk (the mark words are not read).  cursor: the launch's work
    counter, an int64[1] zero on the rows' device that the launch uses up
    (walk_rounds zeroes one per launch of a round at once); None zeroes
    one here."""
    _shard_window("sampled_walk_shard", blocks, first_block, total_blocks)
    if not 1 <= bwt_len <= total_blocks * 256 or not 1 <= sa_ratio < 2**32:
        raise ValueError(f"sampled_walk_shard: sa_ratio={sa_ratio}, bwt_len={bwt_len}, {total_blocks} blocks")
    if _on_cpu(blocks, rows, steps, prefix_sums, codes, c2i):
        return sampled_walk_shard_plain(blocks, first_block, total_blocks, rows, steps, prefix_sums, codes, c2i,
                                        nplanes, ambiguity_idx, sa_ratio, bwt_len)
    _check_walk_args("sampled_walk_shard", blocks, rows, prefix_sums, codes, c2i, nplanes, ambiguity_idx)
    _check("steps", steps, torch.int64, 1)
    r = rows.shape[0]
    if steps.shape[0] != r:
        raise ValueError(f"sampled_walk_shard: {r} rows, {steps.shape[0]} steps")
    if r and blocks.shape[0]:
        if cursor is None:
            cursor = torch.zeros(1, dtype=torch.int64, device=blocks.device)
        elif cursor.dtype != torch.int64 or cursor.numel() != 1 or cursor.device != blocks.device:
            raise ValueError(f"sampled_walk_shard: cursor must be one int64 on {blocks.device}")
        rc = _lib().awry_sampled_walk_shard(
            blocks.device.index, blocks.data_ptr(), blocks.shape[0], first_block, total_blocks, blocks.shape[1],
            nplanes, prefix_sums.data_ptr(), codes.data_ptr(), c2i.data_ptr(), ambiguity_idx, sa_ratio, bwt_len,
            rows.data_ptr(), steps.data_ptr(), r, cursor.data_ptr(), _stream(blocks.device),
        )
        _launch_check(rc, "sampled_walk_shard")
        _count_launch(sampled_walk_shard)
    return rows, steps


sampled_walk_shard.launches = 0
