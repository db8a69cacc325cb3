"""The hand-written Hopper kernels, their plain PyTorch versions, the nvcc
build and the ctypes binding.

Five kernels (sources under ``csrc/``, each with a note on the TPU kernel
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
  (``backstep``'s per-row code; the locate walk at mark ratio > 1).

Tables are int32 tensors holding uint32 bit patterns; positions are int64;
outputs are int32 bit patterns (callers widen with ``& 0xFFFFFFFF``), but
for backstep's stepped rows and marked_walk's text positions, which are
int64 positions.

``chip_smoke.py`` holds every kernel against its plain version on the card;
``scripts/rank_kernel_study.py --kernels window_read,marked_walk`` (or
``occ_pair,occ``) times them against other builds of their sources.

A wrapper takes its plain version only when its inputs are CPU tensors; on
CUDA tensors it launches the kernel or raises.  Each wrapper counts its
launches in a ``launches`` attribute.  The kernels build on first use with
``nvcc -gencode arch=compute_90a,code=sm_90a`` (one nvcc per source, all
started together, then one link) into ``awry_tpu_torch/_build/``; the
library is named by a hash of the sources and flags, so an edited source
rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

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
        window_read.launches += 1
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
        occ_pair.launches += 1
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
        occ.launches += 1
    return out


occ.launches = 0


# -- backstep ------------------------------------------------------------------


def backstep_plain(blocks, rows, prefix_sums, codes, c2i, nplanes: int, mark_offset: int, ambiguity_idx: int):
    """Plain version of backstep (gather + SWAR popcounts)."""
    p, r = _fetch_rows(blocks, rows)
    sym = _symbol_rows(r, p, c2i, nplanes)
    sentinel = sym == 0
    safe = torch.where(sentinel, ambiguity_idx, sym)
    stepped = prefix_sums[safe] + _occ_rows(r, p, safe, codes, nplanes) - 1
    local = p & 255
    before = _word_masks(local, (1 << (local & 31)) - 1)
    marks = r[:, mark_offset : mark_offset + 8]
    mark_rank = r[:, mark_offset + 8] + popcount32(marks & before).sum(dim=1)
    packed = (mark_rank << 1) | _bit_at(r, mark_offset, p)
    return torch.where(sentinel, 0, stepped), as_int32_bits(packed)


def _check_walk_args(kernel: str, blocks, rows, prefix_sums, codes, c2i, nplanes: int, mark_offset: int,
                     ambiguity_idx: int) -> None:
    """The checks backstep and marked_walk share: dtypes and a fused row
    layout with the mark words where the kernel's uint2 loads read them."""
    _check("blocks", blocks, torch.int32, 2)
    for name, t, dt in (("rows", rows, torch.int64), ("prefix_sums", prefix_sums, torch.int64),
                        ("codes", codes, torch.int32), ("c2i", c2i, torch.int32)):
        _check(name, t, dt, 1)
    row_words = blocks.shape[1]
    card = codes.shape[0]
    if (
        nplanes not in (3, 5) or row_words % 4 or row_words < nplanes * 8 + card
        or prefix_sums.shape[0] != card + 1 or c2i.shape[0] != 1 << nplanes
        or mark_offset % 2 or mark_offset < nplanes * 8 + card or mark_offset + 9 > row_words
        or not 0 < ambiguity_idx < card
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
    _check_walk_args("backstep", blocks, rows, prefix_sums, codes, c2i, nplanes, mark_offset, ambiguity_idx)
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
        backstep.launches += 1
    return stepped, mark


backstep.launches = 0


# -- marked_walk ---------------------------------------------------------------


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
    mark_rank = (packed.to(torch.int64) & _FULL) >> 1
    sa_vals = read(sampled_sa, mark_rank, 1)[:, 0].to(torch.int64) & _FULL
    return _text_pos_mod(sa_vals, steps, bwt_len)


def marked_walk_plain(blocks, rows, prefix_sums, codes, c2i, nplanes: int, mark_offset: int, ambiguity_idx: int,
                      mark_ratio: int, sampled_sa, bwt_len: int) -> torch.Tensor:
    """Plain version of marked_walk: the walk by visits of backstep_plain,
    then window_read_plain k=1."""
    return walk_by_visits(backstep_plain, window_read_plain, blocks, rows, prefix_sums, codes, c2i, nplanes,
                          mark_offset, ambiguity_idx, mark_ratio, sampled_sa, bwt_len)


def marked_walk(blocks, rows, prefix_sums, codes, c2i, nplanes: int, mark_offset: int, ambiguity_idx: int,
                mark_ratio: int, sampled_sa, bwt_len: int) -> torch.Tensor:
    """int64[R]: the text position of each BWT row by the marked LF walk.

    Up to ``mark_ratio - 1`` LF steps per row (sentinel rows step to 0),
    stopping at the first marked row; then ``sa = sampled_sa[mark_rank]``
    at the final row (31 bits of the rank, as backstep packs it; clamped
    into the table) and ``sa + steps``, less ``bwt_len`` when that reaches
    it.  blocks .. ambiguity_idx as for backstep; sampled_sa: int32[S] the
    SA values of the marked rows in row order (uint32 bit patterns);
    bwt_len: the BWT's length."""
    if _on_cpu(blocks, rows, prefix_sums, codes, c2i, sampled_sa):
        return marked_walk_plain(blocks, rows, prefix_sums, codes, c2i, nplanes, mark_offset, ambiguity_idx,
                                 mark_ratio, sampled_sa, bwt_len)
    _check_walk_args("marked_walk", blocks, rows, prefix_sums, codes, c2i, nplanes, mark_offset, ambiguity_idx)
    _check("sampled_sa", sampled_sa, torch.int32, 1)
    if mark_ratio < 1 or sampled_sa.shape[0] < 1 or bwt_len < 1:
        raise ValueError(f"marked_walk: mark_ratio={mark_ratio}, {sampled_sa.shape[0]} SA values, bwt_len={bwt_len}")
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
        marked_walk.launches += 1
    return out


marked_walk.launches = 0
