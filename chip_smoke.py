#!/usr/bin/env python3
"""Smoke run of the PyTorch port (awry_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--record PATH]

Phases, in order; any failure raises and the script exits non-zero:

1. Device: a CUDA device is required; prints its name and power limit.
2. Build: compiles the CUDA kernels from awry_tpu_torch/csrc/ (nvcc, one
   process per source, all started together) into awry_tpu_torch/_build/.
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   card, exactly, at main-path shapes: window_read (k = 1, 2, 3, 15, k = 4
   over 4 slots per lane, and k = 5, which has no kernel of its own) over a
   1 GB SA-sized table, occ_pair, backstep and marked_walk (marks 2, 4 and
   32, over a random marked SA) over chr1-sized nucleotide rows and
   Swiss-Prot-sized amino rows (occ_pair on random pairs and on the serving
   shape, ~98 % of pairs in one block), occ over them at the k-mer build's
   full chunk, on random positions and in the build's sorted order
   (positions and rows include 0, the last row, block edges and rows past
   either end).  Each path's
   report (phases 6, 9 and 12) also holds every kernel call the path made
   on its first batch (and the k-mer build's full chunk) against the plain
   version on the same inputs.
4. chr1 path: a chr1-scale index (250 Mbp of seeded random ACGT, k-mer seed
   length 13, mark ratio 1, SA ratio 8) built by the port's builder,
   shipped to the card, then 4 batches of 524,288 30 bp reads drawn from
   the text plus a batch holding a few hundred random reads, served
   through FmQueryEngine.count_locate_stream.  Kernel launch counts are set
   to 0 just before and read just after.
5. chr1 correctness: every reported hit spells its query in the text, every
   drawn read is found at its own position, and for 64 sampled queries the
   count equals a naive overlapping scan of the text.
6. chr1 report: end-to-end queries/s and engine stats; how the time splits
   between host encode, serving from the wire and the device (profiler);
   every kernel call of the path's first batch, recorded, held exactly
   against its plain version; per-kernel device times (CUDA events, L2
   flushed before each launch by a read of 128 MB, and again under the
   earlier flush that wrote it) at the shapes the path gave each kernel,
   beside the plain version, one torch indexing call (window_read only) and
   the bound from bytes moved; two plain reads of known size under both
   flushes, the flushes' yardstick.
   The chr1 engine is then released and the card's cache emptied.
7. chr20-shaped path (bench.py chr20_64Mbp_dna: 64 Mbp, k = 13, mark ratio
   1, SA ratio 8, 30 bp reads, batches of 524,288; seeded random ACGT in one
   record instead of the assembly): one 1 kbp segment planted 3, 6 and 12
   times.  The k-mer table is built on the card (build_kmer_table_on_device:
   every range update ranked through occ, launch counts set to 0 just
   before the build) and held bit-equal to the host counting table; the
   index ships with its slot rows and is served in the slot regime (4
   batches of 524,288 drawn reads plus 512 reads: random, reads of each
   repeat, drawn), counts set to 0 just before serving.
8. chr20 correctness: every hit spells its query, every drawn read and every
   planted copy is found at its own position, 64 counts equal a naive scan,
   the repeat reads report 3, 6 and 12 hits (or more, confirmed by naive
   scan).
9. chr20 report: as phase 6, with the seed-width classes of one batch (the
   SLOT_EXT band and how many of its lanes settled), occ at the k-mer
   build's chunk shape (with and without the L2 flush), the device against
   the host k-mer build; then the regimes side by side on the same index:
   the slot regime and the switch step (slots=False) each serve the path's
   batches and 4 batches of 524,288 uniform drawn reads that overlap no
   planted copy (bench.py chr20's traffic), with the same answers, every
   drawn read at its own position, rates and device times.
10. GRCh38-shaped path (bench.py grch38_3.1Gbp_dna: 100 bp reads, batches of
   524,288, k = 13, mark ratio 4, SA ratio 8; scale cut to 1 Gbp): 24
   records in the proportions of GRCh38's chromosomes 1-22, X and Y, each
   seeded random ACGT between two 10,000-symbol N runs, joined by the N
   delimiter; one 1 kbp segment planted 3 times (wide lanes) and one 12
   times (re-dispatched lanes over the locate cap).  2 batches of 524,288
   reads drawn from record interiors plus a 512-read batch (random reads,
   reads of both repeats, reads right after a leading N run, drawn reads),
   served through count_locate_stream with the counts set to 0 just
   before.  Every locate walks the marked LF walk in one marked_walk
   launch; the path launches no backstep.
11. GRCh38 correctness, per record: every hit spells its query in its
   record, every drawn read (and every planted copy of a repeat read) is
   found at its own (record, local), 64 counts equal a naive scan, and the
   12x repeat reads report 12 hits (or more, confirmed by naive scan).
12. GRCh38 report: as phase 6, with the walks' marked_walk times, each
   beside its bound from the sectors its rows' walks touch, and backstep
   timed as one visit over each walk's rows.

The last three lines are the card's name and power limit, the kernels JSON
and {"ok": true, "device": {...}}.  ``--record PATH`` also writes the full
record (every call site, the time splits, the checks) as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import multiprocessing
import os
import subprocess
import sys
import time
from multiprocessing import shared_memory

import numpy as np
import torch

from awry_tpu_torch import Alphabet, FmBuildArgs, build_from_records
from awry_tpu_torch.alphabet import code_to_index_table, encode_ascii, index_to_code_table
from awry_tpu_torch.build.kmer_count import populate_kmer_table_counting
from awry_tpu_torch.ops import (
    FmQueryEngine,
    count_locate_slots_t,
    counts_from_ranges,
    fused_row_words,
    kernels,
    populate_kmer_table_device,
    slot_regime_capable,
    to_device,
)
from awry_tpu_torch.ops.kmer import _level_chunk
from awry_tpu_torch.ops.verify import SLOT_EXT, WIDE_CAP, unpack_verify_bundle, wide_groups

N_SYMBOLS = 250_000_000  # chr1 scale (bench.py chr1_250Mbp_dna)
KMER_LEN = 13
QLEN = 30
BATCH = 524_288
NUM_BATCHES = 4
NUM_RANDOM = 384
NUM_NAIVE = 64

# chr20-shaped path (bench.py chr20_64Mbp_dna): the slot regime.
C_SYMBOLS = 64_000_000
C_REPEATS = (3, 6, 12)  # wide-meta lanes, the SLOT_EXT band, past it

# GRCh38-shaped path (bench.py grch38_3.1Gbp_dna), scale cut to 1 Gbp.
G_SYMBOLS = 1_000_000_000
G_QLEN = 100
G_MARK = 4
G_NUM_BATCHES = 2
N_RUN = 10_000  # N symbols opening and closing each record
REPEAT_LEN = 1_000
# GRCh38 chromosome lengths in bp, chr1..chr22, chrX, chrY (GRCh38.p14).
GRCH38_LENGTHS = (
    248_956_422, 242_193_529, 198_295_559, 190_214_555, 181_538_259, 170_805_979,
    159_345_973, 145_138_636, 138_394_717, 133_797_422, 135_086_622, 133_275_309,
    114_364_328, 107_043_718, 101_991_189, 90_338_345, 83_257_441, 80_373_285,
    58_617_616, 64_444_167, 46_709_983, 50_818_468, 156_040_895, 57_227_415,
)
GRCH38_NAMES = [f"chr{i}" for i in range(1, 23)] + ["chrX", "chrY"]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
INT32_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores (data sheet)
L2_FLUSH_BYTES = 128 << 20  # > 2x the 50 MB L2
KERNELS = ("window_read", "occ_pair", "backstep", "occ", "marked_walk")
SOURCES = {name: f"awry_tpu_torch/csrc/{name}.cu" for name in KERNELS} | {
    "occ": "awry_tpu_torch/csrc/occ_pair.cu", "marked_walk": "awry_tpu_torch/csrc/backstep.cu",
}
REPLACES = {
    "window_read": "awry_tpu/ops/sweep.py:1036",  # _anchored_text_kernel
    "occ_pair": "awry_tpu/ops/sweep.py:1084",  # _occ_pair_pay_kernel_anchored (and :1062)
    "backstep": "awry_tpu/ops/sweep.py:1123",  # _backstep_kernel_anchored, one visit (backstep_mark_sweep)
    "occ": "awry_tpu/ops/sweep.py:1108",  # _occ_kernel_anchored (and :291)
    "marked_walk": "awry_tpu/ops/sweep.py:1123",  # _backstep_kernel_anchored through marked_walk_sweep (:883)
}
# Arguments of each kernel that carry per-request data (recorded as copies).
REQUEST_ARGS = {"window_read": (1,), "occ_pair": (1, 2, 3), "backstep": (1,), "occ": (1, 2), "marked_walk": (1,)}
WALK_MARKS = (2, 4, 32)  # phase 3's mark ratios for marked_walk
LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def launch_counts() -> dict:
    return {name: getattr(kernels, name).launches for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        getattr(kernels, name).launches = 0


# -- naive scans (spawned processes, each copying the text from shared memory) -

_SCAN_TEXT = b""  # the text a scan worker holds (set by its initializer)


def _scan_init(name: str, size: int) -> None:
    global _SCAN_TEXT
    shm = shared_memory.SharedMemory(name=name)
    try:
        _SCAN_TEXT = bytes(shm.buf[:size])
    finally:
        shm.close()


def _naive_count(q: bytes) -> int:
    """Overlapping occurrences of q in the worker's text."""
    n, at = 0, _SCAN_TEXT.find(q)
    while at >= 0:
        n += 1
        at = _SCAN_TEXT.find(q, at + 1)
    return n


def naive_counts(text: bytes, queries: list[bytes]) -> list[int]:
    """Naive overlapping counts of each query, scanned by one process per
    CPU; the text reaches them through shared memory (passing it as an
    argument pickles it once per process, several times slower).  The pool
    and the shared memory are released before returning."""
    shm = shared_memory.SharedMemory(create=True, size=len(text))
    try:
        shm.buf[: len(text)] = text
        ctx = multiprocessing.get_context("spawn")
        workers = min(len(queries), os.cpu_count() or 1)
        with ctx.Pool(workers, initializer=_scan_init, initargs=(shm.name, len(text))) as pool:
            return pool.map(_naive_count, queries, chunksize=1)
    finally:
        shm.close()
        shm.unlink()


# -- phase 3 -----------------------------------------------------------------


def random_words(shape, device, gen) -> torch.Tensor:
    """int32 tensor of uniformly random 32-bit patterns."""
    return torch.randint(-(2**31), 2**31, shape, device=device, generator=gen).to(torch.int32)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest difference of the values two tensors hold (int32 tensors as
    the uint32 bit patterns they carry)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{got.dtype} {tuple(got.shape)} != {want.dtype} {tuple(want.shape)}")
    mask = 0xFFFFFFFF if got.dtype == torch.int32 else -1
    diff = (got.to(torch.int64) & mask) - (want.to(torch.int64) & mask)
    return int(diff.abs().max()) if diff.numel() else 0


def kernels_vs_plain(device: torch.device, gen: torch.Generator) -> dict:
    """Each kernel against its plain version on the card, exact equality."""
    out = {}
    reqs = BATCH + BATCH // 4  # the walk's rows per verify batch (B + 4 slots per wide group)
    table = random_words((N_SYMBOLS + 1,), device, gen)
    # k = 4 over WIDE_CAP slots per lane: the slot regime's fat-row read;
    # k = 15: the 100 bp text window; k = 5: a width with no kernel of its own.
    for k, n in ((1, reqs), (2, reqs), (3, reqs), (4, WIDE_CAP * BATCH), (15, reqs + 1), (5, reqs + 3)):
        wbase = torch.randint(-8, table.shape[0] + 8, (n,), device=device, generator=gen)
        err = max_abs_err(kernels.window_read(table, wbase, k), kernels.window_read_plain(table, wbase, k))
        if err != 0:
            raise AssertionError(f"window_read k={k} disagrees with its plain version (max abs err {err})")
        out[f"window_read:k{k}"] = {"requests": n, "table_words": table.shape[0], "max_abs_err": err}
    del table, wbase
    chunk = 2 * _level_chunk(4, 4**KMER_LEN)  # occ requests of the k-mer build's full chunk
    for alphabet, symbols in ((Alphabet.NUCLEOTIDE, N_SYMBOLS), (Alphabet.AMINO, 20_000_000)):
        rw = fused_row_words(alphabet)
        nb = -(-(symbols + 1) // 256)
        blocks = random_words((nb, rw), device, gen)
        codes = torch.from_numpy(index_to_code_table(alphabet).astype(np.int32)).to(device)
        sym = torch.randint(0, alphabet.cardinality, (BATCH,), dtype=torch.int32, device=device, generator=gen)
        # occ_pair: random pairs (mostly in two blocks), then the serving
        # shape: ranges of 0-7 rows (~98 % of pairs in one block) and a
        # quarter of the lanes inactive at (1, 0).
        pos_a = torch.randint(-1, nb * 256, (BATCH,), device=device, generator=gen)
        pos_b = (pos_a + torch.randint(0, 600, (BATCH,), device=device, generator=gen)).clamp_max(nb * 256 - 1)
        serving_b = (pos_a + torch.randint(0, 8, (BATCH,), device=device, generator=gen)).clamp_max(nb * 256 - 1)
        idle = torch.rand(BATCH, device=device, generator=gen) < 0.25
        serving = (torch.where(idle, 0, pos_a), torch.where(idle, 0, serving_b))
        for key, (pa, pb) in ((f"occ_pair:{alphabet.name.lower()}", (pos_a, pos_b)),
                              (f"occ_pair:{alphabet.name.lower()}:same_block", serving)):
            got = kernels.occ_pair(blocks, pa, pb, sym, codes, alphabet.num_planes)
            want = kernels.occ_pair_plain(blocks, pa, pb, sym, codes, alphabet.num_planes)
            err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
            if err != 0:
                raise AssertionError(f"{key} disagrees with its plain version (max abs err {err})")
            same = float(((pa.clamp(0, nb * 256 - 1) >> 8) == (pb.clamp(0, nb * 256 - 1) >> 8)).float().mean())
            out[key] = {"requests": BATCH, "rows": nb, "row_words": rw, "same_block_share": same, "max_abs_err": err}

        # occ: positions 0, the last row (bwt_len - 1 = symbols), block
        # edges, past either end, then random ones; symbols past the alphabet
        # (each CTA's span too wide to stage: the direct branch).  Then the
        # k-mer build's order (staged spans): each half of the chunk holds 4
        # symbol runs, positions rising within each run about 32 apart (the
        # chr20 build's level-11 chunk: 61, level 12: 15), the second half's
        # positions 1-8 above the first's.
        edges = torch.tensor([0, symbols, 255, 256, nb * 256 - 1, nb * 256 + 7, -3], device=device)
        pos = torch.cat([edges, torch.randint(-1, nb * 256 + 8, (chunk - edges.shape[0],), device=device, generator=gen)])
        osym = torch.randint(-1, alphabet.cardinality + 1, (chunk,), dtype=torch.int32, device=device, generator=gen)
        span = min(nb * 256, chunk // 8 * 32)
        runs = torch.randint(-1, span, (4, chunk // 8), device=device, generator=gen).sort(dim=1).values.reshape(-1)
        run_sym = torch.randint(1, alphabet.cardinality, (4,), dtype=torch.int32, device=device, generator=gen)
        run_sym = run_sym.sort().values.repeat_interleave(chunk // 8)
        sorted_pos = torch.cat([runs, runs + 1 + torch.randint(0, 8, runs.shape, device=device, generator=gen)])
        for key, (p, s) in ((f"occ:{alphabet.name.lower()}", (pos, osym)),
                            (f"occ:{alphabet.name.lower()}:sorted", (sorted_pos, torch.cat([run_sym, run_sym])))):
            err = max_abs_err(kernels.occ(blocks, p, s, codes, alphabet.num_planes),
                              kernels.occ_plain(blocks, p, s, codes, alphabet.num_planes))
            if err != 0:
                raise AssertionError(f"{key} disagrees with its plain version (max abs err {err})")
            out[key] = {"requests": chunk, "rows": nb, "row_words": rw, "max_abs_err": err}

        # backstep: rows 0, the last row (bwt_len - 1 = symbols), past the
        # end and below 0, then random rows.
        c2i = torch.from_numpy(code_to_index_table(alphabet).astype(np.int32)).to(device)
        prefix_sums = torch.randint(0, 2**32, (alphabet.cardinality + 1,), device=device, generator=gen)
        edges = torch.tensor([0, symbols, symbols + 1, nb * 256 - 1, nb * 256 + 7, -3], device=device)
        rows = torch.cat([edges, torch.randint(0, nb * 256, (reqs - edges.shape[0],), device=device, generator=gen)])
        args = (blocks, rows, prefix_sums, codes, c2i, alphabet.num_planes,
                alphabet.num_planes * 8 + alphabet.cardinality, alphabet.ambiguity_idx)
        got = kernels.backstep(*args)
        want = kernels.backstep_plain(*args)
        err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
        if err != 0:
            raise AssertionError(f"backstep ({alphabet.name}) disagrees with its plain version (max abs err {err})")
        out[f"backstep:{alphabet.name.lower()}"] = {"requests": reqs, "rows": nb, "row_words": rw, "max_abs_err": err}

        # marked_walk on the same rows: random mark bits stop half the lanes
        # at each visit; random prefix sums step rows past either end.
        for mark in WALK_MARKS:
            sa = random_words((-(-(symbols + 1) // mark),), device, gen)
            walk = (*args, mark, sa, symbols + 1)
            err = max_abs_err(kernels.marked_walk(*walk), kernels.marked_walk_plain(*walk))
            if err != 0:
                raise AssertionError(f"marked_walk ({alphabet.name}, mark {mark}) disagrees with its plain version "
                                     f"(max abs err {err})")
            out[f"marked_walk:{alphabet.name.lower()}:mark{mark}"] = {
                "requests": reqs, "rows": nb, "row_words": rw, "sa_words": sa.shape[0], "max_abs_err": err,
            }
            del sa
        del blocks, pos_a, pos_b, serving_b, serving, sym, pos, osym, runs, sorted_pos, rows, got, want
    return out


# -- serving a path ------------------------------------------------------------


@contextlib.contextmanager
def recording_kernel_inputs(calls: list, want=lambda name, args: True):
    """Record the inputs of every kernel call made inside the block for
    which ``want(name, args)`` holds (the wrappers themselves still run)."""
    real = {name: getattr(kernels, name) for name in KERNELS}

    def recorder(name):
        fn, keep = real[name], REQUEST_ARGS[name]

        def rec(*args):
            if want(name, args):
                calls.append((name, tuple(a.clone() if i in keep else a for i, a in enumerate(args))))
            return fn(*args)

        # A wrapper counts its launches on the function its module name
        # binds, so while patched the counts land on this stand-in.
        rec.launches = 0
        return rec

    for name in KERNELS:
        setattr(kernels, name, recorder(name))
    try:
        yield calls
    finally:
        for name in KERNELS:
            setattr(kernels, name, real[name])


def serve(engine: FmQueryEngine, batches: list, device: torch.device) -> dict:
    """Warm up on the first batch (recording the inputs the path gives each
    kernel), then serve every batch with the launch counts set to 0 just
    before and read just after."""
    calls: list = []
    with recording_kernel_inputs(calls):
        next(engine.count_locate_stream([batches[0]]))
    for k in engine.stats:
        engine.stats[k] = 0
    reset_launch_counts()
    t0 = time.perf_counter()
    results = list(engine.count_locate_stream(batches))
    torch.cuda.synchronize(device)
    serve_s = time.perf_counter() - t0
    return {"results": results, "serve_s": serve_s, "launches": launch_counts(), "calls": calls,
            "queries": sum(len(b) for b in batches)}


def ship(index, device: torch.device, **kw) -> tuple[FmQueryEngine, float]:
    t0 = time.perf_counter()
    engine = FmQueryEngine(index, device=device, **kw)
    torch.cuda.synchronize(device)
    ship_s = time.perf_counter() - t0
    dev = engine.device_index
    table_bytes = {
        name: getattr(dev, name).numel() * getattr(dev, name).element_size()
        for name in ("blocks", "kmer_flat", "text_sampled_sa", "text_packed", "vw_flat")
        if getattr(dev, name) is not None
    }
    log(f"index on {device}: ship {ship_s:.3f} s, {'slot regime' if engine._verify_slots else 'switch step'} "
        f"s={engine._verify_s}, mark ratio {dev.mark_ratio}, tables {table_bytes}")
    return engine, ship_s


def chr1_path(device: torch.device, rng: np.random.Generator) -> dict:
    text_np = LETTERS[rng.integers(0, 4, size=N_SYMBOLS, dtype=np.uint8)]
    text = text_np.tobytes()

    t0 = time.perf_counter()
    index = build_from_records(
        [("chr1_synthetic", text)],
        FmBuildArgs(lookup_table_kmer_len=KMER_LEN, locate_mark_ratio=1, suffix_array_compression_ratio=8),
    )
    build_s = time.perf_counter() - t0
    log(f"host index build seconds: {build_s:.3f}")
    engine, ship_s = ship(index, device)
    del index

    # Reads drawn from the text (each batch keeps its start positions), and
    # a last batch of random reads with a few drawn ones.
    starts = [rng.integers(0, N_SYMBOLS - QLEN, size=BATCH) for _ in range(NUM_BATCHES)]
    rnd = LETTERS[rng.integers(0, 4, size=(NUM_RANDOM, QLEN), dtype=np.uint8)]
    tail_starts = rng.integers(0, N_SYMBOLS - QLEN, size=512 - NUM_RANDOM)
    batches = [[text[s : s + QLEN] for s in st.tolist()] for st in starts]
    batches.append([r.tobytes() for r in rnd] + [text[s : s + QLEN] for s in tail_starts.tolist()])
    run = serve(engine, batches, device)
    run.update({
        "text_np": text_np, "text": text, "engine": engine, "build_s": build_s, "ship_s": ship_s,
        "starts": starts, "tail_starts": tail_starts, "random_reads": rnd, "batches": batches,
    })
    return run


def grch38_text(rng: np.random.Generator):
    """The joined text (uint8 ASCII) of 24 records in GRCh38's chromosome
    proportions summing to G_SYMBOLS, each seeded random ACGT between two
    N_RUN N runs, joined by the N delimiter; plus record starts and
    lengths."""
    w = np.asarray(GRCH38_LENGTHS, dtype=np.float64)
    lengths = np.floor(w / w.sum() * G_SYMBOLS).astype(np.int64)
    lengths[0] += G_SYMBOLS - int(lengths.sum())
    starts = np.concatenate([[0], np.cumsum(lengths + 1)[:-1]]).astype(np.int64)
    text = LETTERS[rng.integers(0, 4, size=int(lengths.sum()) + len(lengths) - 1, dtype=np.uint8)]
    for s, ln in zip(starts.tolist(), lengths.tolist()):
        text[s : s + N_RUN] = ord("N")
        text[s + ln - N_RUN : s + ln + 1] = ord("N")  # closing run and the delimiter
    return text, starts, lengths


def plant_repeats(rng, text, starts, lengths, counts=(3, 12), margin=N_RUN) -> list[tuple[np.ndarray, np.ndarray]]:
    """Copy one REPEAT_LEN segment per entry of ``counts`` to that many
    random, non-overlapping places at least ``margin`` inside a record;
    returns each segment with its copies' global positions."""
    weights = lengths / lengths.sum()
    taken: list[int] = []
    out = []
    for copies in counts:
        seg = LETTERS[rng.integers(0, 4, size=REPEAT_LEN, dtype=np.uint8)]
        pos: list[int] = []
        while len(pos) < copies:
            r = int(rng.choice(len(lengths), p=weights))
            p = int(starts[r] + margin + rng.integers(0, lengths[r] - 2 * margin - REPEAT_LEN))
            if all(abs(p - q) >= REPEAT_LEN for q in taken):
                taken.append(p)
                pos.append(p)
        for p in pos:
            text[p : p + REPEAT_LEN] = seg
        out.append((seg, np.asarray(sorted(pos), dtype=np.int64)))
    return out


def draw_positions(rng, starts, lengths, n: int) -> np.ndarray:
    """n global read starts uniform over the records' non-N interiors."""
    valid = lengths - 2 * N_RUN - G_QLEN + 1
    cum = np.cumsum(valid)
    u = rng.integers(0, cum[-1], size=n)
    r = np.searchsorted(cum, u, side="right")
    return starts[r] + N_RUN + (u - (cum[r] - valid[r]))


def grch38_path(device: torch.device, rng: np.random.Generator) -> dict:
    t0 = time.perf_counter()
    text_np, rec_starts, rec_lengths = grch38_text(rng)
    repeats = plant_repeats(rng, text_np, rec_starts, rec_lengths)
    text = text_np.tobytes()
    records = [(name, text[s : s + ln]) for name, s, ln in zip(GRCH38_NAMES, rec_starts.tolist(), rec_lengths.tolist())]
    log(f"text: {len(records)} records, {text_np.shape[0]} symbols ({time.perf_counter() - t0:.3f} s)")

    t0 = time.perf_counter()
    index = build_from_records(
        records,
        FmBuildArgs(lookup_table_kmer_len=KMER_LEN, locate_mark_ratio=G_MARK, suffix_array_compression_ratio=8),
    )
    build_s = time.perf_counter() - t0
    del records
    log(f"host index build seconds: {build_s:.3f}")
    if not np.array_equal(index.seq_starts, rec_starts):
        raise AssertionError("record starts of the index disagree with the joined text")
    engine, ship_s = ship(index, device)
    del index

    # Per batch: the reads' symbols [n, G_QLEN] and the required hits as
    # (query, global position) pairs.
    ar = np.arange(G_QLEN)
    batches, qsyms, required = [], [], []
    for _ in range(G_NUM_BATCHES):
        st = draw_positions(rng, rec_starts, rec_lengths, BATCH)
        batches.append([text[s : s + G_QLEN] for s in st.tolist()])
        qsyms.append(text_np[st[:, None] + ar])
        required.append((np.arange(BATCH), st))
    # Tail batch: 256 random reads, 64 reads of each repeat, 64 reads
    # starting 0-3 symbols after a leading N run, 64 drawn reads.
    rnd = LETTERS[rng.integers(0, 4, size=(256, G_QLEN), dtype=np.uint8)]
    rep_off = [rng.integers(0, REPEAT_LEN - G_QLEN + 1, size=64) for _ in repeats]
    rep_reads = [seg[o[:, None] + ar] for (seg, _), o in zip(repeats, rep_off)]
    after_n = rec_starts[rng.integers(0, len(rec_starts), size=64)] + N_RUN + rng.integers(0, 4, size=64)
    drawn = draw_positions(rng, rec_starts, rec_lengths, 64)
    tail_syms = np.concatenate([rnd, *rep_reads, text_np[after_n[:, None] + ar], text_np[drawn[:, None] + ar]])
    batches.append([r.tobytes() for r in tail_syms])
    qsyms.append(tail_syms)
    q_idx, q_pos = [np.arange(384, 512)], [np.concatenate([after_n, drawn])]
    for i, ((_, copies), o) in enumerate(zip(repeats, rep_off)):
        lanes = 256 + 64 * i + np.arange(64)
        q_idx.append(np.repeat(lanes, len(copies)))
        q_pos.append((o[:, None] + copies[None, :]).reshape(-1))
    required.append((np.concatenate(q_idx), np.concatenate(q_pos)))

    run = serve(engine, batches, device)
    run.update({
        "text_np": text_np, "text": text, "engine": engine, "build_s": build_s, "ship_s": ship_s,
        "rec_starts": rec_starts, "rec_lengths": rec_lengths, "repeats": repeats, "batches": batches,
        "qsyms": qsyms, "required": required, "qlen": G_QLEN,
        "repeat_lanes": [256 + 64 * i + np.arange(64) for i in range(len(repeats))],
    })
    return run


def chr20_path(device: torch.device, rng: np.random.Generator) -> dict:
    text_np = LETTERS[rng.integers(0, 4, size=C_SYMBOLS, dtype=np.uint8)]
    rec_starts, rec_lengths = np.array([0]), np.array([C_SYMBOLS])
    repeats = plant_repeats(rng, text_np, rec_starts, rec_lengths, counts=C_REPEATS, margin=0)
    text = text_np.tobytes()

    # The build, its k-mer table on the card: launch counts from 0.
    args = FmBuildArgs(lookup_table_kmer_len=KMER_LEN, locate_mark_ratio=1, suffix_array_compression_ratio=8,
                       build_kmer_table_on_device=True)
    reset_launch_counts()
    t0 = time.perf_counter()
    index = build_from_records([("chr20_synthetic", text)], args, device=device)
    build_s = time.perf_counter() - t0
    build_launches = launch_counts()
    log(f"index build seconds: {build_s:.3f}; launches {build_launches}")
    require_launches("chr20 k-mer build", build_launches, ("occ",))

    # The host counting table of the same text, the device build timed
    # alone, and once more under the profiler (recording its first
    # full-chunk occ call for the report).
    t0 = time.perf_counter()
    host_table = populate_kmer_table_counting(encode_ascii(Alphabet.NUCLEOTIDE, text_np), Alphabet.NUCLEOTIDE, KMER_LEN)
    host_kmer_s = time.perf_counter() - t0
    if not np.array_equal(index.kmer_table, host_table):
        raise AssertionError("the k-mer table built on the card differs from the host counting table")
    minimal = to_device(index, device, minimal=True)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    again = populate_kmer_table_device(minimal, KMER_LEN)
    device_kmer_s = time.perf_counter() - t0
    if not np.array_equal(again, host_table):
        raise AssertionError("the timed k-mer build on the card differs from the host counting table")
    del again
    full = 2 * _level_chunk(4, 4**KMER_LEN)
    occ_calls: list = []
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with (recording_kernel_inputs(occ_calls, lambda name, a: name == "occ" and a[1].shape[0] == full and not occ_calls),
          torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof):
        again = populate_kmer_table_device(minimal, KMER_LEN)
    device_kmer_warm_s = time.perf_counter() - t0
    if not np.array_equal(again, host_table):
        raise AssertionError("the profiled k-mer build on the card differs from the host counting table")
    del minimal, again, host_table
    events = prof.key_averages()

    def device_s(match=""):
        return sum(getattr(e, "self_device_time_total", 0) for e in events if match in e.key) / 1e6

    kmer_build = {"device_s": device_kmer_s, "device_profiled_s": device_kmer_warm_s,
                  "warm_device_busy_s": device_s(), "warm_table_copy_to_host_s": device_s("Memcpy DtoH"),
                  "warm_occ_kernels_s": device_s("occ_kernel"), "host_counting_s": host_kmer_s,
                  "occ_requests_per_full_chunk": full}
    log(f"k-mer table (k={KMER_LEN}) equal to the host counting table: {json.dumps(kmer_build)}")

    capable = slot_regime_capable(index)
    engine, ship_s = ship(index, device)
    if not (capable and engine._verify_slots and engine._verify_s == KMER_LEN):
        raise AssertionError(f"the chr20-shaped index is not served in the slot regime (capable {capable})")

    # 4 batches of drawn reads; a tail of 128 random reads, 96 reads of each
    # repeat and 96 drawn reads.
    ar = np.arange(QLEN)
    batches, qsyms, required = [], [], []
    for _ in range(NUM_BATCHES):
        st = rng.integers(0, C_SYMBOLS - QLEN, size=BATCH)
        batches.append([text[s : s + QLEN] for s in st.tolist()])
        qsyms.append(text_np[st[:, None] + ar])
        required.append((np.arange(BATCH), st))
    rnd = LETTERS[rng.integers(0, 4, size=(128, QLEN), dtype=np.uint8)]
    rep_off = [rng.integers(0, REPEAT_LEN - QLEN + 1, size=96) for _ in repeats]
    drawn = rng.integers(0, C_SYMBOLS - QLEN, size=96)
    tail_syms = np.concatenate([rnd, *[seg[o[:, None] + ar] for (seg, _), o in zip(repeats, rep_off)],
                                text_np[drawn[:, None] + ar]])
    batches.append([r.tobytes() for r in tail_syms])
    qsyms.append(tail_syms)
    repeat_lanes = [128 + 96 * i + np.arange(96) for i in range(len(repeats))]
    q_idx, q_pos = [416 + np.arange(96)], [drawn]
    for lanes, (_, copies), o in zip(repeat_lanes, repeats, rep_off):
        q_idx.append(np.repeat(lanes, len(copies)))
        q_pos.append((o[:, None] + copies[None, :]).reshape(-1))
    required.append((np.concatenate(q_idx), np.concatenate(q_pos)))

    # bench.py chr20's traffic, for the regime comparison: 4 batches of
    # uniform drawn reads, none overlapping a planted copy.
    planted = np.concatenate([copies for _, copies in repeats])
    uniform_starts = []
    for _ in range(NUM_BATCHES):
        st = rng.integers(0, C_SYMBOLS - QLEN, size=BATCH + 4096)
        near = ((st[:, None] > planted - QLEN) & (st[:, None] < planted + REPEAT_LEN)).any(axis=1)
        uniform_starts.append(st[~near][:BATCH])
        if uniform_starts[-1].shape[0] != BATCH:
            raise AssertionError("too few uniform reads clear of the planted copies")

    run = serve(engine, batches, device)
    run.update({
        "text_np": text_np, "text": text, "engine": engine, "build_s": build_s, "ship_s": ship_s,
        "rec_starts": rec_starts, "rec_lengths": rec_lengths, "repeats": repeats, "batches": batches,
        "qsyms": qsyms, "required": required, "qlen": QLEN, "repeat_lanes": repeat_lanes,
        "build_launches": build_launches, "kmer_build": kmer_build, "occ_call": occ_calls[0][1],
        "index": index, "uniform_starts": uniform_starts,
        "uniform_batches": [[text[s : s + QLEN] for s in st.tolist()] for st in uniform_starts],
    })
    return run


# -- correctness -----------------------------------------------------------------


def check_chr1(run: dict, rng: np.random.Generator) -> dict:
    text_np, text = run["text_np"], run["text"]
    n = text_np.shape[0]
    ar = np.arange(QLEN)
    checked_hits = 0
    all_starts = run["starts"] + [None]
    for b, (res, st) in enumerate(zip(run["results"], all_starts)):
        counts, seq_idx, local, offsets = res
        nb = len(run["batches"][b])
        if counts.shape[0] != nb or offsets.shape[0] != nb + 1 or offsets[-1] != local.shape[0]:
            raise AssertionError(f"batch {b}: malformed result shapes")
        if not (np.diff(offsets) == counts.astype(np.int64)).all() or (seq_idx != 0).any():
            raise AssertionError(f"batch {b}: offsets/counts/records disagree")
        if ((local < 0) | (local > n - QLEN)).any():
            raise AssertionError(f"batch {b}: hit position outside the text")
        qidx = np.repeat(np.arange(nb), counts.astype(np.int64))
        if st is None:
            qsyms = np.concatenate(
                [run["random_reads"], text_np[run["tail_starts"][:, None] + ar]]
            )
            drawn = np.arange(NUM_RANDOM, nb)
            own = np.concatenate([np.full(NUM_RANDOM, -1), run["tail_starts"]])
        else:
            qsyms = text_np[st[:, None] + ar]
            drawn = np.arange(nb)
            own = st
        if not (text_np[local[:, None] + ar] == qsyms[qidx]).all():
            raise AssertionError(f"batch {b}: a reported hit does not spell its query")
        if (counts[drawn] < 1).any():
            raise AssertionError(f"batch {b}: a read drawn from the text was not found")
        key = qidx * (n + 1) + local
        if not np.isin(drawn * (n + 1) + own[drawn], key).all():
            raise AssertionError(f"batch {b}: a drawn read's own position is missing")
        checked_hits += local.shape[0]
    # Naive overlapping scans: drawn reads of batch 0 and the random reads.
    c0 = run["results"][0][0]
    cl = run["results"][-1][0]
    picks = [(run["batches"][0][i], int(c0[i])) for i in rng.integers(0, len(c0), size=NUM_NAIVE - 16)]
    picks += [(run["batches"][-1][i], int(cl[i])) for i in range(16)]
    for (q, c), want in zip(picks, naive_counts(text, [q for q, _ in picks])):
        if c != want:
            raise AssertionError(f"count {c} != naive scan {want} for {q!r}")
    return {"hits_checked": checked_hits, "naive_checked": len(picks)}


def check_records(run: dict, rng: np.random.Generator) -> dict:
    """Per record: every hit spells its query, every required (query,
    position) pair is found, 64 counts equal a naive scan, and every repeat
    read reports at least its copies (more only if a naive scan agrees)."""
    text_np, text = run["text_np"], run["text"]
    rec_starts, rec_lengths = run["rec_starts"], run["rec_lengths"]
    total = text_np.shape[0]
    qlen = run["qlen"]
    ar = np.arange(qlen)
    checked_hits = 0
    for b, res in enumerate(run["results"]):
        counts, seq_idx, local, offsets = res
        nb = len(run["batches"][b])
        if counts.shape[0] != nb or offsets.shape[0] != nb + 1 or offsets[-1] != local.shape[0]:
            raise AssertionError(f"batch {b}: malformed result shapes")
        if not (np.diff(offsets) == counts.astype(np.int64)).all():
            raise AssertionError(f"batch {b}: offsets and counts disagree")
        if ((seq_idx < 0) | (seq_idx >= len(rec_starts))).any():
            raise AssertionError(f"batch {b}: hit in no record")
        if ((local < 0) | (local > rec_lengths[seq_idx] - qlen)).any():
            raise AssertionError(f"batch {b}: hit position outside its record")
        gpos = rec_starts[seq_idx] + local
        qidx = np.repeat(np.arange(nb), counts.astype(np.int64))
        if not (text_np[gpos[:, None] + ar] == run["qsyms"][b][qidx]).all():
            raise AssertionError(f"batch {b}: a reported hit does not spell its query in its record")
        q_req, pos_req = run["required"][b]
        if not np.isin(q_req * (total + 1) + pos_req, qidx * (total + 1) + gpos).all():
            raise AssertionError(f"batch {b}: a drawn read or a planted copy was not found at its own position")
        checked_hits += local.shape[0]

    # Naive scans: 48 drawn reads of batch 0, 16 random reads of the tail,
    # and every repeat read whose count is not its number of copies.
    c0, cl = run["results"][0][0], run["results"][-1][0]
    tail = run["batches"][-1]
    picks = [(run["batches"][0][i], int(c0[i])) for i in rng.integers(0, len(c0), size=NUM_NAIVE - 16)]
    picks += [(tail[i], int(cl[i])) for i in range(16)]
    repeat_counts = {}
    for lanes, (_, copies) in zip(run["repeat_lanes"], run["repeats"]):
        c = cl[lanes].astype(np.int64)
        if (c < len(copies)).any():
            raise AssertionError(f"a {len(copies)}x repeat read reports fewer hits than its copies")
        picks += [(tail[j], int(cl[j])) for j in lanes[c != len(copies)]]
        repeat_counts[f"{len(copies)}x"] = np.bincount(c).nonzero()[0].tolist()
    for (q, c), want in zip(picks, naive_counts(text, [q for q, _ in picks])):
        if c != want:
            raise AssertionError(f"count {c} != naive scan {want} for {q[:20]!r}...")
    return {"hits_checked": checked_hits, "naive_checked": len(picks), "repeat_counts_seen": repeat_counts}


# -- reports -------------------------------------------------------------------


def make_flush(device) -> torch.Tensor:
    """The L2 flush buffer: L2_FLUSH_BYTES written once, here."""
    return torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=device)


def time_ms(fn, device, reps: int, flush: torch.Tensor | None, write_flush: bool = False) -> float:
    """Mean device time of fn() over reps launches, the L2 flushed before
    each unless ``flush`` is None.

    The flush reads ``flush`` (more than twice the 50 MB L2), which nothing
    writes after make_flush: the timed launch finds L2 full of clean lines
    of no use to it.  ``write_flush`` zeroes the buffer instead, the flush
    this script used before, kept to compare: it leaves up to 50 MB of
    dirty lines, and their write-back to device memory lands inside the
    timed launch."""
    fn()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            if write_flush:
                flush.zero_()
            else:
                flush.sum()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def window_read_bound(flat, wbase, k) -> tuple[float, float]:
    """(bytes, ops) the call must move: each distinct 32 B sector of the
    table its requests touch, the int64 request and the k output words."""
    wb = wbase.clamp(k - 1, flat.shape[0] - 1)
    words = (wb[:, None] - torch.arange(k, device=wb.device)).reshape(-1)
    sectors = torch.unique(words >> 3).numel()
    r = wbase.shape[0]
    return float(sectors * 32 + r * 8 + r * k * 4), 0.0


def occ_pair_bound(blocks, pos_a, pos_b, sym, codes, nplanes) -> tuple[float, float]:
    """(bytes, ops): each distinct 32 B sector touched (V plane sectors per
    distinct row, the milestone's sector per distinct (row, sector)), the
    20 B of request and 8 B of result per request; ops: per endpoint V*8
    XOR + V*8 AND + 8 mask AND + 8 popcount + 8 add + 1 milestone add."""
    rw = blocks.shape[1]
    spr = rw // 8  # 32 B sectors per row
    nbits = blocks.shape[0] * 256
    rows = torch.cat([pos_a.clamp(0, nbits - 1), pos_b.clamp(0, nbits - 1)]) >> 8
    s2 = torch.cat([sym, sym]).to(torch.int64)
    plane = (rows[:, None] * spr + torch.arange(nplanes, device=rows.device)).reshape(-1)
    mile = rows * spr + ((nplanes * 8 + s2) >> 3)
    sectors = torch.unique(torch.cat([plane, mile])).numel()
    r = pos_a.shape[0]
    ops = 2 * r * (nplanes * 16 + 8 * 3 + 1)
    return float(sectors * 32 + r * 28), float(ops)


def occ_bound(blocks, pos, sym, codes, nplanes) -> tuple[float, float]:
    """(bytes, ops): each distinct 32 B sector touched (V plane sectors per
    distinct row, the milestone's sector per distinct (row, sector)), the
    12 B of request and 4 B of result per request; ops per request V*8 XOR
    + V*8 AND + 8 mask AND + 8 popcount + 8 add + 1 milestone add."""
    spr = blocks.shape[1] // 8  # 32 B sectors per row
    rows = pos.clamp(0, blocks.shape[0] * 256 - 1) >> 8
    s = sym.clamp(0, codes.shape[0] - 1).to(torch.int64)
    plane = (rows[:, None] * spr + torch.arange(nplanes, device=rows.device)).reshape(-1)
    sectors = torch.unique(torch.cat([plane, rows * spr + ((nplanes * 8 + s) >> 3)])).numel()
    r = pos.shape[0]
    return float(sectors * 32 + r * 16), float(r * (nplanes * 16 + 8 * 3 + 1))


def backstep_bound(blocks, rows, prefix_sums, codes, c2i, nplanes, mark_offset, ambiguity_idx) -> tuple[float, float]:
    """(bytes, ops): each distinct 32 B sector the visits touch (V plane
    sectors per distinct row, the sector of the stepped symbol's milestone,
    the sectors of the mark words up to the row's word and the mark
    milestone's), the 8 B row in and the 12 B of results per request; ops
    per visit: symbol V*3, rank V*16 + 8*3 + 2, mark bit and rank 8*3 + 4."""
    spr = blocks.shape[1] // 8
    p, r = kernels._fetch_rows(blocks, rows)
    sym = kernels._symbol_rows(r, p, c2i, nplanes)
    del r
    safe = torch.where(sym == 0, ambiguity_idx, sym)
    base = (p >> 8) * spr
    word = (p & 255) >> 5
    sectors = torch.unique(torch.cat([
        (base[:, None] + torch.arange(nplanes, device=p.device)).reshape(-1),
        base + ((nplanes * 8 + safe) >> 3),
        base + (mark_offset >> 3),
        base + ((mark_offset + word) >> 3),
        base + ((mark_offset + 8) >> 3),
    ])).numel()
    n = rows.shape[0]
    ops = n * (nplanes * 3 + nplanes * 16 + 8 * 3 + 2 + 8 * 3 + 4)
    return float(sectors * 32 + n * 20), float(ops)


def marked_walk_bound(blocks, rows, prefix_sums, codes, c2i, nplanes, mark_offset, ambiguity_idx, mark_ratio,
                      sampled_sa, bwt_len) -> tuple[float, float]:
    """(bytes, ops) of the walks these rows take: each distinct 32 B sector
    the visits touch (a stepping visit: the sector of the row's mark word,
    the V plane sectors and the stepped symbol's milestone sector; a final
    visit: the sectors of the mark words up to the row's word and of the
    mark milestone), each distinct sector of the marked SA read, and 16 B
    per lane (the row in, the text position out); ops: backstep's per
    stepping visit, the mark rank and 4 more per lane."""
    spr = blocks.shape[1] // 8
    visit_args = (prefix_sums, codes, c2i, nplanes, mark_offset, ambiguity_idx)
    sectors, sa_sectors, stepping_visits = [], [], 0
    pos = rows
    for visit in range(1, mark_ratio + 1):
        p, r = kernels._fetch_rows(blocks, pos)
        base = (p >> 8) * spr
        word = (p & 255) >> 5
        final = (kernels._bit_at(r, mark_offset, p) == 1) | (visit == mark_ratio)
        sym = kernels._symbol_rows(r, p, c2i, nplanes)
        del r
        safe = torch.where(sym == 0, ambiguity_idx, sym)
        step = ~final
        sectors += [
            base + ((mark_offset + word) >> 3),
            base[final] + (mark_offset >> 3),
            base[final] + ((mark_offset + 8) >> 3),
            (base[step][:, None] + torch.arange(nplanes, device=p.device)).reshape(-1),
            base[step] + ((nplanes * 8 + safe[step]) >> 3),
        ]
        _, packed = kernels.backstep_plain(blocks, pos[final], *visit_args)
        rank = ((packed.to(torch.int64) & 0xFFFFFFFF) >> 1).clamp_max(sampled_sa.shape[0] - 1)
        sa_sectors.append(rank >> 3)
        stepping_visits += int(step.sum())
        pos = kernels.backstep_plain(blocks, pos[step], *visit_args)[0]
        if not pos.numel():
            break
    distinct = torch.unique(torch.cat(sectors)).numel() + torch.unique(torch.cat(sa_sectors)).numel()
    n = rows.shape[0]
    ops = stepping_visits * (nplanes * 3 + nplanes * 16 + 8 * 3 + 2 + 3) + n * (8 * 3 + 4 + 4)
    return float(distinct * 32 + n * 16), float(ops)


def time_split(run: dict, device: torch.device) -> dict:
    """Where the end-to-end time goes, over the path's full batches: the
    host encode alone, the same batches served from their pre-encoded wire,
    and the device time of that serving from a profiler trace (its share of
    the wire-served wall time is the device busy share)."""
    engine = run["engine"]
    full = [b for b in run["batches"] if len(b) == len(run["batches"][0])]
    t0 = time.perf_counter()
    wires = [(*engine.encode_queries(b), len(b)) for b in full]
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in engine.count_locate_stream(wires):
        pass
    torch.cuda.synchronize(device)
    wire_s = time.perf_counter() - t0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in engine.count_locate_stream(wires):
            pass
        torch.cuda.synchronize(device)
    events = prof.key_averages()
    device_us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    top = sorted(events, key=lambda e: -getattr(e, "self_device_time_total", 0))[:8]
    return {
        "batches": len(full), "queries": sum(len(b) for b in full), "encode_s": encode_s,
        "wire_serve_s": wire_s, "device_s": device_us / 1e6 if device_us else None,
        "device_busy_share": device_us / 1e6 / wire_s if device_us else None,
        "top_device_ops_us": {e.key: getattr(e, "self_device_time_total", 0) for e in top},
    }


def result_err(got, want) -> int:
    """max_abs_err over a kernel's outputs (a tensor or a tuple of them)."""
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(got, want, strict=True))
    return max_abs_err(got, want)


def kernel_report(run: dict, device: torch.device) -> tuple[list[dict], dict, dict]:
    """Every recorded call held exactly against its plain version on the
    same inputs; then per call site of one verify batch, and per kernel
    summed over them; and per kernel the calls checked and their largest
    error."""
    engine = run["engine"]
    dev = engine.device_index
    batch = len(run["batches"][0])
    names = {id(dev.kmer_flat): "seed", id(dev.text_sampled_sa): "sa", id(dev.text_packed): "text",
             id(dev.vw_flat): "slot fat"}
    flush = make_flush(device)
    rows = []
    per_kernel = {}
    walks = visits = 0
    # The k-mer build's occ call (chr20 path) is timed beside the serving
    # calls, and backstep (off the serving path) as one visit over the rows
    # of each full-batch walk.
    calls = run["calls"] + ([("occ", run["occ_call"])] if "occ_call" in run else [])
    calls += [("backstep", a[:8]) for kind, a in run["calls"] if kind == "marked_walk" and a[1].shape[0] >= batch]
    checked: dict = {}
    for kind, args in calls:
        fn = getattr(kernels, kind)
        plain = getattr(kernels, f"{kind}_plain")
        err = result_err(fn(*args), plain(*args))
        if err != 0:
            raise AssertionError(f"{kind} disagrees with its plain version on a main-path call "
                                 f"({args[1].shape[0]} requests): max abs err {err}")
        c = checked.setdefault(kind, {"calls": 0, "max_abs_err": 0})
        c["calls"] += 1
        c["max_abs_err"] = max(c["max_abs_err"], err)
        if args[1].shape[0] < batch:
            continue  # a re-dispatch call, not the verify path's: checked, not timed
        ms = time_ms(lambda: fn(*args), device, 20, flush)
        ms_wf = time_ms(lambda: fn(*args), device, 20, flush, write_flush=True)
        plain_ms = time_ms(lambda: plain(*args), device, 5, flush)
        lib_ms = lib_ms_wf = warm_ms = None
        if kind == "window_read":
            flat, wbase, k = args
            site = f"{names.get(id(flat), 'table')} k={k}"
            idx = wbase.clamp(k - 1, flat.shape[0] - 1)[:, None] - torch.arange(k, device=device)
            lib_ms = time_ms(lambda: flat[idx], device, 20, flush)
            lib_ms_wf = time_ms(lambda: flat[idx], device, 20, flush, write_flush=True)
            nbytes, ops = window_read_bound(*args)
        elif kind == "occ_pair":
            site = "rank step"
            nbytes, ops = occ_pair_bound(*args)
        elif kind == "occ":
            # The build's rows (40 MB at chr20 scale) stay in L2 between its
            # launches: time it without the flush as well.
            site = "k-mer build chunk"
            nbytes, ops = occ_bound(*args)
            warm_ms = time_ms(lambda: fn(*args), device, 20, None)
        elif kind == "marked_walk":
            walks += 1
            site = f"walk {walks} (mark {args[8]})"
            nbytes, ops = marked_walk_bound(*args)
        else:
            visits += 1
            site = f"one visit over walk {visits}'s rows"
            nbytes, ops = backstep_bound(*args)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
        row = {
            "kernel": kind, "site": site, "requests": int(args[1].shape[0]), "ms": ms, "ms_write_flush": ms_wf,
            "plain_ms": plain_ms, "library_ms": lib_ms, "library_ms_write_flush": lib_ms_wf, "bound_ms": bound,
            "bytes": nbytes, "ops": ops, "max_abs_err": err,
        }
        if warm_ms is not None:
            row["ms_l2_not_flushed"] = warm_ms
        rows.append(row)
        agg = per_kernel.setdefault(kind, {"ms": 0.0, "ms_write_flush": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                                           "library_ms_write_flush": 0.0, "bound_ms": 0.0, "bytes": 0.0, "ops": 0.0})
        for key in ("ms", "ms_write_flush", "plain_ms", "bound_ms", "bytes", "ops"):
            agg[key] += row[key]
        for key in ("library_ms", "library_ms_write_flush"):
            agg[key] = None if row[key] is None or agg[key] is None else agg[key] + row[key]
    # The flush's yardstick: plain reads of known sizes under both flushes.
    request = next(args[1] for kind, args in calls if kind == "window_read")
    fused = dev.blocks.view(-1)[: (64 << 20) // 4]
    for label, t in (("sum of a window_read request tensor", request), ("sum of the fused rows' first words", fused)):
        nbytes = t.numel() * t.element_size()
        rows.append({
            "kernel": "yardstick", "site": label, "bytes": float(nbytes), "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ms": time_ms(t.sum, device, 20, flush), "ms_write_flush": time_ms(t.sum, device, 20, flush, write_flush=True),
        })
    return rows, per_kernel, checked


def report(name: str, run: dict, device: torch.device) -> dict:
    """Log and return the path's throughput, stats, time split and sites."""
    qps = run["queries"] / run["serve_s"]
    stats = dict(run["engine"].stats)
    log(f"  {name}: {qps:.1f} queries/s end to end, engine stats {json.dumps(stats)}")
    split = time_split(run, device)
    log(f"  {name} time split: {json.dumps(split)}")
    rows, per_kernel, checked = kernel_report(run, device)
    log(f"  {name} recorded kernel calls (and backstep over each full walk's rows) equal to their plain "
        f"versions: {json.dumps(checked)}")
    for row in rows:
        log("  " + json.dumps(row))
    build_launches = run.get("build_launches", dict.fromkeys(KERNELS, 0))
    launches = {kind: run["launches"][kind] + build_launches[kind] for kind in KERNELS}
    for kind, agg in per_kernel.items():
        n = run["launches"][kind]
        log(f"  {name} {kind}: {n} launches over {stats['batches']} verify batches "
            f"({n / stats['batches']:.2f} per batch), {build_launches[kind]} in the index build; "
            f"ms per site sum {agg['ms']:.4f}")
    return {
        "build_index_s": run["build_s"], "ship_s": run["ship_s"], "serve_s": run["serve_s"],
        "queries": run["queries"], "queries_per_s": qps, "stats": stats, "launches": launches,
        "serve_launches": run["launches"], "build_launches": build_launches,
        "time_split": split, "sites": rows, "per_kernel": per_kernel, "checked_vs_plain": checked,
    }


def slot_width_classes(engine: FmQueryEngine, batch: list) -> dict:
    """The lanes of one batch by seed width, and the flags the slot path
    gives them, from one direct count_locate_slots_t call."""
    wire, qlens = engine.encode_queries(batch)
    qt, ql, flags = engine._upload(wire, qlens)
    bundle, starts, ends = count_locate_slots_t(engine.device_index, qt, ql, engine._verify_s, **flags)
    b, n = qt.shape[1], len(batch)
    width = counts_from_ranges(starts, ends).cpu().numpy()[:n]
    redis = unpack_verify_bundle(bundle.cpu().numpy(), b, wide_groups(b))[2][:n]
    band = (width > WIDE_CAP) & (width <= SLOT_EXT)
    return {
        "lanes": n, "width_0": int((width == 0).sum()), "width_1": int((width == 1).sum()),
        "width_2_to_4": int(((width >= 2) & (width <= WIDE_CAP)).sum()), "slot_ext_band": int(band.sum()),
        "slot_ext_settled": int((band & ~redis).sum()), "past_slot_ext": int((width > SLOT_EXT).sum()),
        "redis": int(redis.sum()),
    }


def same_answers(a, b) -> bool:
    """Two (counts, seq_idx, local, offsets) results hold the same counts
    and the same hits per query, in whatever order."""
    if not (np.array_equal(a[0], b[0]) and np.array_equal(a[3], b[3])):
        return False
    qidx = np.repeat(np.arange(a[0].shape[0]), a[0].astype(np.int64))
    oa, ob = np.lexsort((a[2], a[1], qidx)), np.lexsort((b[2], b[1], qidx))
    return np.array_equal(a[1][oa], b[1][ob]) and np.array_equal(a[2][oa], b[2][ob])


def check_drawn(text_np: np.ndarray, res, starts: np.ndarray) -> int:
    """Reads drawn from a one-record text at ``starts``: every hit spells its
    read and every read is found at its own position; returns the hits."""
    counts, _, local, _ = res
    n, total = starts.shape[0], text_np.shape[0]
    ar = np.arange(QLEN)
    qidx = np.repeat(np.arange(n), counts.astype(np.int64))
    if not (text_np[local[:, None] + ar] == text_np[starts[qidx, None] + ar]).all():
        raise AssertionError("a reported hit does not spell its drawn read")
    if not np.isin(np.arange(n) * (total + 1) + starts, qidx * (total + 1) + local).all():
        raise AssertionError("a drawn read was not found at its own position")
    return local.shape[0]


def regime_summary(engine: FmQueryEngine, served: dict, batches: list, device: torch.device) -> dict:
    served = served | {"engine": engine, "batches": batches}
    return {
        "serve_s": served["serve_s"], "queries_per_s": served["queries"] / served["serve_s"],
        "stats": dict(engine.stats), "launches": served["launches"], "time_split": time_split(served, device),
    }


def regime_comparison(run: dict, device: torch.device) -> dict:
    """The slot regime against the switch step (slots=False) on the same
    index, on two traffics: the path's batches (planted repeats in each) and
    4 batches of uniform drawn reads clear of the planted copies (bench.py
    chr20's traffic, which the slot regime answers first, then the switch
    step).  Both regimes must give the same answers."""
    index = run.pop("index")
    uniform, text_np = run["uniform_batches"], run["text_np"]
    slot = run["engine"]
    slot_uniform = serve(slot, uniform, device)
    out = {"uniform": {"slot": regime_summary(slot, slot_uniform, uniform, device)}}
    switch, ship_s = ship(index, device, slots=False)
    del index
    if switch._verify_slots:
        raise AssertionError("slots=False still serves in the slot regime")
    sw = serve(switch, run["batches"], device)
    for b, (x, y) in enumerate(zip(run["results"], sw["results"], strict=True)):
        if not same_answers(x, y):
            raise AssertionError(f"batch {b}: the switch-step path answers differently from the slot path")
    out["planted"] = {"switch": regime_summary(switch, sw, run["batches"], device)}
    sw_uniform = serve(switch, uniform, device)
    hits = 0
    for b, (x, y, st) in enumerate(zip(slot_uniform["results"], sw_uniform["results"], run["uniform_starts"],
                                       strict=True)):
        if not same_answers(x, y):
            raise AssertionError(f"uniform batch {b}: the switch-step path answers differently from the slot path")
        hits += check_drawn(text_np, x, st)
    out["uniform"]["switch"] = regime_summary(switch, sw_uniform, uniform, device)
    out.update({"switch_step": switch._verify_s, "switch_ship_s": ship_s, "uniform_hits_checked": hits})
    switch.release()
    return out


def require_launches(name: str, launches: dict, kinds) -> None:
    for kind in kinds:
        if launches[kind] <= 0:
            raise AssertionError(f"{kind} was not launched on the {name} path")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of the synthetic texts and reads")
    parser.add_argument("--record", help="also write the full record as JSON to this file")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"phase 1 device: {torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = kernels.build()
    build_s = time.perf_counter() - t0
    log(f"phase 2 build: {build_s:.3f} s -> {os.path.relpath(lib)}")
    with open(lib + ".log") as f:
        for line in f:
            if "registers" in line or "error" in line.lower():
                log("  ptxas: " + line.strip())

    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    t0 = time.perf_counter()
    exact = kernels_vs_plain(device, gen)
    log(f"phase 3 kernels vs plain: exact on {sorted(exact)} ({time.perf_counter() - t0:.3f} s)")
    torch.cuda.empty_cache()

    rng = np.random.default_rng(args.seed)
    paths = {}
    run = chr1_path(device, rng)
    log(f"phase 4 chr1 path: {run['queries']} queries in {run['serve_s']:.3f} s; launches {run['launches']}; "
        f"peak device memory {torch.cuda.max_memory_allocated(device)} B")
    require_launches("chr1", run["launches"], ("window_read", "occ_pair"))
    t0 = time.perf_counter()
    checks = check_chr1(run, rng)
    log(f"phase 5 chr1 correctness: {checks} ({time.perf_counter() - t0:.3f} s)")
    log("phase 6 chr1 report:")
    paths["chr1"] = report("chr1", run, device) | {"checks": checks}
    paths["chr1"]["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
    run["engine"].release()
    del run
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)

    t0 = time.perf_counter()
    run = chr20_path(device, rng)
    log(f"phase 7 chr20-shaped path: {run['queries']} queries in {run['serve_s']:.3f} s; serve launches "
        f"{run['launches']}; peak device memory {torch.cuda.max_memory_allocated(device)} B "
        f"({time.perf_counter() - t0:.3f} s with text and build)")
    require_launches("chr20-shaped", run["launches"], ("window_read",))
    t0 = time.perf_counter()
    checks = check_records(run, rng)
    log(f"phase 8 chr20 correctness: {checks} ({time.perf_counter() - t0:.3f} s)")
    log("phase 9 chr20 report:")
    paths["chr20"] = report("chr20", run, device) | {"checks": checks, "kmer_build": run["kmer_build"]}
    paths["chr20"]["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
    paths["chr20"]["width_classes"] = slot_width_classes(run["engine"], run["batches"][0])
    log(f"  chr20 seed widths of batch 0: {json.dumps(paths['chr20']['width_classes'])}")
    regimes = regime_comparison(run, device)
    regimes["planted"]["slot"] = {key: paths["chr20"][key] for key in ("serve_s", "queries_per_s", "stats", "time_split")}
    paths["chr20"]["regimes"] = regimes
    log(f"  chr20 regimes (switch step s={regimes['switch_step']}); uniform reads: "
        f"{regimes['uniform_hits_checked']} hits checked, same answers in both")
    for traffic in ("planted", "uniform"):
        for regime in ("slot", "switch"):
            r = regimes[traffic][regime]
            split = r["time_split"]
            log(f"  chr20 {traffic} traffic, {regime}: {r['queries_per_s']:.1f} queries/s end to end, "
                f"{split['queries'] / split['wire_serve_s']:.1f} from the wire, device {split['device_s']} s "
                f"over {split['batches']} batches; fast-path batches {r['stats']['fast_path_batches']} "
                f"of {r['stats']['batches']}")
    run["engine"].release()
    del run
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)

    t0 = time.perf_counter()
    run = grch38_path(device, rng)
    log(f"phase 10 GRCh38-shaped path: {run['queries']} queries in {run['serve_s']:.3f} s; launches "
        f"{run['launches']}; peak device memory {torch.cuda.max_memory_allocated(device)} B "
        f"({time.perf_counter() - t0:.3f} s with text and build)")
    require_launches("GRCh38-shaped", run["launches"], ("window_read", "occ_pair", "marked_walk"))
    if run["launches"]["backstep"]:
        raise AssertionError("the GRCh38-shaped path launched backstep: its walk must be one marked_walk launch")
    stats = run["engine"].stats
    if stats["wide_lanes"] <= 0 or stats["redis_lanes"] <= 0:
        raise AssertionError(f"the GRCh38-shaped path took no wide or no re-dispatched lane: {stats}")
    t0 = time.perf_counter()
    checks = check_records(run, rng)
    log(f"phase 11 GRCh38 correctness: {checks} ({time.perf_counter() - t0:.3f} s)")
    log("phase 12 GRCh38 report:")
    paths["grch38"] = report("grch38", run, device) | {"checks": checks}
    paths["grch38"]["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
    run["engine"].release()
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # Times of window_read and occ_pair come from the chr1 path (slice 1's
    # numbers stay comparable), marked_walk's and backstep's (one visit over
    # the walk's recorded rows) from the GRCh38-shaped path, occ's from the
    # chr20-shaped k-mer build; launches add up over all paths.
    times_from = {"window_read": "chr1", "occ_pair": "chr1", "backstep": "grch38", "occ": "chr20",
                  "marked_walk": "grch38"}
    kernels_line = []
    for name in KERNELS:
        path = times_from[name]
        agg = paths[path]["per_kernel"][name]
        # Phase 3's inputs and every main-path call checked in the reports.
        errs = [v["max_abs_err"] for key, v in exact.items() if key.split(":")[0] == name]
        errs += [p["checked_vs_plain"][name]["max_abs_err"] for p in paths.values() if name in p["checked_vs_plain"]]
        errs += [row["max_abs_err"] for p in paths.values() for row in p["sites"] if row["kernel"] == name]
        kernels_line.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": sum(p["launches"][name] for p in paths.values()),
            "max_abs_err": max(errs),
            "ms": agg["ms"], "ms_write_flush": agg["ms_write_flush"], "plain_ms": agg["plain_ms"],
            "bound_ms": agg["bound_ms"], "library_ms_write_flush": agg["library_ms_write_flush"],
            "bound_by": "bytes" if agg["bytes"] / HBM_BYTES_PER_S >= agg["ops"] / INT32_OPS_PER_S else "operations",
            "library_ms": agg["library_ms"], "times_from_path": path,
            "launches_by_path": {p: v["launches"][name] for p, v in paths.items()},
        })
    total_s = time.perf_counter() - t_start
    log(f"total seconds: {total_s:.3f}")
    record = {
        "card": card, "seed": args.seed, "build_kernels_s": build_s, "exact": exact, "paths": paths,
        "kernels": kernels_line, "total_s": total_s,
    }
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)), exist_ok=True)
        with open(args.record, "w") as f:
            json.dump(record, f, indent=1)

    log(card_line())
    log(json.dumps({"kernels": kernels_line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
