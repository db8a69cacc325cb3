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
   32, over a random marked SA; its range-fed entry marked_walk_ranges on
   524,288 ranges of 0-11 rows at cap 8, 8 and 2) over chr1-sized
   nucleotide rows and
   Swiss-Prot-sized amino rows (occ_pair on random pairs and on the serving
   shape, ~98 % of pairs in one block), occ over them at the k-mer build's
   full chunk, on random positions and in the build's sorted order
   (positions and rows include 0, the last row, block edges and rows past
   either end).  Each path's
   report (phases 6, 9 and 12) also holds every kernel call the path made
   on its first batch (and the k-mer build's full chunk) against the plain
   version on the same inputs.  Then the 64-bit engine's variants
   (occ_pair_wide, backstep_wide, marked_walk_wide and
   marked_walk_ranges_wide at marks 2, 4 and 32,
   sampled_walk_wide flat and range-fed at SA ratios 8 and 12, occ_wide at
   the k-mer build's full chunk on random positions and in the build's
   sorted order) against their plain versions on synthetic wide rows:
   nucleotide over 2**24 + 4096 blocks (2.7 GB; positions and rows past
   2**32), amino over 2**20 blocks; group bases, prefix sums and SA values
   past 2**32, block edges and the last row among the requests.
4. chr1 path: a chr1-scale index (250 Mbp of seeded random ACGT, k-mer seed
   length 13, mark ratio 1, SA ratio 8) built by the port's builder,
   shipped to the card, then 4 batches of 524,288 30 bp reads drawn from
   the text plus a batch holding a few hundred random reads, served
   through FmQueryEngine.count_locate_stream.  Kernel launch counts are set
   to 0 just before and read just after.
5. chr1 correctness: every reported hit spells its query in the text, every
   drawn read is found at its own position, and for 64 sampled queries the
   count equals a naive overlapping scan of the text and the NumPy host
   engine's (awry_tpu_torch.host_engine) count, and the sorted host locate
   equals the sorted (record, local) hits served for the read.
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
   scan); the host oracle of phase 5 on the scanned reads.
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
   before.  The verify walk is one marked_walk launch per batch, and the
   re-dispatched lanes' hits are walked by marked_walk too, each laid out
   at its final offset (required); the path launches no backstep.
11. GRCh38 correctness, per record: every hit spells its query in its
   record, every drawn read (and every planted copy of a repeat read) is
   found at its own (record, local), 64 counts equal a naive scan, and the
   12x repeat reads report 12 hits (or more, confirmed by naive scan); the
   host oracle of phase 5 on the scanned reads.
12. GRCh38 report: as phase 6, with the walks' marked_walk times, each
   beside its bound from the sectors its rows' walks touch, the same
   sectors summed over every visit (what the walks ask of L2) and the rate
   they imply, and the chain floor (the longest walk at the per-step time
   of a one-row walk); backstep timed as one visit over each walk's rows.
   Then the 512-read batch served by the classic path (use_verify=False,
   the same host index, counts set to 0 just before): phase 10's answers,
   its capped walk one marked_walk_ranges launch (required).
13. Index files at chr20 scale: phase 7's host index (kept) saved as the
   .npz artifact (uncompressed) and loaded back, one 524,288-read batch
   served from it with phase 7's answers; then saved as .awry and loaded on
   the card (load_awry: no marks, no packed text, the k-mer table
   re-derived through occ, launch counts set to 0 just before), the table
   bit-equal to the built one.  Bytes and seconds of each.
14. The mark-less path: the .awry-loaded index (64 Mbp, k = 13, SA ratio 8)
   served classic-only, its locate by the row-sampled walk (one
   sampled_walk_ranges launch per batch over its query ranges, and the flat
   sampled_walk for the over-cap expansion), over phase 7's batches with the
   counts set to 0 just before: the same counts and (record, local) hits as
   phase 7, every drawn read at its own position; the report of phase 6,
   with the range-fed walk's time beside its bound, its plain version, the
   composition it replaced (the padded rows walked by the flat entry, as
   one function to int64[B, cap]), its chain floor (the longest walk at the
   per-step time of a one-row walk) and its walk-length distribution.
15. Facade and CLI, counts set to 0 just before: FmIndex.load of the .npz on
   the card, count_string / locate_string of 64 drawn reads equal to phase
   7's answers, backstep and update_range_with_symbol on a few rows against
   their plain versions, ops.rank.backstep on phase 14's walk rows against
   backstep_plain; then an E. coli-sized FASTA (4.6 Mbp of seeded ACGT in
   two records) through ``python -m awry_tpu_torch build --kmer-len 10``,
   ``count``, ``locate`` and ``info`` as processes on the card, their lines
   equal to the in-process facade's for 16 drawn reads; sampled_walk held
   against its plain version on every row of that index (marks stripped).
16. Sustained rate: device_sustained_qps (every output reduced on the card)
   of the chr1 engine, the chr20 engine in both regimes and the mark-less
   engine, over the path's pre-encoded batches, each beside the rate from
   the wire (each measured before its engine's release).
17. Wide GRCh38-shaped path (run right after phase 12, while phase 10's
   engine lives): phase 10's host index shipped in the 64-bit layout
   (FmQueryEngine(wide=True): the classic path, occ_pair_wide rank steps,
   the k-mer seed as window_read k = 4 over the int64 table's words,
   marked_walk_ranges_wide over the capped ranges, required, and
   marked_walk_wide for the over-cap rows) serving phase 10's batches with
   the counts set to 0 just before: phase 10's answers exactly.  Its report: queries/s, the
   time split, every recorded call against its plain version, and each
   wide kernel's full-batch calls timed beside their bound, their plain
   version and their narrow twin on phase 10's engine (same requests, same
   answers); backstep_wide as one visit over the walk's rows.  Then the
   facade on the wide index (FmIndex(wide=True)), counts set to 0 just
   before: backstep of 16 rows and update_range_with_symbol along 4 reads'
   backward search (backstep_wide, occ_pair_wide) equal the plain versions
   on phase 10's tables, each search ending at the read's count.
18. Wide mark-less path (run right after phase 15): the .awry-loaded index
   of phase 14 in the 64-bit layout (sampled_walk_ranges_wide), phase 14's
   answers exactly; the report of phase 17 against phase 14's engine.
   Then its k-mer table built in the 64-bit layout (to_device_wide(minimal
   =True), every rank through occ_wide, launch counts from 0), equal to the
   table load_awry derived; its first full-chunk call against the plain
   version and the narrow occ on the same requests, timed beside them.
19. Federation, the pan-genome shape (bench.py:139-141: 40 records, k = 11,
   mark 32, SA ratio 8, max_query_len 32, 30 bp reads, batches of 524,288,
   cap 2, 4 partitions), cut from 10.3 Gbp to 256 Mbp (40 records of 6.4
   Mbp of seeded random ACGT; a partition cap of 10 records): built with
   num_workers=1 (timed), 2 batches of drawn reads and a batch of every
   read starting within 29 symbols before a record delimiter or a
   partition boundary, through PartitionedFmIndex.count_locate_arrays with
   the counts set to 0 just before.  Every hit spells its query, every
   drawn read is found at its own (record, local), every boundary read at
   its own position exactly once, 64 counts equal a naive scan, and
   count_batch of 4096 reads equals count_locate_arrays' counts.  Its
   report: queries/s, and each partition's marked_walk call of the first
   batch (mark 32) against its plain version, timed beside its bound, its
   summed sectors and their rate, its chain floor and its walk lengths
   (p50, p99, max).
20. Multi-device serving (run right after phase 6, on phase 4's host index
   and batches; 250 Mbp, k = 13, mark 1, SA ratio 8): Mode A,
   FmQueryEngine(index, mesh=make_mesh(devices=[cuda:0] * 2)), one shipped
   copy serving two data slots, through count_locate_stream; Mode B,
   ShardedFmEngine over make_mesh(devices=[cuda:0] * 4, shard_size=4), the
   fused rows in 4 shards (views of one copy), every rank step one
   occ_pair_shard launch per shard, each writing the endpoints its window
   owns into the step's new ranges, and the locate walk the row-sampled
   walk in rounds over the live rows (a compaction, then passes over the
   shards sized by the last round's share of rows still live, one
   sampled_walk_shard launch per shard and pass),
   through count_locate_arrays.  Each serves the batches
   with the launch counts set to 0 just before and must give phase 4's
   answers exactly (counts, offsets, every (record, local) in row order).
   Every shard call of Mode B's first batch is held exactly against its
   plain version, each rank step's 4 calls against one narrow
   rank.update_range and each walk against the narrow sampled_walk on the
   same rows.  Report: queries/s end to end of both modes, and Mode B's
   host encode of the same batches alone; occ_pair_shard's 4 calls of one
   full step timed (L2 flushed) beside their bound, the plain version, the
   narrow twin on the same requests, the collective step and the narrow
   step (also with the card held busy until the host has issued the step:
   its device time alone); every sampled_walk_shard launch of batch 0's walk
   timed from the inputs it found, beside its bound from the live
   row-steps it took and its plain version, the whole walk on the host
   clock (and its device busy time under the profiler) beside the narrow
   sampled_walk of the same rows, the walk's rounds
   (rows per round, rounds per row p50 / p99 / max) and lengths (steps
   p50, p99, max); the CUDA device count and the mesh make_mesh() builds
   from it.
21. CPU reference (run right after phase 20, on phase 4's host index and
   batch 0): AWRY's own count+locate hot path in C++
   (awry_tpu_torch/native/awry_cpu_ref.cpp: AVX2 rank, the full backward
   search, the row-sampled walk, OpenMP; built with g++ -march=native, the
   host must have AVX2) over batch 0's 524,288 reads, already encoded, 3
   trials on every host thread.  Its hits and the XOR of every located text
   position equal the port's batch-0 answers exactly.  Prints the host CPU
   and threads, each trial's rate and the best, the port's chr1 rates of
   phase 6 (end to end, from the wire, device_sustained_qps) and each one's
   ratio to the best CPU rate, the card's name and power limit.  The dump
   (about 0.42 GB) lives in a temporary directory and is deleted.

Before each report's first timed site the engine's warmup() runs and the
card's clocks are sampled (nvidia-smi), and again beside every timed site.

The last three lines are the card's name and power limit, the kernels JSON
and {"ok": true, "device": {...}}.  ``--record PATH`` also writes the full
record (every call site, the time splits, the checks, phase 21 under
"cpu_ref") as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from multiprocessing import shared_memory

import numpy as np
import torch

from awry_tpu_torch import (
    Alphabet,
    FmBuildArgs,
    FmIndex,
    Symbol,
    build_from_records,
    load_artifact,
    load_awry,
    save_artifact,
    save_awry,
)
from awry_tpu_torch import host_engine
from awry_tpu_torch.alphabet import code_to_index_table, encode_ascii, index_to_code_table
from awry_tpu_torch.build.kmer_count import populate_kmer_table_counting
from awry_tpu_torch.native import cpu_ref
from awry_tpu_torch.ops import (
    FmQueryEngine,
    count_locate_slots_t,
    counts_from_ranges,
    fused_row_words,
    kernels,
    populate_kmer_table_device,
    rank,
    slot_regime_capable,
    to_device,
)
from awry_tpu_torch.ops.kmer import _level_chunk
from awry_tpu_torch.ops.verify import SLOT_EXT, WIDE_CAP, unpack_verify_bundle, wide_groups
from awry_tpu_torch.ops.wide import to_device_wide
from awry_tpu_torch.parallel import ShardedFmEngine, make_mesh
from awry_tpu_torch.parallel import sharding
from awry_tpu_torch.parallel.sharding import _Slot

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
STEP_LEAD_CYCLES = 500_000  # time_ms' lead for a call of several launches: about 0.25 ms at 1.98 GHz
KERNELS = ("window_read", "occ_pair", "backstep", "occ", "marked_walk", "sampled_walk")
# The 64-bit engine's variants (texts of 2**32 symbols and more), each its
# narrow twin's template instantiated over the group bases and 64-bit values.
WIDE_KERNELS = ("occ_pair_wide", "backstep_wide", "marked_walk_wide", "sampled_walk_wide", "occ_wide")
# The range-sharded engine's kernels (Mode B), each over one shard's window
# of blocks, writing in place what its window owns.
SHARD_KERNELS = ("occ_pair_shard", "sampled_walk_shard")
ALL_KERNELS = KERNELS + WIDE_KERNELS + SHARD_KERNELS
SOURCES = {name: f"awry_tpu_torch/csrc/{name}.cu" for name in KERNELS} | {
    "occ": "awry_tpu_torch/csrc/occ_pair.cu", "marked_walk": "awry_tpu_torch/csrc/backstep.cu",
    "sampled_walk": "awry_tpu_torch/csrc/backstep.cu", "occ_pair_wide": "awry_tpu_torch/csrc/occ_pair.cu",
    "backstep_wide": "awry_tpu_torch/csrc/backstep.cu", "marked_walk_wide": "awry_tpu_torch/csrc/backstep.cu",
    "sampled_walk_wide": "awry_tpu_torch/csrc/backstep.cu", "occ_wide": "awry_tpu_torch/csrc/occ_pair.cu",
    "occ_pair_shard": "awry_tpu_torch/csrc/occ_pair.cu", "sampled_walk_shard": "awry_tpu_torch/csrc/backstep.cu",
}
REPLACES = {
    "window_read": "awry_tpu/ops/sweep.py:1036",  # _anchored_text_kernel
    "occ_pair": "awry_tpu/ops/sweep.py:1084",  # _occ_pair_pay_kernel_anchored (and :1062)
    "backstep": "awry_tpu/ops/sweep.py:1123",  # _backstep_kernel_anchored, one visit (backstep_mark_sweep)
    "occ": "awry_tpu/ops/sweep.py:1108",  # _occ_kernel_anchored (and :291)
    "marked_walk": "awry_tpu/ops/sweep.py:1123",  # _backstep_kernel_anchored through marked_walk_sweep (:883)
    "sampled_walk": "awry_tpu/ops/locate.py:99",  # _row_sampled_walk: a while_loop of backstep gathers
    # The 64-bit variants replace the same kernels at 64 bits (the reference's
    # 64-bit engine, awry_tpu/ops/wide.py, runs them as plain gathers).
    "occ_pair_wide": "awry_tpu/ops/sweep.py:1084",
    "backstep_wide": "awry_tpu/ops/sweep.py:1123",
    "marked_walk_wide": "awry_tpu/ops/sweep.py:1123",
    "sampled_walk_wide": "awry_tpu/ops/locate.py:99",
    "occ_wide": "awry_tpu/ops/sweep.py:1108",  # _occ_kernel_anchored at 64 bits (the k-mer build of a wide index)
    # Mode B's per-shard paired sweep (sharding.py _sharded_update_fn:
    # occurrence_sweep_pair, _occ_pair_kernel_anchored :1062 and
    # _occ_pair_kernel :305) and its collective LF walk (sharding.py
    # _sharded_backstep_fn under lf_walk: plain gathers, no Pallas kernel).
    "occ_pair_shard": "awry_tpu/ops/sweep.py:1062",
    "sampled_walk_shard": "awry_tpu/parallel/sharding.py:132",
}
# The range-fed marked walks: each counted under its kernel (marked_walk,
# marked_walk_wide) and under a count of its own, which the paths whose
# classic marked walk runs through it require.
MARKED_RANGES = ("marked_walk_ranges", "marked_walk_ranges_wide")
# The wrappers whose calls a path's first batch records: every kernel's, and
# the range-fed entries (sampled_walk_ranges counted under sampled_walk).
RECORDED = (*ALL_KERNELS, "sampled_walk_ranges", "sampled_walk_ranges_wide", *MARKED_RANGES)
# Arguments of each wrapper that carry per-request data (recorded as copies).
REQUEST_ARGS = {"window_read": (1,), "occ_pair": (1, 2, 3), "backstep": (1,), "occ": (1, 2), "marked_walk": (1,),
                "sampled_walk": (1,), "sampled_walk_ranges": (1, 2), "occ_pair_wide": (2, 3, 4),
                "backstep_wide": (2,), "marked_walk_wide": (2,), "sampled_walk_wide": (2,),
                "sampled_walk_ranges_wide": (2, 3), "occ_wide": (2, 3), "occ_pair_shard": (3, 4, 5, 9, 10),
                "sampled_walk_shard": (3, 4), "marked_walk_ranges": (1, 2), "marked_walk_ranges_wide": (2, 3)}
WALK_MARKS = (2, 4, 32)  # phase 3's mark ratios for the marked walks
# Phase 3's cap per mark ratio for the range-fed marked walks (GRCh38's, the
# pan-genome's).
WALK_CAPS = {2: 8, 4: 8, 32: 2}

# Phase 15: an E. coli-sized text (bench.py ecoli_4.6Mbp_dna) in two records,
# built by the command line; reads checked through the facade and the CLI.
ECOLI_SYMBOLS = 4_600_000
ECOLI_KMER_LEN = 10
FACADE_READS = 64
CLI_READS = 16
REPO = os.path.dirname(os.path.abspath(__file__))
LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def clocks() -> dict:
    """The card's SM and memory clocks (MHz), power draw (W) and
    temperature (C), as nvidia-smi reads them now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    )
    sm, mem, power, temp = (v.strip() for v in out.stdout.strip().splitlines()[0].split(","))
    return {"sm_mhz": float(sm), "mem_mhz": float(mem), "power_w": float(power), "temp_c": float(temp)}


def launch_counts() -> dict:
    return {name: getattr(kernels, name).launches for name in ALL_KERNELS + MARKED_RANGES}


def reset_launch_counts() -> None:
    for name in ALL_KERNELS + MARKED_RANGES:
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
        # at each visit; random prefix sums step rows past either end.  Its
        # range-fed entry on BATCH ranges starting at the first rows, counts
        # 0 to 11 (cap 8 at marks 2 and 4, 2 at mark 32).
        counts = torch.randint(0, 12, (BATCH,), device=device, generator=gen)
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
            cap = WALK_CAPS[mark]
            ranges = (blocks, rows[:BATCH], counts, cap, *args[2:], mark, sa, symbols + 1)
            err = max_abs_err(kernels.marked_walk_ranges(*ranges), kernels.marked_walk_ranges_plain(*ranges))
            if err != 0:
                raise AssertionError(f"marked_walk_ranges ({alphabet.name}, mark {mark}) disagrees with its plain "
                                     f"version (max abs err {err})")
            out[f"marked_walk:{alphabet.name.lower()}:ranges:mark{mark}"] = {
                "requests": BATCH, "cap": cap, "rows": nb, "sa_words": sa.shape[0], "max_abs_err": err,
            }
            del sa
        del blocks, pos_a, pos_b, serving_b, serving, sym, pos, osym, runs, sorted_pos, rows, got, want, counts
    return out


def wide_tables(device, gen, alphabet, nb: int, shift: int, walkable: bool = False):
    """Synthetic wide fused rows on the card for phase 3: random planes and
    mark words, relative milestones and mark milestones below 2**24, group
    bases and prefix sums past 2**32 (kernels.WideBases).  ``walkable``:
    relative milestones 0 and bases that send an LF step from group g into
    the last block of group g - 1, so that every sampled walk ends (within
    twice the groups' count) however the random planes read."""
    v, c = alphabet.num_planes, alphabet.cardinality
    blocks = random_words((nb, fused_row_words(alphabet)), device, gen)
    blocks[:, v * 8 : v * 8 + c] = 0 if walkable else torch.randint(
        0, 2**24, (nb, c), device=device, generator=gen, dtype=torch.int32)
    blocks[:, v * 8 + c + 8] = torch.randint(0, 2**24, (nb,), device=device, generator=gen, dtype=torch.int32)
    groups = -(-nb // (1 << shift))
    prefix = torch.randint(2**32, 2**34, (c + 1,), device=device, generator=gen).sort().values
    if walkable:
        g = torch.arange(groups, device=device)[:, None]
        ms_base = g * (256 << shift) - 255 - prefix[None, :c]
    else:
        ms_base = torch.randint(2**32, 2**40, (groups, c), device=device, generator=gen)
    marks = torch.randint(0, 2**36, (groups,), device=device, generator=gen)
    codes = torch.from_numpy(index_to_code_table(alphabet).astype(np.int32)).to(device)
    c2i = torch.from_numpy(code_to_index_table(alphabet).astype(np.int32)).to(device)
    return blocks, kernels.WideBases(ms_base.contiguous(), marks, shift), prefix, codes, c2i


def wide_kernels_vs_plain(device: torch.device, gen: torch.Generator) -> dict:
    """Each wide variant against its plain version on the card, exactly, on
    synthetic tables: nucleotide rows over 2**24 + 4096 blocks (2.7 GB:
    positions, rows and walks past 2**32), amino rows over 2**20 blocks in
    groups of 2**8; bases, prefix sums and SA values past 2**32; 524,288
    requests with rows 0, block edges, the last row, 2**32 +- 1 and rows past
    either end; marked_walk_wide at marks 4 and 32, sampled_walk_wide (flat
    and range-fed, cap 8) at SA ratios 8 and 12 (the 64-bit quotient)."""
    out = {}
    for alphabet, nb, shift in ((Alphabet.NUCLEOTIDE, 2**24 + 4096, 16), (Alphabet.AMINO, 2**20, 8)):
        name = alphabet.name.lower()
        v, c = alphabet.num_planes, alphabet.cardinality
        top = nb * 256
        bwt_len = top - 3
        edges = torch.tensor([e for e in (0, 255, 256, 2**32 - 1, 2**32, 2**32 + 255, bwt_len - 1, top - 1, top + 7, -3)
                              if e < top + 8], device=device)
        pos = torch.cat([edges, torch.randint(0, top, (BATCH - edges.shape[0],), device=device, generator=gen)])
        pos_b = (pos + torch.randint(0, 600, pos.shape, device=device, generator=gen)).clamp_max(top - 1)
        sym = torch.randint(0, c, pos.shape, dtype=torch.int32, device=device, generator=gen)
        blocks, bases, prefix, codes, c2i = wide_tables(device, gen, alphabet, nb, shift)
        meta = {"requests": BATCH, "rows": nb, "group_shift": shift}

        def check(key, got, want, **extra):
            err = result_err(got, want)
            if err != 0:
                raise AssertionError(f"{key} disagrees with its plain version (max abs err {err})")
            top_value = max(int(g.max()) for g in (got if isinstance(got, tuple) else (got,)))
            out[key] = meta | extra | {"max_abs_err": err, "largest_value": top_value}

        check(f"occ_pair_wide:{name}", kernels.occ_pair_wide(blocks, bases, pos, pos_b, sym, codes, v),
              kernels.occ_pair_wide_plain(blocks, bases, pos, pos_b, sym, codes, v))
        # occ_wide at the k-mer build's full chunk: random positions and
        # symbols past the alphabet (the direct branch), then the build's
        # order (4 sorted symbol runs per half, the second half 1-8 above
        # the first: the staged branch), both across 2**32 on nucleotide.
        chunk = 2 * _level_chunk(4, 4**KMER_LEN)
        rnd_pos = torch.cat([edges, torch.randint(-1, top + 8, (chunk - edges.shape[0],), device=device,
                                                  generator=gen)])
        rnd_sym = torch.randint(-1, c + 1, (chunk,), dtype=torch.int32, device=device, generator=gen)
        span = min(top, chunk // 8 * 32)
        runs = (top - span + torch.randint(-1, span, (4, chunk // 8), device=device, generator=gen)).sort(dim=1)
        runs = runs.values.reshape(-1)
        run_sym = torch.randint(1, c, (4,), dtype=torch.int32, device=device, generator=gen).sort().values
        run_sym = run_sym.repeat_interleave(chunk // 8)
        sorted_pos = torch.cat([runs, runs + 1 + torch.randint(0, 8, runs.shape, device=device, generator=gen)])
        for key, (p, sy) in ((f"occ_wide:{name}", (rnd_pos, rnd_sym)),
                             (f"occ_wide:{name}:sorted", (sorted_pos, torch.cat([run_sym, run_sym])))):
            check(key, kernels.occ_wide(blocks, bases, p, sy, codes, v),
                  kernels.occ_wide_plain(blocks, bases, p, sy, codes, v), requests=chunk)
        del rnd_pos, rnd_sym, runs, run_sym, sorted_pos
        args = (prefix, codes, c2i, v, v * 8 + c, alphabet.ambiguity_idx)
        check(f"backstep_wide:{name}", kernels.backstep_wide(blocks, bases, pos, *args),
              kernels.backstep_wide_plain(blocks, bases, pos, *args))
        counts = torch.randint(0, 12, pos.shape, device=device, generator=gen)
        for mark in WALK_MARKS:
            sa = torch.randint(0, bwt_len, (-(-bwt_len // mark),), device=device, generator=gen)
            walk = (blocks, bases, pos, *args, mark, sa, bwt_len)
            check(f"marked_walk_wide:{name}:mark{mark}", kernels.marked_walk_wide(*walk),
                  kernels.marked_walk_wide_plain(*walk), sa_values=sa.shape[0])
            ranges = (blocks, bases, pos, counts, WALK_CAPS[mark], *args, mark, sa, bwt_len)
            check(f"marked_walk_wide:{name}:ranges:mark{mark}", kernels.marked_walk_ranges_wide(*ranges),
                  kernels.marked_walk_ranges_wide_plain(*ranges), sa_values=sa.shape[0], cap=WALK_CAPS[mark])
            del sa, walk, ranges
        del blocks, bases
        blocks, bases, prefix, codes, c2i = wide_tables(device, gen, alphabet, nb, shift, walkable=True)
        for sa_ratio in (8, 12):
            sa = torch.randint(0, bwt_len, (-(-bwt_len // sa_ratio),), device=device, generator=gen)
            tail = (prefix, codes, c2i, v, alphabet.ambiguity_idx, sa_ratio, sa, bwt_len)
            check(f"sampled_walk_wide:{name}:sa{sa_ratio}", kernels.sampled_walk_wide(blocks, bases, pos, *tail),
                  kernels.sampled_walk_wide_plain(blocks, bases, pos, *tail), sa_values=sa.shape[0])
            check(f"sampled_walk_wide:{name}:ranges:sa{sa_ratio}",
                  kernels.sampled_walk_ranges_wide(blocks, bases, pos, counts, 8, *tail),
                  kernels.sampled_walk_ranges_wide_plain(blocks, bases, pos, counts, 8, *tail), cap=8)
            del sa, tail
        del blocks, bases, pos, pos_b, sym, counts
        torch.cuda.empty_cache()
    return out


# -- serving a path ------------------------------------------------------------


@contextlib.contextmanager
def recording_kernel_inputs(calls: list, want=lambda name, args: True):
    """Record the inputs of every kernel call made inside the block for
    which ``want(name, args)`` holds (the wrappers themselves still run)."""
    real = {name: getattr(kernels, name) for name in RECORDED}

    def recorder(name):
        fn, keep = real[name], REQUEST_ARGS[name]

        def rec(*args, **kw):
            if want(name, args):
                calls.append((name, tuple(a.clone() if i in keep else a for i, a in enumerate(args))))
            return fn(*args, **kw)

        # A wrapper counts its launches on the function its module name
        # binds, so while patched the counts land on this stand-in.
        rec.launches = 0
        return rec

    for name in RECORDED:
        setattr(kernels, name, recorder(name))
    try:
        yield calls
    finally:
        for name in RECORDED:
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
        for name in ("blocks", "kmer_flat", "text_sampled_sa", "sampled_sa", "text_packed", "vw_flat")
        if getattr(dev, name) is not None
    }
    if engine._verify_enabled:
        served_by = f"{'slot regime' if engine._verify_slots else 'switch step'} s={engine._verify_s}"
    else:
        served_by = "the classic path"
    walk = f"mark ratio {dev.mark_ratio}" if dev.has_marks else f"no marks, SA ratio {dev.sa_ratio}"
    log(f"index on {device}: ship {ship_s:.3f} s, {served_by}, {walk}, tables {table_bytes}")
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
    engine, ship_s = ship(index, device)  # the host index stays for phase 20's multi-device engines

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
        "starts": starts, "tail_starts": tail_starts, "random_reads": rnd, "batches": batches, "index": index,
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
    engine, ship_s = ship(index, device)  # the host index stays for phase 17's wide engine

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
        "qsyms": qsyms, "required": required, "qlen": G_QLEN, "index": index,
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
    # Naive overlapping scans and the host oracle: drawn reads of batch 0
    # and the random reads.
    last = len(run["results"]) - 1
    picks = [(0, i) for i in rng.integers(0, len(run["results"][0][0]), size=NUM_NAIVE - 16).tolist()]
    picks += [(last, i) for i in range(16)]
    reads = [run["batches"][b][i] for b, i in picks]
    for q, (b, i), want in zip(reads, picks, naive_counts(text, reads)):
        c = int(run["results"][b][0][i])
        if c != want:
            raise AssertionError(f"count {c} != naive scan {want} for {q!r}")
    return {"hits_checked": checked_hits, "naive_checked": len(picks)} | host_oracle(run["index"], run["results"],
                                                                                     run["batches"], picks)


def host_oracle(index, results, batches, picks) -> dict:
    """The NumPy host engine (awry_tpu_torch.host_engine) on the picked
    (batch, read) pairs of a path: each count equal to the port's, and the
    sorted host locate equal to the sorted (record, local) hits the port
    served for that read."""
    t0 = time.perf_counter()
    reads = [batches[b][i] for b, i in picks]
    hits = host_engine.locate_batch(index, reads)
    counts = host_engine.count_batch(index, reads)
    for q, (b, i), c, want in zip(reads, picks, counts.tolist(), hits):
        served, seq_idx, local, offsets = results[b]
        if c != int(served[i]):
            raise AssertionError(f"batch {b} read {i}: host engine count {c} != the port's {int(served[i])}")
        lo, hi = int(offsets[i]), int(offsets[i + 1])
        if sorted(want) != sorted(zip(seq_idx[lo:hi].tolist(), local[lo:hi].tolist())):
            raise AssertionError(f"batch {b} read {i}: host engine locate differs from the port's hits for {q[:20]!r}")
    return {"host_oracle_reads": len(picks), "host_oracle_hits": sum(len(h) for h in hits),
            "host_oracle_s": time.perf_counter() - t0}


def check_records(run: dict, rng: np.random.Generator) -> dict:
    """Per record: every hit spells its query, every required (query,
    position) pair is found, 64 counts equal a naive scan, and every repeat
    read reports at least its copies (more only if a naive scan agrees)."""
    text_np, text = run["text_np"], run["text"]
    rec_starts, rec_lengths = run["rec_starts"], run["rec_lengths"]
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
        checked_hits += local.shape[0]
    check_required(run, run["results"])

    # Naive scans and the host oracle: 48 drawn reads of batch 0, 16 random
    # reads of the tail, and every repeat read whose count is not its number
    # of copies.
    last = len(run["results"]) - 1
    cl = run["results"][-1][0]
    picks = [(0, i) for i in rng.integers(0, len(run["results"][0][0]), size=NUM_NAIVE - 16).tolist()]
    picks += [(last, i) for i in range(16)]
    repeat_counts = {}
    for lanes, (_, copies) in zip(run["repeat_lanes"], run["repeats"]):
        c = cl[lanes].astype(np.int64)
        if (c < len(copies)).any():
            raise AssertionError(f"a {len(copies)}x repeat read reports fewer hits than its copies")
        picks += [(last, int(j)) for j in lanes[c != len(copies)]]
        repeat_counts[f"{len(copies)}x"] = np.bincount(c).nonzero()[0].tolist()
    reads = [run["batches"][b][i] for b, i in picks]
    for q, (b, i), want in zip(reads, picks, naive_counts(text, reads)):
        c = int(run["results"][b][0][i])
        if c != want:
            raise AssertionError(f"count {c} != naive scan {want} for {q[:20]!r}...")
    return ({"hits_checked": checked_hits, "naive_checked": len(picks), "repeat_counts_seen": repeat_counts}
            | host_oracle(run["index"], run["results"], run["batches"], picks))


# -- reports -------------------------------------------------------------------


def make_flush(device) -> torch.Tensor:
    """The L2 flush buffer: L2_FLUSH_BYTES written once, here."""
    return torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=device)


def time_ms(fn, device, reps: int, flush: torch.Tensor | None, write_flush: bool = False, prepare=None,
            lead: int = 0) -> float:
    """Mean device time of fn() over reps launches, the L2 flushed before
    each unless ``flush`` is None; ``prepare()``, untimed, before each
    flush (an in-place kernel's inputs restored).  ``lead``: cycles the card
    sleeps (torch.cuda._sleep) before the first event, so that the host has
    issued all of fn's launches before it starts: the time of a call of
    several launches without the host's gaps between them.

    The flush reads ``flush`` (more than twice the 50 MB L2), which nothing
    writes after make_flush: the timed launch finds L2 full of clean lines
    of no use to it.  ``write_flush`` zeroes the buffer instead, the flush
    this script used before, kept to compare: it leaves up to 50 MB of
    dirty lines, and their write-back to device memory lands inside the
    timed launch."""
    fn()
    total = 0.0
    for _ in range(reps):
        if prepare is not None:
            prepare()
        if flush is not None:
            if write_flush:
                flush.zero_()
            else:
                flush.sum()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if lead:
            torch.cuda._sleep(lead)
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


def marked_walk_bound(*call, sa_word_bytes: int = 4) -> tuple[float, float, dict]:
    """marked_walk_trace without the steps of each row."""
    return marked_walk_trace(*call, sa_word_bytes=sa_word_bytes)[:3]


def marked_walk_trace(blocks, rows, prefix_sums, codes, c2i, nplanes, mark_offset, ambiguity_idx, mark_ratio,
                      sampled_sa, bwt_len, sa_word_bytes: int = 4) -> tuple[float, float, dict, torch.Tensor]:
    """(bytes, ops, walk, steps) of the walks these rows take: each distinct 32 B
    sector the visits touch (a stepping visit: the sector of the row's mark
    word, the V plane sectors and the stepped symbol's milestone sector; a
    final visit: the sectors of the mark words up to the row's word and of the
    mark milestone), each distinct sector of the marked SA read, and 16 B per
    lane (the row in, the text position out); ops: backstep's per stepping
    visit, the mark rank and 4 more per lane.  ``walk``: the same sectors
    summed over every visit (each visit's distinct ones, and the SA word's
    per lane: what the walks ask of L2, however often a row recurs) and the
    bytes they make with the lanes' I/O, the walk lengths (steps p50, p99,
    max, mean), the first row whose walk is the longest and a row whose walk
    takes no step (None if every row steps).  ``steps``: each row's LF
    steps.  ``sa_word_bytes``: 8 for a wide index's int64 SA values."""
    spr = blocks.shape[1] // 8
    visit_args = (prefix_sums, codes, c2i, nplanes, mark_offset, ambiguity_idx)
    sectors, sa_sectors, stepping_visits, summed = [], [], 0, 0
    n = rows.shape[0]
    steps = torch.zeros_like(rows)
    live = torch.arange(n, device=rows.device)
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
        mark_sector = (mark_offset + word) >> 3
        mile_sector = (nplanes * 8 + safe) >> 3
        last = mark_sector[final]
        summed += int((nplanes + 1 + (mark_sector[step] != mile_sector[step]).to(torch.int64)).sum())
        summed += int((last - (mark_offset >> 3) + 1 + (((mark_offset + 8) >> 3) > last).to(torch.int64)).sum())
        sectors += [
            base + mark_sector,
            base[final] + (mark_offset >> 3),
            base[final] + ((mark_offset + 8) >> 3),
            (base[step][:, None] + torch.arange(nplanes, device=p.device)).reshape(-1),
            base[step] + mile_sector[step],
        ]
        _, packed = kernels.backstep_plain(blocks, pos[final], *visit_args)
        rank = ((packed.to(torch.int64) & 0xFFFFFFFF) >> 1).clamp_max(sampled_sa.shape[0] - 1)
        sa_sectors.append((rank * sa_word_bytes) >> 5)
        stepping_visits += int(step.sum())
        live = live[step]
        steps[live] += 1
        pos = kernels.backstep_plain(blocks, pos[step], *visit_args)[0]
        if not pos.numel():
            break
    distinct = torch.unique(torch.cat(sectors)).numel() + torch.unique(torch.cat(sa_sectors)).numel()
    ops = stepping_visits * (nplanes * 3 + nplanes * 16 + 8 * 3 + 2 + 3) + n * (8 * 3 + 4 + 4)
    summed += n  # the SA word's sector, one per lane
    st = steps.double()
    lengths = {"rows": n, "mean": float(st.mean()) if n else 0.0}
    for q in (0.5, 0.99):
        lengths[f"p{q * 100:g}"] = float(torch.quantile(st[: 1 << 24], q)) if n else 0.0
    lengths["max"] = int(steps.max()) if n else 0
    zero = torch.nonzero(steps == 0)[:, 0]
    walk = {"summed_sectors": summed, "summed_bytes": float(summed * 32 + n * 16), "walk_steps": lengths,
            "longest_row": int(rows[int(steps.argmax())]) if n else 0,
            "zero_step_row": int(rows[int(zero[0])]) if zero.numel() else None}
    return float(distinct * 32 + n * 16), float(ops), walk, steps


def marked_walk_ranges_bound(blocks, starts, counts, cap, *walk, sa_word_bytes: int = 4) -> tuple[float, float, dict]:
    """marked_walk_bound of what the range-fed entry walks (each range's live
    slots, then row 0 once for the idle slots), its I/O counted as the entry
    moves it: starts and counts in (16 B per query), the int64[B, cap]
    positions out."""
    rows = kernels.slot_rows(starts, counts, cap).reshape(-1)
    live = torch.arange(cap, device=starts.device)[None, :] < counts.clamp(0, cap)[:, None]
    walked = torch.cat([rows[live.reshape(-1)], rows.new_zeros(1)])
    nbytes, ops, info = marked_walk_bound(blocks, walked, *walk, sa_word_bytes=sa_word_bytes)
    io = starts.shape[0] * 16 + rows.shape[0] * 8 - walked.shape[0] * 16
    info["summed_bytes"] += io
    return nbytes + io, ops, info


def chain_floor(walk_one, walk: dict, device: torch.device, flush) -> dict:
    """The chain floor of a batch of marked walks: its longest walk at the
    per-step time of a one-row walk (``walk_one(rows)``, one launch), the
    longest row's one-row walk less a zero-step row's (or less nothing when
    every row steps)."""
    rows = [None if r is None else torch.tensor([r], device=device) for r in (walk["longest_row"],
                                                                             walk["zero_step_row"])]
    longest_ms, zero_ms = (time_ms(lambda r=r: walk_one(r), device, 20, flush) if r is not None else 0.0
                           for r in rows)
    top = walk["walk_steps"]["max"]
    return {"longest_walk_ms": longest_ms, "zero_step_walk_ms": zero_ms,
            "chain_floor_ms": max(longest_ms - zero_ms, 0.0),
            "per_step_ms": max(longest_ms - zero_ms, 0.0) / top if top else None}


def walk_figures(ms: float, walk: dict, chain: dict) -> dict:
    """A marked walk's row figures beside its bound: the summed sectors, the
    L2 traffic rate they imply at ``ms`` (TB/s), the walk lengths and the
    chain floor."""
    return {"summed_sectors": walk["summed_sectors"], "summed_bytes": walk["summed_bytes"],
            "summed_rate_tb_s": walk["summed_bytes"] / (ms * 1e-3) / 1e12 if ms else None,
            "walk_steps": walk["walk_steps"]} | chain


def sampled_walk_bound(blocks, rows, prefix_sums, codes, c2i, nplanes, ambiguity_idx, sa_ratio, sampled_sa,
                       bwt_len, sa_word_bytes: int = 4) -> tuple[float, float, dict]:
    """(bytes, ops, walk lengths) of the walks these rows take: each distinct
    32 B sector their stepping visits read (the V plane sectors and the
    stepped symbol's milestone sector), each distinct sector of the sampled
    SA words they end on, and 16 B per lane (the row in, the text position
    out); ops per stepping visit: backstep's LF (symbol V*3, rank V*16 + 8*3
    + 2) and the modulo's 4, per lane the final read and add, 4.  The walk
    lengths: steps of the rows other than row 0 (the lanes a query range
    fills; the path's idle lanes walk row 0, which is sampled), and the
    first row whose walk is the longest.  ``sa_word_bytes``: 8 for a wide
    index's int64 SA values."""
    mark_offset = nplanes * 8 + codes.shape[0]  # the LF does not read the mark words
    pos = rows.clamp(0, bwt_len - 1)
    steps = torch.zeros_like(pos)
    live = torch.nonzero(pos % sa_ratio != 0)[:, 0]
    spr = blocks.shape[1] // 8
    sectors = []
    while live.numel():
        p, r = kernels._fetch_rows(blocks, pos[live])
        sym = kernels._symbol_rows(r, p, c2i, nplanes)
        del r
        base = (p >> 8) * spr
        sectors += [(base[:, None] + torch.arange(nplanes, device=p.device)).reshape(-1),
                    base + ((nplanes * 8 + torch.where(sym == 0, ambiguity_idx, sym)) >> 3)]
        pos[live] = kernels.backstep_plain(blocks, pos[live], prefix_sums, codes, c2i, nplanes, mark_offset,
                                           ambiguity_idx)[0].clamp(0, bwt_len - 1)
        steps[live] += 1
        live = live[pos[live] % sa_ratio != 0]
    distinct = torch.unique(torch.cat(sectors)).numel() if sectors else 0
    distinct += torch.unique(((pos // sa_ratio) * sa_word_bytes) >> 5).numel()
    n = rows.shape[0]
    stepping = int(steps.sum())
    ops = stepping * (nplanes * 3 + nplanes * 16 + 8 * 3 + 2 + 4) + n * 4
    live = steps[rows != 0].double()
    lengths = {"rows": int(live.numel()), "mean": float(live.mean()) if live.numel() else 0.0}
    for q in (0.5, 0.9, 0.99, 0.999):
        lengths[f"p{q * 100:g}"] = float(torch.quantile(live[: 1 << 24], q)) if live.numel() else 0.0
    lengths["max"] = int(live.max()) if live.numel() else 0
    lengths["longest_row"] = int(rows[int(steps.argmax())].clamp(0, bwt_len - 1)) if n else 0
    return float(distinct * 32 + n * 16), float(ops), lengths


def sampled_walk_ranges_bound(blocks, starts, counts, cap, *walk, sa_word_bytes: int = 4) -> tuple[float, float, dict]:
    """sampled_walk_bound of the padded rows the ranges give (kernels.slot_rows),
    its I/O counted as the range-fed entry moves it: starts and counts in (16
    B per query), the int64[B, cap] positions out."""
    rows = kernels.slot_rows(starts, counts, cap).reshape(-1)
    nbytes, ops, lengths = sampled_walk_bound(blocks, rows, *walk, sa_word_bytes=sa_word_bytes)
    return nbytes - rows.shape[0] * 16 + starts.shape[0] * 16 + rows.shape[0] * 8, ops, lengths


def time_split(run: dict, device: torch.device) -> dict:
    """Where the end-to-end time goes, over the path's full batches: the
    host encode alone, the same batches served from their pre-encoded wire,
    and the device time of that serving from a profiler trace (its share of
    the wire-served wall time is the device busy share).  The wire batches
    stay in ``run["wires"]``."""
    engine = run["engine"]
    full = [b for b in run["batches"] if len(b) == len(run["batches"][0])]
    t0 = time.perf_counter()
    wires = [(*engine.encode_queries(b), len(b)) for b in full]
    encode_s = time.perf_counter() - t0
    run["wires"] = wires  # phase 16's device_sustained_qps serves them again
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


def kernel_report(run: dict, device: torch.device) -> tuple[list[dict], dict, dict, dict]:
    """Every recorded call held exactly against its plain version on the
    same inputs; then, after the engine's warmup, per call site of one full
    batch (with the card's clocks), and per kernel summed over them; per
    kernel the calls checked and their largest error; and the warmup's
    seconds and the clocks before and after it."""
    engine = run["engine"]
    dev = engine.device_index
    batch = len(run["batches"][0])
    names = {id(dev.kmer_flat): "seed", id(dev.text_sampled_sa): "sa", id(dev.text_packed): "text",
             id(dev.vw_flat): "slot fat"}
    flush = make_flush(device)
    # Warm the card before the first timed site: its clocks drop during the
    # host-side checks that precede a report.
    clocks_before = clocks()
    t0 = time.perf_counter()
    engine.warmup(batch_sizes=(batch,), query_lens=(run.get("qlen", QLEN),))
    warm = {"warmup_s": time.perf_counter() - t0, "clocks_before": clocks_before, "clocks_after": clocks()}
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
        name = kind.removesuffix("_ranges")  # a range-fed entry counts under its kernel
        c = checked.setdefault(name, {"calls": 0, "max_abs_err": 0})
        c["calls"] += 1
        c["max_abs_err"] = max(c["max_abs_err"], err)
        if args[1].shape[0] < batch or kind == "sampled_walk":
            continue  # a re-dispatch call or an over-cap expansion's walk: checked, not timed
        ms = time_ms(lambda: fn(*args), device, 20, flush)
        ms_wf = time_ms(lambda: fn(*args), device, 20, flush, write_flush=True)
        plain_ms = time_ms(lambda: plain(*args), device, 5, flush)
        lib_ms = lib_ms_wf = warm_ms = None
        extra = {}
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
            nbytes, ops, walk = marked_walk_bound(*args)
            chain = chain_floor(lambda r: kernels.marked_walk(args[0], r, *args[2:]), walk, device, flush)
            extra = walk_figures(ms, walk, chain)
        elif kind == "marked_walk_ranges":
            walks += 1
            site = f"walk {walks} (ranges, mark {args[10]}, cap {args[3]})"
            nbytes, ops, walk = marked_walk_ranges_bound(*args)
            chain = chain_floor(lambda r: kernels.marked_walk(args[0], r, *args[4:]), walk, device, flush)
            extra = walk_figures(ms, walk, chain)
        elif kind == "sampled_walk_ranges":
            # The new launch, beside the composition it replaced: the padded
            # rows (slot_rows) walked by the flat entry, as one function to
            # int64[B, cap]; and the chain floor, the longest walk at the
            # per-step time of a one-row walk (its time less a 0-step walk's).
            walks += 1
            site = f"sampled walk {walks} (ranges, SA ratio {args[9]}, cap {args[3]})"
            nbytes, ops, lengths = sampled_walk_ranges_bound(*args)
            blocks, starts, counts, cap, *walk = args

            def glue_flat():
                return kernels.sampled_walk_launch(blocks, kernels.slot_rows(starts, counts, cap).reshape(-1), *walk)

            one_row = [torch.tensor([row], device=device) for row in (lengths["longest_row"], 0)]
            longest_ms, zero_ms = (time_ms(lambda r=r: kernels.sampled_walk_launch(blocks, r, *walk), device, 20,
                                           flush) for r in one_row)
            extra = {"walk_steps": lengths, "glue_flat_ms": time_ms(glue_flat, device, 20, flush),
                     "longest_walk_ms": longest_ms, "zero_step_walk_ms": zero_ms,
                     "chain_floor_ms": max(longest_ms - zero_ms, 0.0),
                     "per_step_ms": (longest_ms - zero_ms) / lengths["max"] if lengths["max"] else None}
        else:
            visits += 1
            site = f"one visit over walk {visits}'s rows"
            nbytes, ops = backstep_bound(*args)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
        row = {
            "kernel": name, "site": site, "requests": int(args[1].shape[0]), "ms": ms, "ms_write_flush": ms_wf,
            "plain_ms": plain_ms, "library_ms": lib_ms, "library_ms_write_flush": lib_ms_wf, "bound_ms": bound,
            "bytes": nbytes, "ops": ops, "max_abs_err": err,
        }
        if warm_ms is not None:
            row["ms_l2_not_flushed"] = warm_ms
        row.update(extra, clocks=clocks())
        rows.append(row)
        agg = per_kernel.setdefault(name, {"ms": 0.0, "ms_write_flush": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
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
    return rows, per_kernel, checked, warm


def report(name: str, run: dict, device: torch.device) -> dict:
    """Log and return the path's throughput, stats, time split and sites."""
    qps = run["queries"] / run["serve_s"]
    stats = dict(run["engine"].stats)
    log(f"  {name}: {qps:.1f} queries/s end to end, engine stats {json.dumps(stats)}")
    split = time_split(run, device)
    log(f"  {name} time split: {json.dumps(split)}")
    rows, per_kernel, checked, warm = kernel_report(run, device)
    log(f"  {name} warmup before the first timed site: {json.dumps(warm)}")
    log(f"  {name} recorded kernel calls (and backstep over each full walk's rows) equal to their plain "
        f"versions: {json.dumps(checked)}")
    for row in rows:
        log("  " + json.dumps(row))
    build_launches = run.get("build_launches", dict.fromkeys(ALL_KERNELS, 0))
    launches = {kind: run["launches"][kind] + build_launches.get(kind, 0) for kind in ALL_KERNELS + MARKED_RANGES}
    for kind, agg in per_kernel.items():
        n = run["launches"][kind]
        batches = len(run["batches"])
        log(f"  {name} {kind}: {n} launches over {batches} batches ({stats['verify_batches']} on the verify path; "
            f"{n / batches:.2f} per batch), {build_launches[kind]} in the index build; "
            f"ms per site sum {agg['ms']:.4f}")
    return {
        "build_index_s": run["build_s"], "ship_s": run["ship_s"], "serve_s": run["serve_s"],
        "queries": run["queries"], "queries_per_s": qps, "stats": stats, "launches": launches,
        "serve_launches": run["launches"], "build_launches": build_launches,
        "time_split": split, "sites": rows, "per_kernel": per_kernel, "checked_vs_plain": checked, "warmup": warm,
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
    step).  Both regimes must give the same answers.  Then each regime's
    device_sustained_qps over the path's pre-encoded full batches (phase
    16).  The uniform batches are dropped from ``run`` afterwards."""
    uniform, text_np = run.pop("uniform_batches"), run["text_np"]
    slot = run["engine"]
    slot_uniform = serve(slot, uniform, device)
    out = {"uniform": {"slot": regime_summary(slot, slot_uniform, uniform, device)}}
    switch, ship_s = ship(run["index"], device, slots=False)
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
    out["sustained_qps"] = {"slot": slot.device_sustained_qps(run["wires"]),
                            "switch": switch.device_sustained_qps(run["wires"])}
    switch.release()
    return out


# -- phases 13-15: index files, the mark-less path, the facade and the CLI --------


def check_required(run: dict, results) -> None:
    """Each batch's drawn reads and planted copies (``run["required"]``)
    are found at their own (record, local) in ``results``."""
    rec_starts, total = run["rec_starts"], run["text_np"].shape[0]
    for b, ((counts, seq_idx, local, _), (q_req, pos_req)) in enumerate(zip(results, run["required"], strict=True)):
        qidx = np.repeat(np.arange(counts.shape[0]), counts.astype(np.int64))
        gpos = rec_starts[seq_idx] + local
        if not np.isin(q_req * (total + 1) + pos_req, qidx * (total + 1) + gpos).all():
            raise AssertionError(f"batch {b}: a drawn read or a planted copy was not found at its own position")


def index_files(run: dict, device: torch.device, tmp: str) -> tuple[dict, object]:
    """Phase 13: phase 7's host index through the .npz artifact and .awry.
    Returns the record and the index loaded from .awry (on the card)."""
    index = run["index"]
    out = {}
    npz = os.path.join(tmp, "chr20.npz")
    t0 = time.perf_counter()
    save_artifact(index, npz, compress=False)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_artifact(npz)
    load_s = time.perf_counter() - t0
    engine, ship_s = ship(loaded, device)
    del loaded
    t0 = time.perf_counter()
    res = next(engine.count_locate_stream([run["batches"][0]]))
    serve_s = time.perf_counter() - t0
    if not same_answers(res, run["results"][0]):
        raise AssertionError("the index loaded from .npz answers batch 0 differently from phase 7")
    engine.release()
    del engine
    torch.cuda.empty_cache()
    out["npz"] = {"bytes": os.path.getsize(npz), "save_s": save_s, "load_s": load_s, "ship_s": ship_s,
                  "serve_batch0_s": serve_s, "path": npz}

    awry = os.path.join(tmp, "chr20.awry")
    t0 = time.perf_counter()
    save_awry(index, awry)
    save_s = time.perf_counter() - t0
    reset_launch_counts()
    t0 = time.perf_counter()
    markless = load_awry(awry, device=device)
    torch.cuda.synchronize(device)
    load_s = time.perf_counter() - t0
    launches = launch_counts()
    require_launches("load_awry k-mer", launches, ("occ",))
    if markless.has_marks or markless.text_packed is not None or markless.sa_ratio != 8:
        raise AssertionError("the index loaded from .awry carries marks or packed text")
    if not np.array_equal(markless.kmer_table, index.kmer_table):
        raise AssertionError("the k-mer table load_awry re-derived on the card differs from the built one")
    for name in ("planes", "milestones", "prefix_sums", "sampled_sa", "seq_starts"):
        if not np.array_equal(getattr(markless, name), getattr(index, name)):
            raise AssertionError(f".awry round trip changed {name}")
    out["awry"] = {"bytes": os.path.getsize(awry), "save_s": save_s, "load_s": load_s, "launches": launches}
    os.remove(awry)
    return out, markless


def markless_path(run: dict, markless, load_s: float, device: torch.device) -> dict:
    """Phase 14: the .awry-loaded index served classic-only over phase 7's
    batches; the same answers as phase 7."""
    engine, ship_s = ship(markless, device)
    if engine._verify_enabled or engine.device_index.has_marks:
        raise AssertionError("the mark-less index is not served classic-only")
    served = serve(engine, run["batches"], device)
    for b, (x, y) in enumerate(zip(run["results"], served["results"], strict=True)):
        if not same_answers(x, y):
            raise AssertionError(f"batch {b}: the mark-less path answers differently from phase 7")
    check_required(run, served["results"])
    return served | {"engine": engine, "batches": run["batches"], "build_s": load_s, "ship_s": ship_s, "qlen": QLEN}


def cli(*args: str) -> subprocess.CompletedProcess:
    """``python -m awry_tpu_torch ARGS`` from the repository, on the card."""
    r = subprocess.run([sys.executable, "-m", "awry_tpu_torch", *args], capture_output=True, text=True, cwd=REPO,
                       timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"awry_tpu_torch {args[0]} exited {r.returncode}: {r.stderr[-2000:]}")
    return r


def facade_and_cli(run: dict, mrun: dict, npz: str, device: torch.device, tmp: str,
                   rng: np.random.Generator) -> dict:
    """Phase 15, launch counts from 0: the facade on the card over the .npz,
    ops.rank.backstep on the mark-less walk's rows, then the command line
    over an E. coli-sized FASTA.  Returns the record with the launches of
    the in-process facade calls."""
    out = {}
    reset_launch_counts()
    t0 = time.perf_counter()
    fm = FmIndex.load(npz, device=device)
    out["load_s"] = time.perf_counter() - t0
    counts, seq_idx, local, offsets = run["results"][0]
    picks = rng.integers(0, len(run["batches"][0]), size=FACADE_READS)
    for i in picks.tolist():
        q = run["batches"][0][i]
        want = list(zip(seq_idx[offsets[i] : offsets[i + 1]].tolist(), local[offsets[i] : offsets[i + 1]].tolist()))
        got = [(h.sequence_idx(), h.local_position()) for h in fm.locate_string(q)]
        if fm.count_string(q) != int(counts[i]) or got != want:
            raise AssertionError(f"the facade answers read {i} differently from phase 7's engine")
    dev = fm.engine.device_index
    walk = (dev.prefix_sums, dev.codes, dev.c2i, dev.num_planes, dev.mark_offset, dev.alphabet.ambiguity_idx)
    rows = [0, 1, dev.bwt_len - 1, *rng.integers(0, dev.bwt_len, size=13).tolist()]
    for row in rows:
        want = int(kernels.backstep_plain(dev.blocks, torch.tensor([row], device=device), *walk)[0][0])
        if fm.backstep(row) != want:
            raise AssertionError(f"FmIndex.backstep({row}) differs from backstep_plain")
    for i in picks[:4].tolist():
        q = run["batches"][0][i]
        r = fm.initial_search_range(Symbol.new_ascii(fm.alphabet(), chr(q[-1])))
        for ch in reversed(q[:-1]):
            sym = Symbol.new_ascii(fm.alphabet(), chr(ch))
            s, e = kernels.occ_pair_plain(dev.blocks, torch.tensor([r.start_ptr - 1], device=device),
                                          torch.tensor([r.end_ptr], device=device),
                                          torch.tensor([sym.index()], dtype=torch.int32, device=device),
                                          dev.codes, dev.num_planes)
            c = int(dev.prefix_sums[sym.index()])
            want = (c + (int(s[0]) & 0xFFFFFFFF), c + (int(e[0]) & 0xFFFFFFFF) - 1)
            r = fm.update_range_with_symbol(r, sym)
            if (r.start_ptr, r.end_ptr) != want:
                raise AssertionError("update_range_with_symbol differs from occ_pair_plain")
        if r.len() != int(counts[i]):
            raise AssertionError("a manual backward search disagrees with the count")
    fm.engine.release()
    del fm
    # ops.rank.backstep on the rows of the mark-less path's recorded walk.
    mdev = mrun["engine"].device_index
    walk_rows = next(kernels.slot_rows(*a[1:4]).reshape(-1) for kind, a in mrun["calls"]
                     if kind == "sampled_walk_ranges")
    mwalk = (mdev.prefix_sums, mdev.codes, mdev.c2i, mdev.num_planes, mdev.mark_offset, mdev.alphabet.ambiguity_idx)
    err = max_abs_err(rank.backstep(mdev, walk_rows), kernels.backstep_plain(mdev.blocks, walk_rows, *mwalk)[0])
    if err != 0:
        raise AssertionError(f"ops.rank.backstep disagrees with backstep_plain on the walk's rows (max abs err {err})")
    torch.cuda.synchronize(device)
    out["launches"] = launch_counts()
    out["checked_vs_plain"] = {"backstep": {"calls": len(rows) + 1, "max_abs_err": err}}
    require_launches("facade", out["launches"], ("backstep", "occ_pair"))

    # The command line over an E. coli-sized FASTA: two records, 80-column lines.
    text_np = LETTERS[rng.integers(0, 4, size=ECOLI_SYMBOLS, dtype=np.uint8)]
    cut = ECOLI_SYMBOLS * 2 // 3
    fasta = os.path.join(tmp, "ecoli.fasta")
    with open(fasta, "wb") as f:
        for name, lo, hi in (("ecoli_chromosome", 0, cut), ("ecoli_plasmids", cut, ECOLI_SYMBOLS)):
            body = text_np[lo:hi].tobytes()
            f.write(f">{name}\n".encode() + b"\n".join(body[j : j + 80] for j in range(0, len(body), 80)) + b"\n")
    idx_path = os.path.join(tmp, "ecoli.npz")
    t0 = time.perf_counter()
    build = cli("build", fasta, "-o", idx_path, "--kmer-len", str(ECOLI_KMER_LEN))
    out["cli_build_s"] = time.perf_counter() - t0
    out["cli_build_stderr"] = build.stderr.strip()
    starts = rng.integers(0, cut - QLEN, size=CLI_READS)
    queries = [text_np[s : s + QLEN].tobytes().decode() for s in starts.tolist()]
    t0 = time.perf_counter()
    count_out, locate_out = cli("count", idx_path, *queries).stdout, cli("locate", idx_path, *queries).stdout
    info = json.loads(cli("info", idx_path).stdout)
    out["cli_query_s"] = time.perf_counter() - t0
    fm = FmIndex.load(idx_path, device=device)
    want_count = "".join(f"{q}\t{int(c)}\n" for q, c in zip(queries, fm.parallel_count(queries)))
    want_locate = ""
    for q, hits in zip(queries, fm.parallel_locate(queries)):
        for s_idx, pos in sorted((h.sequence_idx(), h.local_position()) for h in hits):
            want_locate += f"{q}\t{fm.data.headers[s_idx]}\t{pos}\n"
        if not hits:
            want_locate += f"{q}\t-\t-\n"
    if count_out != want_count or locate_out != want_locate:
        raise AssertionError("the command line's count or locate lines differ from the in-process facade's")
    for i, s0 in enumerate(starts.tolist()):
        if f"{queries[i]}\tecoli_chromosome\t{s0}\n" not in locate_out:
            raise AssertionError("a drawn read is missing from the command line's locate lines")
    if (info["bwt_len"], info["records"], info["kmer_len"], info["has_marks"]) != (
        ECOLI_SYMBOLS + 2, 2, ECOLI_KMER_LEN, True
    ):
        raise AssertionError(f"the command line's info disagrees: {info}")
    out["cli"] = {"queries": CLI_READS, "count_lines": count_out.count("\n"), "locate_lines": locate_out.count("\n"),
                  "info": {k: info[k] for k in ("bwt_len", "records", "sa_ratio", "kmer_len", "has_marks")}}

    # sampled_walk on every row of this index, its marks stripped, against
    # its plain version; the positions are a permutation of the text's.
    stripped = dataclasses.replace(fm.data, mark_bits=None, mark_milestones=None, text_sampled_sa=None,
                                   text_packed=None)
    fm.engine.release()
    sdev = to_device(stripped, device)
    all_rows = torch.arange(sdev.bwt_len, device=device)
    args = (sdev.blocks, all_rows, sdev.prefix_sums, sdev.codes, sdev.c2i, sdev.num_planes,
            sdev.alphabet.ambiguity_idx, sdev.sa_ratio, sdev.sampled_sa, sdev.bwt_len)
    got = kernels.sampled_walk(*args)
    err = max_abs_err(got, kernels.sampled_walk_plain(*args))
    if err != 0:
        raise AssertionError(f"sampled_walk disagrees with its plain version on the E. coli index (max abs err {err})")
    if not torch.equal(got.sort().values, all_rows):
        raise AssertionError("sampled_walk's positions over every row are not a permutation of the text's")
    out["checked_vs_plain"]["sampled_walk"] = {"calls": 1, "rows": int(sdev.bwt_len), "max_abs_err": err}
    return out


# -- phases 17-19: the 64-bit engine at full width, and the federation ----------


def wide_serve(name: str, engine: FmQueryEngine, ship_s: float, batches: list, results: list,
               device: torch.device) -> dict:
    """Serve ``batches`` through an engine shipped in the 64-bit layout
    (wide=True; serve(): the launch counts set to 0 just before and read
    just after); every answer must equal ``results``, the narrow engine's on
    the same batches."""
    if not engine.device_index.wide or engine._verify_enabled:
        raise AssertionError("wide=True did not ship the 64-bit layout for the classic path")
    run = serve(engine, batches, device)
    for b, (x, y) in enumerate(zip(results, run["results"], strict=True)):
        if not same_answers(x, y):
            raise AssertionError(f"batch {b}: the wide engine answers the {name} path differently")
    run.update({"engine": engine, "ship_s": ship_s, "batches": batches})
    return run


def wide_facade(fm, run: dict, narrow, device: torch.device, rng: np.random.Generator) -> dict:
    """Phase 17's facade, launch counts from 0: FmIndex(wide=True).backstep
    on 16 rows and update_range_with_symbol along 4 reads' backward search
    (backstep_wide and occ_pair_wide) equal backstep_plain and occ_pair_plain
    on the narrow index ``narrow`` of the same host index, and each search
    ends at the read's count."""
    reset_launch_counts()
    rows = [0, 1, narrow.bwt_len - 1, *rng.integers(0, narrow.bwt_len, size=13).tolist()]
    got = [fm.backstep(row) for row in rows]
    counts = run["results"][0][0]
    picks = rng.integers(0, len(run["batches"][0]), size=4).tolist()
    searches = []
    for i in picks:
        q = run["batches"][0][i]
        r = fm.initial_search_range(Symbol.new_ascii(fm.alphabet(), chr(q[-1])))
        steps = []
        for ch in reversed(q[:-1]):
            sym = Symbol.new_ascii(fm.alphabet(), chr(ch))
            steps.append((r, sym))
            r = fm.update_range_with_symbol(r, sym)
        searches.append((i, steps, r))
    torch.cuda.synchronize(device)
    launches = launch_counts()
    walk = (narrow.prefix_sums, narrow.codes, narrow.c2i, narrow.num_planes, narrow.mark_offset,
            narrow.alphabet.ambiguity_idx)
    want = kernels.backstep_plain(narrow.blocks, torch.tensor(rows, device=device), *walk)[0].tolist()
    if got != want:
        raise AssertionError("FmIndex(wide=True).backstep differs from backstep_plain on the narrow index")
    for i, steps, final in searches:
        for (r, sym), nxt in zip(steps, [s for s, _ in steps[1:]] + [final]):
            a, b = kernels.occ_pair_plain(narrow.blocks, torch.tensor([r.start_ptr - 1], device=device),
                                          torch.tensor([r.end_ptr], device=device),
                                          torch.tensor([sym.index()], dtype=torch.int32, device=device),
                                          narrow.codes, narrow.num_planes)
            c = int(narrow.prefix_sums[sym.index()])
            if (nxt.start_ptr, nxt.end_ptr) != (c + (int(a[0]) & 0xFFFFFFFF), c + (int(b[0]) & 0xFFFFFFFF) - 1):
                raise AssertionError("update_range_with_symbol on the wide index differs from occ_pair_plain")
        if final.len() != int(counts[i]):
            raise AssertionError("a backward search through the wide facade disagrees with the count")
    checked = {"backstep_wide": {"calls": len(rows), "max_abs_err": 0},
               "occ_pair_wide": {"calls": sum(len(st) for _, st, _ in searches), "max_abs_err": 0}}
    return {"launches": launches, "checked_vs_plain": checked, "sites": []}


def narrow_twin(kind: str, args: tuple, narrow) -> tuple[str, tuple]:
    """The narrow kernel's call on a wide call's requests, over the narrow
    device index ``narrow`` of the same host index."""
    amb = narrow.alphabet.ambiguity_idx
    lf = (narrow.prefix_sums, narrow.codes, narrow.c2i, narrow.num_planes)
    if kind == "occ_pair_wide":
        return "occ_pair", (narrow.blocks, *args[2:5], narrow.codes, narrow.num_planes)
    if kind == "backstep_wide":
        return "backstep", (narrow.blocks, args[2], *lf, narrow.mark_offset, amb)
    marked = (narrow.mark_offset, amb, narrow.mark_ratio, narrow.text_sampled_sa, narrow.bwt_len)
    if kind == "marked_walk_wide":
        return "marked_walk", (narrow.blocks, args[2], *lf, *marked)
    if kind == "marked_walk_ranges_wide":
        return "marked_walk_ranges", (narrow.blocks, *args[2:5], *lf, *marked)
    return "sampled_walk_ranges", (narrow.blocks, *args[2:5], *lf, amb, narrow.sa_ratio, narrow.sampled_sa,
                                   narrow.bwt_len)


def same_values(wide_out, narrow_out) -> bool:
    """A wide kernel's int64 outputs equal its narrow twin's (int32 outputs
    as the uint32 values they carry, 31 bits for backstep's packed rank)."""
    wide_out = wide_out if isinstance(wide_out, tuple) else (wide_out,)
    narrow_out = narrow_out if isinstance(narrow_out, tuple) else (narrow_out,)
    return all(
        torch.equal(w, n) if n.dtype == torch.int64 else torch.equal(w & 0xFFFFFFFF, n.to(torch.int64) & 0xFFFFFFFF)
        for w, n in zip(wide_out, narrow_out, strict=True)
    )


def wide_bound(kind: str, twin_args: tuple) -> tuple[float, float, dict]:
    """(bytes, ops, walk) of a wide call from its narrow twin's inputs: the
    twin's bound, with 8-byte SA values and the wider outputs (occ_pair: 8 B
    more per request, backstep: 4 B); walk: a walk's lengths (and a marked
    walk's summed sectors and rows for its chain floor)."""
    if kind == "occ_pair_wide":
        nbytes, ops = occ_pair_bound(*twin_args)
        return nbytes + twin_args[1].shape[0] * 8, ops, {}
    if kind == "backstep_wide":
        nbytes, ops = backstep_bound(*twin_args)
        return nbytes + twin_args[1].shape[0] * 4, ops, {}
    if kind == "marked_walk_wide":
        return marked_walk_bound(*twin_args, sa_word_bytes=8)
    if kind == "marked_walk_ranges_wide":
        return marked_walk_ranges_bound(*twin_args, sa_word_bytes=8)
    return sampled_walk_ranges_bound(*twin_args, sa_word_bytes=8)


def walk_rows_wide(ranges: tuple) -> tuple:
    """backstep_wide's arguments over the live slots' rows of a
    marked_walk_ranges_wide call."""
    blocks, bases, starts, counts, cap, *rest = ranges
    live = torch.arange(cap, device=starts.device)[None, :] < counts.clamp(0, cap)[:, None]
    return (blocks, bases, kernels.slot_rows(starts, counts, cap)[live], *rest[:6])


def wide_report(name: str, run: dict, narrow, device: torch.device) -> dict:
    """Phases 17-18's report: end-to-end rate, the time split, every
    recorded call of the first batch against its plain version and each
    wide call against its narrow twin (the same answers), and per wide
    kernel its full-batch calls timed (L2 flushed) beside their bound, the
    plain version and the narrow twin on the narrow index's rows."""
    engine = run["engine"]
    batch = len(run["batches"][0])
    qps = run["queries"] / run["serve_s"]
    log(f"  {name}: {qps:.1f} queries/s end to end, launches {json.dumps(run['launches'])}")
    split = time_split(run, device)
    log(f"  {name} time split: {json.dumps(split)}")
    flush = make_flush(device)
    engine.warmup(batch_sizes=(batch,), query_lens=(run.get("qlen", QLEN),))
    # backstep_wide as one visit over each full batch's walk rows (the
    # facade's call on a wide index), as the narrow report times backstep:
    # the range-fed walk's live slots.
    calls = run["calls"] + [("backstep_wide", walk_rows_wide(a)) for kind, a in run["calls"]
                            if kind == "marked_walk_ranges_wide" and a[2].shape[0] >= batch]
    checked: dict = {}
    per_kernel: dict = {}
    rows = []
    for kind, args in calls:
        fn, plain = getattr(kernels, kind), getattr(kernels, f"{kind}_plain")
        got = fn(*args)
        err = result_err(got, plain(*args))
        if err != 0:
            raise AssertionError(f"{kind} disagrees with its plain version on a {name} call: max abs err {err}")
        key = kind.replace("_ranges", "")  # the range-fed entry counts under sampled_walk_wide
        c = checked.setdefault(key, {"calls": 0, "max_abs_err": 0})
        c["calls"] += 1
        if kind == "window_read" or kind == "sampled_walk_wide" or (kind != "backstep_wide" and
                                                                     args[2].shape[0] < batch):
            continue  # the seed read (narrow), an over-cap expansion or a re-dispatch: checked, not timed
        twin_kind, twin_args = narrow_twin(kind, args, narrow)
        twin = getattr(kernels, twin_kind)
        if not same_values(got, twin(*twin_args)):
            raise AssertionError(f"{kind} and its narrow twin {twin_kind} disagree on a {name} call")
        ms = time_ms(lambda: fn(*args), device, 20, flush)
        twin_ms = time_ms(lambda: twin(*twin_args), device, 20, flush)
        plain_ms = time_ms(lambda: plain(*args), device, 3, flush)
        nbytes, ops, lengths = wide_bound(kind, twin_args)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
        agg = per_kernel.setdefault(key, {"calls_timed": 0, "ms": 0.0, "narrow_twin_ms": 0.0, "plain_ms": 0.0,
                                          "bound_ms": 0.0, "bytes": 0.0, "ops": 0.0, "library_ms": None})
        agg["calls_timed"] += 1
        for k, v in (("ms", ms), ("narrow_twin_ms", twin_ms), ("plain_ms", plain_ms), ("bound_ms", bound),
                     ("bytes", nbytes), ("ops", ops)):
            agg[k] += v
        row = {"kernel": key, "site": f"{kind} call {agg['calls_timed']}", "requests": int(args[2].shape[0]),
               "ms": ms, "narrow_twin_ms": twin_ms, "plain_ms": plain_ms, "bound_ms": bound, "bytes": nbytes,
               "ops": ops, "max_abs_err": err}
        if key == "marked_walk_wide":
            # The chain floor from one-row walks of the wide flat entry.
            tail = args[5:] if kind == "marked_walk_ranges_wide" else args[3:]
            chain = chain_floor(lambda r: kernels.marked_walk_wide(args[0], args[1], r, *tail), lengths, device,
                                flush)
            row.update(walk_figures(ms, lengths, chain))
        elif lengths:
            row["walk_steps"] = lengths
        rows.append(row)
    for row in rows:
        if row["kernel"] != "occ_pair_wide":
            log("  " + json.dumps(row))
    for key, agg in per_kernel.items():
        log(f"  {name} {key}: {run['launches'].get(key, 0)} launches over {len(run['batches'])} batches; "
            f"{json.dumps(agg)}")
    log(f"  {name} recorded calls equal to their plain versions: {json.dumps(checked)}")
    return {"ship_s": run["ship_s"], "serve_s": run["serve_s"], "queries": run["queries"], "queries_per_s": qps,
            "launches": run["launches"], "time_split": split, "sites": rows, "per_kernel": per_kernel,
            "checked_vs_plain": checked}


PAN_RECORDS = 40  # bench.py:139-141, pangenome_10Gbp_dna: 40 records, k = 11, mark 32, 30 bp reads, cap 2
PAN_RECORD_SYMBOLS = 6_400_000  # cut from 10.3 Gbp / 40: 256 Mbp in all
PAN_PER_PARTITION = 10  # the partition cap fits 10 records: 4 partitions
PAN_KMER_LEN = 11
PAN_MARK = 32
PAN_MAX_QUERY_LEN = 32
PAN_CAP = 2
PAN_COUNT_BATCH = 4096


def federation_path(device: torch.device, rng: np.random.Generator) -> dict:
    """Phase 19: the pan-genome shape (bench.py:139-141) cut to 256 Mbp: 40
    records of 6.4 Mbp of seeded random ACGT joined by the N delimiter, 4
    partitions of 10 records (k = 11, mark 32, SA ratio 8, max_query_len 32),
    built serially (num_workers=1, the host k-mer build); 2 batches of
    524,288 30 bp reads drawn from record interiors and a batch of every
    read starting within 29 symbols before a record delimiter or a partition
    boundary, served through count_locate_arrays (cap 2) with the counts
    set to 0 just before and read just after."""
    from awry_tpu_torch.parallel import PartitionedFmIndex

    n = PAN_RECORDS * (PAN_RECORD_SYMBOLS + 1) - 1
    rec_starts = np.arange(PAN_RECORDS, dtype=np.int64) * (PAN_RECORD_SYMBOLS + 1)
    text_np = LETTERS[rng.integers(0, 4, size=n, dtype=np.uint8)]
    text_np[rec_starts[1:] - 1] = ord("N")
    text = text_np.tobytes()
    records = [(f"genome_{i}", text[s : s + PAN_RECORD_SYMBOLS]) for i, s in enumerate(rec_starts.tolist())]
    cap_symbols = PAN_PER_PARTITION * (PAN_RECORD_SYMBOLS + 1) - 1 + PAN_RECORD_SYMBOLS // 2
    args = FmBuildArgs(lookup_table_kmer_len=PAN_KMER_LEN, locate_mark_ratio=PAN_MARK, suffix_array_compression_ratio=8)
    t0 = time.perf_counter()
    fed = PartitionedFmIndex.build_from_records(records, args, max_partition_symbols=cap_symbols,
                                                max_query_len=PAN_MAX_QUERY_LEN, num_workers=1, device=device)
    build_s = time.perf_counter() - t0
    del records
    if len(fed.partitions) != PAN_RECORDS // PAN_PER_PARTITION or not np.array_equal(fed.seq_starts, rec_starts):
        raise AssertionError(f"{len(fed.partitions)} partitions, or record starts that disagree with the text")
    log(f"federation build seconds: {build_s:.3f}; partitions (global start, owned length): "
        f"{[(p.global_start, p.owned_len) for p in fed.partitions]}")
    t0 = time.perf_counter()
    engines = [fed._part_engine(p) for p in fed.partitions]
    torch.cuda.synchronize(device)
    ship_s = time.perf_counter() - t0
    if any(e._verify_slots or not e._verify_enabled or e.device_index.mark_ratio != PAN_MARK for e in engines):
        raise AssertionError("a partition is not served by the switch-step verify path at mark 32")

    ar = np.arange(QLEN)
    starts = []
    for _ in range(2):
        r = rng.integers(0, PAN_RECORDS, size=BATCH)
        starts.append(rec_starts[r] + rng.integers(0, PAN_RECORD_SYMBOLS - QLEN + 1, size=BATCH))
    delims = rec_starts[1:] - 1
    bounds = np.array([p.global_start for p in fed.partitions[1:]], dtype=np.int64)
    edge = np.unique(np.concatenate([(e[:, None] - np.arange(1, QLEN)[None, :]).reshape(-1) for e in (delims, bounds)]))
    starts.append(edge)
    batches = [[text[s : s + QLEN] for s in st.tolist()] for st in starts]

    calls: list = []
    with recording_kernel_inputs(calls):
        fed.count_locate_arrays(batches[0], cap=PAN_CAP)
    reset_launch_counts()
    t0 = time.perf_counter()
    results = [fed.count_locate_arrays(b, cap=PAN_CAP) for b in batches[:2]]
    torch.cuda.synchronize(device)
    serve_s = time.perf_counter() - t0
    results.append(fed.count_locate_arrays(batches[2], cap=PAN_CAP))
    torch.cuda.synchronize(device)
    launches = launch_counts()
    return {"fed": fed, "text_np": text_np, "text": text, "rec_starts": rec_starts, "starts": starts,
            "batches": batches, "results": results, "calls": calls, "build_s": build_s, "ship_s": ship_s,
            "serve_s": serve_s, "launches": launches, "queries": 2 * BATCH, "edge_reads": int(edge.shape[0])}


def check_federation(run: dict, rng: np.random.Generator) -> dict:
    """Every hit spells its query; every drawn read is found at its own
    (record, local); every boundary read is reported at its own position
    exactly once; 64 counts (48 drawn, 16 boundary reads) equal a naive scan
    of the corpus; count_batch of 4096 reads equals count_locate_arrays'
    counts."""
    text_np, rec_starts, total = run["text_np"], run["rec_starts"], run["text_np"].shape[0]
    ar = np.arange(QLEN)
    hits = 0
    for b, ((counts, seq_idx, local, offsets), st) in enumerate(zip(run["results"], run["starts"], strict=True)):
        nq = st.shape[0]
        shapes_ok = counts.shape[0] == nq and offsets[-1] == local.shape[0]
        if not shapes_ok or not (np.diff(offsets) == counts.astype(np.int64)).all():
            raise AssertionError(f"federation batch {b}: malformed result")
        gpos = rec_starts[seq_idx] + local
        if ((local < 0) | (gpos + QLEN > total)).any():
            raise AssertionError(f"federation batch {b}: a hit outside the corpus")
        qidx = np.repeat(np.arange(nq), counts.astype(np.int64))
        if not (text_np[gpos[:, None] + ar] == text_np[st[qidx, None] + ar]).all():
            raise AssertionError(f"federation batch {b}: a hit does not spell its query")
        own = np.bincount(qidx[gpos == st[qidx]], minlength=nq)
        if (own < 1).any():
            raise AssertionError(f"federation batch {b}: a read was not found at its own (record, local)")
        if b == 2 and (own != 1).any():
            raise AssertionError("a boundary read was reported at its own position more than once")
        hits += local.shape[0]
    c0, ce = run["results"][0][0], run["results"][2][0]
    picks = [(run["batches"][0][i], int(c0[i])) for i in rng.integers(0, BATCH, size=NUM_NAIVE - 16)]
    picks += [(run["batches"][2][i], int(ce[i])) for i in rng.integers(0, ce.shape[0], size=16)]
    for (q, c), want in zip(picks, naive_counts(run["text"], [q for q, _ in picks])):
        if c != want:
            raise AssertionError(f"federation count {c} != naive scan {want} for {q!r}")
    n_edge = min(96, ce.shape[0])
    queries = run["batches"][0][: PAN_COUNT_BATCH - n_edge] + run["batches"][2][:n_edge]
    t0 = time.perf_counter()
    counted = run["fed"].count_batch(queries)
    count_batch_s = time.perf_counter() - t0
    want = np.concatenate([c0[: PAN_COUNT_BATCH - n_edge], ce[:n_edge]])
    if not np.array_equal(counted, want):
        raise AssertionError("count_batch disagrees with count_locate_arrays' counts")
    return {"hits_checked": hits, "naive_checked": len(picks), "boundary_reads": int(ce.shape[0]),
            "count_batch_queries": len(queries), "count_batch_s": count_batch_s}


def federation_report(run: dict, device: torch.device) -> dict:
    """Phase 19's report: queries/s over the 2 drawn batches, and each
    partition's full-batch marked_walk call of the first batch (mark 32)
    against its plain version, timed (L2 flushed) beside its bound, with its
    walk lengths."""
    qps = run["queries"] / run["serve_s"]
    flush = make_flush(device)
    checked = {}
    rows = []
    for kind, args in run["calls"]:
        err = result_err(getattr(kernels, kind)(*args), getattr(kernels, f"{kind}_plain")(*args))
        if err != 0:
            raise AssertionError(f"{kind} disagrees with its plain version on a federation call: max abs err {err}")
        c = checked.setdefault(kind.removesuffix("_ranges"), {"calls": 0, "max_abs_err": 0})
        c["calls"] += 1
        if kind != "marked_walk" or args[1].shape[0] < BATCH:
            continue
        nbytes, ops, walk = marked_walk_bound(*args)
        ms = time_ms(lambda: kernels.marked_walk(*args), device, 20, flush)
        chain = chain_floor(lambda r: kernels.marked_walk(args[0], r, *args[2:]), walk, device, flush)
        rows.append({
            "kernel": "marked_walk", "site": f"walk {len(rows) + 1} (mark {args[8]}, partition {len(rows)})",
            "requests": int(args[1].shape[0]), "ms": ms,
            "plain_ms": time_ms(lambda: kernels.marked_walk_plain(*args), device, 3, flush),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3, "bytes": nbytes, "ops": ops,
            "max_abs_err": err,
        } | walk_figures(ms, walk, chain))
    for row in rows:
        log("  " + json.dumps(row))
    agg = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms", "bytes", "ops")}
    agg["library_ms"] = None
    stats = [dict(p.engine.stats) for p in run["fed"].partitions]
    log(f"  federation: {qps:.1f} queries/s end to end over {run['queries']} drawn reads; launches "
        f"{json.dumps(run['launches'])}; engine stats per partition {json.dumps(stats)}")
    return {"build_s": run["build_s"], "ship_s": run["ship_s"], "serve_s": run["serve_s"], "queries": run["queries"],
            "queries_per_s": qps, "launches": run["launches"], "sites": rows, "per_kernel": {"marked_walk": agg},
            "checked_vs_plain": checked, "stats": stats, "edge_reads": run["edge_reads"]}

# -- phase 18's wide k-mer build, and phase 20: multi-device serving ---------------


def same_arrays(a, b) -> bool:
    """Two (counts, seq_idx, local, offsets) results are equal array by
    array: the same hits in the same (BWT-row) order."""
    return all(np.array_equal(x, y) for x, y in zip(a, b, strict=True))


def wide_kmer_build(index, device: torch.device) -> dict:
    """Phase 18's k-mer build in the 64-bit layout, launch counts from 0:
    the .awry index's minimal wide ship (to_device_wide(minimal=True)), every
    rank through occ_wide, the table equal to the one load_awry derived.
    A second build records its first full-chunk call: against its plain
    version and against occ on
    the narrow minimal ship's rows (the same values), then timed (L2 flushed,
    and not: the build's rows stay in L2 between launches) beside that twin,
    the plain version and the bound."""
    full = 2 * _level_chunk(4, 4**KMER_LEN)
    calls: list = []
    wide_min = to_device_wide(index, device, minimal=True)
    torch.cuda.synchronize(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    table = populate_kmer_table_device(wide_min, index.kmer_len)
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    launches = launch_counts()
    require_launches("wide k-mer build", launches, ("occ_wide",))
    if launches["occ"]:
        raise AssertionError("the wide k-mer build launched the narrow occ")
    if not np.array_equal(table, index.kmer_table):
        raise AssertionError("the k-mer table built in the 64-bit layout differs from the one load_awry derived")
    # Once more, recording its first full-chunk call (a recorded call counts
    # its launch on the recorder, not on the kernel's counter).
    with recording_kernel_inputs(calls, lambda name, a: name == "occ_wide" and a[2].shape[0] == full and not calls):
        again = populate_kmer_table_device(wide_min, index.kmer_len)
    if not np.array_equal(again, table):
        raise AssertionError("the recorded wide k-mer build differs from the first")
    ((_, args),) = calls
    blocks, bases, pos, sym, codes, nplanes = args
    got = kernels.occ_wide(*args)
    err = result_err(got, kernels.occ_wide_plain(*args))
    if err != 0:
        raise AssertionError(f"occ_wide disagrees with its plain version on a k-mer build call: max abs err {err}")
    narrow = to_device(index, device, minimal=True)
    twin = (narrow.blocks, pos, sym, codes, nplanes)
    if not same_values(got, kernels.occ(*twin)):
        raise AssertionError("occ_wide and its narrow twin occ disagree on a k-mer build call")
    flush = make_flush(device)
    nbytes, ops = occ_bound(*twin)
    nbytes += pos.shape[0] * 4  # int64 ranks
    row = {
        "kernel": "occ_wide", "site": "k-mer build chunk", "requests": int(pos.shape[0]),
        "ms": time_ms(lambda: kernels.occ_wide(*args), device, 20, flush),
        "ms_l2_not_flushed": time_ms(lambda: kernels.occ_wide(*args), device, 20, None),
        "narrow_twin_ms": time_ms(lambda: kernels.occ(*twin), device, 20, flush),
        "narrow_twin_ms_l2_not_flushed": time_ms(lambda: kernels.occ(*twin), device, 20, None),
        "plain_ms": time_ms(lambda: kernels.occ_wide_plain(*args), device, 3, flush),
        "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3, "bytes": nbytes, "ops": ops,
        "max_abs_err": err, "clocks": clocks(),
    }
    agg = {k: row[k] for k in ("ms", "narrow_twin_ms", "plain_ms", "bound_ms", "bytes", "ops")} | {"library_ms": None}
    return {"build_s": build_s, "launches": launches, "sites": [row], "per_kernel": {"occ_wide": agg},
            "checked_vs_plain": {"occ_wide": {"calls": 1, "max_abs_err": err}}}


def occ_pair_shard_bound(blocks, first_block, total_blocks, starts, ends, sym, codes, prefix_sums, nplanes, *out
                         ) -> tuple[float, float]:
    """(bytes, ops) of one occ_pair_shard call: the sectors of the endpoints
    its window owns (as occ_pair_bound counts them), every request's 16 B of
    positions, the 4 B symbol of each request with an owned endpoint and 8
    B out per owned endpoint; ops per owned endpoint occ_pair's and the C
    add."""
    spr = blocks.shape[1] // 8
    nbits = total_blocks * 256
    own_a = kernels.owned_by(starts - 1, first_block, blocks.shape[0], nbits)
    own_b = kernels.owned_by(ends, first_block, blocks.shape[0], nbits)
    rows = torch.cat([(starts - 1).clamp(0, nbits - 1)[own_a], ends.clamp(0, nbits - 1)[own_b]]) >> 8
    s2 = torch.cat([sym[own_a], sym[own_b]]).clamp(0, codes.shape[0] - 1).to(torch.int64)
    rows = rows - first_block
    plane = (rows[:, None] * spr + torch.arange(nplanes, device=rows.device)).reshape(-1)
    sectors = torch.unique(torch.cat([plane, rows * spr + ((nplanes * 8 + s2) >> 3)])).numel()
    owned = rows.shape[0]
    requests = int((own_a | own_b).sum())
    return (float(sectors * 32 + starts.shape[0] * 16 + requests * 4 + owned * 8),
            float(owned * (nplanes * 16 + 8 * 3 + 2)))


def sampled_walk_shard_bound(blocks, first_block, total_blocks, rows, steps, prefix_sums, codes, c2i, nplanes,
                             ambiguity_idx, sa_ratio, bwt_len) -> tuple[float, float, int]:
    """(bytes, ops, row-steps) of one sampled_walk_shard call, from the
    walks its inputs need (the plain version's steps): each distinct 32 B
    sector its steps read (the V plane sectors and the stepped symbol's
    milestone sector), 8 B in per row (the row, which decides whether the
    call walks it), 8 B more in (its steps) and 16 B out per walked row;
    ops per step the LF's, as sampled_walk_bound counts them (symbol V*3,
    rank V*16 + 8*3 + 2)."""
    spr = blocks.shape[1] // 8
    lo = first_block * 256

    def walking(p, st):
        return (p % sa_ratio != 0) & kernels.owned_by(p, first_block, blocks.shape[0], bwt_len) & (st < bwt_len)

    pos = rows.clamp(0, bwt_len - 1)
    idx = torch.nonzero(walking(pos, steps))[:, 0]
    walked, row_steps = idx.numel(), 0
    p, st = pos[idx], steps[idx]
    sectors = []
    while idx.numel():
        local, r = kernels._fetch_rows(blocks, p - lo)
        sym = kernels._symbol_rows(r, local, c2i, nplanes)
        base = (local >> 8) * spr
        sectors += [(base[:, None] + torch.arange(nplanes, device=p.device)).reshape(-1),
                    base + ((nplanes * 8 + torch.where(sym == 0, ambiguity_idx, sym)) >> 3)]
        p = kernels._lf_rows(r, local, prefix_sums, codes, c2i, nplanes, ambiguity_idx).clamp(0, bwt_len - 1)
        del r
        st = st + 1
        row_steps += idx.numel()
        keep = walking(p, st)
        idx, p, st = idx[keep], p[keep], st[keep]
    distinct = torch.unique(torch.cat(sectors)).numel() if sectors else 0
    ops = row_steps * (nplanes * 3 + nplanes * 16 + 8 * 3 + 2)
    return float(distinct * 32 + rows.shape[0] * 8 + walked * 24), float(ops), row_steps


@contextlib.contextmanager
def checking_shard_calls(narrow, slot, num_shards: int, full_step: int):
    """Hold every occ_pair_shard and sampled_walk_shard call made inside the
    block exactly against its plain version on the same inputs (the
    in-place outputs' state before the call copied for it); each step's
    num_shards occ_pair_shard calls (made in shard order) against one narrow
    rank.update_range on the narrow device index ``narrow``; each Mode B
    walk of ``slot`` against the narrow sampled_walk on the same rows.  Keep
    for the timing the calls of the first step with ``full_step`` requests
    and every call of the first walk, each with its inputs as the call found
    them, and each walk's rounds (walk_rounds' live rows and passes of
    each)."""
    real = {name: getattr(kernels, name) for name in SHARD_KERNELS}
    state = {name: {"calls": 0, "steps": 0, "max_abs_err": 0, "kept": []} for name in SHARD_KERNELS}
    walks = {"walks": 0, "rounds": [], "rows": None, "recording": False}

    def before_call(name, args):
        return tuple(a.clone() if i in REQUEST_ARGS[name] else a for i, a in enumerate(args))

    def checker(name):
        fn, plain, st = real[name], getattr(kernels, f"{name}_plain"), state[name]

        def check(*args, **kw):
            pre = before_call(name, args)
            out = fn(*args, **kw)
            err = result_err(out, plain(*before_call(name, pre)))
            if err != 0:
                raise AssertionError(f"{name} disagrees with its plain version on a Mode B call: max abs err {err}")
            k = st["calls"] % num_shards
            st["calls"] += 1
            if name == "occ_pair_shard":
                if k == num_shards - 1:
                    if result_err(out, rank.update_range(narrow, *args[3:6])) != 0:
                        raise AssertionError("a Mode B rank step does not equal the narrow rank.update_range")
                    st["steps"] += 1
                if args[3].shape[0] == full_step and len(st["kept"]) < num_shards and (k == 0 or st["kept"]):
                    st["kept"].append(pre)
            elif walks["recording"]:
                st["kept"].append(pre)
            return out

        check.launches = 0
        return check

    def checked_walk(rows):
        first = walks["walks"] == 0
        walks["recording"] = first
        got = _Slot.walk(slot, rows)
        walks["recording"] = False
        want = kernels.sampled_walk(narrow.blocks, rows, narrow.prefix_sums, narrow.codes, narrow.c2i,
                                    narrow.num_planes, narrow.alphabet.ambiguity_idx, slot.dev.sa_ratio,
                                    slot.dev.sampled_sa, slot.dev.bwt_len)
        if result_err(got, want) != 0:
            raise AssertionError("a Mode B walk's positions differ from the narrow sampled_walk on the same rows")
        walks["walks"] += 1
        if first:
            walks["rows"] = rows.clone()
        return got

    real_rounds = sharding.walk_rounds

    def recorded_rounds(*args):
        out = real_rounds(*args)
        walks["rounds"].append(out[2])
        return out

    for name in SHARD_KERNELS:
        setattr(kernels, name, checker(name))
    slot.walk = checked_walk
    sharding.walk_rounds = recorded_rounds
    try:
        yield state, walks
    finally:
        sharding.walk_rounds = real_rounds
        del slot.walk
        for name in SHARD_KERNELS:
            setattr(kernels, name, real[name])


def round_stats(rounds: list) -> dict:
    """Rounds of a Mode B walk (walk_rounds' (live rows, passes) of each):
    how many, the live rows and passes of each, and the rounds per walked
    row (p50, p99, max: a row is live in the first k rounds, so the rows of
    round k are those that needed more than k)."""
    round_rows = [r for r, _ in rounds]
    n = round_rows[0] if round_rows else 0
    out = {"rounds": len(round_rows), "rows_per_round": round_rows, "passes_per_round": [p for _, p in rounds],
           "passes": sum(p for _, p in rounds), "walked_rows": n}
    for q in (0.5, 0.99):
        out[f"p{q * 100:g}"] = sum(1 for r in round_rows if r > n * (1 - q))
    out["max"] = len(round_rows)
    return out


def walk_lengths(narrow, rows: torch.Tensor) -> dict:
    """Steps of the row-sampled walk of each row other than row 0 (the slots
    a query range fills), by narrow backstep launches: p50, p99, max, mean."""
    pos = rows.clone()
    steps = torch.zeros_like(rows)
    live = pos % narrow.sa_ratio != 0
    while bool(live.any()):
        stepped, _ = kernels.backstep(narrow.blocks, pos, narrow.prefix_sums, narrow.codes, narrow.c2i,
                                      narrow.num_planes, narrow.mark_offset, narrow.alphabet.ambiguity_idx)
        pos = torch.where(live, stepped, pos)
        steps += live.to(torch.int64)
        live = pos % narrow.sa_ratio != 0
    st = steps[rows != 0].double()
    out = {"rows": int(st.numel()), "mean": float(st.mean())}
    for q in (0.5, 0.99):
        out[f"p{q * 100:g}"] = float(torch.quantile(st[: 1 << 24], q))
    out["max"] = int(steps.max())
    return out


def multi_device_path(run: dict, device: torch.device) -> dict:
    """Phase 20 over phase 4's host index and batches (module docstring):
    Mode A (FmQueryEngine on a mesh of 2 data slots) and Mode B
    (ShardedFmEngine, 4 shards), each giving phase 4's answers exactly."""
    index, batches, results = run["index"], run["batches"], run["results"]
    narrow = run["engine"].device_index
    nq = sum(len(b) for b in batches)
    out = {"device_count": torch.cuda.device_count(), "make_mesh_shape": make_mesh().shape}
    log(f"  CUDA devices: {out['device_count']}; make_mesh() with no arguments: {out['make_mesh_shape']}")

    # Mode A: one shipped copy for the two slots on this device.
    t0 = time.perf_counter()
    engine = FmQueryEngine(index, mesh=make_mesh(devices=[device] * 2))
    torch.cuda.synchronize(device)
    ship_s = time.perf_counter() - t0
    if engine._data_shards != 2 or {id(e) for e in engine._slot_engines} != {id(engine)}:
        raise AssertionError("the Mode A engine does not serve two slots from one shipped copy")
    served = serve(engine, batches, device)
    for b, (x, y) in enumerate(zip(results, served["results"], strict=True)):
        if not same_arrays(x, y):
            raise AssertionError(f"batch {b}: Mode A answers differently from phase 4")
    require_launches("Mode A", served["launches"], ("window_read", "occ_pair"))
    checked: dict = {}
    for kind, args in served["calls"]:
        err = result_err(getattr(kernels, kind)(*args), getattr(kernels, f"{kind}_plain")(*args))
        if err != 0:
            raise AssertionError(f"{kind} disagrees with its plain version on a Mode A call: max abs err {err}")
        c = checked.setdefault(kind, {"calls": 0, "max_abs_err": 0})
        c["calls"] += 1
    mode_a = {"ship_s": ship_s, "serve_s": served["serve_s"], "queries": nq, "queries_per_s": nq / served["serve_s"],
              "launches": served["launches"], "stats": dict(engine.stats), "checked_vs_plain": checked}
    log(f"  Mode A (2 data slots on {device}): {mode_a['queries_per_s']:.1f} queries/s end to end (phase 4's "
        f"answers); {json.dumps(mode_a)}")
    engine.release()
    del engine, served
    gc.collect()
    torch.cuda.empty_cache()

    # Mode B: 4 shards of the fused rows, views of one shipped copy.
    t0 = time.perf_counter()
    engine = ShardedFmEngine(index, make_mesh(devices=[device] * 4, shard_size=4))
    torch.cuda.synchronize(device)
    ship_s = time.perf_counter() - t0
    (shards,) = engine.shards
    if len({sh.blocks.untyped_storage().data_ptr() for sh in shards}) != 1:
        raise AssertionError("Mode B's shards on one device are not views of one tensor")
    slot = engine._slots[0]
    with checking_shard_calls(narrow, slot, 4, len(batches[0])) as (state, walks):
        first = engine.count_locate_arrays(batches[0])
    if not same_arrays(first, results[0]):
        raise AssertionError("batch 0: Mode B answers differently from phase 4")
    checked = {name: {k: st[k] for k in ("calls", "steps", "max_abs_err")} for name, st in state.items()}
    checked["walks_vs_narrow_sampled_walk"] = walks["walks"]
    log(f"  Mode B first batch: every shard call equal to its plain version, every rank step to the narrow "
        f"update_range, every walk to the narrow sampled_walk: {json.dumps(checked)}")
    reset_launch_counts()
    t0 = time.perf_counter()
    res = [engine.count_locate_arrays(b) for b in batches]
    torch.cuda.synchronize(device)
    serve_s = time.perf_counter() - t0
    launches = launch_counts()
    require_launches("Mode B", launches, ("window_read", *SHARD_KERNELS))
    if launches["occ_pair"] or launches["backstep"] or launches["sampled_walk"] or launches["marked_walk"]:
        raise AssertionError(f"Mode B launched a narrow rank or walk kernel: {launches}")
    for b, (x, y) in enumerate(zip(results, res, strict=True)):
        if not same_arrays(x, y):
            raise AssertionError(f"batch {b}: Mode B answers differently from phase 4")
    t0 = time.perf_counter()
    for b in batches:
        engine._encode(b)
    encode_s = time.perf_counter() - t0  # the host encode alone, the serve's first stage

    # occ_pair_shard: the 4 calls of one full rank step, timed (L2 flushed)
    # beside the bound, the plain version, the narrow twin on the same
    # requests, the collective step and the narrow step.
    flush = make_flush(device)
    rows_out, per_kernel = [], {}
    name, kept = "occ_pair_shard", state["occ_pair_shard"]["kept"]
    if len(kept) != 4:
        raise AssertionError(f"occ_pair_shard: no full step of 4 calls was kept ({len(kept)})")
    fn, plain = kernels.occ_pair_shard, kernels.occ_pair_shard_plain
    agg = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0.0, "ops": 0.0, "library_ms": None}
    for i, args in enumerate(kept):
        nbytes, ops = occ_pair_shard_bound(*args)
        row = {"kernel": name, "site": f"shard {i} of a full step", "requests": int(args[3].shape[0]),
               "window_blocks": int(args[0].shape[0]), "ms": time_ms(lambda a=args: fn(*a), device, 20, flush),
               "plain_ms": time_ms(lambda a=args: plain(*a), device, 3, flush),
               "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3, "bytes": nbytes, "ops": ops,
               "max_abs_err": 0, "clocks": clocks()}
        rows_out.append(row)
        for k in ("ms", "plain_ms", "bound_ms", "bytes", "ops"):
            agg[k] += row[k]
    starts, ends, sym = kept[0][3:6]
    agg["narrow_twin_ms"] = time_ms(lambda: kernels.occ_pair(narrow.blocks, starts - 1, ends, sym, narrow.codes,
                                                             narrow.num_planes), device, 20, flush)
    agg["collective_step_ms"] = time_ms(lambda: slot.update(starts, ends, sym), device, 20, flush)
    agg["narrow_step_ms"] = time_ms(lambda: rank.update_range(narrow, starts, ends, sym), device, 20, flush)
    # The same two steps with the card held busy until the host has issued
    # them (about 0.25 ms of sleep): their device time alone.
    agg["collective_step_device_ms"] = time_ms(lambda: slot.update(starts, ends, sym), device, 20, flush,
                                               lead=STEP_LEAD_CYCLES)
    agg["narrow_step_device_ms"] = time_ms(lambda: rank.update_range(narrow, starts, ends, sym), device, 20, flush,
                                           lead=STEP_LEAD_CYCLES)
    per_kernel[name] = agg
    log(f"  Mode B {name}: {launches[name]} launches over {len(batches)} batches; one full step (4 launches) "
        f"{json.dumps(agg)}")

    # sampled_walk_shard: every launch of batch 0's walk (its cap slots),
    # each timed from the inputs it found (L2 flushed) beside its bound
    # from the live row-steps it took and its plain version (one run each:
    # it repeats the kernel's steps in PyTorch); then the whole walk on the
    # host clock, beside the narrow sampled_walk of the same rows.
    name, kept = "sampled_walk_shard", state["sampled_walk_shard"]["kept"]
    rounds = round_stats(walks["rounds"][0])
    if len(kept) != 4 * rounds["passes"] or not kept:
        raise AssertionError(f"sampled_walk_shard: {len(kept)} calls kept for {rounds['rounds']} rounds of "
                             f"{rounds['passes']} passes in all")
    fn, plain = kernels.sampled_walk_shard, kernels.sampled_walk_shard_plain
    agg = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0.0, "ops": 0.0, "library_ms": None,
           "launches_timed": len(kept), "row_steps": 0}
    work = {}

    def prepare(pre):
        def copy():
            for i in (3, 4):
                work.setdefault((id(pre), i), pre[i].clone()).copy_(pre[i])
            work.setdefault((id(pre), "cursor"), torch.zeros(1, dtype=torch.int64, device=device)).zero_()
        return copy

    def on_work(pre):
        return tuple(work[(id(pre), i)] if i in (3, 4) else a for i, a in enumerate(pre))

    def launch(pre, fn):
        a, cursor = on_work(pre), work[(id(pre), "cursor")]
        return lambda: fn(*a, cursor=cursor)

    sites = []
    for i, pre in enumerate(kept):
        nbytes, ops, row_steps = sampled_walk_shard_bound(*pre)
        prep = prepare(pre)
        prep()
        ms = time_ms(launch(pre, fn), device, 5, flush, prepare=prep)
        plain_ms = time_ms(lambda a=on_work(pre): plain(*a), device, 1, flush, prepare=prep)
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bytes", nbytes), ("ops", ops), ("row_steps", row_steps),
                     ("bound_ms", max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3)):
            agg[k] += v
        if i < 4:
            sites.append({"kernel": name, "site": f"shard {i} of round 1, pass 1", "rows": int(pre[3].shape[0]),
                          "row_steps": row_steps, "window_blocks": int(pre[0].shape[0]), "ms": ms,
                          "plain_ms": plain_ms, "bytes": nbytes, "ops": ops, "max_abs_err": 0,
                          "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3, "clocks": clocks()})
    work.clear()
    rows_out += sites
    walk_rows = walks["rows"]
    lengths = walk_lengths(narrow, walk_rows)
    agg["narrow_twin_ms"] = time_ms(lambda: kernels.sampled_walk(
        narrow.blocks, walk_rows, narrow.prefix_sums, narrow.codes, narrow.c2i, narrow.num_planes,
        narrow.alphabet.ambiguity_idx, slot.dev.sa_ratio, slot.dev.sampled_sa, slot.dev.bwt_len), device, 20, flush)
    walk_ms = []
    for _ in range(3):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        slot.walk(walk_rows)
        torch.cuda.synchronize(device)
        walk_ms.append((time.perf_counter() - t0) * 1e3)
    agg["walk_ms"] = min(walk_ms)
    agg["walk_ms_runs"] = walk_ms
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        slot.walk(walk_rows)
        torch.cuda.synchronize(device)
    events = prof.key_averages()
    agg["walk_device_busy_ms"] = sum(getattr(e, "self_device_time_total", 0) for e in events) / 1e3
    agg["walk_kernel_device_ms"] = sum(getattr(e, "self_device_time_total", 0) for e in events
                                       if "sampled_walk_kernel" in e.key) / 1e3
    agg["rounds"] = rounds["rounds"]
    agg["walk_steps"] = lengths
    per_kernel[name] = agg
    log(f"  Mode B {name}: {launches[name]} launches over {len(batches)} batches; batch 0's walk "
        f"({rounds['rounds']} rounds, {len(kept)} launches) {json.dumps(agg)}")
    log(f"  Mode B walk rounds of batch 0: {json.dumps(rounds)}; walks per batch 0: "
        f"{[len(r) for r in walks['rounds']]} rounds")
    for row in rows_out:
        log("  " + json.dumps(row))
    mode_b = {"ship_s": ship_s, "serve_s": serve_s, "encode_s": encode_s, "queries": nq, "queries_per_s": nq / serve_s,
              "launches": launches,
              "checked_vs_plain": checked, "sites": rows_out, "per_kernel": per_kernel, "walk_rounds": rounds,
              "shard_blocks": [int(sh.blocks.shape[0]) for sh in shards]}
    log(f"  Mode B (4 shards on {device}): {mode_b['queries_per_s']:.1f} queries/s end to end (phase 4's answers), "
        f"{serve_s:.3f} s of which the host encode alone {encode_s:.3f} s; walk steps of batch 0 {json.dumps(lengths)}")
    del engine, state, walks, slot, shards
    gc.collect()
    torch.cuda.empty_cache()
    return {"mode_a": mode_a, "mode_b": mode_b, **out}


# -- phase 21: AWRY's CPU hot path on this host ------------------------------------


def cpu_reference(run: dict, chr1: dict, sustained_qps: float) -> dict:
    """Phase 21: AWRY's C++ hot path (awry_tpu_torch/native/awry_cpu_ref.cpp
    through native/cpu_ref.py) on phase 4's host index and batch 0's reads,
    already encoded, 3 trials on every host thread; its hits and checksum
    equal to the port's batch-0 answers exactly, its rate beside phase 6's."""
    t0 = time.perf_counter()
    cpu_ref.build()
    build_s = time.perf_counter() - t0
    index = run["index"]
    qsyms = encode_ascii(Alphabet.NUCLEOTIDE, run["text_np"][run["starts"][0][:, None] + np.arange(QLEN)])
    counts, seq_idx, local, _ = run["results"][0]
    want = cpu_ref.expected_hits_checksum(counts, index.seq_starts[seq_idx] + local)
    t0 = time.perf_counter()
    result = cpu_ref.run(index, qsyms, trials=3)
    run_s = time.perf_counter() - t0
    if result["num_queries"] != BATCH or (result["hits"], result["checksum"]) != want:
        raise AssertionError(f"the CPU reference's (hits, checksum) ({result['hits']}, {result['checksum']}) over "
                             f"{result['num_queries']} reads != the port's batch-0 answers {want}")
    split = chr1["time_split"]
    port = {"end_to_end_qps": chr1["queries_per_s"], "wire_qps": split["queries"] / split["wire_serve_s"],
            "device_sustained_qps": sustained_qps}
    best = result["queries_per_sec"]
    return {"result": result, "build_s": build_s, "run_s": run_s, "port_chr1": port,
            "port_over_cpu": {k: v / best for k, v in port.items()}}


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
    t0 = time.perf_counter()
    wide_exact = wide_kernels_vs_plain(device, gen)
    exact |= wide_exact
    log(f"phase 3 wide kernels vs plain (positions, milestones and SA values past 2**32): "
        f"{json.dumps(wide_exact)} ({time.perf_counter() - t0:.3f} s)")
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
    sustained = {"chr1": run["engine"].device_sustained_qps(run["wires"])}  # phase 16, before the release
    t0 = time.perf_counter()
    log("phase 20 multi-device serving (chr1 scale, phase 4's index and batches):")
    multi = multi_device_path(run, device)
    paths["chr1_mode_a"], paths["chr1_mode_b"] = multi.pop("mode_a"), multi.pop("mode_b")
    paths["chr1_mode_b"] |= multi
    log(f"phase 20 multi-device: Mode A {paths['chr1_mode_a']['queries_per_s']:.1f}, Mode B "
        f"{paths['chr1_mode_b']['queries_per_s']:.1f} queries/s, phase 4's answers exactly "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    cpu = cpu_reference(run, paths["chr1"], sustained["chr1"])
    res = cpu["result"]
    log(f"phase 21 CPU reference (AWRY's C++ hot path on this host, phase 4's index, batch 0's {res['num_queries']} "
        f"{res['query_len']} bp reads): hits {res['hits']} and checksum {res['checksum']} equal to the port's "
        f"batch-0 answers; dump {res['dump_bytes']} B, binary built in {cpu['build_s']:.3f} s")
    log(f"  host CPU: {res['cpu_model']}, {res['threads']} threads; trials "
        f"{', '.join(f'{r:.1f}' for r in res['trial_queries_per_sec'])} queries/s; best {res['queries_per_sec']:.1f}")
    log("  the port's chr1 rates (phase 6) over the best CPU rate: " + ", ".join(
        f"{name} {cpu['port_chr1'][name]:.1f} ({cpu['port_over_cpu'][name]:.4f}x)" for name in cpu["port_chr1"]))
    log(f"  card: {card_line()}")
    log(f"phase 21 seconds: {time.perf_counter() - t0:.3f}")
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
    sustained |= {f"chr20 {regime}": qps for regime, qps in regimes["sustained_qps"].items()}
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
    # Phases 13-15 start from this path's host index, batches and answers.
    run["engine"].release()
    c20 = {key: run[key] for key in ("index", "batches", "results", "required", "rec_starts", "text_np")}
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
    # The range-fed walk serves the classic path's capped ranges.
    t0 = time.perf_counter()
    classic, _ = ship(run["index"], device, use_verify=False)
    crun = serve(classic, run["batches"][-1:], device)
    classic.release()
    del classic
    if not same_answers(crun["results"][0], run["results"][-1]):
        raise AssertionError("the classic path's answers to the GRCh38 512-read batch differ from the verify path's")
    log(f"  GRCh38 512-read batch, classic path: phase 10's answers; launches {crun['launches']} "
        f"({time.perf_counter() - t0:.3f} s with the ship)")
    require_launches("GRCh38-shaped classic", crun["launches"], ("occ_pair", "marked_walk_ranges"))
    paths["grch38"]["classic_tail_launches"] = crun["launches"]

    # Phase 17 runs while phase 10's engine lives: its tables give the
    # narrow twins their rows; then the facade on the wide index.
    t0 = time.perf_counter()
    fm = FmIndex(run.pop("index"), device=device, wide=True)
    torch.cuda.synchronize(device)
    wrun = wide_serve("GRCh38-shaped", fm.engine, time.perf_counter() - t0, run["batches"], run["results"], device)
    log(f"phase 17 wide GRCh38-shaped path: {wrun['queries']} queries in {wrun['serve_s']:.3f} s; launches "
        f"{wrun['launches']}; phase 10's answers ({time.perf_counter() - t0:.3f} s with the ship)")
    require_launches("wide GRCh38-shaped", wrun["launches"],
                     ("window_read", "occ_pair_wide", "marked_walk_wide", "marked_walk_ranges_wide"))
    if wrun["launches"]["occ_pair"] or wrun["launches"]["marked_walk"]:
        raise AssertionError("the wide GRCh38-shaped path launched a narrow rank or walk kernel")
    paths["grch38_wide"] = wide_report("grch38_wide", wrun, run["engine"].device_index, device)
    t0 = time.perf_counter()
    paths["grch38_wide_facade"] = wide_facade(fm, run, run["engine"].device_index, device, rng)
    log(f"  wide facade: {json.dumps(paths['grch38_wide_facade'])} ({time.perf_counter() - t0:.3f} s)")
    require_launches("wide facade", paths["grch38_wide_facade"]["launches"], ("backstep_wide", "occ_pair_wide"))
    fm.engine.release()
    del wrun, fm
    run["engine"].release()
    del run
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        files, markless = index_files(c20, device, tmp)
        log(f"phase 13 index files (chr20 scale): {json.dumps(files)} ({time.perf_counter() - t0:.3f} s)")
        del c20["index"]
        gc.collect()

        t0 = time.perf_counter()
        mrun = markless_path(c20, markless, files["awry"]["load_s"], device)
        log(f"phase 14 mark-less path: {mrun['queries']} queries in {mrun['serve_s']:.3f} s; launches "
            f"{mrun['launches']}; the same answers as phase 7 ({time.perf_counter() - t0:.3f} s)")
        require_launches("mark-less", mrun["launches"], ("occ_pair", "sampled_walk"))
        if mrun["launches"]["marked_walk"]:
            raise AssertionError("the mark-less path launched marked_walk")
        paths["markless"] = report("markless", mrun, device)
        paths["markless"]["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
        paths["markless"]["files"] = files
        walk_rows = [row for row in paths["markless"]["sites"] if row["kernel"] == "sampled_walk"]
        log(f"  markless sampled_walk lengths (steps per walked row of batch 0): {json.dumps(walk_rows[0]['walk_steps'])}")
        sustained["markless"] = mrun["engine"].device_sustained_qps(mrun["wires"])

        t0 = time.perf_counter()
        facade = facade_and_cli(c20, mrun, files["npz"]["path"], device, tmp, rng)
        log(f"phase 15 facade and CLI: {json.dumps(facade)} ({time.perf_counter() - t0:.3f} s)")
        paths["facade"] = {"launches": facade["launches"], "checked_vs_plain": facade["checked_vs_plain"],
                           "sites": [], "record": facade}

        # Phase 18, while phase 14's engine lives (the narrow twins' rows).
        t0 = time.perf_counter()
        engine, ship_s = ship(markless, device, wide=True)
        wrun = wide_serve("mark-less", engine, ship_s, c20["batches"], mrun["results"], device)
        del engine
        log(f"phase 18 wide mark-less path (.awry): {wrun['queries']} queries in {wrun['serve_s']:.3f} s; "
            f"launches {wrun['launches']}; phase 14's answers ({time.perf_counter() - t0:.3f} s with the ship)")
        require_launches("wide mark-less", wrun["launches"], ("occ_pair_wide", "sampled_walk_wide"))
        if wrun["launches"]["sampled_walk"] or wrun["launches"]["occ_pair"]:
            raise AssertionError("the wide mark-less path launched a narrow rank or walk kernel")
        paths["markless_wide"] = wide_report("markless_wide", wrun, mrun["engine"].device_index, device)
        t0 = time.perf_counter()
        paths["markless_wide_kmer"] = wide_kmer_build(markless, device)
        del markless
        log(f"phase 18 wide k-mer build (the .awry index's table through occ_wide, equal to load_awry's): "
            f"{json.dumps(paths['markless_wide_kmer'])} ({time.perf_counter() - t0:.3f} s)")
        wrun["engine"].release()
        del wrun
        mrun["engine"].release()
        del mrun
    gc.collect()
    torch.cuda.empty_cache()

    wire_qps = {
        "chr1": paths["chr1"]["time_split"], "chr20 slot": paths["chr20"]["time_split"],
        "chr20 switch": paths["chr20"]["regimes"]["planted"]["switch"]["time_split"],
        "markless": paths["markless"]["time_split"],
    }
    paths["sustained"] = {
        name: {"device_sustained_qps": qps, "wire_qps": wire_qps[name]["queries"] / wire_qps[name]["wire_serve_s"]}
        for name, qps in sustained.items()
    }
    for name, v in paths["sustained"].items():
        log(f"phase 16 sustained {name}: {v['device_sustained_qps']:.1f} queries/s with every output reduced on "
            f"the card, {v['wire_qps']:.1f} from the wire")

    t0 = time.perf_counter()
    frun = federation_path(device, rng)
    log(f"phase 19 federation (pan-genome shape, 256 Mbp, 4 partitions, mark 32): {frun['queries']} drawn reads in "
        f"{frun['serve_s']:.3f} s, {frun['edge_reads']} boundary reads; launches {frun['launches']} "
        f"({time.perf_counter() - t0:.3f} s with the text and the build)")
    require_launches("federation", frun["launches"], ("window_read", "occ_pair", "marked_walk"))
    t0 = time.perf_counter()
    checks = check_federation(frun, rng)
    log(f"  federation correctness: {json.dumps(checks)} ({time.perf_counter() - t0:.3f} s)")
    paths["federation"] = federation_report(frun, device) | {"checks": checks}
    del frun
    gc.collect()
    torch.cuda.empty_cache()

    # Times of window_read and occ_pair come from the chr1 path (slice 1's
    # numbers stay comparable), marked_walk's and backstep's (one visit over
    # the walk's recorded rows) from the GRCh38-shaped path, occ's from the
    # chr20-shaped k-mer build; launches add up over all paths.
    # The wide variants' times come from phases 17 (GRCh38-shaped) and 18
    # (mark-less), each beside its narrow twin on the same rows.
    # occ_wide's from phase 18's wide k-mer build beside occ on the same
    # requests; the shard variants' from phase 20's Mode B (one full step:
    # the sums of its 4 launches), beside their narrow twins.
    times_from = {"window_read": "chr1", "occ_pair": "chr1", "backstep": "grch38", "occ": "chr20",
                  "marked_walk": "grch38", "sampled_walk": "markless", "occ_pair_wide": "grch38_wide",
                  "backstep_wide": "grch38_wide", "marked_walk_wide": "grch38_wide",
                  "sampled_walk_wide": "markless_wide", "occ_wide": "markless_wide_kmer",
                  "occ_pair_shard": "chr1_mode_b", "sampled_walk_shard": "chr1_mode_b"}
    kernels_line = []
    for name in ALL_KERNELS:
        path = times_from[name]
        agg = paths[path]["per_kernel"][name]
        # Phase 3's inputs and every main-path call checked in the reports.
        errs = [v["max_abs_err"] for key, v in exact.items() if key.split(":")[0] == name]
        errs += [p["checked_vs_plain"][name]["max_abs_err"] for p in paths.values()
                 if name in p.get("checked_vs_plain", {})]
        errs += [row["max_abs_err"] for p in paths.values() for row in p.get("sites", ()) if row["kernel"] == name]
        kernels_line.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": sum(p["launches"].get(name, 0) for p in paths.values() if "launches" in p),
            "max_abs_err": max(errs),
            "ms": agg["ms"], "ms_write_flush": agg.get("ms_write_flush"), "plain_ms": agg["plain_ms"],
            "bound_ms": agg["bound_ms"], "library_ms_write_flush": agg.get("library_ms_write_flush"),
            "bound_by": "bytes" if agg["bytes"] / HBM_BYTES_PER_S >= agg["ops"] / INT32_OPS_PER_S else "operations",
            "library_ms": agg["library_ms"], "times_from_path": path,
            "launches_by_path": {p: v["launches"].get(name, 0) for p, v in paths.items() if "launches" in v},
        } | {k: agg[k] for k in ("narrow_twin_ms", "collective_step_ms", "narrow_step_ms", "collective_step_device_ms",
                                 "narrow_step_device_ms", "walk_ms", "walk_device_busy_ms", "walk_kernel_device_ms",
                                 "rounds", "launches_timed") if k in agg})
    total_s = time.perf_counter() - t_start
    log(f"total seconds: {total_s:.3f}")
    record = {
        "card": card, "seed": args.seed, "build_kernels_s": build_s, "exact": exact, "paths": paths,
        "kernels": kernels_line, "total_s": total_s, "cpu_ref": cpu,
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
