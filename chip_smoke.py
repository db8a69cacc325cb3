#!/usr/bin/env python3
"""Smoke run of the PyTorch port (awry_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--record PATH]

Phases, in order; any failure raises and the script exits non-zero:

1. Device: a CUDA device is required; prints its name and power limit.
2. Build: compiles the CUDA kernels from awry_tpu_torch/csrc/ (nvcc, one
   process per source) into awry_tpu_torch/_build/.
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   card, exactly, at main-path shapes: window_read (k = 2, 3) over a 1 GB
   SA-sized table, occ_pair over chr1-sized nucleotide rows and amino rows.
4. Main path: a chr1-scale index (250 Mbp of seeded random ACGT, k-mer
   seed length 13, mark ratio 1, SA ratio 8) built by the port's builder,
   shipped to the card, then 4 batches of 524,288 30 bp reads drawn from
   the text plus a batch holding a few hundred random reads, served
   through FmQueryEngine.count_locate_stream.  Kernel launch counts are set
   to 0 just before and read just after.
5. Correctness: every reported hit spells its query in the text, every
   drawn read is found at its own position, and for 64 sampled queries the
   count equals a naive overlapping scan of the text.
6. Report: end-to-end queries/s and engine stats; how the time splits
   between host encode, serving from the wire and the device (profiler);
   per-kernel device times
   (CUDA events, L2 flushed before each launch) at the shapes the main path
   gave each kernel, beside the plain version, one torch indexing call
   (window_read only) and the bound from bytes moved.

The last three lines are the card's name and power limit, the kernels JSON
and {"ok": true, "device": {...}}.  ``--record PATH`` also writes the full
record (every call site, the time split, the checks) as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from awry_tpu_torch import Alphabet, FmBuildArgs, build_from_records
from awry_tpu_torch.alphabet import index_to_code_table
from awry_tpu_torch.ops import FmQueryEngine, fused_row_words, kernels

N_SYMBOLS = 250_000_000  # chr1 scale (bench.py chr1_250Mbp_dna)
KMER_LEN = 13
QLEN = 30
BATCH = 524_288
NUM_BATCHES = 4
NUM_RANDOM = 384
NUM_NAIVE = 64

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
INT32_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores (data sheet)
L2_FLUSH_BYTES = 128 << 20  # > 2x the 50 MB L2
SOURCES = {"window_read": "awry_tpu_torch/csrc/window_read.cu", "occ_pair": "awry_tpu_torch/csrc/occ_pair.cu"}
REPLACES = {
    "window_read": "awry_tpu/ops/sweep.py:1036",  # _anchored_text_kernel
    "occ_pair": "awry_tpu/ops/sweep.py:1084",  # _occ_pair_pay_kernel_anchored (and :1062)
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- phase 3 -----------------------------------------------------------------


def random_words(shape, device, gen) -> torch.Tensor:
    """int32 tensor of uniformly random 32-bit patterns."""
    return torch.randint(-(2**31), 2**31, shape, device=device, generator=gen).to(torch.int32)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest difference of the uint32 values two int32 bit-pattern tensors hold."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    diff = (got.to(torch.int64) & 0xFFFFFFFF) - (want.to(torch.int64) & 0xFFFFFFFF)
    return int(diff.abs().max()) if diff.numel() else 0


def kernels_vs_plain(device: torch.device, gen: torch.Generator) -> dict:
    """Each kernel against its plain version on the card, exact equality."""
    out = {}
    table = random_words((N_SYMBOLS + 1,), device, gen)
    wbase = torch.randint(-8, table.shape[0] + 8, (BATCH + BATCH // 4,), device=device, generator=gen)
    for k in (2, 3):
        err = max_abs_err(kernels.window_read(table, wbase, k), kernels.window_read_plain(table, wbase, k))
        if err != 0:
            raise AssertionError(f"window_read k={k} disagrees with its plain version (max abs err {err})")
        out[f"window_read_k{k}"] = {"requests": wbase.shape[0], "table_words": table.shape[0], "max_abs_err": err}
    del table, wbase
    for alphabet, symbols in ((Alphabet.NUCLEOTIDE, N_SYMBOLS), (Alphabet.AMINO, 20_000_000)):
        rw = fused_row_words(alphabet)
        nb = -(-(symbols + 1) // 256)
        blocks = random_words((nb, rw), device, gen)
        codes = torch.from_numpy(index_to_code_table(alphabet).astype(np.int32)).to(device)
        pos_a = torch.randint(-1, nb * 256, (BATCH,), device=device, generator=gen)
        pos_b = (pos_a + torch.randint(0, 600, (BATCH,), device=device, generator=gen)).clamp_max(nb * 256 - 1)
        sym = torch.randint(0, alphabet.cardinality, (BATCH,), dtype=torch.int32, device=device, generator=gen)
        got = kernels.occ_pair(blocks, pos_a, pos_b, sym, codes, alphabet.num_planes)
        want = kernels.occ_pair_plain(blocks, pos_a, pos_b, sym, codes, alphabet.num_planes)
        err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
        if err != 0:
            raise AssertionError(f"occ_pair ({alphabet.name}) disagrees with its plain version (max abs err {err})")
        out[f"occ_pair_{alphabet.name.lower()}"] = {"requests": BATCH, "rows": nb, "row_words": rw, "max_abs_err": err}
    return out


# -- phase 4 -----------------------------------------------------------------


@contextlib.contextmanager
def recording_kernel_inputs(calls: list):
    """Record the inputs of every kernel call made inside the block (the
    wrappers themselves still run and count their launches)."""
    window_read, occ_pair = kernels.window_read, kernels.occ_pair

    def rec_window_read(flat, wbase, k):
        calls.append(("window_read", (flat, wbase.clone(), k)))
        return window_read(flat, wbase, k)

    def rec_occ_pair(blocks, pos_a, pos_b, sym, codes, nplanes):
        calls.append(("occ_pair", (blocks, pos_a.clone(), pos_b.clone(), sym.clone(), codes, nplanes)))
        return occ_pair(blocks, pos_a, pos_b, sym, codes, nplanes)

    # A wrapper counts its launches on the function its module name binds,
    # so while patched the counts land on these stand-ins.
    rec_window_read.launches = rec_occ_pair.launches = 0
    kernels.window_read, kernels.occ_pair = rec_window_read, rec_occ_pair
    try:
        yield calls
    finally:
        kernels.window_read, kernels.occ_pair = window_read, occ_pair


def main_path(device: torch.device, rng: np.random.Generator, n_symbols: int, batch: int, num_batches: int):
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    text_np = letters[rng.integers(0, 4, size=n_symbols, dtype=np.uint8)]
    text = text_np.tobytes()

    t0 = time.perf_counter()
    index = build_from_records(
        [("chr1_synthetic", text)],
        FmBuildArgs(lookup_table_kmer_len=KMER_LEN, locate_mark_ratio=1, suffix_array_compression_ratio=8),
    )
    build_s = time.perf_counter() - t0
    log(f"host index build seconds: {build_s:.3f}")

    t0 = time.perf_counter()
    engine = FmQueryEngine(index, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ship_s = time.perf_counter() - t0
    dev = engine.device_index
    table_bytes = {
        name: getattr(dev, name).numel() * getattr(dev, name).element_size()
        for name in ("blocks", "kmer_flat", "text_sampled_sa", "text_packed")
    }
    log(f"index on {device}: ship {ship_s:.3f} s, switch step {engine._verify_s}, tables {table_bytes}")

    # Reads drawn from the text (each batch keeps its start positions), and
    # a last batch of random reads with a few drawn ones.
    starts = [rng.integers(0, n_symbols - QLEN, size=batch) for _ in range(num_batches)]
    rnd = letters[rng.integers(0, 4, size=(NUM_RANDOM, QLEN), dtype=np.uint8)]
    tail_starts = rng.integers(0, n_symbols - QLEN, size=512 - NUM_RANDOM)
    batches = [[text[s : s + QLEN] for s in st.tolist()] for st in starts]
    batches.append([r.tobytes() for r in rnd] + [text[s : s + QLEN] for s in tail_starts.tolist()])

    # Warm-up on the first batch, recording the inputs the main path gives
    # each kernel (timed in the report phase).
    calls: list = []
    with recording_kernel_inputs(calls):
        next(engine.count_locate_stream([batches[0]]))
    for k in engine.stats:
        engine.stats[k] = 0

    kernels.window_read.launches = 0
    kernels.occ_pair.launches = 0
    t0 = time.perf_counter()
    results = list(engine.count_locate_stream(batches))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    serve_s = time.perf_counter() - t0
    launches = {"window_read": kernels.window_read.launches, "occ_pair": kernels.occ_pair.launches}
    nq = sum(len(b) for b in batches)
    return {
        "text_np": text_np, "text": text, "index": index, "engine": engine, "build_s": build_s,
        "ship_s": ship_s, "starts": starts, "tail_starts": tail_starts, "random_reads": rnd,
        "batches": batches, "results": results, "serve_s": serve_s, "queries": nq,
        "launches": launches, "calls": calls,
    }


# -- phase 5 -----------------------------------------------------------------


def naive_count(text: bytes, q: bytes) -> int:
    n, at = 0, text.find(q)
    while at >= 0:
        n += 1
        at = text.find(q, at + 1)
    return n


def check_results(run: dict, rng: np.random.Generator) -> dict:
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
    for q, c in picks:
        want = naive_count(text, q)
        if c != want:
            raise AssertionError(f"count {c} != naive scan {want} for {q!r}")
    return {"hits_checked": checked_hits, "naive_checked": len(picks)}


# -- phase 6 -----------------------------------------------------------------


def time_ms(fn, device, reps: int, flush: torch.Tensor) -> float:
    """Mean device time of fn() over reps launches, L2 flushed before each."""
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
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


def time_split(run: dict, device: torch.device) -> dict:
    """Where the end-to-end time goes, over the main path's full batches:
    the host encode alone, the same batches served from their pre-encoded
    wire, and the device time of that serving from a profiler trace (its
    share of the wire-served wall time is the device busy share)."""
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


def kernel_report(run: dict, device: torch.device) -> tuple[list[dict], dict]:
    """Per call site of one verify batch, and per kernel summed over them."""
    engine = run["engine"]
    dev = engine.device_index
    batch = len(run["batches"][0])
    names = {id(dev.kmer_flat): "seed", id(dev.text_sampled_sa): "sa", id(dev.text_packed): "text"}
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=device)
    rows = []
    per_kernel = {}
    for kind, args in run["calls"]:
        if args[1].shape[0] < batch:
            continue  # a re-dispatch call, not the verify path's
        if kind == "window_read":
            flat, wbase, k = args
            site = f"{names.get(id(flat), 'table')} k={k}"
            ms = time_ms(lambda: kernels.window_read(flat, wbase, k), device, 20, flush)
            plain_ms = time_ms(lambda: kernels.window_read_plain(flat, wbase, k), device, 5, flush)
            idx = wbase.clamp(k - 1, flat.shape[0] - 1)[:, None] - torch.arange(k, device=device)
            lib_ms = time_ms(lambda: flat[idx], device, 20, flush)
            nbytes, ops = window_read_bound(flat, wbase, k)
        else:
            site = "rank step"
            ms = time_ms(lambda: kernels.occ_pair(*args), device, 20, flush)
            plain_ms = time_ms(lambda: kernels.occ_pair_plain(*args), device, 5, flush)
            lib_ms = None
            nbytes, ops = occ_pair_bound(*args)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
        row = {
            "kernel": kind, "site": site, "requests": int(args[1].shape[0]), "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound, "bytes": nbytes, "ops": ops,
        }
        rows.append(row)
        agg = per_kernel.setdefault(kind, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "bytes": 0.0, "ops": 0.0})
        for key in ("ms", "plain_ms", "bound_ms", "bytes", "ops"):
            agg[key] += row[key]
        agg["library_ms"] = None if lib_ms is None or agg["library_ms"] is None else agg["library_ms"] + lib_ms
    return rows, per_kernel


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of the synthetic text and reads")
    parser.add_argument("--record", help="also write the full record as JSON to this file")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
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
    run = main_path(device, rng, N_SYMBOLS, BATCH, NUM_BATCHES)
    qps = run["queries"] / run["serve_s"]
    log(
        f"phase 4 main path: {run['queries']} queries in {run['serve_s']:.3f} s = {qps:.1f} queries/s "
        f"end to end; launches {run['launches']}; peak device memory "
        f"{torch.cuda.max_memory_allocated(device)} B"
    )
    for name, n in run["launches"].items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    t0 = time.perf_counter()
    checks = check_results(run, rng)
    log(f"phase 5 correctness: {checks} ({time.perf_counter() - t0:.3f} s)")

    stats = dict(run["engine"].stats)
    log(f"phase 6 report: {qps:.1f} queries/s end to end, engine stats {json.dumps(stats)}")
    split = time_split(run, device)
    log(f"  time split: {json.dumps(split)}")
    rows, per_kernel = kernel_report(run, device)
    verify_batches = stats["batches"]
    for row in rows:
        log("  " + json.dumps(row))
    kernels_line = []
    for name in ("window_read", "occ_pair"):
        agg = per_kernel[name]
        log(f"  {name}: {run['launches'][name]} launches over {verify_batches} verify batches "
            f"({run['launches'][name] / verify_batches:.2f} per batch); per-batch ms {agg['ms']:.4f}")
        kernels_line.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": run["launches"][name], "ms": agg["ms"],
            "max_abs_err": max(v["max_abs_err"] for key, v in exact.items() if key.startswith(name)),
            "plain_ms": agg["plain_ms"], "bound_ms": agg["bound_ms"],
            "bound_by": "bytes" if agg["bytes"] / HBM_BYTES_PER_S >= agg["ops"] / INT32_OPS_PER_S else "operations",
            "library_ms": agg["library_ms"],
        })
    record = {
        "card": card, "seed": args.seed, "build_kernels_s": build_s, "build_index_s": run["build_s"],
        "ship_s": run["ship_s"], "serve_s": run["serve_s"], "queries": run["queries"],
        "queries_per_s": qps, "stats": stats, "launches": run["launches"], "exact": exact,
        "checks": checks, "time_split": split, "sites": rows, "kernels": kernels_line,
        "peak_device_bytes": torch.cuda.max_memory_allocated(device),
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
