#!/usr/bin/env python3
"""The rank kernels of awry_tpu_torch (occ_pair, occ) timed on one NVIDIA GPU
against other builds of their source, in turns, at the shapes chip_smoke.py's
paths give them.

    python3 scripts/rank_kernel_study.py [--baseline DIR ...]
        [--paths chr1,chr20,grch38] [--pairs] [--out PATH]

Builds (nvcc with the package's own flags, all started together):

- ``new``: awry_tpu_torch/csrc/occ_pair.cu as the package builds it; it
  must equal the plain version at every site;
- ``--baseline DIR`` (repeatable): ``DIR/occ_pair.cu``, another revision of
  the source (``git show REV:awry_tpu_torch/csrc/occ_pair.cu``) or a copy cut
  down for an ablation, named by DIR's last part, its entry points renamed.
  Its largest error against the plain version is recorded, not enforced: a
  cut that does not compute the rank is timed all the same.

Inputs, recorded from the paths:

- ``chr1``: the full-batch rank steps (``occ_pair``) of chip_smoke's chr1
  path's first batch (250 Mbp, k = 13);
- ``chr20``: every full chunk (``occ``) of the k-mer build of the
  chr20-shaped index (64 Mbp, k = 13; levels 11, 12 and 13), and their sum;
- ``grch38``: the GRCh38-shaped path's full-batch rank steps of its first
  batch (1 Gbp, mark 4).

Each site: every build in turns (b1 .. bk, then bk .. b1), 20 launches each
timed by chip_smoke's ``time_ms`` with the L2 flushed before each launch.
``--pairs``: ``occ_pair`` also on the chr1 calls with every pair moved into
one block, then into two blocks.  The full record goes to ``--out`` as
JSON; the last line printed is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from awry_tpu_torch import FmBuildArgs, build_from_records  # noqa: E402
from awry_tpu_torch.ops import kernels, populate_kmer_table_device, to_device  # noqa: E402
from awry_tpu_torch.ops.kmer import _level_chunk  # noqa: E402

STUDY_DIR = os.path.join(kernels.BUILD_DIR, "study")
REPS = 20
P = ctypes.c_void_p
I64 = ctypes.c_int64
I32 = ctypes.c_int
PAIR_ARGTYPES = [I32, P, I64, I32, I32, I32, P, P, P, P, I64, P, P, P]
OCC_ARGTYPES = [I32, P, I64, I32, I32, I32, P, P, P, I64, P, P]


def log(msg: str) -> None:
    print(msg, flush=True)


# -- builds ------------------------------------------------------------------------


def _start_baseline(directory: str) -> tuple[str, str, subprocess.Popen]:
    """Start nvcc on DIR/occ_pair.cu with its entry points renamed
    ``<name>_occ_pair`` / ``<name>_occ``."""
    name = re.sub(r"\W", "_", os.path.basename(os.path.normpath(directory)))
    with open(os.path.join(directory, "occ_pair.cu")) as f:
        text = f.read().replace("awry_occ", f"{name}_occ")
    src = os.path.join(STUDY_DIR, f"{name}_occ_pair.cu")
    with open(src, "w") as f:
        f.write(text)
    h = hashlib.sha256((text + " ".join(kernels.NVCC_FLAGS)).encode()).hexdigest()[:12]
    out = os.path.join(STUDY_DIR, f"{name}-{h}.so")
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", out, src]
    return name, out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _bind(path: str, name: str) -> ctypes.CDLL:
    """Load a build and expose its entry points under the package's names,
    so that kernels.occ_pair / kernels.occ launch them."""
    lib = ctypes.CDLL(path)
    for entry, argtypes in (("occ_pair", PAIR_ARGTYPES), ("occ", OCC_ARGTYPES)):
        fn = getattr(lib, f"{name}_{entry}")
        fn.restype, fn.argtypes = I32, argtypes
        setattr(lib, f"awry_{entry}", fn)
    return lib


def build_all(baselines: list[str]) -> tuple[dict, dict]:
    """{name: lib} for every build ("new" first), and each one's ptxas
    report."""
    os.makedirs(STUDY_DIR, exist_ok=True)
    pending = [_start_baseline(d) for d in baselines]
    kernels._lib()  # the package's own build ("new")
    with open(kernels.library_path() + ".log") as f:
        ptxas = {"new": [ln.strip() for ln in f if "occ" in ln or "registers" in ln]}
    libs = {"new": kernels._lib()}
    for name, out, proc in pending:
        text = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        ptxas[name] = [ln.strip() for ln in text.splitlines() if "registers" in ln or "Compiling" in ln]
        libs[name] = _bind(out, name)
    return libs, ptxas


@contextlib.contextmanager
def using(lib):
    """Route the kernel wrappers to ``lib`` inside the block."""
    saved = kernels._lib_handle
    kernels._lib_handle = lib
    try:
        yield
    finally:
        kernels._lib_handle = saved


# -- recorded inputs ------------------------------------------------------------------


def record_chr1(device, rng) -> list:
    run = cs.chr1_path(device, rng)
    steps = [a for kind, a in run["calls"] if kind == "occ_pair" and a[1].shape[0] == cs.BATCH]
    run["engine"].release()
    return [("occ_pair", f"step {i + 1}", a) for i, a in enumerate(steps)]


def record_chr20(device, rng) -> list:
    text_np = cs.LETTERS[rng.integers(0, 4, size=cs.C_SYMBOLS, dtype=np.uint8)]
    index = build_from_records(
        [("chr20_synthetic", text_np.tobytes())],
        FmBuildArgs(lookup_table_kmer_len=cs.KMER_LEN, locate_mark_ratio=1, suffix_array_compression_ratio=8),
    )
    minimal = to_device(index, device, minimal=True)
    full = 2 * _level_chunk(4, 4**cs.KMER_LEN)
    calls: list = []
    with cs.recording_kernel_inputs(calls, lambda name, a: name == "occ" and a[1].shape[0] == full):
        table = populate_kmer_table_device(minimal, cs.KMER_LEN)
    if not np.array_equal(table, index.kmer_table):
        raise AssertionError("the device k-mer table differs from the host counting table")
    # At k = 13 a full chunk is 4^11 updates: level 11 one, 12 four, 13 sixteen.
    return [("occ", f"level {11 if i == 0 else 12 if i < 5 else 13}, chunk {i + 1}", a) for i, (_, a) in enumerate(calls)]


def record_grch38(device, rng) -> list:
    run = cs.grch38_path(device, rng)
    steps = [a for kind, a in run["calls"] if kind == "occ_pair" and a[1].shape[0] == cs.BATCH]
    run["engine"].release()
    return [("occ_pair", f"step {i + 1}", a) for i, a in enumerate(steps)]


# -- timing ----------------------------------------------------------------------------


def time_site(libs: dict, kind: str, args, device, flush) -> dict:
    """Each build's largest error against the plain version, and its mean
    ms timed in turns (forward, then backward)."""
    plain = getattr(kernels, f"{kind}_plain")(*args)
    errs, times = {}, {name: [] for name in libs}
    for name, lib in libs.items():
        with using(lib):
            errs[name] = cs.result_err(getattr(kernels, kind)(*args), plain)
    if errs["new"] != 0:
        raise AssertionError(f"{kind} disagrees with its plain version: max abs err {errs['new']}")
    for name in list(libs) + list(libs)[::-1]:

        def run(lib=libs[name]):
            with using(lib):
                getattr(kernels, kind)(*args)

        times[name].append(cs.time_ms(run, device, REPS, flush))
    return {"max_abs_err": errs, "ms": {name: sum(v) / len(v) for name, v in times.items()}}


def same_block(args):
    blocks, pos_a, pos_b, sym, codes, nplanes = args
    nbits = blocks.shape[0] * 256
    pa, pb = pos_a.clamp(0, nbits - 1), pos_b.clamp(0, nbits - 1)
    return (blocks, pa, (pa & ~255) | (pb & 255), sym, codes, nplanes)


def two_blocks(args):
    blocks, pos_a, pos_b, sym, codes, nplanes = args
    nb = blocks.shape[0]
    pa, pb = pos_a.clamp(0, nb * 256 - 1), pos_b.clamp(0, nb * 256 - 1)
    return (blocks, pa, (((pa >> 8) + 1) % nb << 8) | (pb & 255), sym, codes, nplanes)


def site_row(libs, path: str, kind: str, label: str, call, device, flush) -> dict:
    bound_fn = {"occ_pair": cs.occ_pair_bound, "occ": cs.occ_bound}[kind]
    nbytes, ops = bound_fn(*call)
    row = {"path": path, "kernel": kind, "site": label, "requests": int(call[1].shape[0]),
           "bound_ms": max(nbytes / cs.HBM_BYTES_PER_S, ops / cs.INT32_OPS_PER_S) * 1e3}
    if kind == "occ_pair":
        blocks, pos_a, pos_b = call[0], call[1], call[2]
        nbits = blocks.shape[0] * 256
        same = (pos_a.clamp(0, nbits - 1) >> 8) == (pos_b.clamp(0, nbits - 1) >> 8)
        row["same_block_share"] = float(same.float().mean())
    row.update(time_site(libs, kind, call, device, flush))
    log(json.dumps(row))
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", action="append", default=[], help="directory holding another occ_pair.cu")
    parser.add_argument("--paths", default="chr1,chr20", help="comma-separated: chr1, chr20, grch38")
    parser.add_argument("--pairs", action="store_true", help="occ_pair on chr1 pairs moved into one / two blocks")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", help="write the full record as JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("rank_kernel_study: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = cs.card_line()
    log(f"device: {card}")
    t0 = time.perf_counter()
    libs, ptxas = build_all(args.baseline)
    log(f"builds {list(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, lines in ptxas.items():
        for ln in lines:
            log(f"  ptxas {name}: {ln}")
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.int32, device=device)
    rng = np.random.default_rng(args.seed)
    rows, sums = [], {}
    for path in args.paths.split(","):
        t0 = time.perf_counter()
        sites = {"chr1": record_chr1, "chr20": record_chr20, "grch38": record_grch38}[path](device, rng)
        log(f"{path}: {len(sites)} sites recorded in {time.perf_counter() - t0:.1f} s")
        for kind, label, call in sites:
            rows.append(site_row(libs, path, kind, label, call, device, flush))
            if args.pairs and path == "chr1":
                for name, fn in (("one block", same_block), ("two blocks", two_blocks)):
                    rows.append(site_row(libs, path, kind, f"{label}, every pair in {name}", fn(call), device, flush))
        if path == "chr20":
            ours = [r for r in rows if r["path"] == "chr20"]
            sums["chr20 full chunks"] = {"chunks": len(ours), "bound_ms": sum(r["bound_ms"] for r in ours),
                                         "ms": {n: sum(r["ms"][n] for r in ours) for n in libs}}
            log(json.dumps(sums))
        del sites
        gc.collect()
        torch.cuda.empty_cache()
    record = {"card": card, "ptxas": ptxas, "sites": rows, "sums": sums, "reps": REPS}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    log(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
