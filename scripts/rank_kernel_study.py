#!/usr/bin/env python3
"""The kernels of awry_tpu_torch timed on one NVIDIA GPU against other builds
of their sources, in turns, at the shapes chip_smoke.py's paths give them:
the rank kernels (occ_pair, occ), window_read and the marked LF walk.

    python3 scripts/rank_kernel_study.py [--baseline DIR ...]
        [--kernels occ_pair,occ,window_read,marked_walk]
        [--paths chr1,chr20,grch38] [--pairs] [--out PATH]

Builds (nvcc with the package's own flags, all started together):

- ``new``: the package's sources as the package builds them; every call
  must equal the plain version;
- ``--baseline DIR`` (repeatable): whichever of ``DIR/occ_pair.cu``,
  ``DIR/window_read.cu`` and ``DIR/backstep.cu`` exist, another revision
  (``git show REV:awry_tpu_torch/csrc/NAME.cu``) or a copy cut down for an
  ablation, built into one library named by DIR's last part, its entry
  points renamed.  Its largest error against the plain version is recorded,
  not enforced: a cut that does not compute the function is timed all the
  same.  A kernel whose source DIR lacks runs the package's build.

Inputs, recorded from the paths (each kernel's full-batch calls of the
path's first batch):

- ``chr1`` (250 Mbp, k = 13, mark 1): occ_pair's rank steps; window_read's
  seed, SA and text reads;
- ``chr20`` (64 Mbp, k = 13): occ over every full chunk of the k-mer build
  (levels 11, 12 and 13) and their sum; window_read's seed read and slot
  fat rows (the slot regime's serving);
- ``grch38`` (1 Gbp, mark 4): occ_pair's rank steps; window_read's seed
  and text reads; the verify walk's rows (marked_walk).

Each site: every build in turns (b1 .. bk, then bk .. b1, twice), 20
launches each timed by chip_smoke's ``time_ms`` (L2 flushed by a read
before each launch); a build's ms is the median of its 4 turns, each turn
kept in the record.  window_read sites add PyTorch's ``flat[idx]`` to the turns.  The
walk is timed whole (events around the call): a build with marked_walk in
one launch, a build without it (the parent's) as mark_ratio backstep
launches, the glue between them and the k=1 window_read of the marked SA
(kernels.walk_by_visits); ``new, by visits`` runs the new build that way.
``--pairs``: occ_pair also on the chr1 calls with every pair moved into one
block, then into two blocks.  The full record goes to ``--out`` as JSON;
the last line printed is the card's name and power limit.
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
TURN_PAIRS = 2  # forward and backward turns per site, each REPS launches
P = ctypes.c_void_p
I64 = ctypes.c_int64
I32 = ctypes.c_int
# Each source's entry points and their argument types.
ENTRIES = {
    "occ_pair.cu": {
        "occ_pair": [I32, P, I64, I32, I32, I32, P, P, P, P, I64, P, P, P],
        "occ": [I32, P, I64, I32, I32, I32, P, P, P, I64, P, P],
    },
    "window_read.cu": {"window_read": [I32, P, I64, P, I64, I32, P, P]},
    "backstep.cu": {
        "backstep": [I32, P, I64, I32, I32, P, P, P, I32, I32, P, I64, P, P, P],
        "marked_walk": [I32, P, I64, I32, I32, P, P, P, I32, I32, I32, P, I64, I64, P, I64, P, P],
    },
}
KINDS = ("occ_pair", "occ", "window_read", "marked_walk")


def log(msg: str) -> None:
    print(msg, flush=True)


# -- builds ------------------------------------------------------------------------


def _start_baseline(directory: str) -> tuple[str, str, list, subprocess.Popen]:
    """Start nvcc on DIR's sources, their entry points renamed ``<name>_*``."""
    name = re.sub(r"\W", "_", os.path.basename(os.path.normpath(directory)))
    srcs, present, h = [], [], hashlib.sha256(" ".join(kernels.NVCC_FLAGS).encode())
    for source in ENTRIES:
        path = os.path.join(directory, source)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            text = re.sub(r"\bawry_", f"{name}_", f.read())
        src = os.path.join(STUDY_DIR, f"{name}_{source}")
        with open(src, "w") as f:
            f.write(text)
        h.update(text.encode())
        srcs.append(src)
        present.append(source)
    if not srcs:
        raise ValueError(f"{directory} holds none of {list(ENTRIES)}")
    out = os.path.join(STUDY_DIR, f"{name}-{h.hexdigest()[:12]}.so")
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", out, *srcs]
    return name, out, present, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


class _Build:
    """A baseline's entry points under the package's names; entries of the
    sources it lacks fall through to the package's own build.  It walks in
    one launch unless its backstep.cu has no marked_walk (the parent's)."""

    def __init__(self, path: str, name: str, present: list, fallback):
        self._lib = ctypes.CDLL(path)
        for source in present:
            for entry, argtypes in ENTRIES[source].items():
                if hasattr(self._lib, f"{name}_{entry}"):
                    fn = getattr(self._lib, f"{name}_{entry}")
                    fn.restype, fn.argtypes = I32, argtypes
                    setattr(self, f"awry_{entry}", fn)
        self.walks_fused = "backstep.cu" not in present or hasattr(self._lib, f"{name}_marked_walk")
        self._fallback = fallback

    def __getattr__(self, attr):
        return getattr(self._fallback, attr)


def build_all(baselines: list[str]) -> tuple[dict, dict]:
    """{name: lib} for every build ("new" first), and each one's ptxas
    report."""
    os.makedirs(STUDY_DIR, exist_ok=True)
    pending = [_start_baseline(d) for d in baselines]
    new = kernels._lib()  # the package's own build
    with open(kernels.library_path() + ".log") as f:
        ptxas = {"new": [ln.strip() for ln in f if "Compiling" in ln or "registers" in ln]}
    libs = {"new": new}
    for name, out, present, proc in pending:
        text = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        ptxas[name] = [ln.strip() for ln in text.splitlines() if "registers" in ln or "Compiling" in ln]
        libs[name] = _Build(out, name, present, new)
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


def _table_names(dev) -> dict:
    return {id(dev.kmer_flat): "seed", id(dev.text_sampled_sa): "sa", id(dev.text_packed): "text",
            id(dev.vw_flat): "slot fat"}


def _serving_sites(run: dict, kinds) -> list:
    """The full-batch calls of the path's first batch, labelled."""
    names, sites, steps = _table_names(run["engine"].device_index), [], 0
    for kind, a in run["calls"]:
        if kind not in kinds or a[1].shape[0] < cs.BATCH:
            continue
        if kind == "occ_pair":
            steps += 1
            sites.append((kind, f"step {steps}", a))
        elif kind == "window_read":
            sites.append((kind, f"{names.get(id(a[0]), 'table')} k={a[2]}", a))
        elif kind == "marked_walk":
            sites.append((kind, f"walk rows (mark {a[8]})", a))
    run["engine"].release()
    return sites


def record_chr1(device, rng, kinds) -> list:
    return _serving_sites(cs.chr1_path(device, rng), kinds)


def record_chr20(device, rng, kinds) -> list:
    sites = []
    if "occ" in kinds:
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
        sites += [("occ", f"level {11 if i == 0 else 12 if i < 5 else 13}, chunk {i + 1}", a)
                  for i, (_, a) in enumerate(calls)]
        del index, minimal, table
    if "window_read" in kinds:
        run = cs.chr20_path(device, rng)
        run.pop("index", None)
        sites += _serving_sites(run, kinds)
    return sites


def record_grch38(device, rng, kinds) -> list:
    return _serving_sites(cs.grch38_path(device, rng), kinds)


# -- timing ----------------------------------------------------------------------------


def _walk(lib, args):
    """The whole walk on ``lib``: one marked_walk launch if it has one, else
    by visits of its backstep and window_read."""
    with using(lib):
        if getattr(lib, "walks_fused", True):
            return kernels.marked_walk(*args)
        return kernels.walk_by_visits(kernels.backstep, kernels.window_read, *args)


def contenders(libs: dict, kind: str, args) -> dict:
    """{name: fn} timed in turns at a site."""
    if kind == "marked_walk":
        out = {name: (lambda lib=lib: _walk(lib, args)) for name, lib in libs.items()}

        def by_visits():
            with using(libs["new"]):
                return kernels.walk_by_visits(kernels.backstep, kernels.window_read, *args)

        return out | {"new, by visits": by_visits}

    def launch(lib):
        with using(lib):
            return getattr(kernels, kind)(*args)

    out = {name: (lambda lib=lib: launch(lib)) for name, lib in libs.items()}
    if kind == "window_read":
        flat, wbase, k = args
        idx = wbase.clamp(k - 1, flat.shape[0] - 1)[:, None] - torch.arange(k, device=flat.device)
        out["flat[idx]"] = lambda: flat[idx]
    return out


def time_site(libs: dict, kind: str, args, device, flush) -> dict:
    """Each contender's largest error against the plain version, and its
    median ms over turns (forward, then backward, TURN_PAIRS times)."""
    plain = getattr(kernels, f"{kind}_plain")(*args)
    fns = contenders(libs, kind, args)
    errs = {name: cs.result_err(fn(), plain) for name, fn in fns.items()}
    if errs["new"] != 0:
        raise AssertionError(f"{kind} disagrees with its plain version: max abs err {errs['new']}")
    times = {name: [] for name in fns}
    for name in (list(fns) + list(fns)[::-1]) * TURN_PAIRS:
        times[name].append(cs.time_ms(fns[name], device, REPS, flush))
    return {"max_abs_err": errs, "ms": {name: float(np.median(v)) for name, v in times.items()}, "turns_ms": times}


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


BOUNDS = {"occ_pair": cs.occ_pair_bound, "occ": cs.occ_bound, "window_read": cs.window_read_bound,
          "marked_walk": cs.marked_walk_bound}


def site_row(libs, path: str, kind: str, label: str, call, device, flush) -> dict:
    nbytes, ops = BOUNDS[kind](*call)
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
    parser.add_argument("--baseline", action="append", default=[], help="directory holding other kernel sources")
    parser.add_argument("--kernels", default="occ_pair,occ", help=f"comma-separated, of {','.join(KINDS)}")
    parser.add_argument("--paths", default="chr1,chr20", help="comma-separated: chr1, chr20, grch38")
    parser.add_argument("--pairs", action="store_true", help="occ_pair on chr1 pairs moved into one / two blocks")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", help="write the full record as JSON here")
    args = parser.parse_args()
    kinds = set(args.kernels.split(","))
    if not kinds <= set(KINDS):
        parser.error(f"--kernels: unknown {sorted(kinds - set(KINDS))}")
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
    flush = cs.make_flush(device)
    rng = np.random.default_rng(args.seed)
    rows, sums = [], {}
    for path in args.paths.split(","):
        t0 = time.perf_counter()
        sites = {"chr1": record_chr1, "chr20": record_chr20, "grch38": record_grch38}[path](device, rng, kinds)
        log(f"{path}: {len(sites)} sites recorded in {time.perf_counter() - t0:.1f} s")
        for kind, label, call in sites:
            rows.append(site_row(libs, path, kind, label, call, device, flush))
            if args.pairs and path == "chr1" and kind == "occ_pair":
                for name, fn in (("one block", same_block), ("two blocks", two_blocks)):
                    rows.append(site_row(libs, path, kind, f"{label}, every pair in {name}", fn(call), device, flush))
        for kind in ("occ", "window_read"):
            ours = [r for r in rows if r["path"] == path and r["kernel"] == kind]
            if len(ours) > 1:
                sums[f"{path} {kind}"] = {"sites": len(ours), "bound_ms": sum(r["bound_ms"] for r in ours),
                                          "ms": {n: sum(r["ms"][n] for r in ours) for n in ours[0]["ms"]}}
                log(json.dumps({f"{path} {kind}": sums[f"{path} {kind}"]}))
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
