"""One run of one cell: set-up, the measured window, the comparison with the
reference, and (``--trace 1``) the profiled slice.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name in ``BENCHMARK.json``:
``fmbench/configs/<config>.json`` (through the entry's ``file``),
``fmbench/traffic/<traffic>.json`` and ``fmbench/metrics/<metric>.py``.

The load is a closed loop of client threads in this one process (one
process per card), each on a CUDA stream of its own, all sharing one
``FmQueryEngine`` (one copy of the index on the card, as one server process
holds it).  Each client cycles the seed's pool of pre-encoded wire batches:
count+locate through ``count_locate_stream`` (assembled on the host), or
counts through ``count_batch_dispatch`` (copied to the host).  Every batch a
client gets back has lanes of its own drawn for the comparison (``Sampler``).
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
import os
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import data, tracing
from .check import CONTROLS, compare, control_answers, sample_answers
from .reference.exact_match import find_all


def log(msg: str) -> None:
    print(f"[fmbench] {msg}", file=sys.stderr, flush=True)


# -- the cell's files, found by name ---------------------------------------------


def load_cell(root: str, workload: str) -> dict:
    """The cell named ``workload`` of ``root/BENCHMARK.json`` with its
    configuration, its traffic mix and the metric names it reports."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, entry["file"]), "rb") as f:
        cfg_bytes = f.read()
    with open(os.path.join(root, "fmbench", "traffic", cell["traffic"] + ".json")) as f:
        mix = json.load(f)

    def names(metrics):
        return [m["name"] for m in metrics if workload in m.get("workloads", [workload])]

    return {"root": root, "cell": cell, "config": json.loads(cfg_bytes), "config_bytes": cfg_bytes, "mix": mix,
            "end_to_end": names(bench["end_to_end"]), "per_layer": names(bench["per_layer"]),
            "units": {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}}


def load_metric(root: str, name: str):
    """The reader module ``fmbench/metrics/<name>.py``."""
    path = os.path.join(root, "fmbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"fmbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the index, built once per checkout ---------------------------------------------


def source_digest(pkg_dir: str) -> str:
    """A hash of every source file of the program's package."""
    h = hashlib.sha256()
    for d, subdirs, files in sorted(os.walk(pkg_dir)):
        subdirs[:] = sorted(s for s in subdirs if s not in ("_build", "__pycache__"))
        for name in sorted(files):
            if name.endswith((".py", ".cu", ".cpp", ".h", ".cuh")):
                path = os.path.join(d, name)
                h.update(os.path.relpath(path, pkg_dir).encode())
                with open(path, "rb") as f:
                    h.update(f.read())
    return h.hexdigest()


def cached_index(cs: dict) -> tuple[str, dict]:
    """The cache directory of the cell's configuration, building the text and
    the index there first if it is missing.  Keyed by the configuration
    file's bytes and the program's sources; returns (directory, build info)."""
    import awry_tpu_torch
    from awry_tpu_torch import FmBuildArgs, build_from_records, save_artifact

    cfg = cs["config"]
    key = hashlib.sha256(cs["config_bytes"] + source_digest(os.path.dirname(awry_tpu_torch.__file__)).encode())
    path = os.path.join(cs["root"], "fmbench", ".cache", f"{cs['cell']['config']}-{key.hexdigest()[:16]}")
    if os.path.exists(os.path.join(path, "done.json")):
        with open(os.path.join(path, "done.json")) as f:
            return path, json.load(f)
    os.makedirs(path, exist_ok=True)
    t0 = time.perf_counter()
    text, starts, lengths, copies = data.make_text(cfg)
    text_s = time.perf_counter() - t0
    for name, arr in (("text", text), ("starts", starts), ("lengths", lengths), ("copies", copies)):
        np.save(os.path.join(path, name + ".npy"), arr)
    raw = text.tobytes()
    del text
    records = [(f"rec{i}", raw[s : s + ln]) for i, (s, ln) in enumerate(zip(starts.tolist(), lengths.tolist()))]
    del raw
    t0 = time.perf_counter()
    args = FmBuildArgs(lookup_table_kmer_len=int(cfg["kmer_len"]), locate_mark_ratio=int(cfg["mark_ratio"]),
                       suffix_array_compression_ratio=int(cfg["sa_ratio"]))
    index = build_from_records(records, args)
    build_s = time.perf_counter() - t0
    del records
    if not np.array_equal(index.seq_starts, starts):
        raise RuntimeError("the index's record starts disagree with the generated text")
    save_artifact(index, os.path.join(path, "index.npz"), compress=False)
    info = {"text_s": text_s, "build_s": build_s,
            "artifact_bytes": os.path.getsize(os.path.join(path, "index.npz")),
            "text_bytes": os.path.getsize(os.path.join(path, "text.npy"))}
    with open(os.path.join(path, "done.json"), "w") as f:
        json.dump(info, f)
    info["built_now"] = True
    return path, info


# -- clients --------------------------------------------------------------------


class Sampler:
    """The lanes of each returned batch whose answers are compared, drawn
    afresh for every batch a client gets back: ``sample_random`` lanes at
    random, ``sample_n`` of the reads with an N, ``sample_repeat`` of those
    drawn over a repeat copy and ``sample_overcap`` of the lanes whose
    returned count is over the mix's ``cap`` (the over-cap expansion).  The
    k-th batch client c gets back takes its lanes from (seed, c, k) alone."""

    def __init__(self, mix: dict, seed: int, has_n: np.ndarray, in_repeat: np.ndarray):
        self.B, self.seed = int(mix["batch"]), seed
        P = int(mix["pool"])
        self.sizes = [int(mix.get(k, 0)) for k in ("sample_random", "sample_n", "sample_repeat", "sample_overcap")]
        self.cap = int(mix["cap"]) if "cap" in mix else None
        B = self.B
        self.kinds = [[np.flatnonzero(m[b * B : (b + 1) * B]) for b in range(P)] for m in (has_n, in_repeat)]

    def __call__(self, client: int, k: int, b: int, counts) -> np.ndarray:
        rng = np.random.default_rng(data.seed_words(self.seed, 0xC11E) + [client, k])
        n_random, n_n, n_rep, n_over = self.sizes
        picks = [rng.choice(self.B, size=min(self.B, n_random), replace=False)]
        for idx, size in ((self.kinds[0][b], n_n), (self.kinds[1][b], n_rep)):
            picks.append(rng.choice(idx, size=min(idx.shape[0], size), replace=False))
        if n_over and self.cap is not None:
            over = np.flatnonzero(np.asarray(counts)[: self.B] > self.cap)
            picks.append(rng.choice(over, size=min(over.shape[0], n_over), replace=False))
        return np.unique(np.concatenate(picks)).astype(np.int64)


class Client:
    """One closed-loop client: in each pass it hands the engine its next pool
    batch as soon as the stream takes one, and records each batch's hand-off
    and return times, its reads and the sampled lanes' answers."""

    def __init__(self, cid, engine, pool, order, mix, sampler, stream):
        self.cid, self.engine, self.pool, self.order, self.mix = cid, engine, pool, order, mix
        self.sampler, self.stream = sampler, stream
        self.cursor = 0  # the next place in ``order``
        self.returned = 0  # batches got back in this run (the sampler's k)
        self.done: list = []  # (batch id, handed, returned, reads)
        self.failed: list = []  # (batch id, reads)
        self.answers: list = []  # (batch id, sampled answers)
        self.counts: list = []  # (batch id, counts) while ``keep_counts``
        self.keep_counts = False
        self.error = None

    def serve(self, go: threading.Event, end: float, limit: int | None, stop: threading.Event) -> None:
        """One pass, on this client's stream, once ``go`` is set: until
        ``end`` (perf_counter seconds), ``limit`` batches or ``stop``; the
        batches in flight are then waited for.  A batch that raises counts
        its reads in ``failed``, and the pass goes on."""
        import torch

        try:
            with torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext():
                go.wait()
                base = len(self.done) + len(self.failed)
                while time.perf_counter() < end and not stop.is_set():
                    served = len(self.done) + len(self.failed) - base
                    if limit is not None and served >= limit:
                        return
                    handed: deque = deque()
                    left = None if limit is None else limit - served
                    try:
                        if self.mix["entry"] == "count_locate":
                            self._locate(end, left, handed, stop)
                        else:
                            self._count(end, left, handed, stop)
                        return
                    except Exception as e:
                        log(f"client batch failed: {type(e).__name__}: {e}")
                        while handed:
                            b, _ = handed.popleft()
                            self.failed.append((b, self.pool[b][2]))
        except BaseException as e:  # re-raised by run_pass
            self.error = e

    def _next(self, end: float, limit: int | None, handed: deque, stop: threading.Event):
        n = 0
        while time.perf_counter() < end and (limit is None or n < limit) and not stop.is_set():
            b = self.order[self.cursor % len(self.order)]
            self.cursor += 1
            n += 1
            handed.append((b, time.perf_counter()))
            yield self.pool[b]

    def _finish(self, handed: deque, result) -> None:
        b, t_hand = handed.popleft()
        now = time.perf_counter()
        self.done.append((b, t_hand, now, self.pool[b][2]))
        counts = result[0] if isinstance(result, tuple) else result
        lanes = self.sampler(self.cid, self.returned, b, counts)
        self.returned += 1
        self.answers.append((b, sample_answers(result, lanes)))
        if self.keep_counts:
            self.counts.append((b, np.asarray(counts)))

    def _locate(self, end, limit, handed, stop) -> None:
        cap, depth = int(self.mix["cap"]), int(self.mix["depth"])
        for result in self.engine.count_locate_stream(self._next(end, limit, handed, stop), cap=cap, depth=depth):
            self._finish(handed, result)

    def _count(self, end, limit, handed, stop) -> None:
        import torch

        inflight: deque = deque()
        for wire, qlens, n in self._next(end, limit, handed, stop):
            counts = self.engine.count_batch_dispatch((wire, qlens))
            if counts.device.type == "cuda":
                host = torch.empty(counts.shape, dtype=counts.dtype, pin_memory=True)
                host.copy_(counts, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host, event = counts, None
            inflight.append((host, event, n))
            if len(inflight) >= int(self.mix["depth"]):
                self._land(handed, *inflight.popleft())
        while inflight:
            self._land(handed, *inflight.popleft())

    def _land(self, handed, host, event, n) -> None:
        if event is not None:
            event.synchronize()
        self._finish(handed, host.numpy()[:n])


def run_pass(clients, end: float, limit: int | None = None, monitor=None) -> float:
    """Run one pass of every client in a thread of its own, all released at
    one instant; returns the release time (perf_counter seconds).
    ``monitor(threads, stop)``, if given, runs in this thread meanwhile and
    may end the pass by setting ``stop``."""
    go, stop = threading.Event(), threading.Event()
    threads = [threading.Thread(target=c.serve, args=(go, end, limit, stop), daemon=True) for c in clients]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    go.set()
    try:
        if monitor is not None:
            monitor(threads, stop)
    finally:
        if monitor is not None:
            stop.set()
        for t in threads:
            t.join()
    for c in clients:
        if c.error is not None:
            raise c.error
    return t0


# -- one run ---------------------------------------------------------------------


def hits_shares(counts: list[np.ndarray], cap: int) -> dict:
    """Share (%) of reads with 0, 1, 2..cap and more than cap hits, and the
    mean hits per read."""
    c = np.concatenate(counts).astype(np.int64)
    n = max(c.shape[0], 1)
    out = {"0": (c == 0).sum(), "1": (c == 1).sum()}
    if cap >= 2:
        out[f"2-{cap}"] = ((c >= 2) & (c <= cap)).sum()
    out[f">{cap}"] = (c > cap).sum()
    return {**{k: 100.0 * float(v) / n for k, v in out.items()}, "mean": float(c.mean()) if c.size else 0.0}


def encode_pool(engine, reads: np.ndarray, B: int, P: int) -> list:
    """The pool's wire batches ``(wire, qlens, n)``, encoded by the program's
    ``encode_queries`` from bytes, a few batches at once."""

    def one(b):
        return (*engine.encode_queries([r.tobytes() for r in reads[b * B : (b + 1) * B]]), B)

    with ThreadPoolExecutor(min(P, 4)) as ex:
        return list(ex.map(one, range(P)))


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool, device: str, t_start: float,
             controls: bool = False) -> dict:
    """One run of one cell; returns the result line's fields with ``checks``
    last.  ``device`` "cuda" is the card; "cpu" serves through the kernels'
    plain versions (tests only: no device metric is read there).
    ``controls``: also put each control of ``check.CONTROLS`` in the
    program's place over the same returned lanes (``control.py`` only)."""
    import torch

    from awry_tpu_torch.io.artifact import load_artifact
    from awry_tpu_torch.ops import FmQueryEngine, kernels

    cs = load_cell(root, workload)
    mix = cs["mix"]
    on_card = device == "cuda"
    t0 = time.perf_counter()
    path, built = cached_index(cs)
    # A checkout's first run builds the index: that build is recorded
    # apart, so that ``setup_s`` is a restart's time in every run.
    build_s = time.perf_counter() - t0 if built.get("built_now") else 0.0
    log(f"index cache {os.path.basename(path)}: {json.dumps(built)}"
        + (f"; built in this run in {build_s:.3f} s, left out of setup_s" if build_s else ""))
    if on_card:
        kernels.build()
    setup = {}
    t0 = time.perf_counter()
    index = load_artifact(os.path.join(path, "index.npz"))
    setup["index_load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    engine = FmQueryEngine(index, device=dev)
    if on_card:
        torch.cuda.synchronize(dev)
    setup["index_ship_s"] = time.perf_counter() - t0
    del index

    # The pool of wire batches, the sampler, and each client's order.
    t0 = time.perf_counter()
    d = draw(cs, path, seed)
    B, P = int(mix["batch"]), int(mix["pool"])
    pool = encode_pool(engine, d["reads"], B, P)
    n_clients = max(1, min(int(mix["clients"]), (os.cpu_count() or 2) - 1))
    streams = [torch.cuda.Stream(dev) if on_card else None for _ in range(n_clients)]
    rng = np.random.default_rng(data.seed_words(seed, 0x0D3D))
    cl = [Client(i, engine, pool, rng.permutation(P).tolist(), mix, d["sampler"], s) for i, s in enumerate(streams)]
    setup["pool_s"] = time.perf_counter() - t0

    # Warm-up: every client at once serves its first ``warmup_batches``, so
    # that the shapes, the allocations and pinned buffers of the pool are
    # made before the window (a pass of the whole pool would cost set-up
    # many times over).
    t0 = time.perf_counter()
    for c in cl:
        c.keep_counts = True
    run_pass(cl, float("inf"), int(mix["warmup_batches"]))
    setup["warmup_s"] = time.perf_counter() - t0
    shares = hits_shares([x for _, x in cl[0].counts], int(mix.get("cap", 1)))
    for c in cl:
        c.done.clear(), c.answers.clear(), c.counts.clear(), c.failed.clear()
        c.keep_counts = False
    if on_card:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start - build_s
    log(f"set-up {setup_s:.3f} s ({json.dumps(setup)}); hits per read (%): {json.dumps(shares)}")

    # The measured window.
    for k in engine.stats:
        engine.stats[k] = 0
    launches0 = tracing.launch_counts(kernels)
    t_open = time.perf_counter()
    window_end = t_open + seconds
    run_pass(cl, window_end)
    if on_card:
        torch.cuda.synchronize(dev)
    launches = {k: v - launches0.get(k, 0) for k, v in tracing.launch_counts(kernels).items() if v - launches0.get(k, 0)}
    log(f"engine.stats {json.dumps(engine.stats)}")
    log(f"kernel launches in the window {json.dumps(launches)}")
    done = [x for c in cl for x in c.done]  # (batch id, handed, returned, reads)
    failed = sum(n for c in cl for _, n in c.failed)
    attempted = sum(x[3] for x in done) + failed
    in_window = sum(x[3] for x in done if x[2] <= window_end)
    lat_ms = np.asarray([1000.0 * (x[2] - x[1]) for x in done])
    e2e = {"reads_per_s": in_window / seconds,
           "batch_p95_ms": float(np.percentile(lat_ms, 95)) if lat_ms.size else None,
           "setup_s": setup_s}
    log(f"window: {len(done)} batches ({sum(x[2] <= window_end for x in done)} "
        f"returned inside), {n_clients} clients, median batch {float(np.median(lat_ms)) if lat_ms.size else 0:.3f} ms")
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    rec = {"setup": setup}
    if trace:
        rec.update(tracing.traced_slice(cs, engine, cl, kernels, on_card, lambda n: load_metric(root, n)))

    answers = [a for c in cl for a in c.answers]
    engine.release()
    del engine, cl, pool
    if on_card:
        torch.cuda.empty_cache()

    # The comparison with the reference, over every sampled answer the
    # window (and a traced run's slices) returned.
    t0 = time.perf_counter()
    text = np.load(os.path.join(path, "text.npy"))
    want = reference_answers(text, d, answers)
    locate = mix["entry"] == "count_locate"
    checks, compared = compare(answers, want, d["starts"], locate)
    checks["failed_reads"] = {"value": failed, "max": 0}
    checks["batches_returned"] = {"value": len(answers), "min": 1}
    correct = passes(checks)
    log(f"reference over {len(want)} sampled reads, {compared} lanes of {len(answers)} returned batches "
        f"compared: {time.perf_counter() - t0:.3f} s")
    control_checks = {}
    if controls:
        reads = {key: d["reads"][key[0] * B + key[1]] for key in want}
        for kind in CONTROLS:
            got = control_answers(kind, answers, want, reads, text, d["starts"], int(mix.get("cap", 1)), locate)
            control_checks[kind] = compare(got, want, d["starts"], locate)[0]

    if trace:
        metrics = {}
        for name in cs["per_layer"]:
            v = load_metric(root, name).read(rec)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": cs["units"][name]}
    else:
        metrics = {n: {"value": float(e2e[n]), "unit": cs["units"][n]} for n in cs["end_to_end"] if e2e.get(n) is not None}
    out = {"correct": correct, "attempted": int(attempted), "failed": int(failed), "metrics": metrics}
    out["device"] = {"platform": "gpu" if on_card else "cpu", "count": 1, "memory_peak_bytes": int(memory_peak)}
    if trace and on_card and "trace" in rec:
        out["device"].update(busy_s=rec["trace"]["busy_s"], window_s=rec["trace"]["window_s"])
        # The device ops are the first slice's; the idle gaps the span
        # slice's, named by the host op or the innermost span across each.
        out["breakdown"] = {"device_ops": rec["trace"]["breakdown"]["device_ops"],
                            "idle_gaps": rec["span_slice"]["idle_gaps"]}
    out["clients"] = n_clients
    out["hits_per_read_pct"] = shares
    out["index_build_s"] = build_s
    if controls:
        out["controls"] = control_checks
    out["checks"] = checks
    return out


def passes(checks: dict) -> bool:
    """Every number compared within its limit."""
    return all(v["value"] >= v["min"] if "min" in v else v["value"] <= v["max"] for v in checks.values())


def draw(cs: dict, path: str, seed: int) -> dict:
    """The seed's pool of reads (``data.draw_pool``) and the ``Sampler`` of
    the lanes compared."""
    mix = cs["mix"]
    text = np.load(os.path.join(path, "text.npy"), mmap_mode="r")
    starts, lengths, copies = (np.load(os.path.join(path, f"{n}.npy")) for n in ("starts", "lengths", "copies"))
    reads, _, has_n, in_repeat = data.draw_pool(text, starts, lengths, copies, cs["config"], mix, seed)
    return {"reads": reads, "sampler": Sampler(mix, seed, has_n, in_repeat), "starts": starts,
            "batch": int(mix["batch"])}


def reference_answers(text: np.ndarray, d: dict, answers: list) -> dict:
    """The reference's sorted global positions of every (pool batch, lane)
    that some returned batch's sample holds."""
    picks = sorted({(b, int(lane)) for b, ans in answers for lane in ans[0].tolist()})
    B = d["batch"]
    return dict(zip(picks, find_all(text, [d["reads"][b * B + lane] for b, lane in picks])))
