"""The engine's spans and counters on one benchmark cell, read as ``fmbench``
reads a traced slice.

    python3 scripts/engine_spans.py [--workload chr1.reads30] [--seed N] [--seconds 20]
                                    [--out FILE.json]

from the repository root, on a machine with a CUDA card (``--device cpu
--root DIR`` dry-runs it on the CPU over a benchmark layout at toy sizes,
such as ``fmbench/tests/tiny.py`` makes).  One process sets
the cell up as ``fmbench/harness.py`` does (the index from
``fmbench/.cache``, built there first if missing; the seed's pool, one
client per the mix, warm-up), then:

1. an untraced closed-loop window of ``--seconds``;
2. a profiled slice of the mix's ``trace_batches`` batches once the
   pipeline is full, recording every thread (``profile_all_threads``):
   ``fmbench.tracing.summarize`` and ``fmbench.spans.summarize_spans`` over
   the same events, and the batch times inside it against the window's;
3. the same slice profiled from the monitor thread alone, as
   ``fmbench.tracing.traced_slice`` profiles it;
4. ``engine.stats``' change over a recording pass (every pool batch once,
   one client, no profiler), twice;
5. the host cost of one span with a profiler running and without.

Prints a summary (the per-batch figures of ``fmbench.spans.READERS`` among
it) as its last line and writes the whole record to ``--out`` if given.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def profiler(all_threads: bool, on_card: bool):
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    if not all_threads:
        return profile(activities=acts)
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return profile(activities=acts, experimental_config=every_thread)


def profiled_slice(clients, k: int, depth: int, all_threads: bool, on_card: bool) -> dict:
    """The clients' closed loop with a profiler on from when each has
    ``depth`` batches back until each has ``k`` more (tracing.traced_slice's
    monitor); returns the summaries and the slice's batch times."""
    from fmbench import spans, tracing
    from fmbench.harness import run_pass

    prof = profiler(all_threads, on_card)
    mark: dict = {}

    def monitor(threads, stop):
        r0 = [c.returned for c in clients]
        if not tracing._wait(threads, lambda: all(c.returned - r >= depth for c, r in zip(clients, r0))):
            return
        prof.start()
        mark["t0"], mark["r0"] = time.perf_counter(), [c.returned for c in clients]
        mark["full"] = tracing._wait(threads, lambda: all(c.returned - r >= k for c, r in zip(clients, mark["r0"])))
        mark["t1"], mark["r1"] = time.perf_counter(), [c.returned for c in clients]
        prof.stop()

    run_pass(clients, float("inf"), None, monitor)
    if not mark.get("full"):
        raise RuntimeError("a client ended before the slice was full")
    batches = sum(b - a for a, b in zip(mark["r0"], mark["r1"]))
    events = prof.profiler.kineto_results.events()
    trace = tracing.summarize(events, batches, mark["t1"] - mark["t0"])
    trace.update(spans.summarize_spans(events))
    times = [1000.0 * (ret - hand) for c in clients for _, hand, ret, _ in c.done if mark["t0"] <= ret <= mark["t1"]]
    return {"trace": trace, "batch_ms": times}


def span_cost_us(n: int, running: bool, on_card: bool) -> float:
    """Host microseconds of one ``with span(name, i): pass``."""
    from awry_tpu_torch.utils.profiling import span

    def loop():
        t0 = time.perf_counter()
        for i in range(n):
            with span("awry.cost", i):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    if not running:
        return loop()
    with profiler(True, on_card):
        return loop()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="chr1.reads30")
    p.add_argument("--seed", type=int, default=2_600_000_016)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--out", help="write the whole record here as JSON")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--root", default=ROOT, help="the benchmark layout (BENCHMARK.json, fmbench/) to read the cell from")
    args = p.parse_args(argv)
    on_card = args.device == "cuda"

    import numpy as np
    import torch

    from awry_tpu_torch.io.artifact import load_artifact
    from awry_tpu_torch.ops import FmQueryEngine, kernels
    from fmbench import data, spans
    from fmbench.harness import Client, cached_index, draw, encode_pool, load_cell, log, run_pass

    if on_card and not torch.cuda.is_available():
        print("engine_spans: no CUDA device", file=sys.stderr)
        return 2
    out: dict = {"workload": args.workload, "seed": args.seed, "torch": torch.__version__,
                 "card": torch.cuda.get_device_name(0) if on_card else "cpu"}
    cs = load_cell(args.root, args.workload)
    mix = cs["mix"]
    path, _ = cached_index(cs)
    if on_card:
        kernels.build()
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    engine = FmQueryEngine(load_artifact(os.path.join(path, "index.npz")), device=dev)
    d = draw(cs, path, args.seed)
    B, P, depth = int(mix["batch"]), int(mix["pool"]), int(mix.get("depth", 2))
    pool = encode_pool(engine, d["reads"], B, P)
    rng = np.random.default_rng(data.seed_words(args.seed, 0x0D3D))
    n_clients = max(1, min(int(mix["clients"]), (os.cpu_count() or 2) - 1))
    cl = [Client(i, engine, pool, rng.permutation(P).tolist(), mix, d["sampler"],
                 torch.cuda.Stream(dev) if on_card else None) for i in range(n_clients)]
    run_pass(cl, float("inf"), int(mix["warmup_batches"]))

    # 1. The untraced window.
    for c in cl:
        c.done.clear()
    t0 = time.perf_counter()
    run_pass(cl, t0 + args.seconds)
    window = [1000.0 * (ret - hand) for c in cl for _, hand, ret, _ in c.done]
    out["window"] = {"batches": len(window), "median_batch_ms": statistics.median(window),
                     "reads_per_s": sum(x[3] for c in cl for x in c.done if x[2] <= t0 + args.seconds) / args.seconds}
    log(f"window: {json.dumps(out['window'])}")

    # 2-3. The profiled slices.
    k = int(mix["trace_batches"])
    for key, every in (("slice", True), ("slice_monitor_thread_only", False)):
        for c in cl:
            c.done.clear()
        s = profiled_slice(cl, k, depth, every, on_card)
        t = s["trace"]
        out[key] = {"batches": t["batches"], "window_s": t["window_s"], "busy_s": t["busy_s"],
                    "median_batch_ms": statistics.median(s["batch_ms"]) if s["batch_ms"] else None,
                    "kernels_per_batch": sum(n for n, _ in t["kernels"].values()) / max(t["batches"], 1),
                    "spans": t["spans"], "idle_outside_spans_s": t["idle_outside_spans_s"],
                    "idle_gaps_named": t["idle_gaps"], "idle_gaps_tracing": t["breakdown"]["idle_gaps"],
                    "device_ops": t["breakdown"]["device_ops"]}
        out[key]["spans_per_batch"] = sum(r["count"] for r in t["spans"].values()) / max(t["batches"], 1)
        log(f"{key}: {t['batches']} batches in {t['window_s']:.3f} s, busy {t['busy_s']:.4f} s")
        for name, r in sorted(t["spans"].items(), key=lambda kv: -kv[1]["total_s"]):
            log(f"  {name:22s} {r['count']:4d} x  total {r['total_s']:.4f} s  self {r['self_s']:.4f} s")
        for label, sec in t["idle_gaps"]:
            log(f"  idle gap {sec:.4f} s  {label}")
        if every:
            trace = t

    # 4. The counters over two recording passes.
    passes = []
    for _ in range(2):
        before = dict(engine.stats)
        run_pass(cl[:1], float("inf"), len(cl[0].order))
        passes.append({name: v - before[name] for name, v in engine.stats.items()})
    out["recording_passes"] = passes
    log(f"recording passes: {json.dumps(passes)}")
    rec = {"trace": {**trace, "stats": passes[0]}}
    out["per_batch"] = {name: read(rec) for name, read in spans.READERS.items()}
    log(f"per-batch figures: {json.dumps(out['per_batch'])}")

    # 5. The cost of a span.
    out["span_cost_us"] = {"profiler_off": span_cost_us(1_000_000, False, on_card),
                           "profiler_on": span_cost_us(20_000, True, on_card)}
    log(f"span cost: {json.dumps(out['span_cost_us'])}")
    engine.release()

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("card", "torch", "window", "per_batch", "span_cost_us")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
