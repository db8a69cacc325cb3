"""The traced run's records: a profiled steady slice of every client at
once, a second slice that records every thread's spans, and a recording
pass over the pool for the roofline bounds and the engine's counters.

After the measured window every client starts a new closed-loop pass.
Once each has got ``depth`` batches back since the pass began, so that its
pipeline is full, ``torch.profiler`` (CPU and CUDA activity) starts; it
stops once each has got ``trace_batches`` more back, while all still serve.
The slice's batches are those the clients got back while it ran.  Only
summaries are kept: per kernel name its launches and seconds, the union of
the device's busy intervals, and the longest idle gaps with the host op
that ran across each.  Once each client has got ``depth`` more back, a
second profiler, made with ``profile_all_threads`` so that the clients'
threads and their ``awry.*`` spans are recorded, runs over another
``trace_batches`` batches of each, and the pass then ends: its record holds
that slice's own batches, seconds and busy seconds, and
``spans.summarize_spans`` of its events.  Then, with no profiler, one
client serves every pool batch once, with each roofline metric's wrapper of
``awry_tpu_torch.ops.kernels`` recording the bytes and operations its calls
must move (the metric module's ``KERNEL`` and ``bound``): the mean bound
of a call, against the mean traced time of a launch.  The recording pass
also keeps ``engine.stats``' change over it.
"""

from __future__ import annotations

import statistics
import time

import numpy as np

TOP = 10  # entries of each breakdown list


def launch_counts(kernels) -> dict:
    """The ``launches`` counter of every kernel wrapper of the program."""
    return {name: int(getattr(fn, "launches")) for name, fn in vars(kernels).items()
            if callable(fn) and hasattr(fn, "launches")}


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merged [start, end) rows of a set of intervals (sorted by start)."""
    if not intervals.shape[0]:
        return intervals
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.ones(iv.shape[0], dtype=bool)
    new[1:] = iv[1:, 0] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.concatenate([first[1:] - 1, [iv.shape[0] - 1]])
    return np.stack([iv[first, 0], reach[last]], axis=1)


def summarize(events, batches: int, window_s: float) -> dict:
    """Summaries of the profiled slice's kineto events: kernels by name,
    busy seconds (the union of device kernel, copy and memset intervals),
    summed device seconds, and the breakdown lists."""
    import torch

    device, host, kinds = [], [], set()
    for e in events:
        if getattr(e, "is_user_annotation", lambda: False)():
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            name = e.name()
            copy = name.startswith(("Memcpy", "Memset"))
            kinds.add(name.split(" ")[0] if copy else "kernel")
            device.append((name, not copy, e.start_ns(), e.start_ns() + e.duration_ns()))
        else:
            host.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    kernels: dict = {}
    by_op: dict = {}
    for name, is_kernel, s, t in device:
        if is_kernel:
            n, sec = kernels.get(name, (0, 0.0))
            kernels[name] = (n + 1, sec + (t - s) / 1e9)
        short = name.replace("(anonymous namespace)", "{anon}").split("(")[0]
        by_op[short] = by_op.get(short, 0.0) + (t - s) / 1e9
    iv = _union(np.asarray([(s, t) for _, _, s, t in device], dtype=np.int64).reshape(-1, 2))
    busy_s = float((iv[:, 1] - iv[:, 0]).sum()) / 1e9 if iv.shape[0] else 0.0
    gaps = []
    if iv.shape[0] > 1:
        g0, g1 = iv[:-1, 1], iv[1:, 0]
        order = np.argsort(g0 - g1)[:TOP]  # longest first
        hs = np.asarray([h[1] for h in host], dtype=np.int64)
        he = np.asarray([h[2] for h in host], dtype=np.int64)
        for i in order.tolist():
            mid = (int(g0[i]) + int(g1[i])) // 2
            cover = np.flatnonzero((hs <= mid) & (he >= mid)) if hs.size else np.zeros(0, np.int64)
            label = host[int(cover[np.argmin(he[cover] - hs[cover])])][0] if cover.size else "host outside torch (Python or NumPy)"
            gaps.append([label, (int(g1[i]) - int(g0[i])) / 1e9])
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    return {"kernels": kernels, "batches": batches, "busy_s": busy_s, "window_s": window_s,
            "summed_s": float(sum(by_op.values())), "device_kinds": sorted(kinds),
            "breakdown": {"device_ops": [[k, v] for k, v in top], "idle_gaps": gaps}}


def _wait(threads, test) -> bool:
    """Poll until ``test()`` holds (True) or a client thread has ended (False)."""
    while not test():
        if not all(t.is_alive() for t in threads):
            return False
        time.sleep(0.001)
    return True


def traced_slice(cs: dict, engine, clients, kernels, on_card: bool, load_metric) -> dict:
    """``{"trace": summaries, "span_slice": the span slice's record,
    "counters": engine.stats' change over the recording pass, "recorded":
    {metric: {bytes, ops, calls}}}`` of the two profiled steady slices and
    the recording pass (see the module doc)."""
    import torch

    from . import spans
    from .harness import log, run_pass

    mix = cs["mix"]
    k, depth = int(mix["trace_batches"]), int(mix.get("depth", 2))
    out: dict = {}
    # On the CPU (tests) the same slices run with host activity alone, and
    # no device number comes of them.
    acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if on_card else [])
    prof = torch.profiler.profile(activities=acts)
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    span_prof = torch.profiler.profile(activities=acts, experimental_config=every_thread)
    first: dict = {}
    second: dict = {}

    def profiled(threads, p, mark: dict) -> None:
        """``p`` on from when every client has ``depth`` more batches back
        until each has ``k`` more; ``mark`` gets the times, the clients'
        returned counts and whether the slice was full."""
        r0 = [c.returned for c in clients]
        if not _wait(threads, lambda: all(c.returned - r >= depth for c, r in zip(clients, r0))):
            return
        p.start()
        mark["t0"], mark["r0"] = time.perf_counter(), [c.returned for c in clients]
        full = _wait(threads, lambda: all(c.returned - r >= k for c, r in zip(clients, mark["r0"])))
        mark["t1"], mark["r1"] = time.perf_counter(), [c.returned for c in clients]
        p.stop()
        mark["full"] = full

    def monitor(threads, stop):
        profiled(threads, prof, first)
        if first.get("full"):
            profiled(threads, span_prof, second)

    run_pass(clients, float("inf"), None, monitor)
    if not first.get("full"):
        raise RuntimeError("a client ended before the traced slice was full")
    batches = sum(b - a for a, b in zip(first["r0"], first["r1"]))
    window_s = first["t1"] - first["t0"]
    out["trace"] = summarize(prof.profiler.kineto_results.events(), batches, window_s)
    log(f"traced slice: {batches} batches of {len(clients)} clients ({k}+ each, pipelines full) in "
        f"{window_s:.3f} s, busy {out['trace']['busy_s']:.4f} s, device event kinds {out['trace']['device_kinds']}")
    for i, (name, (n, sec)) in enumerate(sorted(out["trace"]["kernels"].items(), key=lambda kv: -kv[1][1])):
        if i < 25 or "walk" in name:
            log(f"  kernel {n:6d} x {sec:.6f} s  {name[:200]}")

    # The span slice: its own batches, seconds and busy seconds, the spans'
    # table, the idle time no span covers and the idle gaps named.
    if not second.get("full"):
        raise RuntimeError("a client ended before the span slice was full")
    events = span_prof.profiler.kineto_results.events()
    batches = sum(b - a for a, b in zip(second["r0"], second["r1"]))
    window_s = second["t1"] - second["t0"]
    times = [1000.0 * (ret - hand) for c in clients for _, hand, ret, _ in c.done if second["t0"] <= ret <= second["t1"]]
    sl = {"batches": batches, "window_s": window_s, "busy_s": summarize(events, batches, window_s)["busy_s"],
          "median_batch_ms": statistics.median(times) if times else None, **spans.summarize_spans(events)}
    del events
    out["span_slice"] = sl
    log(f"span slice: {batches} batches in {window_s:.3f} s, busy {sl['busy_s']:.4f} s, median batch "
        f"{sl['median_batch_ms']} ms, device idle with no span open {sl['idle_outside_spans_s']:.4f} s")
    for name, r in sorted(sl["spans"].items(), key=lambda kv: -kv[1]["total_s"]):
        log(f"  span {name:22s} {r['count']:5d} x  total {r['total_s']:.6f} s  self {r['self_s']:.6f} s")
    for label, sec in sl["idle_gaps"]:
        log(f"  idle gap {sec:.6f} s  {label}")

    # The recording pass: every pool batch once, one client, with the
    # roofline metrics' wrappers in place and engine.stats' change kept.
    wanted: dict = {}
    for name in cs["per_layer"]:
        mod = load_metric(name)
        if hasattr(mod, "KERNEL"):
            wanted.setdefault(mod.KERNEL, []).append((name, mod.bound))
    totals = {name: {"bytes": 0.0, "ops": 0.0, "calls": 0} for entries in wanted.values() for name, _ in entries}
    real = {kname: getattr(kernels, kname) for kname in wanted}

    def recorder(kname):
        fn = real[kname]

        def rec(*args, **kw):
            for name, bound in wanted[kname]:
                nbytes, ops = bound(*args, **kw)
                t = totals[name]
                t["bytes"] += nbytes
                t["ops"] += ops
                t["calls"] += 1
            return fn(*args, **kw)

        rec.launches = 0  # a wrapper counts its launches on the name its module binds
        return rec

    for kname in wanted:
        setattr(kernels, kname, recorder(kname))
    before = dict(engine.stats)
    try:
        run_pass(clients[:1], float("inf"), len(clients[0].order))
    finally:
        for kname, fn in real.items():
            setattr(kernels, kname, fn)
    out["counters"] = {name: v - before[name] for name, v in engine.stats.items()}
    log(f"engine.stats over the recording pass {out['counters']}")
    if wanted:
        out["recorded"] = totals
        log(f"recorded bounds over the pool {totals}")
    return out
