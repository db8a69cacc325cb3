"""The traced run's records: a profiled steady slice of every client at
once, and a recording pass over the pool for the roofline bounds.

After the measured window every client starts a new closed-loop pass.
Once each has got ``depth`` batches back since the pass began, so that its
pipeline is full, ``torch.profiler`` (CPU and CUDA activity) starts; it
stops once each has got ``trace_batches`` more back, while all still serve,
and the pass then ends.  The slice's batches are those the clients got back
while it ran.  Only summaries are kept: per kernel name its launches and
seconds, the union of the device's busy intervals, and the longest idle
gaps with the host op that ran across each.  Then, with no profiler, one
client serves every pool batch once with each roofline metric's wrapper of
``awry_tpu_torch.ops.kernels`` recording the bytes and operations its calls
must move (the metric module's ``KERNEL`` and ``bound``): the mean bound
of a call, against the mean traced time of a launch.
"""

from __future__ import annotations

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
    """``{"trace": summaries, "recorded": {metric: {bytes, ops, calls}}}``
    of one profiled steady slice and the recording pass (see the module
    doc)."""
    import torch

    from .harness import log, run_pass

    mix = cs["mix"]
    k, depth = int(mix["trace_batches"]), int(mix.get("depth", 2))
    out: dict = {}
    # On the CPU (tests) the same slice runs with host activity alone, and
    # no device number comes of it.
    acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if on_card else [])
    prof = torch.profiler.profile(activities=acts)
    span: dict = {}

    def monitor(threads, stop):
        r0 = [c.returned for c in clients]
        if not _wait(threads, lambda: all(c.returned - r >= depth for c, r in zip(clients, r0))):
            return
        prof.start()
        span["t0"], span["r0"] = time.perf_counter(), [c.returned for c in clients]
        full = _wait(threads, lambda: all(c.returned - r >= k for c, r in zip(clients, span["r0"])))
        span["t1"], span["r1"] = time.perf_counter(), [c.returned for c in clients]
        prof.stop()
        span["full"] = full

    run_pass(clients, float("inf"), None, monitor)
    if not span.get("full"):
        raise RuntimeError("a client ended before the traced slice was full")
    batches = sum(b - a for a, b in zip(span["r0"], span["r1"]))
    window_s = span["t1"] - span["t0"]
    out["trace"] = summarize(prof.profiler.kineto_results.events(), batches, window_s)
    log(f"traced slice: {batches} batches of {len(clients)} clients ({k}+ each, pipelines full) in "
        f"{window_s:.3f} s, busy {out['trace']['busy_s']:.4f} s, device event kinds {out['trace']['device_kinds']}")
    for i, (name, (n, sec)) in enumerate(sorted(out["trace"]["kernels"].items(), key=lambda kv: -kv[1][1])):
        if i < 25 or "walk" in name:
            log(f"  kernel {n:6d} x {sec:.6f} s  {name[:200]}")

    # The recording pass: every pool batch once, one client.
    wanted: dict = {}
    for name in cs["per_layer"]:
        mod = load_metric(name)
        if hasattr(mod, "KERNEL"):
            wanted.setdefault(mod.KERNEL, []).append((name, mod.bound))
    if not wanted:
        return out
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
    try:
        run_pass(clients[:1], float("inf"), len(clients[0].order))
    finally:
        for kname, fn in real.items():
            setattr(kernels, kname, fn)
    out["recorded"] = totals
    log(f"recorded bounds over the pool {totals}")
    return out
