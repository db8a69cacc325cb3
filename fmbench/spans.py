"""The program's spans in a profiled slice, and what is read from them and
from ``engine.stats``.

``FmQueryEngine`` marks the parts of serving with ``awry.*`` spans
(``torch.profiler.record_function`` user annotations, on the profiler's
clock; ``awry.dispatch#n`` and ``awry.assemble#n`` carry the batch's
number).  ``summarize_spans`` turns a slice's kineto events into: per span
name (the part before ``#``) its count, total and self seconds, a span's
self time being its length less what its children cover on its own thread;
the device-idle seconds of the slice during which no span was open on any
thread; and the slice's longest idle gaps, each named by the host op that
covers its midpoint, else by the innermost span open there, else as
``tracing.summarize`` names it.  The device intervals are
``tracing.summarize``'s: kernels, copies and memsets, never a span's
``gpu_user_annotation``.  ``READERS`` computes the per-batch figures from a
record that holds ``trace.spans``, ``trace.idle_outside_spans_s`` and
``trace.stats`` (the counters' change over a recording pass); each returns
None when its input is missing.  ``read`` gives a reader that record from a
traced run's: the span slice (``span_slice``) and the recording pass's
``counters``, both made by ``tracing.traced_slice``.

A profiler started in one thread records the host ops and spans of that
thread alone unless it is made with ``profile_all_threads``
(``torch._C._profiler._ExperimentalConfig``): the clients' threads must be
recorded for any span to show.
"""

from __future__ import annotations

import numpy as np

from .tracing import TOP, _union

PREFIX = "awry."
UNCOVERED = "host outside torch (Python or NumPy)"


def _is_annotation(e) -> bool:
    return getattr(e, "is_user_annotation", lambda: False)()


def _thread(e) -> int:
    return getattr(e, "start_thread_id", lambda: 0)()


def _covered_ns(a: np.ndarray, b: np.ndarray) -> int:
    """Length of the part of union ``a`` that union ``b`` covers (both
    sorted, disjoint [start, end) rows)."""
    i = j = covered = 0
    while i < a.shape[0] and j < b.shape[0]:
        lo, hi = max(a[i, 0], b[j, 0]), min(a[i, 1], b[j, 1])
        covered += max(0, int(hi) - int(lo))
        if a[i, 1] < b[j, 1]:
            i += 1
        else:
            j += 1
    return covered


def _self_ns(spans: list) -> list:
    """Self ns of each (name, thread, start, end) span: its length less its
    direct children's on its own thread."""
    out = [e - s for _, _, s, e in spans]
    by_thread: dict = {}
    for i, (_, tid, s, e) in enumerate(spans):
        by_thread.setdefault(tid, []).append((s, -e, i))
    for rows in by_thread.values():
        stack: list = []  # (end, index) of the open spans
        for s, neg_e, i in sorted(rows):
            while stack and stack[-1][0] <= s:
                stack.pop()
            if stack:
                out[stack[-1][1]] -= -neg_e - s
            stack.append((-neg_e, i))
    return out


def summarize_spans(events) -> dict:
    """``{"spans": {name: {count, total_s, self_s}}, "idle_outside_spans_s",
    "idle_gaps": [[label, seconds], ...]}`` of a slice's kineto events (see
    the module doc).  The slice runs from its first event's start to its last
    event's end."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host, spans, lo, hi = [], [], [], None, None
    for e in events:
        s, t = e.start_ns(), e.start_ns() + e.duration_ns()
        lo, hi = s if lo is None else min(lo, s), t if hi is None else max(hi, t)
        annotation = _is_annotation(e)
        if e.device_type() == cuda:
            if not annotation:
                device.append((s, t))
        elif annotation:
            if e.name().startswith(PREFIX):
                spans.append((e.name().split("#")[0], _thread(e), s, t))
        else:
            host.append((e.name(), s, t))
    table: dict = {}
    for (name, _, s, t), own in zip(spans, _self_ns(spans)):
        row = table.setdefault(name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        row["count"] += 1
        row["total_s"] += (t - s) / 1e9
        row["self_s"] += own / 1e9
    out = {"spans": table, "idle_outside_spans_s": 0.0, "idle_gaps": []}
    if lo is None:
        return out
    busy = _union(np.asarray(device, dtype=np.int64).reshape(-1, 2))
    edges = np.concatenate([[lo], busy.reshape(-1), [hi]]).reshape(-1, 2)  # idle = between busy intervals
    idle = edges[edges[:, 1] > edges[:, 0]]
    open_ = _union(np.asarray([(s, t) for _, _, s, t in spans], dtype=np.int64).reshape(-1, 2))
    idle_ns = int((idle[:, 1] - idle[:, 0]).sum())
    out["idle_outside_spans_s"] = (idle_ns - _covered_ns(idle, open_)) / 1e9
    if busy.shape[0] > 1:
        g0, g1 = busy[:-1, 1], busy[1:, 0]
        for i in np.argsort(g0 - g1)[:TOP].tolist():  # longest first
            mid = (int(g0[i]) + int(g1[i])) // 2
            label = _innermost(host, mid)
            if label is None:
                label = _innermost([(n, s, t) for n, _, s, t in spans], mid)
            out["idle_gaps"].append([label or UNCOVERED, (int(g1[i]) - int(g0[i])) / 1e9])
    return out


def _innermost(intervals: list, at: int) -> str | None:
    """Name of the shortest (name, start, end) interval that holds ``at``."""
    best = None
    for name, s, t in intervals:
        if s <= at <= t and (best is None or t - s < best[1]):
            best = (name, t - s)
    return None if best is None else best[0]


# -- per-batch figures ------------------------------------------------------------


def _span(rec: dict, name: str) -> dict | None:
    return (rec.get("trace") or {}).get("spans", {}).get(name)


def _per_assemble(rec: dict, total_s: float) -> float | None:
    a = _span(rec, "awry.assemble")
    if not a or not a["count"]:
        return None
    return 1000.0 * total_s / a["count"]


def assemble_ms_per_batch(rec: dict) -> float | None:
    """``awry.assemble`` less its ``awry.d2h_wait``, ms per assemble span."""
    a = _span(rec, "awry.assemble")
    wait = _span(rec, "awry.d2h_wait")
    if not a:
        return None
    return _per_assemble(rec, a["total_s"] - (wait["total_s"] if wait else 0.0))


def _totals_per_assemble(rec: dict, *names: str) -> float | None:
    """The named spans' summed seconds over the assemble spans, in ms; None
    when none of them was opened."""
    parts = [x for x in (_span(rec, name) for name in names) if x]
    return None if not parts else _per_assemble(rec, sum(x["total_s"] for x in parts))


def localize_ms_per_batch(rec: dict) -> float | None:
    """``awry.localize`` seconds over the assemble spans, in ms."""
    return _totals_per_assemble(rec, "awry.localize")


def redis_serve_ms_per_batch(rec: dict) -> float | None:
    """The re-dispatched lanes' serve, ``awry.redispatch`` and
    ``awry.redis_layout``, seconds over the assemble spans, in ms."""
    return _totals_per_assemble(rec, "awry.redispatch", "awry.redis_layout")


def overcap_expand_ms_per_batch(rec: dict) -> float | None:
    """``awry.overcap_expand`` seconds over the assemble spans, in ms."""
    return _totals_per_assemble(rec, "awry.overcap_expand")


def _mean_ms(rec: dict, name: str) -> float | None:
    x = _span(rec, name)
    return 1000.0 * x["total_s"] / x["count"] if x and x["count"] else None


def dispatch_ms_per_batch(rec: dict) -> float | None:
    """Mean ``awry.dispatch`` span, ms."""
    return _mean_ms(rec, "awry.dispatch")


def d2h_wait_ms_per_batch(rec: dict) -> float | None:
    """Mean ``awry.d2h_wait`` span, ms."""
    return _mean_ms(rec, "awry.d2h_wait")


def idle_outside_spans_share(rec: dict) -> float | None:
    """Share (%) of the slice's device-idle time with no span open."""
    t = rec.get("trace") or {}
    if "idle_outside_spans_s" not in t or "spans" not in t:
        return None
    idle = t.get("window_s", 0.0) - t.get("busy_s", 0.0)
    return 100.0 * t["idle_outside_spans_s"] / idle if idle > 0 else None


def _per_batch(rec: dict, counter: str, scale: float = 1.0) -> float | None:
    st = (rec.get("trace") or {}).get("stats")
    if not st or counter not in st or not st.get("batches"):
        return None
    return st[counter] / st["batches"] / scale


def overcap_rows_per_batch(rec: dict) -> float | None:
    return _per_batch(rec, "overcap_rows")


def pageable_d2h_mb_per_batch(rec: dict) -> float | None:
    return _per_batch(rec, "pageable_d2h_bytes", 1e6)


def host_syncs_per_batch(rec: dict) -> float | None:
    return _per_batch(rec, "host_syncs")


def laid_positions_per_batch(rec: dict) -> float | None:
    return _per_batch(rec, "laid_positions")


READERS = {f.__name__: f for f in (
    assemble_ms_per_batch, localize_ms_per_batch, redis_serve_ms_per_batch, overcap_expand_ms_per_batch,
    dispatch_ms_per_batch, d2h_wait_ms_per_batch, idle_outside_spans_share, overcap_rows_per_batch,
    pageable_d2h_mb_per_batch, host_syncs_per_batch, laid_positions_per_batch)}


def read(name: str, rec: dict) -> float | None:
    """``READERS[name]`` over a traced run's record (see the module doc)."""
    view = dict(rec.get("span_slice") or {})
    if rec.get("counters"):
        view["stats"] = rec["counters"]
    return READERS[name]({"trace": view})
