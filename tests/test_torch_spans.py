"""The engine's spans and counters, and the benchmark's reading of them.

On the CPU with a tiny index (mark 1, k = 4, ~20k symbols, so that 30 bp
reads take the switch-step verify path): the ``awry.*`` spans of a
pipelined stream, nested as they run and numbered per batch; no
``RecordFunction`` at all with no profiler; ``engine.stats`` and the kernel
launch counters on hand-counted batches and under two client threads; and
``fmbench``'s summaries of made-up kineto events (``tracing.summarize``,
``spans.summarize_spans``) and its per-batch readers."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

import awry_tpu_torch as pt
from awry_tpu_torch.ops import FmQueryEngine, kernels
from awry_tpu_torch.utils.profiling import Counters, device_trace, span
from fmbench import spans, tracing

QLEN = 30
CAP = 2


@pytest.fixture(scope="module")
def text():
    """~20k random symbols holding a 40 bp unit 9 times and another 3 times
    (reads inside them hit 9 and 3 times, over the cap of 2)."""
    rng = np.random.default_rng(160)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)

    def rand(n):
        return bytes(rng.choice(acgt, size=n))

    unit9, unit3 = rand(40), rand(40)
    parts = []
    for i in range(12):
        parts.append(rand(1_600))
        parts.append(unit9 if i < 9 else unit3)
    return b"".join(parts), unit9, unit3


@pytest.fixture(scope="module")
def index(text):
    body = text[0]
    return pt.build_from_records([("chrA", body)], pt.FmBuildArgs(lookup_table_kmer_len=4, locate_mark_ratio=1))


def _reads(text, n, seed):
    """n reads of the text outside the repeats (one hit each), then one
    read inside each repeat unit (9 and 3 hits)."""
    body, unit9, unit3 = text
    rng = np.random.default_rng(seed)
    reads = []
    while len(reads) < n:
        s = int(rng.integers(0, len(body) - QLEN))
        r = body[s : s + QLEN]
        if body.count(r) == 1:
            reads.append(r)
    return reads + [unit9[5 : 5 + QLEN], unit3[2 : 2 + QLEN]]


def _spans_of(prof):
    """(name, start, end) of every ``awry.*`` host span the profiler holds."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CPU and e.name().startswith("awry."):
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _by_kind(prof):
    """The spans of ``_spans_of`` grouped by name without the ``#n``."""
    by = {}
    for name, s, t in _spans_of(prof):
        by.setdefault(name.split("#")[0], []).append((name, s, t))
    return by


def _inside(child, parents):
    return any(s <= child[1] and child[2] <= t for _, s, t in parents)


def test_stream_spans_nest_and_number_batches(text, index):
    """Two batches through the stream record dispatch#n and assemble#n with
    the same two n, each child inside its parent, and the re-dispatched
    lanes' serve and layout inside the verify finish; on a classic batch,
    the over-cap read's expansion inside its flat positions."""
    eng = FmQueryEngine(index, device="cpu")
    batches = [_reads(text, 40, 1), _reads(text, 40, 2)]
    want = [eng.count_locate_arrays(b, cap=CAP) for b in batches]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = list(eng.count_locate_stream(batches, cap=CAP, depth=2))
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)
    by = _by_kind(prof)
    ns = {kind: sorted(int(n.split("#")[1]) for n, _, _ in by[f"awry.{kind}"]) for kind in ("dispatch", "assemble")}
    assert len(ns["dispatch"]) == 2 and ns["dispatch"] == ns["assemble"]
    assert len(by["awry.encode"]) == 2
    parents = {
        "awry.upload": by["awry.dispatch"] + by["awry.redispatch"],
        "awry.launch": by["awry.dispatch"],
        "awry.verify_finish": by["awry.assemble"],
        "awry.redispatch": by["awry.verify_finish"],
        "awry.redis_layout": by["awry.verify_finish"],
        "awry.localize": by["awry.assemble"],
    }
    for child, outer in parents.items():
        assert by[child], child
        assert all(_inside(c, outer) for c in by[child]), child
    # Every upload but the re-dispatches' sits in a dispatch; the encode in none.
    assert sum(_inside(c, by["awry.dispatch"]) for c in by["awry.upload"]) == 2
    assert not any(_inside(c, by["awry.dispatch"]) for c in by["awry.encode"])
    # A verify batch lays its re-dispatched lanes' hits out once: no flat
    # positions, no over-cap expansion.
    assert "awry.flat_positions" not in by and "awry.overcap_expand" not in by

    classic = FmQueryEngine(index, device="cpu", use_verify=False)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = classic.count_locate_arrays(batches[0], cap=CAP)
    for x, y in zip(got, want[0]):
        np.testing.assert_array_equal(x, y)
    by = _by_kind(prof)
    parents = {
        "awry.flat_positions": by["awry.assemble"],
        "awry.overcap_expand": by["awry.flat_positions"],
        "awry.localize": by["awry.assemble"],
    }
    for child, outer in parents.items():
        assert by[child], child
        assert all(_inside(c, outer) for c in by[child]), child
    assert "awry.verify_finish" not in by and "awry.redis_layout" not in by


def test_spans_off_make_no_record_function(text, index, monkeypatch):
    """With no profiler running a batch opens no RecordFunction: the op that
    opens one raises here, and the answers are unchanged."""
    eng = FmQueryEngine(index, device="cpu")
    batch = _reads(text, 40, 3)
    want = eng.count_locate_arrays(batch, cap=CAP)

    def refuse(*args, **kw):
        raise AssertionError("a RecordFunction was opened with no profiler running")

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", refuse)
    with pytest.raises(AssertionError):
        with torch.profiler.record_function("probe"):
            pass
    assert span("awry.probe", 7) is span("awry.other")  # one shared no-op
    for x, y in zip(eng.count_locate_arrays(batch, cap=CAP), want):
        np.testing.assert_array_equal(x, y)


def test_counters_on_hand_counted_batches(text, index):
    """Classic path, cap 2: a crumb batch with reads of 9 and 3 hits lays
    out the 12 rows of its 2 queries over cap on the device (one read of
    the batch's flat positions, through _to_host, so nothing pageable); a
    nibble batch (an N) checks the live mask once per step after the first
    (its 30 bp pad to 32: 31 checks) and has nothing over cap."""
    eng = FmQueryEngine(index, device="cpu", use_verify=False)
    crumb = _reads(text, 20, 4)
    nibble = _reads(text, 20, 5)[:20] + [b"ACGTN" * 6]
    counts = [eng.count_locate_arrays(b, cap=CAP)[0] for b in (crumb, nibble)]
    assert counts[0][-2:].tolist() == [9, 3] and (counts[0][:-2] == 1).all()
    assert counts[1].max() == 1
    st = eng.stats
    assert st["batches"] == 2 and st["queries"] == len(crumb) + len(nibble)
    assert (st["overcap_queries"], st["overcap_rows"]) == (2, 12)
    assert st["laid_positions"] == 12 and st["pageable_d2h_bytes"] == 0
    # The CPU has no copy event: the crumb batch's one sync is its laid-out rows'.
    assert st["host_syncs"] == 1 + 31
    assert st["fast_path_batches"] == st["redis_lanes"] == 0


def test_counters_of_a_verify_batch(text, index):
    """Verify path: the 9-hit read is wider than a wide lane takes, so it is
    re-dispatched to a full-depth search (one read: its count), and its 9
    rows are walked and laid out at their final offsets on the device (one
    read: the batch's flat positions), through _to_host, so nothing is read
    from pageable memory."""
    eng = FmQueryEngine(index, device="cpu")
    batch = _reads(text, 40, 6)[:-1]
    counts = eng.count_locate_arrays(batch, cap=CAP)[0]
    assert counts[-1] == 9 and (counts[:-1] == 1).all()
    st = eng.stats
    assert (st["batches"], st["queries"], st["redis_lanes"]) == (1, len(batch), 1)
    assert (st["overcap_queries"], st["overcap_rows"]) == (1, 9)
    assert st["laid_positions"] == 9
    # The CPU has no copy event for the bundle: the syncs are the two reads.
    assert st["host_syncs"] == 1 + 1
    assert st["pageable_d2h_bytes"] == 0


def _in_threads(work, n: int) -> None:
    """Run ``work()`` in n threads at once, switching threads as often as
    the interpreter allows; every thread must end within two minutes."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)


def test_two_client_threads_add_up(text, index):
    """Two threads stream through one engine: every counter reads twice one
    thread's pass."""
    batches = [_reads(text, 24, 10 + i) for i in range(6)]
    one = FmQueryEngine(index, device="cpu")
    for _ in one.count_locate_stream(batches, cap=CAP):
        pass
    assert one.stats["batches"] == 6 and one.stats["queries"] == sum(len(b) for b in batches)
    eng = FmQueryEngine(index, device="cpu")
    served = []

    def client():
        served.append(len(list(eng.count_locate_stream(batches, cap=CAP))))

    _in_threads(client, 2)
    assert served == [6, 6]
    assert eng.stats == {k: 2 * v for k, v in one.stats.items()}


def test_counters_and_launches_add_up_under_threads():
    """More threads than cores add to one Counters and count launches on two
    wrappers at once: no update is lost."""
    n = (os.cpu_count() or 4) + 1
    c = Counters(("a", "b"))
    n0, r0 = kernels.marked_walk.launches, kernels.marked_walk_ranges.launches

    def work():
        for _ in range(5_000):
            c.add(a=1, b=2)
            kernels._count_launch(kernels.marked_walk, kernels.marked_walk_ranges)

    _in_threads(work, n)
    assert c == {"a": 5_000 * n, "b": 10_000 * n}
    assert kernels.marked_walk.launches - n0 == kernels.marked_walk_ranges.launches - r0 == 5_000 * n


def test_device_trace_records_client_threads(tmp_path, text, index):
    """device_trace records the spans of a thread it was not started in."""
    eng = FmQueryEngine(index, device="cpu")
    batch = _reads(text, 16, 20)
    go, done = threading.Event(), threading.Event()

    def client():
        go.wait()
        eng.count_locate_arrays(batch, cap=CAP)
        done.set()

    t = threading.Thread(target=client)
    t.start()
    with device_trace(str(tmp_path), device="cpu") as prof:
        go.set()
        assert done.wait(timeout=120)
    t.join(timeout=120)
    names = {n.split("#")[0] for n, _, _ in _spans_of(prof)}
    assert {"awry.dispatch", "awry.assemble", "awry.redis_layout"} <= names


# -- fmbench's reading, on made-up events ------------------------------------------------


class Event:
    def __init__(self, name, cuda, start, end, annotation=False, thread=1):
        self._n, self._c, self._s, self._e, self._a, self._t = name, cuda, start, end, annotation, thread

    def name(self):
        return self._n

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def is_user_annotation(self):
        return self._a

    def start_thread_id(self):
        return self._t


def _made_up():
    """Kernels [0, 100) and [500, 600) ns and a copy [900, 1000); an assemble
    span [100, 450) holding flat positions [200, 400) holding the over-cap
    expansion [250, 350); a dispatch span [460, 520) on another thread; a
    host op across [600, 900); each host span mirrored on the device as a
    gpu_user_annotation."""
    ev = [
        Event("void k(int)", True, 0, 100),
        Event("void k(int)", True, 500, 600),
        Event("Memcpy DtoH (Device -> Pageable)", True, 900, 1000),
        Event("awry.assemble#3", False, 100, 450, True),
        Event("awry.flat_positions", False, 200, 400, True),
        Event("awry.overcap_expand", False, 250, 350, True),
        Event("awry.dispatch#4", False, 460, 520, True, thread=2),
        Event("aten::copy_", False, 600, 900),
    ]
    mirrors = [Event(e.name(), True, e._s, e._e, True) for e in ev if e._a]
    return ev, mirrors


def test_summarize_leaves_span_annotations_out_of_busy():
    ev, mirrors = _made_up()
    plain = tracing.summarize(ev, batches=1, window_s=1e-6)
    with_mirrors = tracing.summarize(ev + mirrors, batches=1, window_s=1e-6)
    assert plain["busy_s"] == with_mirrors["busy_s"] == pytest.approx(300e-9)
    assert with_mirrors["kernels"] == plain["kernels"]
    assert with_mirrors["breakdown"] == plain["breakdown"]


def test_summarize_spans_names_gaps_and_self_time():
    ev, mirrors = _made_up()
    s = spans.summarize_spans(ev + mirrors)
    table = s["spans"]
    assert set(table) == {"awry.assemble", "awry.flat_positions", "awry.overcap_expand", "awry.dispatch"}
    assert table["awry.assemble"]["count"] == 1
    assert table["awry.assemble"]["total_s"] == pytest.approx(350e-9)
    assert table["awry.assemble"]["self_s"] == pytest.approx(150e-9)
    assert table["awry.flat_positions"]["self_s"] == pytest.approx(100e-9)
    assert table["awry.overcap_expand"]["self_s"] == pytest.approx(100e-9)
    assert table["awry.dispatch"]["self_s"] == pytest.approx(60e-9)
    # Idle: [100, 500) and [600, 900); spans cover [100, 450) and [460, 520).
    assert s["idle_outside_spans_s"] == pytest.approx((10 + 300) * 1e-9)
    # Longest first: [100, 500) named by the innermost span at 300, [600, 900) by its host op.
    assert s["idle_gaps"] == [["awry.overcap_expand", pytest.approx(400e-9)], ["aten::copy_", pytest.approx(300e-9)]]
    bare = spans.summarize_spans([e for e in ev if not e._a])
    assert bare["spans"] == {} and bare["idle_gaps"][0][0] == spans.UNCOVERED


RECORD = {"trace": {
    "window_s": 4.0, "busy_s": 0.5, "idle_outside_spans_s": 0.35,
    "spans": {"awry.assemble": {"count": 8, "total_s": 3.2, "self_s": 0.4},
              "awry.d2h_wait": {"count": 8, "total_s": 0.08, "self_s": 0.08},
              "awry.overcap_expand": {"count": 8, "total_s": 1.6, "self_s": 1.6},
              "awry.dispatch": {"count": 10, "total_s": 0.25, "self_s": 0.01}},
    "stats": {"batches": 4, "overcap_rows": 31_000_000, "pageable_d2h_bytes": 260_000_000, "host_syncs": 22},
}}
WANT = {"assemble_ms_per_batch": 390.0, "overcap_expand_ms_per_batch": 200.0, "dispatch_ms_per_batch": 25.0,
        "d2h_wait_ms_per_batch": 10.0, "idle_outside_spans_share": 10.0, "overcap_rows_per_batch": 7_750_000.0,
        "pageable_d2h_mb_per_batch": 65.0, "host_syncs_per_batch": 5.5}


@pytest.mark.parametrize("name", sorted(WANT))
def test_per_batch_readers(name):
    read = spans.READERS[name]
    assert read(RECORD) == pytest.approx(WANT[name])
    assert read({}) is None and read({"trace": {"busy_s": 0.5, "window_s": 4.0}}) is None
    assert read({"trace": {"spans": {}, "stats": {}}}) is None
