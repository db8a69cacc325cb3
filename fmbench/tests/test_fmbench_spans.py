"""The traced run's span slice and recording-pass counters, on the CPU at toy
sizes: the clients' spans recorded, the counters kept over the pool, the
per-layer metrics that read them, and the first slice's record as it was."""

import time

import pytest

from awry_tpu_torch.ops import FmQueryEngine
from fmbench import harness, spans, tracing
from fmbench.tests.tiny import MIX, make_root

SPAN_METRICS = ["dispatch_ms_per_batch", "assemble_ms_per_batch", "localize_ms_per_batch",
                "redis_serve_ms_per_batch", "d2h_wait_ms_per_batch", "idle_outside_spans_share"]
COUNTER_METRICS = ["host_syncs_per_batch", "laid_positions_per_batch"]
FIRST_SLICE_KEYS = {"kernels", "batches", "busy_s", "window_s", "summed_s", "device_kinds", "breakdown"}
SEED = 2**33 + 19


def _traced_run(root):
    """One traced run of chr1.reads30 with spies: the record traced_slice
    returns, the awry.* spans' thread ids of each summarized slice, and the
    blocking reads of the card (``_read_back``) made in each pass."""
    seen = {"record": {}, "span_threads": [], "reads": []}
    real_slice, real_summarize, real_pass = tracing.traced_slice, tracing.summarize, harness.run_pass
    real_read = FmQueryEngine._read_back

    def traced_slice(*args, **kw):
        out = real_slice(*args, **kw)
        seen["record"].update(out)
        return out

    def summarize(events, batches, window_s):
        seen["span_threads"].append({e.start_thread_id() for e in events
                                     if e.is_user_annotation() and e.name().startswith(spans.PREFIX)})
        return real_summarize(events, batches, window_s)

    def run_pass(clients, end, limit=None, monitor=None):
        seen["reads"].append(0)
        return real_pass(clients, end, limit, monitor)

    def read_back(self, tensor):
        seen["reads"][-1] += 1
        return real_read(self, tensor)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tracing, "traced_slice", traced_slice)
        mp.setattr(tracing, "summarize", summarize)
        mp.setattr(harness, "run_pass", run_pass)
        mp.setattr(FmQueryEngine, "_read_back", read_back)
        seen["out"] = harness.run_cell(root, "chr1.reads30", SEED, 0.5, True, "cpu", time.perf_counter())
    return seen


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("fmbench_spans_root")))


@pytest.fixture(scope="module")
def traced(root):
    return _traced_run(root)


def test_the_span_slice_records_the_clients_spans(traced):
    """The span slice holds the clients' dispatch, assemble and localize
    spans, from both client threads; the first slice, profiled from the
    monitor thread alone, holds none."""
    sl = traced["record"]["span_slice"]
    table = sl["spans"]
    assert {"awry.dispatch", "awry.assemble", "awry.localize"} <= set(table)
    assert all(table[n]["count"] >= 1 and table[n]["total_s"] > 0 for n in ("awry.dispatch", "awry.assemble"))
    assert sl["batches"] >= MIX["clients"] * MIX["trace_batches"]
    assert sl["window_s"] > 0 and sl["median_batch_ms"] > 0
    first, second = traced["span_threads"][:2]
    assert first == set()
    assert len(second) == MIX["clients"]


def test_the_recording_pass_keeps_the_counters(traced):
    st = traced["record"]["counters"]
    assert st["batches"] == MIX["pool"]
    assert st["queries"] == MIX["pool"] * MIX["batch"]
    assert st["laid_positions"] > 0


def test_every_new_metric_reads_a_number(traced):
    """Each of the eight reads a number, but the copy wait: the CPU makes no
    copy event, so no ``awry.d2h_wait`` opens and its metric is left out."""
    metrics = traced["out"]["metrics"]
    for name in SPAN_METRICS + COUNTER_METRICS:
        if name == "d2h_wait_ms_per_batch":
            assert "awry.d2h_wait" not in traced["record"]["span_slice"]["spans"]
            assert name not in metrics
            continue
        if name == "idle_outside_spans_share":
            # Two clients' spans may cover the whole slice on the CPU.
            assert 0.0 <= metrics[name]["value"] <= 100.0
            continue
        assert metrics[name]["value"] > 0, name
    assert traced["out"]["correct"]


def test_host_syncs_per_batch_is_the_reads_counted_by_hand(traced):
    """The recording pass is the run's last pass; on the CPU a crumb-wire
    verify batch's only blocking reads are ``_read_back``'s (the redis
    lanes' counts and their laid-out hits)."""
    reads = traced["reads"][-1]
    assert reads >= MIX["pool"]
    assert traced["out"]["metrics"]["host_syncs_per_batch"]["value"] == reads / MIX["pool"]


def test_the_first_slice_keeps_its_keys(traced):
    rec = traced["record"]
    assert set(rec["trace"]) == FIRST_SLICE_KEYS
    assert set(rec["trace"]["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(rec) == {"trace", "span_slice", "counters", "recorded"}


def test_counters_repeat_for_a_seed(root, traced):
    again = _traced_run(root)["record"]["counters"]
    assert again == traced["record"]["counters"]


SLICE = {"window_s": 2.0, "busy_s": 0.5, "batches": 4, "idle_outside_spans_s": 0.15,
         "spans": {"awry.assemble": {"count": 4, "total_s": 0.8, "self_s": 0.02},
                   "awry.localize": {"count": 4, "total_s": 0.16, "self_s": 0.16},
                   "awry.redispatch": {"count": 4, "total_s": 0.08, "self_s": 0.07},
                   "awry.redis_layout": {"count": 4, "total_s": 0.012, "self_s": 0.012}}}
COUNTERS = {"batches": 4, "host_syncs": 12, "laid_positions": 31_327_606}


@pytest.mark.parametrize("name, want", [
    ("localize_ms_per_batch", 40.0), ("redis_serve_ms_per_batch", 23.0), ("laid_positions_per_batch", 7_831_901.5),
    ("host_syncs_per_batch", 3.0), ("assemble_ms_per_batch", 200.0), ("idle_outside_spans_share", 10.0)])
def test_read_takes_the_span_slice_and_counters(name, want):
    assert spans.read(name, {"span_slice": SLICE, "counters": COUNTERS, "trace": {"batches": 1}}) == pytest.approx(want)
    assert spans.read(name, {}) is None
    assert spans.read(name, {"trace": {"spans": SLICE["spans"], "stats": COUNTERS}}) is None


def test_redis_serve_reads_either_part():
    only = {"span_slice": {"spans": {k: v for k, v in SLICE["spans"].items() if k != "awry.redis_layout"}}}
    assert spans.read("redis_serve_ms_per_batch", only) == pytest.approx(20.0)
    none = {"span_slice": {"spans": {"awry.assemble": SLICE["spans"]["awry.assemble"]}}}
    assert spans.read("redis_serve_ms_per_batch", none) is None

