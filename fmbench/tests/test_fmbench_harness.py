"""The harness on the CPU at toy sizes: cells found by name, the comparison
that decides ``correct`` and its faults, the refusals, and what it loads."""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from fmbench import harness
from fmbench.check import CONTROLS
from fmbench.tests.tiny import BENCH, REPO, make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("fmbench_root")))


def run(root, workload, trace=False, seconds=0.5):
    return harness.run_cell(root, workload, 2**32 + 17, seconds, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("workload", ["chr1.reads30", "grch38.reads100", "grch38.screen100", "chr1.multihit30"])
def test_every_cell_is_correct_on_the_cpu(root, workload):
    out = run(root, workload)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"reads_per_s", "batch_p95_ms", "setup_s"}
    assert list(out)[-1] == "checks"


def test_a_new_mix_and_metric_are_found_by_name(root, tmp_path):
    new = str(tmp_path / "r")
    shutil.copytree(root, new, ignore=shutil.ignore_patterns(".cache"))
    with open(os.path.join(new, "fmbench", "traffic", "reads30.json")) as f:
        mix = json.load(f)
    mix.update(read_len=24, substitution_rate=0.0)
    with open(os.path.join(new, "fmbench", "traffic", "toy24.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(new, "fmbench", "metrics", "toy_metric.py"), "w") as f:
        f.write("def read(rec):\n    return 42.0 if 'setup' in rec else None\n")
    with open(os.path.join(new, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "chr1.toy24", "config": "chr1_250M_k13_m1", "traffic": "toy24", "chips": 1,
                               "why": "toy"})
    bench["per_layer"].append({"name": "toy_metric", "unit": "n", "better": "higher", "source": "program_counter",
                               "layer": "toy", "moves": "reads_per_s", "workloads": ["chr1.toy24"]})
    # A new cell joins an existing metric by its name in the metric's list.
    next(m for m in bench["per_layer"] if m["name"] == "index_load_s")["workloads"].append("chr1.toy24")
    with open(os.path.join(new, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    out = run(new, "chr1.toy24", trace=True)
    assert out["correct"]
    assert out["metrics"]["toy_metric"] == {"value": 42.0, "unit": "n"}
    assert "index_load_s" in out["metrics"]
    assert "reads_per_s" not in out["metrics"]  # a traced line carries the per-layer metrics


def _patch_results(monkeypatch, alter):
    from awry_tpu_torch.ops import FmQueryEngine

    real_stream, real_count = FmQueryEngine.count_locate_stream, FmQueryEngine.count_batch_dispatch

    def stream(self, batches, **kw):
        for counts, seq_idx, local, offsets in real_stream(self, batches, **kw):
            yield alter(counts.copy(), seq_idx.copy(), local.copy(), offsets.copy())

    def count(self, encoded):
        c = real_count(self, encoded)
        return c.new_tensor(alter(c.numpy().copy(), None, None, None)[0])

    monkeypatch.setattr(FmQueryEngine, "count_locate_stream", stream)
    monkeypatch.setattr(FmQueryEngine, "count_batch_dispatch", count)


def _shifted(counts, seq_idx, local, offsets):
    """An answer altered where it is produced: every count and position off by one."""
    return counts + 1, seq_idx, None if local is None else local + 1, offsets


def _half(counts, seq_idx, local, offsets):
    """Half of the batch left out: the second half's lanes answer nothing."""
    n = counts.shape[0]
    counts[n // 2 :] = 0
    if offsets is None:
        return counts, None, None, None
    keep = int(offsets[n // 2])
    offsets = offsets.copy()
    offsets[n // 2 :] = keep
    return counts, seq_idx[:keep], local[:keep], offsets


@pytest.mark.parametrize("fault", [_shifted, _half], ids=["answer_altered", "half_left_out"])
@pytest.mark.parametrize("workload", ["chr1.reads30", "grch38.screen100"])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault, workload):
    _patch_results(monkeypatch, fault)
    out = run(root, workload)
    assert not out["correct"]
    assert out["checks"]["count_mismatches"]["value"] > 0


def test_the_controls_fail_the_comparison(root):
    out = harness.run_cell(root, "chr1.multihit30", 5, 0.5, False, "cpu", time.perf_counter(), controls=True)
    assert out["correct"], out["checks"]
    assert set(out["controls"]) == set(CONTROLS)
    for kind, checks in out["controls"].items():
        assert not harness.passes(checks), (kind, checks)
        assert checks["hit_set_mismatches"]["value"] > 0


def test_each_returned_batch_draws_its_own_lanes():
    mix = {"batch": 1000, "pool": 2, "cap": 2, "sample_random": 10, "sample_n": 3, "sample_repeat": 3,
           "sample_overcap": 4}
    has_n = np.zeros(2000, dtype=bool)
    has_n[[5, 17, 1500]] = True
    in_repeat = np.zeros(2000, dtype=bool)
    in_repeat[100:200] = True
    sampler = harness.Sampler(mix, 2**40 + 3, has_n, in_repeat)
    counts = np.ones(1000, dtype=np.uint64)
    counts[[7, 8, 900]] = 5
    a = sampler(0, 0, 0, counts)
    assert np.array_equal(a, sampler(0, 0, 0, counts))  # from (seed, client, k) alone
    assert not np.array_equal(a, sampler(0, 1, 0, counts))
    assert not np.array_equal(a, sampler(1, 0, 0, counts))
    got = set(a.tolist())
    assert {5, 17} <= got and {7, 8, 900} <= got  # every N read and over-cap lane there is
    assert len(got & set(range(100, 200))) >= 3
    assert 500 in sampler(0, 0, 1, counts).tolist()  # pool batch 1's N read


def test_a_first_runs_build_is_left_out_of_setup(root, monkeypatch):
    warm = run(root, "chr1.reads30")["metrics"]["setup_s"]["value"]
    real = harness.cached_index

    def building(cs):
        path, info = real(cs)
        time.sleep(3.0)
        return path, dict(info, built_now=True)

    monkeypatch.setattr(harness, "cached_index", building)
    out = run(root, "chr1.reads30")
    assert out["index_build_s"] >= 3.0
    assert out["metrics"]["setup_s"]["value"] < warm + 2.0


def test_no_card_no_result():
    r = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", "chr1.reads30", "--seed", "1",
                        "--seconds", "1"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "fmbench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    r = subprocess.run([sys.executable, "fmbench/run.py", "--workload", "chr1.reads30", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=120,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert r.returncode != 0 and r.stdout == ""


REHEARSAL = """
import sys, time, json
sys.path.insert(0, {repo!r})
from fmbench import harness
out = harness.run_cell({root!r}, "chr1.reads30", 3, 0.3, True, "cpu", time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_rehearsal_loads_no_jax(root):
    r = subprocess.run([sys.executable, "-c", REHEARSAL.format(repo=REPO, root=root)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    top = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert "awry_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "awry_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {REPO!r}); import fmbench.reference.exact_match, fmbench.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    top = set(eval(r.stdout))
    assert not top & {"awry_tpu_torch", "awry_tpu", "jax", "torch"}
