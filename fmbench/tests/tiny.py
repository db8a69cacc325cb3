"""A tiny copy of the benchmark's layout for CPU tests: the real metric
readers, the real traffic mixes and configurations cut to toy sizes."""

from __future__ import annotations

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

SIZES = {"symbols": 200_000, "kmer_len": 8, "n_run": 500}
MIX = {"batch": 256, "pool": 2, "clients": 2, "trace_batches": 2, "warmup_batches": 1, "sample_random": 24}
# The configuration and mixes kept for later cells (PERF.md §7) have no cell
# of BENCHMARK.json; the tests give them one, so that the harness's count
# entry, its classic path over many records and its repeat-read path stay held.
EXTRA_CONFIGS = [{"name": "grch38_1G_k13_m4", "source": "GRCh38-shaped", "file": "fmbench/configs/grch38_1G_k13_m4.json",
                  "reduced": ["symbols"], "why": "24 records, mark 4"}]
EXTRA = [{"name": "grch38.reads100", "config": "grch38_1G_k13_m4", "traffic": "reads100", "chips": 1,
          "why": "classic path"},
         {"name": "grch38.screen100", "config": "grch38_1G_k13_m4", "traffic": "screen100", "chips": 1,
          "why": "count only"},
         {"name": "chr1.multihit30", "config": "chr1_250M_k13_m1", "traffic": "multihit30", "chips": 1,
          "why": "repeat reads"}]


def make_root(tmp: str) -> str:
    """A root holding BENCHMARK.json and fmbench/{configs,traffic,metrics}
    whose cells are the real ones at toy sizes; returns its path."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] += [c for c in EXTRA_CONFIGS if c["name"] not in {x["name"] for x in bench["configs"]}]
    bench["workloads"] += [w for w in EXTRA if w["name"] not in {x["name"] for x in bench["workloads"]}]
    for sub in ("configs", "traffic"):
        os.makedirs(os.path.join(tmp, "fmbench", sub), exist_ok=True)
    shutil.copytree(os.path.join(BENCH, "metrics"), os.path.join(tmp, "fmbench", "metrics"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for c in bench["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        cfg.update({k: v for k, v in SIZES.items() if k != "n_run" or "n_run" in cfg})
        if "record_lengths" in cfg:
            cfg["record_lengths"] = cfg["record_lengths"][:4]
        with open(os.path.join(tmp, c["file"]), "w") as f:
            json.dump(cfg, f)
    for w in bench["workloads"]:
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
            mix = json.load(f)
        mix.update(MIX)
        if mix.get("n_read_share"):
            mix["n_read_share"] = 0.05
        with open(os.path.join(tmp, "fmbench", "traffic", w["traffic"] + ".json"), "w") as f:
            json.dump(mix, f)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp
