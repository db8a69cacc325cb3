"""The port's serving slice as a whole: awry_tpu_torch's FmQueryEngine on the
CPU (every kernel through its plain version) against the JAX engine with
its sorted-sweep kernels (Pallas interpret mode), on one index and one
query stream.

The shape takes the branches the chr1-scale cell takes: mark ratio 1 (the
one-read SA walk), k = 6 on ~60k symbols so the switch step leaves four
post-seed rank steps, and crumb-wire batches of 4096 reads so the JAX
engine's anchored sweep kernels and seeded chain engage.  A repetitive fragment makes
wide lanes (step-s width 2..4, settled on the device) and re-dispatched
lanes (width > 4, over the locate cap)."""

import numpy as np
import pytest
import torch

import awry_tpu as jx
import awry_tpu.ops.sweep as jsweep
import awry_tpu_torch as pt
from awry_tpu.ops import FmQueryEngine as JaxEngine
from awry_tpu_torch.ops import FmQueryEngine

from .conftest import random_seq

K = 6
QLEN = 30
NQ = 4096  # crumb batch size: large batches keep the JAX sweep windows small


@pytest.fixture(scope="module")
def served():
    """(text, JAX index, port index): ~61k symbols in two records, with a
    unit repeated 3 times (wide lanes) and one repeated 9 times (redis
    lanes whose count exceeds the cap of 8)."""
    rng = np.random.default_rng(21)
    nuc = jx.Alphabet.NUCLEOTIDE
    unit3, unit12 = random_seq(nuc, rng, 90), random_seq(nuc, rng, 70)
    parts = []
    for i in range(15):
        parts.append(random_seq(nuc, rng, 3_100))
        parts.append(unit3 if i % 5 == 0 else unit12 if i < 12 else b"")
    body = b"".join(parts)
    records = [("chrA", body[:40_000]), ("chrB", body[40_000:])]
    args = dict(lookup_table_kmer_len=K, locate_mark_ratio=1)
    jidx = jx.build_from_records(records, jx.FmBuildArgs(**args))
    tidx = pt.build_from_records(records, pt.FmBuildArgs(**args))
    return body, jidx, tidx, unit3, unit12


def _batches(body, unit3, unit12):
    rng = np.random.default_rng(22)

    def draw(n, ln=QLEN):
        """n reads of length ln from the text, none across the record boundary."""
        starts = rng.integers(0, len(body) - ln, size=n)
        starts = np.where((starts < 40_000) & (starts + ln > 40_000), starts - ln, starts)
        return [body[s : s + ln] for s in starts]

    # Crumb wire: text reads plus reads inside the repeats.
    repeats = [unit3[i : i + QLEN] for i in range(0, 60, 5)]
    repeats += [unit12[i : i + QLEN] for i in range(0, 40, 4)]
    mixed = draw(NQ - len(repeats)) + repeats
    # Crumb wire, every read a single hit: the verify fast path.
    single = [q for q in draw(NQ + 200) if body.count(q) == 1]
    # Nibble wire on the verify path: N, a sentinel, short reads (<= the
    # switch step, with hits) and mixed lengths.
    odd = [b"AC$GT", b"NNNN", body[100:115] + b"N" + body[116:130], b"acgtn" * 6]
    odd += draw(12, 5) + draw(12, 17) + draw(36)
    # Nibble wire on the classic path: reads longer than the padded verify
    # window (512 symbols), an N and an empty query.
    long = draw(14, 600) + [body[:299] + b"N" + body[300:600], b""]
    return [mixed, single[:NQ], odd, long]


@pytest.fixture(scope="module")
def engines(served):
    """Both engines over the served index, the query batches, and the JAX
    engine's count_locate_stream output (computed once: the JAX engine
    compiles every program anew per instance)."""
    body, jidx, tidx, unit3, unit12 = served
    jeng = JaxEngine(jidx, use_sweep=True)
    assert jeng._verify_enabled and not jeng._verify_slots
    eng = FmQueryEngine(tidx, device="cpu")
    assert eng._verify_s == jeng._verify_s == 10  # four post-seed steps
    batches = _batches(body, unit3, unit12)
    before = dict(jsweep.TRACE_COUNTS)
    want = list(jeng.count_locate_stream(batches, cap=8))
    traced = {key: jsweep.TRACE_COUNTS[key] - before[key] for key in before}
    return jeng, eng, batches, want, traced


def test_stream_matches_jax_engine(engines):
    jeng, eng, batches, want, traced = engines
    for key in ("seeded_chain", "window_sweep_anchored"):
        assert traced[key] > 0, f"JAX engine never traced {key}"

    # One batch arrives pre-encoded, as a streaming server would send it.
    wire, qlens = eng.encode_queries(batches[1])
    assert wire.dtype == np.int8  # crumb wire
    for b in batches[2:]:
        assert eng.encode_queries(b)[0].dtype == np.uint8  # nibble wire
    stream = [batches[0], (wire, qlens, len(batches[1])), *batches[2:]]
    got = list(eng.count_locate_stream(stream, cap=8))

    assert len(got) == len(want) == 4
    for b, (g, w) in enumerate(zip(got, want)):
        for name, x, y in zip(("counts", "seq_idx", "local", "offsets"), g, w):
            np.testing.assert_array_equal(x, np.asarray(y), err_msg=f"batch {b} {name}")

    counts = got[0][0]
    assert (counts >= 1).all()
    assert set(counts[-22:-10].tolist()) == {3} and set(counts[-10:].tolist()) == {9}
    st = eng.stats
    assert st["batches"] == 3  # the 600-symbol batch takes the classic path
    assert st["fast_path_batches"] == 1
    assert st["wide_lanes"] > 0 and st["redis_lanes"] > 0 and st["multi_hit_queries"] > 0


def test_count_batch_matches_jax_engine(engines):
    jeng, eng, batches, _, _ = engines
    for batch in batches:
        np.testing.assert_array_equal(eng.count_batch(batch), jeng.count_batch(batch))


def test_hits_are_in_the_text(served):
    """Every reported (record, local) hit spells its query in its record,
    and the count equals a naive overlapping scan of the records."""
    body, _, tidx, unit3, unit12 = served
    eng = FmQueryEngine(tidx, device="cpu")
    records = [body[:40_000], body[40_000:]]
    # The last query spans the record boundary: no match.
    queries = [unit12[3:33], unit3[7:37], body[5_000:5_030], body[39_990:40_020]]
    counts, seq_idx, local, offsets = eng.count_locate_arrays(queries)
    for i, q in enumerate(queries):
        naive = sum(
            sum(1 for p in range(len(r) - len(q) + 1) if r.startswith(q, p)) for r in records
        )
        assert int(counts[i]) == naive == offsets[i + 1] - offsets[i]
        for s, p in zip(seq_idx[offsets[i] : offsets[i + 1]], local[offsets[i] : offsets[i + 1]]):
            assert records[s][p : p + len(q)] == q
    assert counts.tolist() == [9, 3, 1, 0]


def test_device_rules(monkeypatch):
    """The engine runs on the card unless told otherwise: without a CUDA
    device and without device= it raises.  The default build (mark ratio 4)
    serves on device="cpu" and equals the mark-1 build."""
    rng = np.random.default_rng(23)
    seq = random_seq(jx.Alphabet.NUCLEOTIDE, rng, 5_000)
    idx = pt.build_from_records([("x", seq)], pt.FmBuildArgs(lookup_table_kmer_len=4, locate_mark_ratio=1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FmQueryEngine(idx)
    mark1 = FmQueryEngine(idx, device="cpu")
    assert mark1.device.type == "cpu"
    default_mark = pt.build_from_records([("x", seq)], pt.FmBuildArgs(lookup_table_kmer_len=4))
    assert default_mark.resolved_mark_ratio == 4
    mark4 = FmQueryEngine(default_mark, device="cpu")
    assert mark4.device_index.mark_ratio == 4
    queries = [seq[s : s + 12] for s in rng.integers(0, 4_900, size=200)] + [b"ACGT", b"AC"]
    for x, y in zip(mark4.count_locate_arrays(queries), mark1.count_locate_arrays(queries)):
        np.testing.assert_array_equal(x, y)
