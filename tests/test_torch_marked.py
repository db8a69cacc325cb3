"""Locate at mark ratio > 1: the port's marked LF walk (the ``backstep``
kernel through its plain version on the CPU) against the JAX package's
walks, and the port's engine against the JAX engine with its sorted-sweep
kernels (Pallas interpret mode), on one index and one query stream.

The index has ~60k symbols in five records, each opening and closing with
an N run, joined by the N delimiter, so walks step over BWT N symbols; a
700-symbol unit copied 3 times makes wide lanes (step-s width 2..4) and a
650-symbol unit copied 12 times makes re-dispatched lanes whose count
exceeds the locate cap of 8 (the over-cap expansion).  k = 6 and mark
ratio 4 (the default build's) unless a test says otherwise.  Every
comparison is exact."""

import numpy as np
import pytest
import torch

import awry_tpu as jx
import awry_tpu.ops.engine as jengine
import awry_tpu.ops.sweep as jsweep
import awry_tpu.ops.verify as jverify
import awry_tpu_torch as pt
import awry_tpu_torch.ops.verify as tverify
from awry_tpu.ops import FmQueryEngine as JaxEngine
from awry_tpu.ops import to_device as jax_to_device
from awry_tpu.ops.locate import lf_walk as jax_lf_walk
from awry_tpu_torch.ops import FmQueryEngine, lf_walk, to_device

from .conftest import random_seq

K = 6
NRUN = 100  # N symbols opening and closing each record
QLEN = 100
NQ = 4096  # crumb batch size: large batches keep the JAX sweep windows small
UNIT3, UNIT12 = 700, 650
# Lanes of the crumb verify batch: text reads, then 64 reads of the 3x
# unit, 32 of the 12x unit and 20 reads right after leading N runs.
REDIS = slice(NQ - 52, NQ - 20)
# The JAX engine walks over-cap hits in fixed slabs of 8M rows; in Pallas
# interpret mode one such marked walk takes hours, so the tests shrink it.
SLAB = 4096


def _records(rng):
    """Five records of unequal length; the repeat copies sit between random
    pieces of the records' interiors, round-robin over the records."""
    nuc = jx.Alphabet.NUCLEOTIDE
    unit3, unit12 = random_seq(nuc, rng, UNIT3), random_seq(nuc, rng, UNIT12)
    units = [unit3] * 3 + [unit12] * 12
    order = rng.permutation(len(units))
    lengths = [14_000, 11_000, 9_000, 7_000, 5_000]
    records = []
    for r, length in enumerate(lengths):
        mine = [units[i] for i in order[r :: len(lengths)]]
        cut = length // (len(mine) + 1)
        pieces = [random_seq(nuc, rng, cut)]
        for u in mine:
            pieces += [u, random_seq(nuc, rng, cut)]
        records.append((f"chr{r + 1}", b"N" * NRUN + b"".join(pieces) + b"N" * NRUN))
    return records, unit3, unit12


def _build(records, mark_ratio):
    args = dict(lookup_table_kmer_len=K, locate_mark_ratio=mark_ratio)
    return (
        jx.build_from_records(records, jx.FmBuildArgs(**args)),
        pt.build_from_records(records, pt.FmBuildArgs(**args)),
    )


@pytest.fixture(scope="module")
def served():
    records, unit3, unit12 = _records(np.random.default_rng(31))
    jidx, tidx = _build(records, 4)
    # The whole SA (mark ratio 1 stores it) for picking edge-case rows.
    sa = pt.build_from_records(records, pt.FmBuildArgs(lookup_table_kmer_len=K, locate_mark_ratio=1))
    sa = sa.text_sampled_sa.astype(np.int64)
    return records, unit3, unit12, jidx, tidx, sa


class _WalkCounter:
    """Counting stand-in for awry_tpu.ops.sweep.marked_walk_sweep (the JAX
    lf_walk imports it at call time, so the stand-in is what runs)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = jsweep.marked_walk_sweep

        def counting(index, rows):
            self.calls += 1
            return real(index, rows)

        monkeypatch.setattr(jsweep, "marked_walk_sweep", counting)


def _edge_rows(sa: np.ndarray, records, mark_ratio: int) -> np.ndarray:
    """Row 0, the last row, the first marked row (mark rank 0) and the rows
    whose walks end on it, rows of text positions below the mark ratio, and
    rows of the first positions after each N run (and of the runs' last N)."""
    n = sa.shape[0]
    inv = np.empty(n, dtype=np.int64)
    inv[sa] = np.arange(n)
    first_marked = int(np.flatnonzero(sa % mark_ratio == 0)[0])
    texts = [sa[first_marked] + j for j in range(mark_ratio)]
    texts += list(range(2 * mark_ratio))
    start = 0
    for _, seq in records:
        for p in (start + NRUN - 1, start + len(seq) - NRUN):  # last N of each run
            texts += [p + j for j in range(mark_ratio + 2)]
        start += len(seq) + 1
    texts = np.asarray([t for t in texts if t < n], dtype=np.int64)
    return np.concatenate([[0, n - 1, first_marked], inv[texts]])


@pytest.mark.parametrize("mark_ratio", [2, 4, 32])
def test_lf_walk_matches_jax_walks(served, mark_ratio, monkeypatch):
    """The port's walk equals marked_walk_sweep (sweep layout, interpret
    mode) and _marked_walk (plain gathers) on >= 4,000 rows."""
    import jax.numpy as jnp

    records, _, _, jidx4, tidx4, sa = served
    jidx, tidx = (jidx4, tidx4) if mark_ratio == 4 else _build(records, mark_ratio)
    assert tidx.text_sampled_sa.shape[0] == -(-tidx.bwt_len // mark_ratio)
    rng = np.random.default_rng(32 + mark_ratio)
    rows = np.concatenate([_edge_rows(sa, records, mark_ratio), rng.integers(0, tidx.bwt_len, size=4000)])

    got = lf_walk(to_device(tidx, "cpu"), torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got, sa[rows])  # the walk recovers each row's SA value

    counter = _WalkCounter(monkeypatch)
    jrows = jnp.asarray(rows, dtype=jnp.uint32)
    swept = np.asarray(jax_lf_walk(jax_to_device(jidx, build_sweep=True), jrows))
    assert counter.calls == 1, "the JAX walk did not take marked_walk_sweep"
    plain = np.asarray(jax_lf_walk(jax_to_device(jidx), jrows))
    assert counter.calls == 1
    np.testing.assert_array_equal(got, swept.astype(np.int64))
    np.testing.assert_array_equal(got, plain.astype(np.int64))


def _batches(records, unit3, unit12):
    rng = np.random.default_rng(33)
    seqs = [seq for _, seq in records]

    def draw(n, ln=QLEN):
        """n reads of length ln from the records' non-N interiors."""
        out = []
        for r in rng.integers(0, len(seqs), size=n):
            seq = seqs[r]
            s = rng.integers(NRUN, len(seq) - NRUN - ln)
            out.append(seq[s : s + ln])
        return out

    # Crumb wire, verify path: text reads, reads of the 3x unit (wide
    # lanes), of the 12x unit (redis lanes over the cap) and reads starting
    # 0-3 symbols after a leading N run (their walks cross N).
    wide = [unit3[i : i + QLEN] for i in range(0, 64 * 9, 9)]
    redis = [unit12[i : i + QLEN] for i in range(0, 32 * 17, 17)]
    after_n = [seq[NRUN + j : NRUN + j + QLEN] for seq in seqs for j in range(4)]
    mixed = draw(NQ - len(wide) - len(redis) - len(after_n)) + wide + redis + after_n
    # Nibble wire, verify path: reads reaching into N runs, a sentinel,
    # short reads and mixed lengths.
    into_n = [seq[NRUN - 5 : NRUN + 95] for seq in seqs]
    into_n += [seq[-NRUN - 60 : -NRUN + 40] for seq in seqs]
    odd = into_n + [b"AC$GT", b"NNNN", b"acgtn" * 6] + draw(12, 7) + draw(12, 30) + draw(20)
    # Crumb wire, classic path (padded length 1024 > the 512-symbol verify
    # window): 600-symbol reads, of the text and of both units.
    long = draw(10, 600) + [unit3[50:650], unit12[20:620], unit12[:600]]
    return [mixed, odd, long]


@pytest.fixture(scope="module")
def engines(served):
    """Both engines over the mark-4 index, the query batches and the JAX
    engine's count_locate_stream output, with the calls of the counting
    stand-in for marked_walk_sweep."""
    records, unit3, unit12, jidx, tidx, _ = served
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "_OVERCAP_WALK_SLAB", SLAB)
        counter = _WalkCounter(mp)
        jeng = JaxEngine(jidx, use_sweep=True)
        assert jeng._verify_enabled and not jeng._verify_slots
        batches = _batches(records, unit3, unit12)
        want = list(jeng.count_locate_stream(batches, cap=8))
    eng = FmQueryEngine(tidx, device="cpu")
    assert eng._verify_s == jeng._verify_s == 10  # four post-seed steps
    return jeng, eng, batches, want, counter.calls


def test_stream_matches_jax_engine(engines):
    jeng, eng, batches, want, walk_calls = engines
    assert walk_calls > 0, "the JAX engine never took marked_walk_sweep"
    assert eng.encode_queries(batches[0])[0].dtype == np.int8  # crumb wire
    assert eng.encode_queries(batches[1])[0].dtype == np.uint8  # nibble wire
    got = list(eng.count_locate_stream(batches, cap=8))
    assert len(got) == len(want) == 3
    for b, (g, w) in enumerate(zip(got, want)):
        for name, x, y in zip(("counts", "seq_idx", "local", "offsets"), g, w):
            np.testing.assert_array_equal(x, np.asarray(y), err_msg=f"batch {b} {name}")

    counts = got[0][0]
    assert (counts >= 1).all()
    assert (counts[REDIS] >= 12).all() and (counts[NQ - 84 : NQ - 52] >= 3).all()
    assert got[2][0][-1] == 12 and got[2][0][-3] == 3
    st = eng.stats
    assert st["batches"] == 3 and st["verify_batches"] == 2  # the 600-symbol batch takes the classic path
    assert st["wide_lanes"] > 0 and st["redis_lanes"] >= 32 and st["multi_hit_queries"] > 0


def test_hits_spell_their_queries(engines, served):
    """Every (record, local) hit of the verify batch spells its query in
    its record, and the 12x unit's reads are found at every copy."""
    _, eng, batches, _, _ = engines
    records = [seq for _, seq in served[0]]
    counts, seq_idx, local, offsets = eng.count_locate_arrays(batches[0])
    for i, q in enumerate(batches[0]):
        hits = list(zip(seq_idx[offsets[i] : offsets[i + 1]], local[offsets[i] : offsets[i + 1]]))
        assert len(hits) == int(counts[i])
        for s, p in hits:
            assert records[s][p : p + len(q)] == q
    unit12 = served[2]
    naive = sum(r.count(unit12[:QLEN]) for r in records)
    assert naive >= 12 and int(counts[REDIS.start]) == naive


def test_entry_points_match_jax_engine(engines, served, monkeypatch):
    monkeypatch.setattr(jengine, "_OVERCAP_WALK_SLAB", SLAB)
    jeng, eng, batches, _, _ = engines
    records, unit3, unit12 = served[0], served[1], served[2]
    queries = batches[0][:8] + [unit3[5:40], unit12[:30], b"ACGTACGTAC", b"CCCCCCCCCCCCCCCCCCCCCC", b"AC"]
    queries += [records[1][1][NRUN - 3 : NRUN + 20], b"GATTACA" * 20]
    c1, r1 = eng.count_locate_batch(queries)
    c2, r2 = jeng.count_locate_batch(queries)
    np.testing.assert_array_equal(c1, c2)
    assert r1 == r2
    assert eng.locate_batch(queries) == jeng.locate_batch(queries) == r1
    s1, e1 = eng.search_ranges_batch(queries)
    s2, e2 = (np.asarray(x).astype(np.int64) for x in jeng.search_ranges_batch(queries))
    live = s2 <= e2
    np.testing.assert_array_equal(s1 <= e1, live)
    np.testing.assert_array_equal(s1[live], s2[live])
    np.testing.assert_array_equal(e1[live], e2[live])
    for q in queries[8:]:
        assert eng.count(q) == jeng.count(q)
        assert eng.locate(q) == jeng.locate(q)


@pytest.mark.parametrize("mark_ratio", [1, 2, 32])
def test_mark_ratio_invariance(served, mark_ratio):
    """Counts and (record, local) hits do not depend on the mark ratio."""
    records, unit3, unit12, _, tidx4, _ = served
    tidx = pt.build_from_records(records, pt.FmBuildArgs(lookup_table_kmer_len=K, locate_mark_ratio=mark_ratio))
    rng = np.random.default_rng(34)
    text = b"N".join(seq for _, seq in records)
    queries = [text[s : s + 18] for s in rng.integers(0, len(text) - 18, size=300)]
    queries += [unit12[:40], unit3[:40], b"ACGTA", b"NNNNN"]
    want = FmQueryEngine(tidx4, device="cpu").count_locate_arrays(queries, cap=4)
    got = FmQueryEngine(tidx, device="cpu").count_locate_arrays(queries, cap=4)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    assert int(want[0][-4]) >= 12 and int(want[0][-1]) > 4  # over-cap lanes


def test_split_bundle_mode_matches_jax(served, monkeypatch):
    """The split pos + flags bundle, which indexes of 2**28 symbols and more
    take, matches the reference's split bundle."""
    records, unit3, unit12, jidx, tidx, _ = served
    monkeypatch.setattr(jengine, "_OVERCAP_WALK_SLAB", SLAB)
    monkeypatch.setattr(jverify, "_packed_bundle", lambda index: False)
    monkeypatch.setattr(tverify, "_packed_bundle", lambda dev: False)
    rng = np.random.default_rng(35)
    text = b"N".join(seq for _, seq in records)
    reads = [text[s : s + QLEN] for s in rng.integers(0, len(text) - QLEN, size=NQ - 40)]
    reads = [r if b"N" not in r else unit3[:QLEN] for r in reads]
    reads += [unit3[i : i + QLEN] for i in range(0, 200, 10)] + [unit12[i : i + QLEN] for i in range(0, 200, 10)]
    eng = FmQueryEngine(tidx, device="cpu")
    wire, _ = eng.encode_queries(reads)
    assert wire.dtype == np.int8
    got = eng.count_locate_arrays(reads)
    want = JaxEngine(jidx, use_sweep=True).count_locate_arrays(reads)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, np.asarray(y))
    assert (got[0] >= 1).all() and eng.stats["redis_lanes"] >= 20
