"""The re-dispatched (redis) lanes of a verify batch: their hits walked on the
device and laid out there, each at its final offset, on the CPU engine.

A ~17k-symbol text holds a 40 bp unit 9 times, two of its copies behind one
12 bp flank, three behind another and four behind flanks of their own, and
a second 40 bp unit 3 times.  30 bp reads inside the 9x unit are redis
lanes over the cap of 3; a flank's last 10 symbols and the unit's first 20
make redis lanes of 2, 3 or 1 hits, a random 10-mer in place of the flank
one of 0; reads inside the 3x unit settle in the wide groups, and the other
reads settle with one hit.  Every batch is compared exactly with the same
index served at ``use_verify=False`` (the classic path), the mixed batch at
marks 1 and 4 with the JAX engine too; ``laid_positions`` must equal the
summed counts of the lanes that the verify bundle flags redis.  A classic
batch's rows over cap take the same layout, held against the JAX engine."""

import numpy as np
import pytest

import awry_tpu as jx
import awry_tpu.ops.engine as jengine
import awry_tpu_torch as pt
import awry_tpu_torch.ops.engine as tengine
from awry_tpu.ops import FmQueryEngine as JaxEngine
from awry_tpu_torch.ops import FmQueryEngine
from awry_tpu_torch.parallel import make_mesh

QLEN = 30
CAP = 3
# Index builds: the switch-step verify path at marks 1 and 4 (k = 4), and
# the slot regime (mark 1, k = 8: the text fits 1.6 * 4**8 rows).
KINDS = {"mark1": dict(lookup_table_kmer_len=4, locate_mark_ratio=1),
         "mark4": dict(lookup_table_kmer_len=4, locate_mark_ratio=4),
         "slots": dict(lookup_table_kmer_len=8, locate_mark_ratio=1)}


@pytest.fixture(scope="module")
def text():
    rng = np.random.default_rng(170)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)

    def rand(n):
        return bytes(rng.choice(acgt, size=n))

    unit9, unit3 = rand(40), rand(40)
    flank2, flank3 = rand(12), rand(12)
    flanks = [flank2] * 2 + [flank3] * 3 + [rand(12) for _ in range(4)]
    parts, pieces, at = [], [], 0
    for i in range(12):
        parts += [rand(1_400), flanks[i] + unit9 if i < 9 else unit3]
        pieces.append((at, at + 1_400))
        at += len(parts[-2]) + len(parts[-1])
    body = b"".join(parts)
    absent = rand(10)
    assert body.count(absent + unit9[:20]) == 0
    return body, unit9, unit3, flanks, absent, pieces


@pytest.fixture(scope="module", params=sorted(KINDS))
def kind(request):
    return request.param


@pytest.fixture(scope="module")
def indexes(text):
    """The text built as each of KINDS (port) and at marks 1 and 4 (JAX)."""
    records = [("chrA", text[0])]
    port = {k: pt.build_from_records(records, pt.FmBuildArgs(**a)) for k, a in KINDS.items()}
    jax = {k: jx.build_from_records(records, jx.FmBuildArgs(**KINDS[k])) for k in ("mark1", "mark4")}
    return port, jax


def _settled(text, n, seed):
    """n reads of the random pieces of the text that occur once."""
    body, pieces = text[0], text[-1]
    rng = np.random.default_rng(seed)
    reads = []
    while len(reads) < n:
        a, b = pieces[int(rng.integers(0, len(pieces)))]
        s = int(rng.integers(a, b - QLEN))
        r = body[s : s + QLEN]
        if body.count(r) == 1:
            reads.append(r)
    return reads


def _mixed(text, seed=1):
    _, unit9, unit3, flanks, absent, _ = text
    head = unit9[:20]
    return (_settled(text, 120, seed)
            + [unit3[i : i + QLEN] for i in (0, 5, 10)]                 # wide groups, 3 hits
            + [unit9[i : i + QLEN] for i in (0, 4, 8)]                  # redis, 9 hits
            + [flanks[0][-10:] + head, flanks[2][-10:] + head]          # redis, 2 and 3 hits
            + [f[-10:] + head for f in flanks[5:]]                      # redis, 1 hit
            + [absent + head])                                          # redis, 0 hits


def _one_hit(text, seed=2):
    """Reads of one hit each, four of them redis: the fast path."""
    unit9, flanks = text[1], text[3]
    return _settled(text, 60, seed) + [f[-10:] + unit9[:20] for f in flanks[5:]]


def _served(eng, queries):
    """count_locate_arrays of the verify engine, and the redis flags of the
    batch's lanes as the verify bundle gave them (over the slices, in query
    order)."""
    flags = []
    unpack = tengine.unpack_verify_bundle

    def spy(bundle, batch, groups):
        out = unpack(bundle, batch, groups)
        flags.append(out[2].copy())
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tengine, "unpack_verify_bundle", spy)
        got = eng.count_locate_arrays(queries, cap=CAP)
    return got, np.concatenate(flags)[: len(queries)]


def _check(eng, index, queries, slices=1):
    """The verify engine's answers equal the classic path's, and it laid out
    exactly the redis lanes' hits; returns the counts and the redis flags."""
    got, redis = _served(eng, queries)
    want = FmQueryEngine(index, device="cpu", use_verify=False).count_locate_arrays(queries, cap=CAP)
    for name, x, y in zip(("counts", "seq_idx", "local", "offsets"), got, want):
        np.testing.assert_array_equal(x, y, err_msg=name)
    counts = got[0].astype(np.int64)
    st = eng.stats
    assert st["verify_batches"] == slices and st["redis_lanes"] == int(redis.sum())
    assert st["laid_positions"] == int(counts[redis].sum())
    over = redis & (counts > CAP)
    assert (st["overcap_queries"], st["overcap_rows"]) == (int(over.sum()), int(counts[over].sum()))
    assert st["pageable_d2h_bytes"] == 0
    return counts, redis


def test_mixed_batch_lays_out_every_redis_hit(text, indexes, kind):
    """Settled, wide-group and redis lanes of 0, 1, 2..cap and over cap hits
    in one batch, off the fast path."""
    index = indexes[0][kind]
    eng = FmQueryEngine(index, device="cpu")
    assert eng._verify_slots == (kind == "slots")
    counts, redis = _check(eng, index, _mixed(text))
    assert counts[-10:].tolist() == [9, 9, 9, 2, 3, 1, 1, 1, 1, 0]
    assert redis.sum() == 10 and redis[-10:].all()
    assert (counts[-13:-10] == 3).all()
    assert eng.stats["wide_lanes"] >= 3 and eng.stats["fast_path_batches"] == 0


def test_fast_path_with_redis_lanes(text, indexes, kind):
    """Every lane has one hit, the redis lanes' too: the fast path, with the
    redis lanes' positions laid out on the device."""
    index = indexes[0][kind]
    eng = FmQueryEngine(index, device="cpu")
    counts, redis = _check(eng, index, _one_hit(text))
    assert (counts == 1).all() and redis.sum() == 4
    assert eng.stats["fast_path_batches"] == 1 and eng.stats["laid_positions"] == 4


@pytest.mark.parametrize("slab", [1, 4, 7])
def test_lanes_across_slabs(text, indexes, monkeypatch, slab):
    """Slabs of a few rows: the 9-hit lanes' rows cross slab boundaries."""
    index = indexes[0]["mark4"]
    monkeypatch.setattr(tengine, "_OVERCAP_WALK_SLAB", slab)
    eng = FmQueryEngine(index, device="cpu")
    counts, redis = _check(eng, index, _mixed(text, seed=3))
    assert int(counts[redis].sum()) > 3 * slab


def test_two_slot_data_mesh(text, indexes):
    """A 2-slot data mesh lays out each slice's redis lanes; the answers
    merge to the single engine's."""
    index = indexes[0]["mark1"]
    queries = _mixed(text, seed=4)
    eng = FmQueryEngine(index, mesh=make_mesh(devices=["cpu"] * 2))
    counts, redis = _check(eng, index, queries, slices=2)
    single = FmQueryEngine(index, device="cpu").count_locate_arrays(queries, cap=CAP)
    for x, y in zip(eng.count_locate_arrays(queries, cap=CAP), single):
        np.testing.assert_array_equal(x, y)
    assert eng.stats["laid_positions"] == 2 * int(counts[redis].sum())


@pytest.mark.parametrize("mark", ["mark1", "mark4"])
def test_mixed_batch_matches_jax_engine(text, indexes, monkeypatch, mark):
    monkeypatch.setattr(jengine, "_OVERCAP_WALK_SLAB", 64)
    queries = _mixed(text)
    got = FmQueryEngine(indexes[0][mark], device="cpu").count_locate_arrays(queries, cap=CAP)
    want = JaxEngine(indexes[1][mark], use_sweep=False).count_locate_arrays(queries, cap=CAP)
    for name, x, y in zip(("counts", "seq_idx", "local", "offsets"), got, want):
        np.testing.assert_array_equal(x, np.asarray(y), err_msg=name)


@pytest.mark.parametrize("mark", ["mark1", "mark4"])
def test_classic_overcap_rows_laid_out(text, indexes, monkeypatch, mark):
    """A classic batch lays out its rows over cap by the same code, in slabs
    of 4 rows so that the 9-hit reads cross slabs: the JAX engine's
    answers, every over-cap row counted in laid_positions and nothing read
    from pageable memory."""
    monkeypatch.setattr(tengine, "_OVERCAP_WALK_SLAB", 4)
    monkeypatch.setattr(jengine, "_OVERCAP_WALK_SLAB", 64)
    queries = _mixed(text)
    eng = FmQueryEngine(indexes[0][mark], device="cpu", use_verify=False)
    got = eng.count_locate_arrays(queries, cap=CAP)
    want = JaxEngine(indexes[1][mark], use_sweep=False).count_locate_arrays(queries, cap=CAP)
    for name, x, y in zip(("counts", "seq_idx", "local", "offsets"), got, want):
        np.testing.assert_array_equal(x, np.asarray(y), err_msg=name)
    counts = got[0].astype(np.int64)
    over = counts > CAP
    st = eng.stats
    assert st["verify_batches"] == 0 and int(counts[over].sum()) > 3 * 4
    assert (st["overcap_queries"], st["overcap_rows"]) == (int(over.sum()), int(counts[over].sum()))
    assert st["laid_positions"] == int(counts[over].sum()) and st["pageable_d2h_bytes"] == 0
