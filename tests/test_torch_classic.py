"""The classic-only engine over indexes without marks, on the CPU.

An index saved by the JAX package to ``.awry`` and loaded by both packages
has no locate marks and no packed text: the port serves it by the classic
full-depth path and locates by the row-sampled walk (``sampled_walk``, its
plain version here), against the JAX engine (plain gathers,
``use_sweep=False``) on the same file.  Nucleotide and amino, SA ratios 1,
4 and 8; reads over the locate cap (a unit planted 12 times, cap 8),
absent reads, reads with the ambiguity letter, an empty query, a sentinel,
and reads longer than the verify window.  Then ``sampled_walk_plain``
against the JAX walk on every row, ``use_verify=False`` on a marked index,
strict wire checks, ``warmup`` and ``device_sustained_qps``.  Every
comparison is exact; inputs come from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import awry_tpu as jx
import awry_tpu.ops.engine as jengine
import awry_tpu_torch as pt
from awry_tpu.io import awry_format as jx_awry
from awry_tpu.ops import FmQueryEngine as JaxEngine
from awry_tpu.ops import to_device as jax_to_device
from awry_tpu.ops.locate import lf_walk as jax_lf_walk
from awry_tpu_torch.ops import FmQueryEngine, kernels, lf_walk, to_device

from .conftest import random_seq

K = 4
CAP = 8
SLAB = 4096  # the JAX engine's over-cap walk slab, cut from 8M rows
AMB = {"NUCLEOTIDE": b"N", "AMINO": b"X"}
LONG = {"NUCLEOTIDE": 600, "AMINO": 300}  # past the verify window (512 / 256 symbols)


def _records(alphabet: str, seed: int):
    """Two records, ~16k symbols: a 70-symbol unit planted 12 times, one of
    40 planted 3 times, ambiguity runs; and the two units."""
    rng = np.random.default_rng(seed)
    seq = lambda n: random_seq(jx.Alphabet[alphabet], rng, n)  # noqa: E731
    unit12, unit3 = seq(70), seq(40)
    parts = []
    for i in range(15):
        parts.append(seq(950))
        parts.append(unit12 if i < 12 else b"")
        parts.append(unit3 if i % 5 == 0 else b"")
    body = b"".join(parts)
    amb = AMB[alphabet]
    return [("first", amb * 20 + body[:9_000]), ("second", body[9_000:] + amb * 7)], unit12, unit3


def _batches(alphabet: str, records, unit12, unit3, seed: int, long: bool = True):
    """Drawn 20-mers with over-cap, 3x and absent reads (the crumb wire for
    nucleotide); odd reads (empty, sentinel, ambiguity runs, short, an
    ambiguity letter inside); with ``long``, reads past the verify window."""
    rng = np.random.default_rng(seed)
    text = records[0][1] + records[1][1]

    def draw(n, ln):
        starts = rng.integers(0, len(text) - ln, size=n)
        return [text[s : s + ln] for s in starts]

    amb = AMB[alphabet]
    absent = [random_seq(jx.Alphabet[alphabet], rng, 24) for _ in range(20)]
    over_cap = [unit12[i : i + 20] for i in range(0, 50, 5)]
    wide = [unit3[i : i + 20] for i in range(0, 20, 4)]
    plain = draw(160, 20) + over_cap + wide + absent
    odd = [b"", b"A$CA", amb * 3, amb * 30, amb + records[0][1][20:40], records[1][1][-12:]]
    odd += draw(30, 7) + [q[:9] + amb + q[10:] for q in draw(10, 20)]
    if not long:
        return [plain, odd]
    return [plain, odd, draw(12, LONG[alphabet]) + [records[0][1][20 : 20 + LONG[alphabet]]]]


@pytest.fixture(scope="module", params=[(a, r) for a in ("NUCLEOTIDE", "AMINO") for r in (1, 4, 8)],
                ids=lambda p: f"{p[0].lower()}-sa{p[1]}")
def markless(request, tmp_path_factory):
    """A .awry file of the JAX build, loaded by both packages; both engines
    over it, the batches, and the JAX engine's answers.  Nucleotide reads
    past the verify window pad to 1024 symbols, where the JAX engine's
    programs take about 20 s each to compile: they run at SA ratio 8 only,
    and count_batch is held against the JAX stream's counts there."""
    alphabet, sa_ratio = request.param
    seed = 31 + sa_ratio + (10 if alphabet == "AMINO" else 0)
    records, unit12, unit3 = _records(alphabet, seed)
    jbuilt = jx.build_from_records(
        records, jx.FmBuildArgs(alphabet=jx.Alphabet[alphabet], lookup_table_kmer_len=K,
                                suffix_array_compression_ratio=sa_ratio),
    )
    path = str(tmp_path_factory.mktemp("classic") / "index.awry")
    jx_awry.save_awry(jbuilt, path)
    jidx = jx_awry.load_awry(path, kmer_on_device=False)
    tidx = pt.load_awry(path, device="cpu")
    assert not tidx.has_marks and tidx.text_packed is None and tidx.sa_ratio == sa_ratio
    batches = _batches(alphabet, records, unit12, unit3, seed + 1, long=alphabet == "AMINO" or sa_ratio == 8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "_OVERCAP_WALK_SLAB", SLAB)
        jeng = JaxEngine(jidx, use_sweep=False)
        assert not jeng._verify_enabled
        stream = list(jeng.count_locate_stream(batches, cap=CAP))
        want = {
            "stream": stream,
            "counts": [jeng.count_batch(b) for b in batches[:2]] + [np.asarray(r[0]) for r in stream[2:]],
            "locate": jeng.locate_batch(batches[0], cap=CAP),
        }
    eng = FmQueryEngine(tidx, device="cpu")
    return alphabet, tidx, records, eng, batches, want, unit12


def test_markless_stream_matches_jax(markless):
    """count_locate_stream: counts, (record, local) hits in BWT-row order and
    offsets equal the JAX engine's; the over-cap unit reports 12 hits; the
    engine is classic only and walks by sampled_walk's plain version."""
    alphabet, tidx, _, eng, batches, want, _ = markless
    assert not eng._verify_enabled and not eng.device_index.has_marks
    n0 = {k: getattr(kernels, k).launches for k in ("sampled_walk", "marked_walk", "window_read")}
    got = list(eng.count_locate_stream(batches, cap=CAP))
    assert {k: getattr(kernels, k).launches for k in n0} == n0  # plain versions on the CPU
    assert len(got) == len(want["stream"]) == len(batches)
    for b, (g, w) in enumerate(zip(got, want["stream"])):
        for name, x, y in zip(("counts", "seq_idx", "local", "offsets"), g, w):
            np.testing.assert_array_equal(x, np.asarray(y), err_msg=f"batch {b} {name}")
    counts = got[0][0]
    assert set(counts[160:170].tolist()) == {12} and (counts[170:175] >= 3).all()
    assert eng.stats["verify_batches"] == 0 and eng.stats["batches"] == len(batches)


def test_markless_count_and_locate_batch_match_jax(markless):
    _, _, _, eng, batches, want, unit12 = markless
    for batch, counts in zip(batches, want["counts"]):
        np.testing.assert_array_equal(eng.count_batch(batch), counts)
    assert eng.locate_batch(batches[0], cap=CAP) == want["locate"]
    assert len(eng.locate(unit12[:20])) == eng.count(unit12[:20]) == 12


def test_hits_spell_their_queries(markless):
    """Every hit of the port's mark-less engine spells its query in its
    record (the JAX engine could share a fault; the text cannot)."""
    _, _, records, eng, batches, _, _ = markless
    for batch in batches:
        counts, seq_idx, local, offsets = eng.count_locate_arrays(batch, cap=CAP)
        for i, q in enumerate(batch):
            for s, p in zip(seq_idx[offsets[i] : offsets[i + 1]], local[offsets[i] : offsets[i + 1]]):
                assert records[s][1][p : p + len(q)].upper() == q.upper()


@pytest.mark.parametrize("alphabet,sa_ratio", [("NUCLEOTIDE", 1), ("NUCLEOTIDE", 4), ("NUCLEOTIDE", 8),
                                               ("AMINO", 8)])
def test_sampled_walk_plain_matches_jax_walk(alphabet, sa_ratio, tmp_path):
    """sampled_walk_plain equals the JAX row-sampled walk (lf_walk of an
    index without marks: _row_sampled_walk) on every row, and lf_walk takes
    it for an index without marks, whatever its SA ratio."""
    records, _, _ = _records(alphabet, 50 + sa_ratio)
    built = pt.build_from_records(records, pt.FmBuildArgs(alphabet=pt.Alphabet[alphabet], lookup_table_kmer_len=K,
                                                           suffix_array_compression_ratio=sa_ratio))
    path = str(tmp_path / "i.awry")
    pt.save_awry(built, path)
    tidx, jidx = pt.load_awry(path, device="cpu"), jx_awry.load_awry(path, kmer_on_device=False)
    tdev = to_device(tidx, "cpu")
    assert not tdev.has_marks and tdev.mark_ratio == sa_ratio
    rows = np.arange(tidx.bwt_len, dtype=np.int64)
    got = kernels.sampled_walk_plain(
        tdev.blocks, torch.from_numpy(rows), tdev.prefix_sums, tdev.codes, tdev.c2i, tdev.num_planes,
        tdev.alphabet.ambiguity_idx, sa_ratio, tdev.sampled_sa, tdev.bwt_len,
    ).numpy()
    want = np.asarray(jax_lf_walk(jax_to_device(jidx), jnp.asarray(rows, dtype=jnp.uint32))).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    full = pt.build_from_records(records, pt.FmBuildArgs(alphabet=pt.Alphabet[alphabet], lookup_table_kmer_len=K,
                                                          locate_mark_ratio=1))
    np.testing.assert_array_equal(got, full.text_sampled_sa.astype(np.int64))  # the whole SA
    np.testing.assert_array_equal(lf_walk(tdev, torch.from_numpy(rows)).numpy(), got)


def test_sampled_walk_clamps_and_refuses_endless_walks():
    """Rows past either end walk as the clamped row; a walk that reaches no
    sampled row within bwt_len steps (a corrupt table) raises."""
    records, _, _ = _records("NUCLEOTIDE", 60)
    idx = pt.build_from_records(records, pt.FmBuildArgs(lookup_table_kmer_len=K, suffix_array_compression_ratio=4))
    idx = pt.FmIndexData(**{**idx.__dict__, "mark_bits": None, "mark_milestones": None, "text_sampled_sa": None})
    dev = to_device(idx, "cpu")
    args = (dev.prefix_sums, dev.codes, dev.c2i, dev.num_planes, dev.alphabet.ambiguity_idx, 4, dev.sampled_sa,
            dev.bwt_len)
    rows = torch.tensor([-5, 0, dev.bwt_len - 1, dev.bwt_len + 300])
    got = kernels.sampled_walk(dev.blocks, rows, *args)
    want = kernels.sampled_walk(dev.blocks, rows.clamp(0, dev.bwt_len - 1), *args)
    assert torch.equal(got, want)
    # A table whose every row steps to row 3: all-zero planes read the
    # ambiguity symbol, whose rank is 0, and C[N] = 4 makes LF(row) = 3.
    blocks = torch.zeros((1, dev.blocks.shape[1]), dtype=torch.int32)
    prefix_sums = torch.tensor([0, 0, 0, 0, 4, 4, 50])
    sampled_sa = torch.zeros(13, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="corrupt index"):
        kernels.sampled_walk(blocks, torch.tensor([0, 3, 7, 11]), prefix_sums, *args[1:6], sampled_sa, 50)
    ok = kernels.sampled_walk(blocks, torch.tensor([0, 8]), prefix_sums, *args[1:6], sampled_sa, 50)
    assert ok.tolist() == [0, 0]

def test_use_verify_false_matches_jax():
    """use_verify=False serves a marked index by the classic path (the
    marked walk), equal to JaxEngine(use_verify=False)."""
    records, unit12, unit3 = _records("NUCLEOTIDE", 70)
    args = dict(lookup_table_kmer_len=K, locate_mark_ratio=4)
    jidx = jx.build_from_records(records, jx.FmBuildArgs(**args))
    tidx = pt.build_from_records(records, pt.FmBuildArgs(**args))
    batches = _batches("NUCLEOTIDE", records, unit12, unit3, 71)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "_OVERCAP_WALK_SLAB", SLAB)
        jeng = JaxEngine(jidx, use_sweep=False, use_verify=False)
        want = list(jeng.count_locate_stream(batches, cap=CAP))
    eng = FmQueryEngine(tidx, device="cpu", use_verify=False)
    assert not eng._verify_enabled and eng.device_index.vw_flat is None and eng.device_index.has_marks
    got = list(eng.count_locate_stream(batches, cap=CAP))
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, np.asarray(y))
    assert eng.stats["verify_batches"] == 0
    verify = FmQueryEngine(tidx, device="cpu")
    for g, v in zip(got, verify.count_locate_stream(batches, cap=CAP)):
        for x, y in zip(g, v):
            np.testing.assert_array_equal(x, y)


def test_strict_checks_pre_encoded_wire():
    """strict=True refuses pre-encoded batches with a symbol or a length
    out of range (the nibble and raw wires); every crumb is a dense symbol,
    so any crumb bytes pass."""
    records, _, _ = _records("NUCLEOTIDE", 80)
    idx = pt.build_from_records(records, pt.FmBuildArgs(lookup_table_kmer_len=K))
    eng = FmQueryEngine(idx, device="cpu", strict=True)
    q = records[0][1][100:120]
    wire, qlens = eng.encode_queries([q[:10] + b"N" + q[11:]])
    assert wire.dtype == np.uint8  # nibble
    with pytest.raises(ValueError, match="symbol index"):
        next(eng.count_locate_stream([(np.full_like(wire, 0xFF), qlens, 1)]))
    with pytest.raises(ValueError, match="query length"):
        next(eng.count_locate_stream([(wire, np.array([999], dtype=np.int32), 1)]))
    crumb, cl = eng.encode_queries([q])
    assert crumb.dtype == np.int8
    counts = next(eng.count_locate_stream([(np.full_like(crumb, -1), cl, 1)]))[0]
    assert counts.shape == (1,)
    assert next(eng.count_locate_stream([(crumb, cl, 1)]))[0][0] == 1
    aidx = pt.build_from_records([("p", random_seq(jx.Alphabet.AMINO, np.random.default_rng(81), 3_000))],
                                 pt.FmBuildArgs(alphabet=pt.Alphabet.AMINO, lookup_table_kmer_len=2))
    aeng = FmQueryEngine(aidx, device="cpu", strict=True)
    raw, rl = aeng.encode_queries([b"ACDEFGHIK"])
    assert raw.dtype == np.int8
    with pytest.raises(ValueError, match="symbol index"):
        next(aeng.count_locate_stream([(np.full_like(raw, 22), rl, 1)]))


@pytest.mark.parametrize("markless_index", [True, False], ids=["markless", "marked"])
def test_warmup_and_sustained_qps(markless_index, tmp_path):
    """warmup runs every dispatch kind; device_sustained_qps returns a
    positive rate, and its per-batch digest is the sum of every output that
    batch's dispatch hands the host."""
    records, unit12, unit3 = _records("NUCLEOTIDE", 90)
    idx = pt.build_from_records(records, pt.FmBuildArgs(lookup_table_kmer_len=K))
    if markless_index:
        pt.save_awry(idx, str(tmp_path / "i.awry"))
        idx = pt.load_awry(str(tmp_path / "i.awry"), device="cpu")
    eng = FmQueryEngine(idx, device="cpu")
    eng.warmup(batch_sizes=(16, 40), query_lens=(8, 30))
    batches = _batches("NUCLEOTIDE", records, unit12, unit3, 91)
    wires = [(*eng.encode_queries(b), len(b)) for b in batches]
    assert eng.device_sustained_qps(wires, trials=1) > 0
    digests = eng._digests(wires, CAP).numpy()
    kinds = set()
    for (wire, qlens, _), digest in zip(wires, digests):
        kind, outs, _ = eng._device_outputs(wire, qlens, CAP)
        kinds.add(kind)
        assert digest == sum(int(o.to(torch.int64).sum()) for o in outs)
    assert kinds == ({"classic"} if markless_index else {"verify", "classic"})
