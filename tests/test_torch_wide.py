"""The port's 64-bit engine on the CPU: awry_tpu_torch's FmQueryEngine with
``wide=True`` (every wide kernel through its plain version) against the JAX
package's host engine and its own 64-bit engine (``FmQueryEngine(index,
wide=True)``), on small indexes built by the JAX package and carried over by
``from_numpy_index``: nucleotide at marks 1 and 4 over 1 and 3 records,
amino with an over-cap query, an index without marks (a ``.awry`` round
trip), and the facade's ``backstep`` and ``update_range_with_symbol``.
Milestone groups are cut to 2 blocks (``GROUP_SHIFT`` 1) where a case says
so, so that the group bases take part on a small index.

Then each wide kernel's plain version on synthetic tables whose positions,
milestones, prefix sums and SA values pass 2**32 (a non-power-of-two
sa_ratio among them), against an independent computation in Python
integers.  Every comparison is exact; inputs come from numpy seeds."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import awry_tpu as jx
import awry_tpu.host_engine as he
import awry_tpu_torch as pt
import awry_tpu_torch.ops.wide as wide_mod
from awry_tpu.io import awry_format as jx_awry
from awry_tpu.ops import FmQueryEngine as JaxEngine
from awry_tpu_torch.alphabet import code_to_index_table, index_to_code_table
from awry_tpu_torch.ops import FmQueryEngine, from_numpy_index, kernels

LETTERS = {"NUCLEOTIDE": b"ACGTN", "AMINO": b"ACDEFGHIKLMNPQRSTVWYX"}


def _to_port(jidx) -> pt.FmIndexData:
    names = [f.name for f in dataclasses.fields(jx.FmIndexData)]
    arrays = {k: getattr(jidx, k) for k in names if isinstance(getattr(jidx, k), np.ndarray)}
    meta = {k: getattr(jidx, k) for k in names if k not in arrays and k != "alphabet"}
    meta = {k: v for k, v in meta.items() if v is not None}
    return from_numpy_index(arrays, {"alphabet": jidx.alphabet.name, **meta})


def _index(alphabet="NUCLEOTIDE", n=3000, mark=4, k=3, records=1, seed=11):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(LETTERS[alphabet], dtype=np.uint8)
    recs = [(f"rec{i}", bytes(rng.choice(letters, size=n // records))) for i in range(records)]
    args = jx.FmBuildArgs(alphabet=jx.Alphabet[alphabet], lookup_table_kmer_len=k, locate_mark_ratio=mark)
    return jx.build_from_records(recs, args), recs


def _queries(recs, seed, n=64, lo=3, hi=18):
    rng = np.random.default_rng(seed)
    text = b"".join(seq for _, seq in recs)
    out = []
    for _ in range(n):
        ln = int(rng.integers(lo, hi))
        s = int(rng.integers(0, len(text) - ln))
        out.append(text[s : s + ln])
    return out


def _hits(res, i):
    counts, seq_idx, local, offsets = res
    return sorted(zip(seq_idx[offsets[i] : offsets[i + 1]].tolist(), local[offsets[i] : offsets[i + 1]].tolist()))


def _assert_parity(jidx, port_engine, queries, cap, jax_engine=None):
    """Counts and sorted (record, local) hits equal the host engine's, and
    the JAX wide engine's where one is given."""
    res = port_engine.count_locate_arrays(queries, cap=cap)
    np.testing.assert_array_equal(res[0], [he.count(jidx, q) for q in queries])
    np.testing.assert_array_equal(port_engine.count_batch(queries), res[0])
    for i, q in enumerate(queries):
        assert _hits(res, i) == sorted(he.locate(jidx, q)), q
    if jax_engine is not None:
        jres = jax_engine.count_locate_arrays(queries, cap=cap)
        np.testing.assert_array_equal(res[0], jres[0])
        for i in range(len(queries)):
            assert _hits(res, i) == _hits(jres, i)


@pytest.mark.parametrize("mark", [1, 4])
@pytest.mark.parametrize("records", [1, 3])
def test_wide_nucleotide_parity(mark, records, monkeypatch):
    """Drawn reads, absent and ambiguity reads, RNA letters and a long run,
    at marks 1 (the SA read of two int32 words) and 4 (marked_walk_wide),
    groups of 2 blocks."""
    jidx, recs = _index(mark=mark, records=records)
    monkeypatch.setattr(wide_mod, "GROUP_SHIFT", 1)
    eng = FmQueryEngine(_to_port(jidx), device="cpu", wide=True)
    assert eng.wide and eng.device_index.wide and not eng._verify_enabled
    assert eng.device_index.bases.milestones.shape[0] == -(-jidx.num_blocks // 2)
    queries = _queries(recs, 5) + [b"ACGT", b"NNN", b"acgu", b"T" * 22, b""]
    _assert_parity(jidx, eng, queries, 8, JaxEngine(jidx, wide=True))


def test_wide_amino_overcap():
    """Amino 4-mers and a one-symbol query with hundreds of hits past the
    locate cap (the over-cap expansion walks them through lf_walk)."""
    jidx, recs = _index("AMINO", n=1200, mark=4, k=2)
    eng = FmQueryEngine(_to_port(jidx), device="cpu", wide=True)
    text = recs[0][1]
    queries = _queries(recs, 7, n=32, lo=4, hi=5) + [text[:1]]
    _assert_parity(jidx, eng, queries, 2, JaxEngine(jidx, wide=True))


def test_wide_markless_awry(tmp_path, monkeypatch):
    """An index without marks through a .awry file written by the JAX
    package: the row-sampled walk's wide variant (sampled_walk_wide, range
    fed) and the over-cap expansion, against both packages' loads."""
    jidx, recs = _index(n=2400, mark=4, records=2, seed=3)
    path = str(tmp_path / "x.awry")
    jx_awry.save_awry(jidx, path)
    jm = jx_awry.load_awry(path)
    monkeypatch.setattr(wide_mod, "GROUP_SHIFT", 1)
    eng = FmQueryEngine(pt.load_awry(path, device="cpu"), device="cpu", wide=True)
    assert not eng.device_index.has_marks and eng.device_index.sampled_sa.dtype == torch.int64
    queries = _queries(recs, 9, n=48, lo=2, hi=12) + [b"A", b"GG"]
    _assert_parity(jm, eng, queries, 3, JaxEngine(jm, wide=True))


def test_wide_facade_backstep_and_update_range(monkeypatch):
    """FmIndex(wide=True): backstep of every row and update_range_with_symbol
    of ranges and symbols (backstep_wide and occ_pair_wide) equal the host
    engine's."""
    jidx, _ = _index(n=2000, mark=4, records=2, seed=4)
    monkeypatch.setattr(wide_mod, "GROUP_SHIFT", 1)
    fm = pt.FmIndex(_to_port(jidx), device="cpu", wide=True)
    assert fm.engine.wide
    rows = np.arange(jidx.bwt_len)
    want = he.backstep(jidx, rows)
    assert [fm.backstep(int(r)) for r in rows[::7]] == want[::7].astype(np.int64).tolist()
    rng = np.random.default_rng(8)
    alphabet = pt.Alphabet.NUCLEOTIDE
    for _ in range(40):
        s = int(rng.integers(0, jidx.bwt_len))
        e = min(jidx.bwt_len - 1, s + int(rng.integers(0, 400)))
        sym = int(rng.integers(1, alphabet.cardinality))
        got = fm.update_range_with_symbol(pt.SearchRange(s, e), pt.Symbol(alphabet, sym))
        ws, we = he.update_range(jidx, np.array([s]), np.array([e]), np.array([sym]))
        assert (got.start_ptr, got.end_ptr) == (int(ws[0]), int(we[0]))


def test_wide_refusals(monkeypatch, tmp_path):
    """FmQueryEngine picks the wide layout exactly at bwt_len >= 2**32 (None)
    and to_device refuses such an index for serving; the device k-mer build
    ships it in the wide layout (to_device(minimal=True)), rank.occurrence
    on a wide index equals the narrow one, and load_awry of a file that long
    reaches the wide derivation."""
    jidx, _ = _index(n=600, mark=4)
    tidx = _to_port(jidx)
    path = str(tmp_path / "long.awry")
    pt.save_awry(tidx, path)
    with open(path, "r+b") as f:  # the header's bwt_len: magic (11 B), version, sa_ratio, then bwt_len
        f.seek(11 + 16)
        f.write((2**32 + 5).to_bytes(8, "little"))
        f.truncate(3 << 30)  # sparse: as long as the blocks such a file holds, so it reads as whole
    # load_awry's sections as its reader gives them for that header (the
    # small index's arrays, so that no 3 GB are read), then the derivation:
    # the minimal ship in the wide layout, ranked through occ_wide.
    from awry_tpu_torch.io import awry_format

    short = str(tmp_path / "short.awry")
    pt.save_awry(tidx, short)
    loaded = awry_format._read_index(short, False)
    reads, derived = [], []

    def read_index(p, strict):
        reads.append(p)
        return dataclasses.replace(loaded, bwt_len=2**32 + 5)

    class Reached(Exception):
        pass

    def derive(dev, k):
        derived.append((dev.wide, dev.bwt_len, k))
        raise Reached

    monkeypatch.setattr(awry_format, "_read_index", read_index)
    monkeypatch.setattr(awry_format, "populate_kmer_table_device", derive)
    with pytest.raises(Reached):
        pt.load_awry(path, device="cpu")
    assert reads == [path] and derived == [(True, 2**32 + 5, tidx.kmer_len)]
    monkeypatch.undo()

    assert not FmQueryEngine(tidx, device="cpu").wide
    big = dataclasses.replace(tidx, bwt_len=2**32)
    with pytest.raises(NotImplementedError, match="wide=True"):
        pt.ops.to_device(big, "cpu")
    minimal = pt.ops.to_device(big, "cpu", minimal=True)
    assert minimal.wide and minimal.kmer_len == 0 and minimal.bwt_len == 2**32
    wide_dev = FmQueryEngine(tidx, device="cpu", wide=True).device_index
    narrow_dev = FmQueryEngine(tidx, device="cpu").device_index
    rng = np.random.default_rng(4)
    pos = torch.from_numpy(np.concatenate([[-1, 0, tidx.bwt_len - 1, tidx.bwt_len + 3],
                                           rng.integers(0, tidx.bwt_len, size=60)]).astype(np.int64))
    sym = torch.from_numpy(rng.integers(0, 5, size=pos.shape[0]).astype(np.int32))
    got = pt.ops.rank.occurrence(wide_dev, pos, sym)
    assert got.dtype == torch.int64
    assert torch.equal(got, pt.ops.rank.occurrence(narrow_dev, pos, sym))
    assert torch.equal(pt.ops.rank.occurrence_plain(wide_dev, pos, sym), got)
    # The choice, on an index that only claims 2**32 symbols: the layout is
    # shipped from the real one.
    shipped = []

    def ship(index, device):
        shipped.append(index.bwt_len)
        return wide_mod.to_device_wide(tidx, device)

    monkeypatch.setattr("awry_tpu_torch.ops.engine.to_device_wide", ship)
    assert FmQueryEngine(big, device="cpu").wide and shipped == [2**32]
    with pytest.raises(NotImplementedError, match="wide=True"):
        FmQueryEngine(big, device="cpu", wide=False)


@pytest.mark.parametrize("alphabet", ["NUCLEOTIDE", "AMINO"])
def test_wide_minimal_kmer_build(alphabet, monkeypatch):
    """The device k-mer build on the wide layout's minimal ship (groups of 2
    blocks, so the bases take part) equals the narrow layout's and the JAX
    package's host table."""
    monkeypatch.setattr(wide_mod, "GROUP_SHIFT", 1)
    k = 4 if alphabet == "NUCLEOTIDE" else 2
    jidx, _ = _index(alphabet, n=2500, mark=4, k=k, seed=19)
    tidx = _to_port(jidx)
    wide_dev = wide_mod.to_device_wide(tidx, "cpu", minimal=True)
    assert wide_dev.wide and wide_dev.kmer_len == 0 and wide_dev.bases.milestones.shape[0] > 1
    got = pt.ops.populate_kmer_table_device(wide_dev, k)
    narrow = pt.ops.populate_kmer_table_device(pt.ops.to_device(tidx, "cpu", minimal=True), k)
    np.testing.assert_array_equal(got, narrow)
    np.testing.assert_array_equal(got, he.populate_kmer_table(jidx))


# -- the plain versions past 2**32, against Python integers -----------------------


def _synthetic(alphabet, nb, rows_distinct, shift, seed, *, rel_zero=False):
    """A wide table of nb fused rows (nb random rows, or one random row
    seen nb times through a stride-0 view), group bases past 2**32,
    prefix sums past 2**32, mark bits at random.  ``rel_zero``: relative
    milestones 0 and bases chosen so that an LF step from group g lands in
    the last block of group g - 1 (walks end within the groups' count)."""
    rng = np.random.default_rng(seed)
    v, card = alphabet.num_planes, alphabet.cardinality
    rw = pt.ops.fused_row_words(alphabet)
    rows = rng.integers(0, 2**32, size=(rows_distinct, rw), dtype=np.uint64).astype(np.uint32)
    rows[:, v * 8 : v * 8 + card] = 0 if rel_zero else rng.integers(0, 2**24, size=(rows_distinct, card))
    rows[:, v * 8 + card + 8] = rng.integers(0, 2**24, size=rows_distinct)
    small = torch.from_numpy(rows.view(np.int32))
    blocks = small if rows_distinct == nb else small[:1].expand(nb, rw)
    groups = -(-nb // (1 << shift))
    prefix = np.sort(rng.integers(2**32, 2**34, size=card + 1)).astype(np.int64)
    if rel_zero:
        g = np.arange(groups, dtype=np.int64)[:, None]
        ms_base = g * (256 << shift) - 256 - prefix[None, :card] + 1
    else:
        ms_base = rng.integers(2**32, 2**40, size=(groups, card)).astype(np.int64)
    mark_base = rng.integers(0, 2**36, size=groups).astype(np.int64)
    bases = kernels.WideBases(torch.from_numpy(ms_base), torch.from_numpy(mark_base), shift)
    codes = torch.from_numpy(index_to_code_table(alphabet).astype(np.int32))
    c2i = torch.from_numpy(code_to_index_table(alphabet).astype(np.int32))
    return blocks, bases, torch.from_numpy(prefix), codes, c2i


def _row_words(blocks, p):
    return [int(w) & 0xFFFFFFFF for w in blocks[p >> 8].tolist()]


def _bit(words, off, local):
    return (words[off + (local >> 5)] >> (local & 31)) & 1


@functools.lru_cache(maxsize=None)
def _matches(words: tuple, nplanes: int, local: int, code: int) -> int:
    """Bits [0..=local] of a row whose plane bits spell ``code``."""
    return sum(all(_bit(words, v * 8, i) == (code >> v) & 1 for v in range(nplanes)) for i in range(local + 1))


def _ref_occ(blocks, bases, codes, nplanes, p, sym):
    """Occ(p, sym) in Python integers: group base + the row's relative
    milestone + the popcount of sym's matches in bits [0..=p & 255]."""
    p = min(max(p, 0), blocks.shape[0] * 256 - 1)
    words = _row_words(blocks, p)
    count = _matches(tuple(words), nplanes, p & 255, int(codes[sym]))
    return int(bases.milestones[p >> (8 + bases.shift), sym]) + words[nplanes * 8 + sym] + count


def _ref_backstep(blocks, bases, prefix, codes, c2i, nplanes, mark_offset, amb, p):
    p = min(max(p, 0), blocks.shape[0] * 256 - 1)
    words, local = _row_words(blocks, p), p & 255
    sym = int(c2i[sum(_bit(words, v * 8, local) << v for v in range(nplanes))])
    safe = amb if sym == 0 else sym
    step = 0 if sym == 0 else int(prefix[safe]) + _ref_occ(blocks, bases, codes, nplanes, p, safe) - 1
    rank = int(bases.marks[p >> (8 + bases.shift)]) + words[mark_offset + 8]
    rank += sum(_bit(words, mark_offset, i) for i in range(local))
    return step, rank, _bit(words, mark_offset, local)


@pytest.mark.parametrize("alphabet", ["NUCLEOTIDE", "AMINO"])
def test_wide_plain_versions_past_2_32(alphabet):
    """occ_pair_wide, backstep_wide and marked_walk_wide (marks 3 and 4) on
    a table of 2**24 + 300 blocks (positions past 2**32, the block edges and
    the last row among them) and on 40 distinct rows in groups of 2 blocks;
    every base, prefix sum and SA value past 2**32."""
    a = pt.Alphabet[alphabet]
    nplanes, card = a.num_planes, a.cardinality
    mark_offset = nplanes * 8 + card
    rng = np.random.default_rng(12)
    for nb, distinct, shift in ((2**24 + 300, 1, 16), (40, 40, 1)):
        blocks, bases, prefix, codes, c2i = _synthetic(a, nb, distinct, shift, 13)
        top = nb * 256
        pos = np.concatenate([[0, 255, 256, top - 1, top + 9, -2, 2**32 - 1, 2**32],
                              rng.integers(0, top, size=40)])[:48].astype(np.int64)
        pos = np.clip(pos, -2, top + 9)
        sym = rng.integers(0, card, size=pos.shape[0]).astype(np.int32)
        pa, pb = torch.from_numpy(pos), torch.from_numpy(np.minimum(pos + rng.integers(0, 600, pos.shape[0]), top))
        got_a, got_b = kernels.occ_pair_wide_plain(blocks, bases, pa, pb, torch.from_numpy(sym), codes, nplanes)
        for i in range(pos.shape[0]):
            assert int(got_a[i]) == _ref_occ(blocks, bases, codes, nplanes, int(pa[i]), int(sym[i]))
            assert int(got_b[i]) == _ref_occ(blocks, bases, codes, nplanes, int(pb[i]), int(sym[i]))
        assert int(got_a.max()) >= 2**32

        args = (prefix, codes, c2i, nplanes, mark_offset, a.ambiguity_idx)
        stepped, packed = kernels.backstep_wide_plain(blocks, bases, pa, *args)
        for i in range(pos.shape[0]):
            step, rank, bit = _ref_backstep(blocks, bases, prefix, codes, c2i, nplanes, mark_offset,
                                            a.ambiguity_idx, int(pa[i]))
            assert (int(stepped[i]), int(packed[i])) == (step, (rank << 1) | bit)
        assert int(packed.max()) >= 2**33

        bwt_len = top - 3
        sa = torch.from_numpy(rng.integers(2**32, max(bwt_len, 2**33), size=4000).astype(np.int64))
        for mark in (3, 4):
            got = kernels.marked_walk_wide_plain(blocks, bases, pa, *args, mark, sa, bwt_len)
            for i in range(pos.shape[0]):
                p, steps = int(pa[i]), 0
                while True:
                    step, rank, bit = _ref_backstep(blocks, bases, prefix, codes, c2i, nplanes, mark_offset,
                                                    a.ambiguity_idx, p)
                    if bit or steps + 1 >= mark:
                        break
                    p, steps = step, steps + 1
                t = int(sa[min(max(rank, 0), sa.shape[0] - 1)]) + steps
                assert int(got[i]) == (t - bwt_len if t >= bwt_len else t)


@pytest.mark.parametrize("alphabet", ["NUCLEOTIDE", "AMINO"])
def test_occ_wide_plain_past_2_32(alphabet):
    """occ_wide_plain on a table of 2**24 + 300 blocks (positions past
    2**32, block edges, the last row and positions past either end) and on
    40 distinct rows in groups of 2 blocks, symbols past the alphabet among
    them, against Python integers; it agrees with occ_pair_wide_plain."""
    a = pt.Alphabet[alphabet]
    nplanes, card = a.num_planes, a.cardinality
    rng = np.random.default_rng(17)
    for nb, distinct, shift in ((2**24 + 300, 1, 16), (40, 40, 1)):
        blocks, bases, _, codes, _ = _synthetic(a, nb, distinct, shift, 18)
        top = nb * 256
        pos = np.concatenate([[0, 255, 256, top - 1, top + 9, -2, 2**32 - 1, 2**32, 2**32 + 256],
                              rng.integers(0, top, size=40)]).astype(np.int64)
        pos = torch.from_numpy(np.clip(pos, -2, top + 9))
        sym = torch.from_numpy(rng.integers(-1, card + 1, size=pos.shape[0]).astype(np.int32))
        got = kernels.occ_wide_plain(blocks, bases, pos, sym, codes, nplanes)
        assert got.dtype == torch.int64
        for i in range(pos.shape[0]):
            s = min(max(int(sym[i]), 0), card - 1)
            assert int(got[i]) == _ref_occ(blocks, bases, codes, nplanes, int(pos[i]), s)
        assert torch.equal(got, kernels.occ_pair_wide_plain(blocks, bases, pos, pos, sym, codes, nplanes)[0])
        assert int(got.max()) >= 2**32


@pytest.mark.parametrize("sa_ratio", [8, 12])
@pytest.mark.parametrize("size", ["past_2_32", "distinct_rows"])
def test_wide_sampled_walk_plain_past_2_32(sa_ratio, size):
    """sampled_walk_wide and its range-fed entry on tables whose LF steps go
    down one milestone group at a time (every walk ends), a power-of-two and
    a non-power-of-two sa_ratio, against the walk in Python integers
    (64-bit modulo and quotient): 2**24 + 600 blocks of one row (rows past
    2**32; the sampled SA one value past 2**32, a stride-0 view, as the
    table's 2**29 entries would not fit a test), and 64 distinct rows in
    groups of 2 blocks with distinct SA values past 2**32."""
    a = pt.Alphabet.NUCLEOTIDE
    nplanes = a.num_planes
    rng = np.random.default_rng(22)
    if size == "past_2_32":
        nb = 2**24 + 600
        blocks, bases, prefix, codes, c2i = _synthetic(a, nb, 1, 16, 21, rel_zero=True)
        bwt_len = nb * 256 - 5
        sa = torch.tensor([2**32 + 12_345], dtype=torch.int64).expand(-(-bwt_len // sa_ratio))
        starts = np.concatenate([[0, 1, bwt_len - 1, 2**32 + 3, bwt_len + 4], rng.integers(0, bwt_len, size=11)])
    else:
        nb = 64
        blocks, bases, prefix, codes, c2i = _synthetic(a, nb, nb, 1, 23, rel_zero=True)
        bwt_len = nb * 256 - 5
        sa = torch.from_numpy(rng.integers(2**32, 2**34, size=-(-bwt_len // sa_ratio)).astype(np.int64))
        starts = np.concatenate([[0, 1, bwt_len - 1, bwt_len + 4], rng.integers(0, bwt_len, size=28)])
    counts = rng.integers(0, 4, size=starts.shape[0])
    walk = (prefix, codes, c2i, nplanes, a.ambiguity_idx, sa_ratio, sa, bwt_len)

    def ref(row):
        p, steps = min(max(row, 0), bwt_len - 1), 0
        while p % sa_ratio:
            step = _ref_backstep(blocks, bases, prefix, codes, c2i, nplanes, nplanes * 8 + 6, a.ambiguity_idx, p)[0]
            p, steps = min(max(step, 0), bwt_len - 1), steps + 1
        t = int(sa[p // sa_ratio]) + steps
        return t - bwt_len if t >= bwt_len else t

    rows = torch.from_numpy(starts.astype(np.int64))
    got = kernels.sampled_walk_wide_plain(blocks, bases, rows, *walk)
    assert got.tolist() == [ref(int(r)) for r in starts]
    cap = 3
    ranges = kernels.sampled_walk_ranges_wide_plain(
        blocks, bases, rows, torch.from_numpy(counts.astype(np.int64)), cap, *walk
    )
    for q in range(starts.shape[0]):
        for j in range(cap):
            row = int(starts[q]) + j if j < counts[q] else 0
            assert int(ranges[q, j]) == ref(row)
    assert int(got.max()) >= 2**32
