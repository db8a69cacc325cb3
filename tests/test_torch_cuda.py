"""The CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device and imports nothing of the JAX package, so it runs on a
machine without JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -m cuda

On the CPU every test here skips."""

import dataclasses

import numpy as np
import pytest
import torch

from awry_tpu_torch import Alphabet, FmBuildArgs, FmIndex, Symbol, build_from_records, load_awry, save_awry
from awry_tpu_torch.alphabet import code_to_index_table, index_to_code_table
from awry_tpu_torch.ops import (
    FmQueryEngine,
    count_locate_capped_t,
    fused_row_words,
    kernels,
    lf_walk,
    populate_kmer_table_device,
    rank,
    to_device,
)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    return torch.device("cuda", 0)


def _random_text(alphabet, n, rng) -> bytes:
    letters = b"ACGT" if alphabet is Alphabet.NUCLEOTIDE else b"ACDEFGHIKLMNPQRSTVWY"
    return bytes(rng.choice(np.frombuffer(letters, dtype=np.uint8), size=n))


def _device_index(alphabet, n, seed, mark_ratio=1):
    rng = np.random.default_rng(seed)
    seq = _random_text(alphabet, n, rng)
    args = FmBuildArgs(alphabet=alphabet, lookup_table_kmer_len=4, locate_mark_ratio=mark_ratio)
    return to_device(build_from_records([("x", seq)], args), "cpu"), rng


@pytest.mark.cuda
def test_window_read_matches_plain(card):
    """window_read equals its plain version at every templated width (1, 2,
    3, 4, 15) and at widths without a kernel of their own (5, 7), on the
    index's tables and on an odd-length table, with wbase below 0 and past
    the end and request counts that fill no whole tile."""
    tdev, rng = _device_index(Alphabet.NUCLEOTIDE, 60_000, 1)
    odd = torch.from_numpy(rng.integers(-(2**31), 2**31, size=100_003).astype(np.int32)).to(card)
    for flat in (tdev.text_sampled_sa.to(card), tdev.text_packed.to(card), tdev.kmer_flat.to(card), odd):
        for n in (4099, 1, 1023):
            wbase = torch.from_numpy(rng.integers(-5, flat.shape[0] + 5, size=n)).to(card)
            for k in (1, 2, 3, 4, 15, 5, 7):
                n0 = kernels.window_read.launches
                got = kernels.window_read(flat, wbase, k)
                assert kernels.window_read.launches == n0 + 1
                assert torch.equal(got, kernels.window_read_plain(flat, wbase, k)), (flat.shape[0], n, k)
    empty = kernels.window_read(flat, wbase[:0], 2)
    assert empty.shape == (0, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4])
def test_window_read_aligned_windows(card, k):
    """Windows that all start on a k-word boundary (the seed table's pairs,
    the slot regime's fat rows) take the kernel's vector loads; a quarter of
    the warps mixed with unaligned windows take the scalar ones."""
    rng = np.random.default_rng(9)
    flat = torch.from_numpy(rng.integers(-(2**31), 2**31, size=80_001).astype(np.int32)).to(card)
    wb = rng.integers(0, flat.shape[0] // k, size=5001) * k + k - 1
    wb[: 5001 // 4] = rng.integers(-3, flat.shape[0] + 3, size=5001 // 4)
    wbase = torch.from_numpy(wb).to(card)
    assert torch.equal(kernels.window_read(flat, wbase, k), kernels.window_read_plain(flat, wbase, k))


def _pairs(kind: str, n: int, rng, size: int = 4099):
    """occ_pair endpoints (pos_a, pos_b) over a table of n positions."""
    if kind == "random":
        pos_a = rng.integers(-1, n, size=size)
        return pos_a, np.minimum(pos_a + rng.integers(0, 300, size=size), n - 1)
    if kind == "same_block":  # ranges of ~1.5 rows: ~99 % of pairs in one block, as in serving
        pos_a = rng.integers(-1, n, size=size)
        return pos_a, np.minimum(pos_a + rng.integers(0, 4, size=size), n - 1)
    if kind == "cross_block":  # every pair in two blocks
        pos_a = rng.integers(-1, n - 512, size=size)
        return pos_a, (np.maximum(pos_a, 0) | 255) + 1 + rng.integers(0, 256, size=size)
    # edges: pos_a = -1, the 255/256 block edge, the last row, past the end
    last = n - 1
    pairs = [(-1, 0), (-1, 255), (-1, 256), (255, 256), (255, 255), (256, 511), (0, 255), (511, 512),
             (last, last), (last - 1, last), (-1, last), (last, last + 40), ((last & ~255) - 1, last)]
    pairs += [(a, b) for a, b in zip(range(-1, 600), range(255, 856))]
    return np.array([a for a, _ in pairs]), np.array([b for _, b in pairs])


@pytest.mark.cuda
@pytest.mark.parametrize("alphabet", [Alphabet.NUCLEOTIDE, Alphabet.AMINO])
@pytest.mark.parametrize("pairs", ["random", "same_block", "cross_block", "edges"])
def test_occ_pair_matches_plain(card, alphabet, pairs):
    """occ_pair equals its plain version on random pairs, on pairs nearly
    all in one block (one row read), all in two blocks, and at the edges."""
    tdev, rng = _device_index(alphabet, 60_000, 2)
    blocks, codes = tdev.blocks.to(card), tdev.codes.to(card)
    pa, pb = _pairs(pairs, tdev.bwt_len, rng)
    pos_a, pos_b = torch.from_numpy(pa).to(card), torch.from_numpy(pb).to(card)
    nbits = blocks.shape[0] * 256
    same = ((pos_a.clamp(0, nbits - 1) >> 8) == (pos_b.clamp(0, nbits - 1) >> 8)).float().mean()
    assert {"same_block": same > 0.95, "cross_block": same == 0}.get(pairs, True)
    sym = torch.from_numpy(rng.integers(0, alphabet.cardinality, size=pa.shape[0]).astype(np.int32)).to(card)
    n0 = kernels.occ_pair.launches
    got = kernels.occ_pair(blocks, pos_a, pos_b, sym, codes, tdev.num_planes)
    assert kernels.occ_pair.launches == n0 + 1
    want = kernels.occ_pair_plain(blocks, pos_a, pos_b, sym, codes, tdev.num_planes)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mark_ratio", [1, 4, 32])
@pytest.mark.parametrize("alphabet", [Alphabet.NUCLEOTIDE, Alphabet.AMINO])
def test_backstep_matches_plain(card, alphabet, mark_ratio, monkeypatch):
    """backstep and backstep_wide (groups of 2 blocks, so the bases matter)
    equal their plain versions on random rows and on every case of
    tests/backstep_cases.py (row counts around a warp's tile and a block,
    block edges, the table's edges and the sentinel's row, rows past either
    end, repeated and unsorted rows), each call one launch."""
    import awry_tpu_torch.ops.wide as wide_mod

    from .backstep_cases import CASES, case_rows

    monkeypatch.setattr(wide_mod, "GROUP_SHIFT", 1)
    rng = np.random.default_rng(3)
    index = build_from_records([("x", _random_text(alphabet, 60_000, rng))],
                               FmBuildArgs(alphabet=alphabet, lookup_table_kmer_len=4, locate_mark_ratio=mark_ratio))
    tdev, wide = to_device(index, card), wide_mod.to_device_wide(index, card)
    n, nbits = tdev.bwt_len, tdev.blocks.shape[0] * 256
    tail = (tdev.prefix_sums, tdev.codes, tdev.c2i, tdev.num_planes, tdev.mark_offset, alphabet.ambiguity_idx)
    wtail = (wide.prefix_sums, wide.codes, wide.c2i, wide.num_planes, wide.mark_offset, alphabet.ambiguity_idx)
    sentinel = int(torch.nonzero(rank.symbol_at(tdev, torch.arange(n, device=card)) == 0)[0])
    cases = {"random": np.concatenate([[0, n - 1, n + 300, -4], rng.integers(0, n, size=4095)])}
    cases |= {case: case_rows(case, n, nbits, sentinel, seed=i) for i, case in enumerate(CASES)}
    for case, r in cases.items():
        rows = torch.from_numpy(r).to(card)
        n0, w0 = kernels.backstep.launches, kernels.backstep_wide.launches
        got = kernels.backstep(tdev.blocks, rows, *tail)
        got_wide = kernels.backstep_wide(wide.blocks, wide.bases, rows, *wtail)
        assert (kernels.backstep.launches, kernels.backstep_wide.launches) == (n0 + 1, w0 + 1), case
        want = kernels.backstep_plain(tdev.blocks, rows, *tail)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), case
        want = kernels.backstep_wide_plain(wide.blocks, wide.bases, rows, *wtail)
        assert torch.equal(got_wide[0], want[0]) and torch.equal(got_wide[1], want[1]), case


@pytest.mark.cuda
@pytest.mark.parametrize("mark_ratio", [2, 4, 32])
def test_lf_walk_mark4_matches_cpu(card, mark_ratio):
    """The marked walk on the card (one marked_walk launch, no backstep)
    equals the CPU walk through the plain versions, row 0 and the last row
    included, at mark ratios 2, 4 (the default build's) and 32."""
    rng = np.random.default_rng(4)
    seq = bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=60_000))
    index = build_from_records([("a", b"N" * 50 + seq[:40_000]), ("b", seq[40_000:] + b"N" * 50)],
                               FmBuildArgs(lookup_table_kmer_len=4, locate_mark_ratio=mark_ratio))
    assert index.resolved_mark_ratio == mark_ratio
    rows = np.concatenate([[0, index.bwt_len - 1], rng.integers(0, index.bwt_len, size=5000)])
    n0, b0 = kernels.marked_walk.launches, kernels.backstep.launches
    got = lf_walk(to_device(index, card), torch.from_numpy(rows).to(card))
    assert kernels.marked_walk.launches == n0 + 1 and kernels.backstep.launches == b0
    want = lf_walk(to_device(index, "cpu"), torch.from_numpy(rows))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("alphabet", [Alphabet.NUCLEOTIDE, Alphabet.AMINO])
@pytest.mark.parametrize("mark_ratio", [2, 32])
def test_marked_walk_matches_plain(card, alphabet, mark_ratio):
    """marked_walk equals its plain version on rows past either end, the
    table's edges and random rows."""
    tdev, rng = _device_index(alphabet, 60_000, 10, mark_ratio=mark_ratio)
    n, nbits = tdev.bwt_len, tdev.blocks.shape[0] * 256
    rows = torch.from_numpy(np.concatenate([[0, n - 1, n, nbits - 1, nbits + 9, -4], rng.integers(0, n, size=4093)]))
    args = [t.to(card) for t in (tdev.blocks, rows, tdev.prefix_sums, tdev.codes, tdev.c2i)]
    tail = (tdev.num_planes, tdev.mark_offset, alphabet.ambiguity_idx, mark_ratio, tdev.text_sampled_sa.to(card), n)
    n0 = kernels.marked_walk.launches
    got = kernels.marked_walk(*args, *tail)
    assert kernels.marked_walk.launches == n0 + 1
    assert torch.equal(got, kernels.marked_walk_plain(*args, *tail))


def _marked_steps(tdev, rows, mark_ratio):
    """LF steps of each row's marked walk (backstep_plain visits) and
    whether each row is itself marked."""
    lf = (tdev.prefix_sums, tdev.codes, tdev.c2i, tdev.num_planes, tdev.mark_offset, tdev.alphabet.ambiguity_idx)
    pos, steps = rows.clone(), torch.zeros_like(rows)
    live = torch.arange(rows.shape[0])
    marked = None
    for _ in range(mark_ratio - 1):
        stepped, packed = kernels.backstep_plain(tdev.blocks, pos[live], *lf)
        going = (packed & 1) == 0
        if marked is None:
            marked = ~going
        live = live[going]
        pos[live] = stepped[going]
        steps[live] += 1
    return steps, marked


@pytest.mark.cuda
@pytest.mark.parametrize("alphabet", [Alphabet.NUCLEOTIDE, Alphabet.AMINO])
@pytest.mark.parametrize("mark_ratio", [2, 4, 32])
def test_marked_walk_rows_match_plain(card, alphabet, mark_ratio):
    """The flat marked walk equals its plain version on rows sorted by walk
    length, rows that are all marked, rows past either end, and 1, 33 and
    4099 rows; no row launches nothing; one launch per call."""
    tdev, rng = _device_index(alphabet, 60_000, 40 + mark_ratio, mark_ratio=mark_ratio)
    n, nbits = tdev.bwt_len, tdev.blocks.shape[0] * 256
    rows = torch.from_numpy(np.concatenate([[0, n - 1, n, nbits - 1, nbits + 9, -4], rng.integers(0, n, size=4093)]))
    steps, marked = _marked_steps(tdev, rows.clamp(0, nbits - 1), mark_ratio)
    tables = [t.to(card) for t in (tdev.blocks, tdev.prefix_sums, tdev.codes, tdev.c2i)]
    tail = (tdev.num_planes, tdev.mark_offset, alphabet.ambiguity_idx, mark_ratio, tdev.text_sampled_sa.to(card), n)
    batches = {
        "sorted by walk length": rows[torch.argsort(steps, stable=True)],
        "all marked": rows.clamp(0, nbits - 1)[marked],
        "past either end": torch.tensor([-9, -1, n, n + 1, nbits - 1, nbits, nbits + 300]),
        "one": rows[:1], "33": rows[:33], "4099": rows[:4099], "none": rows[:0],
    }
    assert batches["all marked"].numel() > 0
    for name, batch in batches.items():
        n0 = kernels.marked_walk.launches
        got = kernels.marked_walk(tables[0], batch.to(card), *tables[1:], *tail)
        assert kernels.marked_walk.launches == n0 + (1 if batch.numel() else 0), name
        want = kernels.marked_walk_plain(tdev.blocks, batch, tdev.prefix_sums, tdev.codes, tdev.c2i, *tail[:4],
                                         tdev.text_sampled_sa, n)
        assert torch.equal(got.cpu(), want), name


# kernels.MARKED_EAGER_FROM for each visit mode of the range-fed marked
# walks: every visit reads the planes with the mark word, or after it.
VISIT_MODES = {"eager": 1, "lazy": 1 << 30}


@pytest.mark.cuda
@pytest.mark.parametrize("alphabet", [Alphabet.NUCLEOTIDE, Alphabet.AMINO])
@pytest.mark.parametrize("mark_ratio", [2, 4, 32])
@pytest.mark.parametrize("mode", VISIT_MODES)
def test_marked_walk_ranges_matches_plain(card, alphabet, mark_ratio, mode, monkeypatch):
    """The range-fed marked walk, in either visit mode, equals its plain
    version (the padded rows walked by marked_walk_plain: row 0's walk in
    every idle slot) at caps 8 and 3: ranges tiling every row
    (every slot live), every slot idle, ranges of every count class
    reaching past bwt_len, one query; one launch per call, counted under
    marked_walk and the entry's own count."""
    monkeypatch.setattr(kernels, "MARKED_EAGER_FROM", VISIT_MODES[mode])
    tdev, rng = _device_index(alphabet, 60_000, 50 + mark_ratio, mark_ratio=mark_ratio)
    n = tdev.bwt_len
    tables = [t.to(card) for t in (tdev.blocks, tdev.prefix_sums, tdev.codes, tdev.c2i)]
    tail = (tdev.num_planes, tdev.mark_offset, alphabet.ambiguity_idx, mark_ratio)
    for cap in (8, 3):
        tiles = torch.arange(0, n, cap)
        batches = {
            "every slot live": (tiles, torch.full_like(tiles, cap)),
            "every slot idle": (tiles, torch.zeros_like(tiles)),
            "count classes": (torch.from_numpy(rng.integers(n - 3000, n + 5, 4099)),
                              torch.from_numpy(np.resize(np.array([0, 1, cap, cap + 7, 2]), 4099))),
            "one query": (torch.tensor([n // 2]), torch.tensor([2])),
        }
        for name, (starts, counts) in batches.items():
            want = kernels.marked_walk_ranges_plain(tdev.blocks, starts, counts, cap, tdev.prefix_sums, tdev.codes,
                                                    tdev.c2i, *tail, tdev.text_sampled_sa, n)
            n0, r0 = kernels.marked_walk.launches, kernels.marked_walk_ranges.launches
            got = kernels.marked_walk_ranges(tables[0], starts.to(card), counts.to(card), cap, *tables[1:], *tail,
                                             tdev.text_sampled_sa.to(card), n)
            assert (kernels.marked_walk.launches, kernels.marked_walk_ranges.launches) == (n0 + 1, r0 + 1), name
            assert torch.equal(got.cpu(), want), (name, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("alphabet", [Alphabet.NUCLEOTIDE, Alphabet.AMINO])
def test_marked_walk_wide_matches_plain_and_narrow(card, alphabet, monkeypatch):
    """marked_walk_wide and marked_walk_ranges_wide on a built index in
    groups of 2 blocks (the bases matter) equal their plain versions (rows
    past either end included) and the narrow walks on rows inside the
    index, at marks 2, 4 and 32, the range feed in both visit modes."""
    import awry_tpu_torch.ops.wide as wide_mod

    monkeypatch.setattr(wide_mod, "GROUP_SHIFT", 1)
    for mark_ratio, eager_from in ((2, 1), (4, 1), (32, 1), (2, 1 << 30), (4, 1 << 30), (32, 1 << 30)):
        monkeypatch.setattr(kernels, "MARKED_EAGER_FROM", eager_from)
        rng = np.random.default_rng(60 + mark_ratio)
        seq = _random_text(alphabet, 40_000, rng)
        index = build_from_records([("x", seq)], FmBuildArgs(alphabet=alphabet, lookup_table_kmer_len=4,
                                                             locate_mark_ratio=mark_ratio))
        wide, narrow = wide_mod.to_device_wide(index, card), to_device(index, card)
        n = wide.bwt_len
        rows = torch.from_numpy(np.concatenate([[0, n - 1, n + 3, -2], rng.integers(0, n, size=4095)])).to(card)
        starts = torch.from_numpy(rng.integers(0, n - 12, size=3001)).to(card)
        counts = torch.from_numpy(np.resize(np.array([0, 1, 3, 11]), 3001)).to(card)
        lf = (wide.prefix_sums, wide.codes, wide.c2i, wide.num_planes, wide.mark_offset, alphabet.ambiguity_idx,
              mark_ratio, wide.text_sampled_sa, n)
        nlf = (narrow.prefix_sums, narrow.codes, narrow.c2i, narrow.num_planes, narrow.mark_offset,
               alphabet.ambiguity_idx, mark_ratio, narrow.text_sampled_sa, n)
        n0 = kernels.marked_walk_wide.launches
        got = kernels.marked_walk_wide(wide.blocks, wide.bases, rows, *lf)
        assert torch.equal(got, kernels.marked_walk_wide_plain(wide.blocks, wide.bases, rows, *lf))
        assert torch.equal(got[4:], kernels.marked_walk(narrow.blocks, rows[4:], *nlf))
        got = kernels.marked_walk_ranges_wide(wide.blocks, wide.bases, starts, counts, 4, *lf)
        assert kernels.marked_walk_wide.launches == n0 + 2
        assert torch.equal(got, kernels.marked_walk_ranges_wide_plain(wide.blocks, wide.bases, starts, counts, 4, *lf))
        assert torch.equal(got, kernels.marked_walk_ranges(narrow.blocks, starts, counts, 4, *nlf))


@pytest.mark.cuda
def test_marked_capped_locate_walks_ranges(card):
    """count_locate_capped_t on a marked index launches the range-fed walk
    once and no flat walk, and gives the CPU's answers."""
    rng = np.random.default_rng(70)
    text = _random_text(Alphabet.NUCLEOTIDE, 60_000, rng)
    index = build_from_records([("x", text)], FmBuildArgs(lookup_table_kmer_len=4, locate_mark_ratio=4))
    on_card, on_cpu = (FmQueryEngine(index, device=d, use_verify=False) for d in (card, "cpu"))
    queries = [text[s : s + 12] for s in rng.integers(0, len(text) - 12, size=3000)] + [text[5:9]]
    qt, ql, flags = on_card._upload(*on_card.encode_queries(queries))
    n0, r0 = kernels.marked_walk.launches, kernels.marked_walk_ranges.launches
    out = count_locate_capped_t(on_card.device_index, qt, ql, 8, **flags)
    assert (kernels.marked_walk.launches, kernels.marked_walk_ranges.launches) == (n0 + 1, r0 + 1)
    want = count_locate_capped_t(on_cpu.device_index, *on_cpu._upload(*on_cpu.encode_queries(queries))[:2], 8,
                                 **flags)
    for x, y in zip(out, want):
        assert torch.equal(x.cpu(), y)


def _build_chunk(alphabet, card):
    """The last occ request batch of the device k-mer build of a small index
    (k = 7 nucleotide, 4 amino: every CTA's span is a few rows)."""
    letters = b"ACGT" if alphabet is Alphabet.NUCLEOTIDE else b"ACDEFGHIKLMNPQRSTVWY"
    k = 7 if alphabet is Alphabet.NUCLEOTIDE else 4
    rng = np.random.default_rng(8)
    seq = bytes(rng.choice(np.frombuffer(letters, dtype=np.uint8), size=60_000))
    index = build_from_records([("x", seq)], FmBuildArgs(alphabet=alphabet, lookup_table_kmer_len=k, locate_mark_ratio=1))
    calls = []
    real = kernels.occ

    def recording(*args):
        calls.append(args)
        return real(*args)

    kernels.occ = recording
    try:
        populate_kmer_table_device(to_device(index, "cpu", minimal=True), k)
    finally:
        kernels.occ = real
    blocks, pos, sym, codes, nplanes = calls[-1]
    return blocks.to(card), pos.to(card), sym.to(card), codes.to(card), nplanes


@pytest.mark.cuda
@pytest.mark.parametrize("alphabet", [Alphabet.NUCLEOTIDE, Alphabet.AMINO])
@pytest.mark.parametrize("positions", ["random", "build_chunk", "straddle"])
def test_occ_matches_plain(card, alphabet, positions):
    """occ equals its plain version on random positions (the direct
    branch), on a real k-mer build chunk (the staged branch) and on sorted
    positions whose gaps grow from 1 to 250, so that the tiles' spans run
    from a few rows to about a thousand, across the stage limit."""
    tdev, rng = _device_index(alphabet, 60_000, 5)
    codes, nplanes = tdev.codes.to(card), tdev.num_planes
    if positions == "build_chunk":
        blocks, pos, sym, codes, nplanes = _build_chunk(alphabet, card)
    elif positions == "straddle":
        nb = 20_000
        blocks = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(nb, tdev.blocks.shape[1])).astype(np.int32)).to(card)
        gaps = np.linspace(1, 250, 30_000).astype(np.int64)
        pos = torch.from_numpy(np.cumsum(gaps) - 1).to(card)
        assert int(pos[-1]) < nb * 256
        sym = torch.from_numpy(rng.integers(0, alphabet.cardinality, size=gaps.shape[0]).astype(np.int32)).to(card)
    else:
        blocks = tdev.blocks.to(card)
        n = tdev.bwt_len
        pos = torch.from_numpy(np.concatenate([[0, n - 1, 255, 256, n + 300, -4], rng.integers(0, n, size=4093)])).to(card)
        sym = torch.from_numpy(rng.integers(-1, alphabet.cardinality + 1, size=4099).astype(np.int32)).to(card)
    n0 = kernels.occ.launches
    got = kernels.occ(blocks, pos, sym, codes, nplanes)
    assert kernels.occ.launches == n0 + 1
    assert torch.equal(got, kernels.occ_plain(blocks, pos, sym, codes, nplanes))


@pytest.mark.cuda
def test_device_kmer_build_matches_cpu(card):
    """The k-mer table built on the card through occ equals the CPU build
    and the host counting table, and the builder flag builds it on cuda:0."""
    rng = np.random.default_rng(6)
    seq = bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=60_000))
    records = [("a", seq[:45_000] + b"N" * 20 + seq[45_000:])]
    index = build_from_records(records, FmBuildArgs(lookup_table_kmer_len=6, locate_mark_ratio=1))
    n0 = kernels.occ.launches
    got = populate_kmer_table_device(to_device(index, card, minimal=True), 6)
    assert kernels.occ.launches > n0
    np.testing.assert_array_equal(got, populate_kmer_table_device(to_device(index, "cpu", minimal=True), 6))
    np.testing.assert_array_equal(got, index.kmer_table)
    built = build_from_records(
        records, FmBuildArgs(lookup_table_kmer_len=6, locate_mark_ratio=1, build_kmer_table_on_device=True)
    )
    np.testing.assert_array_equal(built.kmer_table, index.kmer_table)


@pytest.mark.cuda
def test_slot_engine_matches_cpu(card):
    """The slot regime on the card (window_read over the fat rows) gives the
    CPU engine's answers, fat rows and all."""
    rng = np.random.default_rng(7)
    seq = bytearray(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=50_000))
    for r in range(3):
        seq[5_000 + 4_000 * r : 5_060 + 4_000 * r] = seq[1_000:1_060]
    seq = bytes(seq)
    index = build_from_records([("s", seq)], FmBuildArgs(lookup_table_kmer_len=8, locate_mark_ratio=1))
    on_card, on_cpu = FmQueryEngine(index, device=card), FmQueryEngine(index, device="cpu")
    assert on_card._verify_slots and on_cpu._verify_slots
    assert torch.equal(on_card.device_index.vw_flat.cpu(), on_cpu.device_index.vw_flat)
    queries = [seq[s : s + 25] for s in rng.integers(0, len(seq) - 25, size=3000)]
    queries += [seq[1_010:1_035], seq[10:14] * 3, b"ACGTNACGTNAC", b"AC", b"", seq[100:108]]
    n0 = kernels.window_read.launches
    got = on_card.count_locate_arrays(queries, cap=2)
    assert kernels.window_read.launches > n0
    for x, y in zip(got, on_cpu.count_locate_arrays(queries, cap=2)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("mark_ratio", [1, 4])
def test_redis_layout_on_card(card, mark_ratio, monkeypatch):
    """The verify path's re-dispatched lanes (10 hits, over cap 2; 1 hit; 0
    hits) laid out on the card, in slabs of 5 rows so that lanes cross
    slabs (window_read at mark 1, marked_walk at mark 4): the CPU engine's
    answers, with two pinned reads beside the bundle's and no pageable
    one."""
    import awry_tpu_torch.ops.engine as engine_mod

    monkeypatch.setattr(engine_mod, "_OVERCAP_WALK_SLAB", 5)
    rng = np.random.default_rng(71)
    seq = bytearray(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=30_000))
    for r in range(9):
        seq[2_000 + 3_000 * r : 2_040 + 3_000 * r] = seq[100:140]
    seq = bytes(seq)
    index = build_from_records([("s", seq)], FmBuildArgs(lookup_table_kmer_len=4, locate_mark_ratio=mark_ratio))
    on_card, on_cpu = FmQueryEngine(index, device=card), FmQueryEngine(index, device="cpu")
    queries = [seq[s : s + 30] for s in rng.integers(0, len(seq) - 30, size=2000)]
    queries += [seq[105:135], seq[90:120], b"A" * 10 + seq[100:120]]
    walks = (kernels.window_read if mark_ratio == 1 else kernels.marked_walk).launches
    got = on_card.count_locate_arrays(queries, cap=2)
    assert (kernels.window_read if mark_ratio == 1 else kernels.marked_walk).launches > walks
    for x, y in zip(got, on_cpu.count_locate_arrays(queries, cap=2)):
        np.testing.assert_array_equal(x, y)
    assert got[0][-3:].tolist() == [10, 1, 0] and on_card.stats["laid_positions"] >= 10
    assert on_card.stats["pageable_d2h_bytes"] == 0 and on_card.stats["host_syncs"] == 3


def _markless(alphabet, sa_ratio, tmp_path, n=60_000, seed=11):
    """A built index saved to .awry and loaded back on the CPU: no marks, no
    packed text."""
    rng = np.random.default_rng(seed)
    letters = b"ACGT" if alphabet is Alphabet.NUCLEOTIDE else b"ACDEFGHIKLMNPQRSTVWY"
    amb = b"N" if alphabet is Alphabet.NUCLEOTIDE else b"X"
    seq = bytes(rng.choice(np.frombuffer(letters, dtype=np.uint8), size=n))
    index = build_from_records([("a", amb * 40 + seq[: n // 2]), ("b", seq[n // 2 :] + amb * 9)],
                               FmBuildArgs(alphabet=alphabet, lookup_table_kmer_len=4,
                                           suffix_array_compression_ratio=sa_ratio))
    path = str(tmp_path / "i.awry")
    save_awry(index, path)
    return load_awry(path, device="cpu"), path, seq, rng


@pytest.mark.cuda
@pytest.mark.parametrize("alphabet", [Alphabet.NUCLEOTIDE, Alphabet.AMINO])
@pytest.mark.parametrize("sa_ratio", [1, 8, 32])
def test_sampled_walk_matches_plain(card, alphabet, sa_ratio, tmp_path):
    """sampled_walk equals its plain version on every row of a built index
    without marks, and on rows past either end (clamped)."""
    index, _, _, _ = _markless(alphabet, sa_ratio, tmp_path)
    tdev = to_device(index, "cpu")
    n = tdev.bwt_len
    rows = torch.from_numpy(np.concatenate([np.arange(n), [-4, n, n + 300]]))
    tables = [t.to(card) for t in (tdev.blocks, tdev.prefix_sums, tdev.codes, tdev.c2i)]
    tail = (tdev.num_planes, alphabet.ambiguity_idx, sa_ratio, tdev.sampled_sa.to(card), n)
    n0 = kernels.sampled_walk.launches
    got = kernels.sampled_walk(tables[0], rows.to(card), *tables[1:], *tail)
    assert kernels.sampled_walk.launches == n0 + 1
    want = kernels.sampled_walk_plain(tdev.blocks, rows, tdev.prefix_sums, tdev.codes, tdev.c2i, *tail[:3],
                                      tdev.sampled_sa, n)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_markless_engine_and_load_on_card(card, tmp_path):
    """load_awry on the card re-derives the k-mer table through occ, equal
    to the CPU's; the mark-less engine on the card (classic path, one
    sampled_walk per walk) gives the CPU engine's answers."""
    index, path, seq, rng = _markless(Alphabet.NUCLEOTIDE, 8, tmp_path)
    o0 = kernels.occ.launches
    on_card_index = load_awry(path, device=card)
    assert kernels.occ.launches > o0
    np.testing.assert_array_equal(on_card_index.kmer_table, index.kmer_table)
    queries = [seq[s : s + 25] for s in rng.integers(0, len(seq) - 25, size=3000)]
    queries += [seq[10:14] * 3, b"ACGTNACGTNAC", b"AC", b"", seq[100:108], b"N" * 12]
    on_card, on_cpu = FmQueryEngine(on_card_index, device=card), FmQueryEngine(index, device="cpu")
    w0, p0 = kernels.sampled_walk.launches, kernels.occ_pair.launches
    got = on_card.count_locate_arrays(queries, cap=2)
    assert kernels.sampled_walk.launches > w0 and kernels.occ_pair.launches > p0
    for x, y in zip(got, on_cpu.count_locate_arrays(queries, cap=2)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_fm_index_on_card(card, tmp_path):
    """The facade on the card (its default device) answers as on the CPU;
    update_range_with_symbol launches occ_pair and backstep launches
    backstep."""
    rng = np.random.default_rng(12)
    seq = bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=20_000))
    data = build_from_records([("r", seq)], FmBuildArgs(lookup_table_kmer_len=5))
    fm, ref = FmIndex(data), FmIndex(data, device="cpu")
    assert fm.device.type == "cuda"
    for s in rng.integers(0, len(seq) - 16, size=20):
        q = seq[s : s + 16]
        assert fm.count_string(q) == ref.count_string(q)
        assert fm.locate_string(q) == ref.locate_string(q)
    qs = [seq[s : s + 12] for s in rng.integers(0, len(seq) - 12, size=100)]
    np.testing.assert_array_equal(fm.parallel_count(qs), ref.parallel_count(qs))
    assert fm.parallel_locate(qs) == ref.parallel_locate(qs)
    b0, p0 = kernels.backstep.launches, kernels.occ_pair.launches
    row = want = 0
    for _ in range(50):
        row, want = fm.backstep(row), ref.backstep(want)
        assert row == want
    assert kernels.backstep.launches == b0 + 50
    g = Symbol.new_ascii(Alphabet.NUCLEOTIDE, "G")
    r, r_cpu = fm.initial_search_range(g), ref.initial_search_range(g)
    assert r == r_cpu
    for ch in "ACGTT":
        sym = Symbol.new_ascii(Alphabet.NUCLEOTIDE, ch)
        r, r_cpu = fm.update_range_with_symbol(r, sym), ref.update_range_with_symbol(r_cpu, sym)
        assert r == r_cpu
    assert kernels.occ_pair.launches == p0 + 5


def _walk_lengths(tdev, rows):
    """LF steps each row's row-sampled walk takes (plain LF steps)."""
    pos = rows.clone()
    steps = torch.zeros_like(pos)
    live = pos % tdev.sa_ratio != 0
    lf = (tdev.prefix_sums, tdev.codes, tdev.c2i, tdev.num_planes, tdev.mark_offset, tdev.alphabet.ambiguity_idx)
    while live.any():
        pos[live] = kernels.backstep_plain(tdev.blocks, pos[live], *lf)[0]
        steps[live] += 1
        live &= pos % tdev.sa_ratio != 0
    return steps


@pytest.mark.cuda
@pytest.mark.parametrize("alphabet", [Alphabet.NUCLEOTIDE, Alphabet.AMINO])
@pytest.mark.parametrize("sa_ratio", [8, 32])
def test_sampled_walk_ranges_matches_plain(card, alphabet, sa_ratio, tmp_path):
    """The range-fed walk equals its plain version: ranges tiling every row
    of a built index (every slot live), every slot idle, ranges of every
    count class (0, 1, cap, over cap) reaching past bwt_len, and a single
    query whose one walk is the index's longest; each launch counts once
    under sampled_walk."""
    index, _, _, rng = _markless(alphabet, sa_ratio, tmp_path)
    tdev = to_device(index, "cpu")
    n, cap = tdev.bwt_len, 8
    tables = [t.to(card) for t in (tdev.blocks, tdev.prefix_sums, tdev.codes, tdev.c2i)]
    tail = (tdev.num_planes, alphabet.ambiguity_idx, sa_ratio, tdev.sampled_sa, n)
    longest = int(_walk_lengths(tdev, torch.arange(n)).argmax())
    tiles = torch.arange(0, n, cap)
    batches = {
        "every slot live": (tiles, torch.full_like(tiles, cap)),
        "every slot idle": (tiles, torch.zeros_like(tiles)),
        "count classes": (torch.from_numpy(rng.integers(n - 3000, n + 5, 4099)),
                          torch.from_numpy(np.resize(np.array([0, 1, cap, cap + 7, 3]), 4099))),
        "the longest walk": (torch.tensor([longest]), torch.tensor([1])),
    }
    for name, (starts, counts) in batches.items():
        want = kernels.sampled_walk_ranges_plain(tdev.blocks, starts, counts, cap, tdev.prefix_sums, tdev.codes,
                                                 tdev.c2i, *tail)
        n0 = kernels.sampled_walk.launches
        got = kernels.sampled_walk_ranges(tables[0], starts.to(card), counts.to(card), cap, *tables[1:],
                                          tail[0], tail[1], tail[2], tail[3].to(card), n)
        assert kernels.sampled_walk.launches == n0 + 1
        assert torch.equal(got.cpu(), want), name


@pytest.mark.cuda
def test_markless_capped_locate_does_not_sync(card, tmp_path):
    """count_locate_capped_t on an index without marks, with the crumb
    wire's flags, runs with no host sync (set_sync_debug_mode("error")
    raises on one, naming the call), and gives the CPU's answers."""
    index, _, seq, rng = _markless(Alphabet.NUCLEOTIDE, 8, tmp_path)
    on_card, on_cpu = FmQueryEngine(index, device=card), FmQueryEngine(index, device="cpu")
    queries = [seq[s : s + 30] for s in rng.integers(0, len(seq) - 30, size=4000)] + [seq[10:14] * 3]
    wire, qlens = on_card.encode_queries(queries)
    qt, ql, flags = on_card._upload(wire, qlens)
    assert flags["no_sentinel"] and flags["seeded_floor"]
    torch.cuda.synchronize(card)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = count_locate_capped_t(on_card.device_index, qt, ql, 8, **flags)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = count_locate_capped_t(on_cpu.device_index, *on_cpu._upload(wire, qlens)[:2], 8, **flags)
    for x, y in zip(out, want):
        assert torch.equal(x.cpu(), y)


# -- the wide variants (64-bit engine) and the federation -----------------------


def _wide_tables(card, alphabet, nb, shift, seed, walkable=False):
    """Synthetic wide rows on the card: random planes and marks, relative
    milestones below 2**24, group bases and prefix sums past 2**32.
    ``walkable``: relative milestones 0 and bases that take an LF step from
    group g into the last block of group g - 1, so every sampled walk ends."""
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    v, c = alphabet.num_planes, alphabet.cardinality
    blocks = torch.randint(-(2**31), 2**31, (nb, fused_row_words(alphabet)), device=card, generator=gen)
    blocks = blocks.to(torch.int32)
    blocks[:, v * 8 : v * 8 + c] = 0 if walkable else torch.randint(0, 2**24, (nb, c), device=card, generator=gen,
                                                                    dtype=torch.int32)
    blocks[:, v * 8 + c + 8] = torch.randint(0, 2**24, (nb,), device=card, generator=gen, dtype=torch.int32)
    groups = -(-nb // (1 << shift))
    prefix = torch.randint(2**32, 2**34, (c + 1,), device=card, generator=gen).sort().values
    if walkable:
        g = torch.arange(groups, device=card)[:, None]
        ms_base = g * (256 << shift) - 255 - prefix[None, :c]
    else:
        ms_base = torch.randint(2**32, 2**40, (groups, c), device=card, generator=gen)
    marks = torch.randint(0, 2**36, (groups,), device=card, generator=gen)
    codes = torch.from_numpy(index_to_code_table(alphabet).astype(np.int32)).to(card)
    c2i = torch.from_numpy(code_to_index_table(alphabet).astype(np.int32)).to(card)
    return blocks, kernels.WideBases(ms_base.contiguous(), marks, shift), prefix, codes, c2i


@pytest.mark.cuda
@pytest.mark.parametrize("alphabet", [Alphabet.NUCLEOTIDE, Alphabet.AMINO])
def test_wide_kernels_match_plain(card, alphabet):
    """occ_pair_wide, backstep_wide, marked_walk_wide (marks 4 and 32) and
    sampled_walk_wide with its range-fed entry (sa_ratio 8 and 12) against
    their plain versions on the card: nucleotide over 2**24 + 300 blocks
    (positions past 2**32), amino over 2**18 blocks in groups of 16; bases,
    prefix sums and SA values past 2**32; rows 0, block edges, the last row
    and rows past either end."""
    nb, shift = (2**24 + 300, 16) if alphabet is Alphabet.NUCLEOTIDE else (2**18, 4)
    v, c = alphabet.num_planes, alphabet.cardinality
    top = nb * 256
    blocks, bases, prefix, codes, c2i = _wide_tables(card, alphabet, nb, shift, 31)
    rng = np.random.default_rng(32)
    edges = [0, 255, 256, top - 1, top + 7, -3, 2**32 - 1, 2**32]
    pos = torch.from_numpy(np.concatenate([edges, rng.integers(0, top, size=20_000)]).astype(np.int64)).to(card)
    pos_b = (pos + torch.randint(0, 600, pos.shape, device=card)).clamp_max(top - 1)
    sym = torch.randint(0, c, pos.shape, device=card, dtype=torch.int32)
    n0 = kernels.occ_pair_wide.launches
    got = kernels.occ_pair_wide(blocks, bases, pos, pos_b, sym, codes, v)
    assert kernels.occ_pair_wide.launches == n0 + 1
    want = kernels.occ_pair_wide_plain(blocks, bases, pos, pos_b, sym, codes, v)
    assert all(torch.equal(g, w) for g, w in zip(got, want)) and int(got[0].max()) >= 2**32
    args = (prefix, codes, c2i, v, v * 8 + c, alphabet.ambiguity_idx)
    got = kernels.backstep_wide(blocks, bases, pos, *args)
    want = kernels.backstep_wide_plain(blocks, bases, pos, *args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    bwt_len = top - 3
    for mark in (4, 32):
        sa = torch.randint(2**32 if bwt_len > 2**32 else 0, bwt_len, (-(-bwt_len // mark),), device=card)
        walk = (blocks, bases, pos, *args, mark, sa, bwt_len)
        assert torch.equal(kernels.marked_walk_wide(*walk), kernels.marked_walk_wide_plain(*walk)), mark
        del sa
    blocks, bases, prefix, codes, c2i = _wide_tables(card, alphabet, nb, shift, 33, walkable=True)
    counts = torch.from_numpy(rng.integers(0, 5, size=pos.shape[0])).to(card)
    for sa_ratio in (8, 12):
        sa = torch.randint(0, bwt_len, (-(-bwt_len // sa_ratio),), device=card)
        tail = (prefix, codes, c2i, v, alphabet.ambiguity_idx, sa_ratio, sa, bwt_len)
        n0 = kernels.sampled_walk_wide.launches
        got = kernels.sampled_walk_wide(blocks, bases, pos, *tail)
        assert torch.equal(got, kernels.sampled_walk_wide_plain(blocks, bases, pos, *tail)), sa_ratio
        got = kernels.sampled_walk_ranges_wide(blocks, bases, pos, counts, 3, *tail)
        want = kernels.sampled_walk_ranges_wide_plain(blocks, bases, pos, counts, 3, *tail)
        assert torch.equal(got, want) and kernels.sampled_walk_wide.launches == n0 + 2, sa_ratio
        del sa


@pytest.mark.cuda
@pytest.mark.parametrize("marks", [True, False])
def test_wide_engine_on_card(card, marks, tmp_path, monkeypatch):
    """FmQueryEngine(wide=True) on the card, milestone groups of 2 blocks,
    gives the CPU's answers, marked (mark 4) and without marks (a .awry
    load); its search with every step masked (count_batch_dispatch's) makes
    no host sync."""
    import awry_tpu_torch.ops.wide as wide_mod
    from awry_tpu_torch.ops.search import count_batch_kernel_t

    monkeypatch.setattr(wide_mod, "GROUP_SHIFT", 1)
    rng = np.random.default_rng(34)
    seq = bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=40_000))
    index = build_from_records([("a", seq[:25_000]), ("b", seq[25_000:])],
                               FmBuildArgs(lookup_table_kmer_len=4, locate_mark_ratio=4))
    if not marks:
        save_awry(index, str(tmp_path / "x.awry"))
        index = load_awry(str(tmp_path / "x.awry"), device=card)
    on_card, on_cpu = FmQueryEngine(index, device=card, wide=True), FmQueryEngine(index, device="cpu", wide=True)
    queries = [seq[s : s + 20] for s in rng.integers(0, len(seq) - 20, size=3000)] + [seq[10:13], b"ACNGT"]
    for a, b in zip(on_card.count_locate_arrays(queries, cap=4), on_cpu.count_locate_arrays(queries, cap=4)):
        assert np.array_equal(a, b)
    wire, qlens = on_card.encode_queries(queries)
    assert wire.dtype == np.uint8  # the nibble wire: no seeded floor
    qt, ql, flags = on_card._upload(wire, qlens)
    torch.cuda.synchronize(card)
    torch.cuda.set_sync_debug_mode("error")
    try:
        counts = count_batch_kernel_t(on_card.device_index, qt, ql, **flags, skip_idle=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.array_equal(counts.cpu().numpy()[: len(queries)], on_cpu.count_batch(queries).astype(np.int64))


@pytest.mark.cuda
def test_partitioned_on_card(card):
    """PartitionedFmIndex with no device= serves on the card and gives the
    answers of device="cpu"."""
    from awry_tpu_torch.parallel import PartitionedFmIndex

    rng = np.random.default_rng(35)
    records = [(f"r{i}", bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=3000))) for i in range(8)]
    args = FmBuildArgs(lookup_table_kmer_len=4, locate_mark_ratio=32)
    fed = PartitionedFmIndex.build_from_records(records, args, max_partition_symbols=7000, max_query_len=32)
    on_cpu = PartitionedFmIndex.build_from_records(records, args, max_partition_symbols=7000, max_query_len=32,
                                                   device="cpu")
    text = b"N".join(s for _, s in records)
    queries = [text[s : s + 30] for s in rng.integers(0, len(text) - 30, size=2000)]
    for a, b in zip(fed.count_locate_arrays(queries), on_cpu.count_locate_arrays(queries)):
        assert np.array_equal(a, b)
    assert np.array_equal(fed.count_batch(queries[:300]), on_cpu.count_batch(queries[:300]))
    assert {p.engine.device.type for p in fed.partitions} == {"cuda"}


# -- occ_wide, the shard variants and multi-device serving -----------------------


@pytest.mark.cuda
@pytest.mark.parametrize("alphabet", [Alphabet.NUCLEOTIDE, Alphabet.AMINO])
def test_occ_wide_matches_plain(card, alphabet):
    """occ_wide against its plain version past 2**32 (nucleotide over 2**24
    + 300 blocks), on random positions (the direct branch) and on sorted
    runs a few positions apart (the staged branch), symbols past the
    alphabet among them; and against the narrow occ plus the group base."""
    nb, shift = (2**24 + 300, 16) if alphabet is Alphabet.NUCLEOTIDE else (2**18, 4)
    v, c = alphabet.num_planes, alphabet.cardinality
    top = nb * 256
    blocks, bases, _, codes, _ = _wide_tables(card, alphabet, nb, shift, 41)
    rng = np.random.default_rng(42)
    edges = [0, 255, 256, top - 1, top + 7, -3, 2**32 - 1, 2**32, 2**32 + 256]
    random = np.concatenate([edges, rng.integers(0, top, size=20_000)]).astype(np.int64)
    mid = min(2**32, top // 2)  # the sorted runs cross 2**32 on the nucleotide table
    runs = np.sort(rng.integers(mid - 40_000, mid + 40_000, size=(4, 5000)), axis=1).reshape(-1)
    for pos_np in (random, runs):
        pos = torch.from_numpy(pos_np).to(card)
        sym = torch.from_numpy(rng.integers(-1, c + 1, size=pos.shape[0]).astype(np.int32)).to(card)
        n0 = kernels.occ_wide.launches
        got = kernels.occ_wide(blocks, bases, pos, sym, codes, v)
        assert kernels.occ_wide.launches == n0 + 1 and got.dtype == torch.int64
        assert torch.equal(got, kernels.occ_wide_plain(blocks, bases, pos, sym, codes, v))
        s = sym.clamp(0, c - 1).to(torch.int64)
        p = pos.clamp(0, top - 1)
        narrow = kernels.occ(blocks, pos, sym, codes, v).to(torch.int64) & 0xFFFFFFFF
        assert torch.equal(got, narrow + bases.milestones[p >> (8 + shift), s])
        if alphabet is Alphabet.NUCLEOTIDE:
            assert int(got.max()) >= 2**32


def _windows(nb, shards):
    per = -(-nb // shards)
    return [(min(i * per, nb), min((i + 1) * per, nb)) for i in range(shards)]


@pytest.mark.cuda
@pytest.mark.parametrize("alphabet", [Alphabet.NUCLEOTIDE, Alphabet.AMINO])
@pytest.mark.parametrize("shards", [1, 2, 3, 5])
def test_shard_kernels_match_plain(card, alphabet, shards):
    """occ_pair_shard and sampled_walk_shard on views of one table equal
    their plain versions call by call, write only what their window owns,
    and over the windows give one narrow rank.update_range and (in rounds)
    the narrow sampled_walk's positions, with row 0, the last row, block
    and shard edges, and positions below 0 and past the end."""
    from awry_tpu_torch.ops import rank
    from awry_tpu_torch.parallel.sharding import Shard, walk_rounds

    rng = np.random.default_rng(43 + shards)
    index = build_from_records([("x", _random_text(alphabet, 60_000, rng))],
                               FmBuildArgs(alphabet=alphabet, lookup_table_kmer_len=4,
                                           suffix_array_compression_ratio=16))
    markless = dataclasses.replace(index, mark_bits=None, mark_milestones=None, text_sampled_sa=None, mark_ratio=0)
    tdev = to_device(markless, card)
    blocks = tdev.blocks
    nb = blocks.shape[0]
    codes, c2i, prefix = tdev.codes, tdev.c2i, tdev.prefix_sums
    v, amb = tdev.num_planes, alphabet.ambiguity_idx
    windows = _windows(nb, shards)
    top = nb * 256
    edges = [0, top - 1, top, top + 17, -1, -300, 255, 256]
    edges += [e for lo, hi in windows for e in (lo * 256 - 1, lo * 256, hi * 256 - 1, hi * 256)]
    pos = torch.from_numpy(np.concatenate([edges, rng.integers(0, top, size=20_000)]).astype(np.int64)).to(card)
    starts, ends = pos + 1, pos + torch.from_numpy(rng.integers(0, 9, size=pos.shape[0])).to(card)
    sym = torch.from_numpy(rng.integers(-1, alphabet.cardinality + 1, size=pos.shape[0]).astype(np.int32)).to(card)
    want = rank.update_range(tdev, starts, ends, sym.clamp(0, alphabet.cardinality - 1))
    new = (torch.full_like(starts, -1), torch.full_like(ends, -1))
    cpu = lambda *ts: [t.cpu() for t in ts]  # noqa: E731
    for lo, hi in windows:
        view = blocks[lo:hi]
        before = cpu(*new)
        n0 = kernels.occ_pair_shard.launches
        kernels.occ_pair_shard(view, lo, nb, starts, ends, sym, codes, prefix, v, *new)
        assert kernels.occ_pair_shard.launches == n0 + (1 if hi > lo else 0)
        plain = kernels.occ_pair_shard_plain(*cpu(view), lo, nb, *cpu(starts, ends, sym, codes, prefix), v, *before)
        for got, w in zip(new, plain):
            assert torch.equal(got.cpu(), w)
    assert torch.equal(new[0], want[0]) and torch.equal(new[1], want[1])

    shs = [Shard(blocks[lo:hi], lo, codes, c2i, prefix) for lo, hi in windows]
    rows = torch.cat([torch.arange(0, tdev.bwt_len, 7, device=card), torch.tensor([0, 16, -2], device=card),
                      torch.tensor([tdev.bwt_len - 1, tdev.bwt_len + 4], device=card)])
    walk = (v, amb, tdev.sa_ratio, tdev.bwt_len)
    r, s = rows.clamp(0, tdev.bwt_len - 1), torch.from_numpy(rng.integers(0, 3, size=rows.shape[0])).to(card)
    for i, sh in enumerate(shs):
        before = cpu(r, s)
        n0 = kernels.sampled_walk_shard.launches
        # Every other shard's launch is given its zeroed work counter.
        cursor = torch.zeros(1, dtype=torch.int64, device=card) if i % 2 else None
        kernels.sampled_walk_shard(sh.blocks, sh.first_block, nb, r, s, prefix, codes, c2i, *walk, cursor=cursor)
        assert kernels.sampled_walk_shard.launches == n0 + (1 if sh.blocks.shape[0] else 0)
        plain = kernels.sampled_walk_shard_plain(*cpu(sh.blocks), sh.first_block, nb, *before, *cpu(prefix, codes, c2i),
                                                 *walk)
        assert torch.equal(r.cpu(), plain[0]) and torch.equal(s.cpu(), plain[1])
    with pytest.raises(ValueError, match="cursor"):
        kernels.sampled_walk_shard(blocks, 0, nb, r, s, prefix, codes, c2i, *walk,
                                   cursor=torch.zeros(1, dtype=torch.int32, device=card))
    final, steps, rounds = walk_rounds(shs, nb, rows, *walk)
    assert [n for n, _ in rounds] == sorted((n for n, _ in rounds), reverse=True)
    got = kernels._text_pos_mod(kernels._sa_values(kernels.window_read, tdev.sampled_sa, final // tdev.sa_ratio),
                                steps, tdev.bwt_len)
    want_pos = kernels.sampled_walk(blocks, rows, prefix, codes, c2i, v, amb, tdev.sa_ratio, tdev.sampled_sa,
                                    tdev.bwt_len)
    assert torch.equal(got, want_pos)


@pytest.mark.cuda
def test_multi_device_engines_on_card(card):
    """ShardedFmEngine on ["cuda:0"] * 4 (Mode B, 4 shards; Mode A, 4 data
    slots) and FmQueryEngine(mesh=["cuda:0"] * 2) give FmQueryEngine's
    answers on the card, through the shard kernels in Mode B."""
    from awry_tpu_torch.parallel import ShardedFmEngine, make_mesh

    rng = np.random.default_rng(47)
    seq = bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=80_000))
    index = build_from_records([("a", seq[:50_000]), ("b", seq[50_000:])],
                               FmBuildArgs(lookup_table_kmer_len=6, locate_mark_ratio=1))
    single = FmQueryEngine(index, device=card)
    queries = [seq[s : s + 25] for s in rng.integers(0, len(seq) - 25, size=5000)] + [seq[10:14], b"ACNGT", b""]
    want = single.count_locate_arrays(queries, cap=8)
    n0 = (kernels.occ_pair_shard.launches, kernels.sampled_walk_shard.launches)
    mode_b = ShardedFmEngine(index, make_mesh(devices=[card] * 4, shard_size=4))
    for got, w in zip(mode_b.count_locate_arrays(queries), want, strict=True):
        assert np.array_equal(got, w)
    assert kernels.occ_pair_shard.launches > n0[0] and kernels.sampled_walk_shard.launches > n0[1]
    assert np.array_equal(mode_b.count_batch(queries), want[0])
    mode_a = ShardedFmEngine(index, make_mesh(devices=[card] * 4))
    for got, w in zip(mode_a.count_locate_arrays(queries), want, strict=True):
        assert np.array_equal(got, w)
    mesh_engine = FmQueryEngine(index, mesh=make_mesh(devices=[card] * 2))
    for got, w in zip(next(mesh_engine.count_locate_stream([queries], cap=8)), want, strict=True):
        assert np.array_equal(got, w)
    assert make_mesh().shape["data"] == torch.cuda.device_count()
