"""The CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device and imports nothing of the JAX package, so it runs on a
machine without JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -m cuda

On the CPU every test here skips."""

import numpy as np
import pytest
import torch

from awry_tpu_torch import Alphabet, FmBuildArgs, build_from_records
from awry_tpu_torch.ops import FmQueryEngine, kernels, lf_walk, populate_kmer_table_device, to_device


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    return torch.device("cuda", 0)


def _device_index(alphabet, n, seed, mark_ratio=1):
    rng = np.random.default_rng(seed)
    letters = b"ACGT" if alphabet is Alphabet.NUCLEOTIDE else b"ACDEFGHIKLMNPQRSTVWY"
    seq = bytes(rng.choice(np.frombuffer(letters, dtype=np.uint8), size=n))
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
@pytest.mark.parametrize("alphabet", [Alphabet.NUCLEOTIDE, Alphabet.AMINO])
def test_backstep_matches_plain(card, alphabet):
    tdev, rng = _device_index(alphabet, 60_000, 3, mark_ratio=4)
    args = [t.to(card) for t in (tdev.blocks, tdev.prefix_sums, tdev.codes, tdev.c2i)]
    n = tdev.bwt_len
    rows = torch.from_numpy(np.concatenate([[0, n - 1, n + 300, -4], rng.integers(0, n, size=4095)])).to(card)
    tail = (tdev.num_planes, tdev.mark_offset, alphabet.ambiguity_idx)
    n0 = kernels.backstep.launches
    got = kernels.backstep(args[0], rows, *args[1:], *tail)
    assert kernels.backstep.launches == n0 + 1
    want = kernels.backstep_plain(args[0], rows, *args[1:], *tail)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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
