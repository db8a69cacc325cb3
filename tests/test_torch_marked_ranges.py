"""The range-fed marked walk (``marked_walk_ranges`` and its wide twin) on
the CPU, against the JAX package's capped locate.

The classic path of a marked index walks its query ranges' live slots in
one ``marked_walk_ranges`` launch.  Its plain version (the padded rows
``starts + j``, or row 0, walked by ``marked_walk_plain``) must give the
JAX package's ``count_locate_capped_t`` text positions slot for slot: its
live slots are the hits, and every other slot holds row 0's walk, as the
JAX function writes there.  The JAX walk runs through ``_marked_walk``
(plain gathers: the device index is shipped without the sweep layout).
Indexes of about 20k to 60k symbols, nucleotide and amino, marks 2, 4 and
32, one text length per case that makes row 0 itself marked; queries with
no hit, with fewer hits than the cap and with more.  Every comparison is
exact; inputs come from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import awry_tpu as jx
import awry_tpu_torch as pt
import awry_tpu_torch.ops.wide as wide_mod
from awry_tpu.ops import to_device as jax_to_device
from awry_tpu.ops.engine import encode_query_batch
from awry_tpu.ops.locate import count_locate_capped_t as jax_count_locate_capped_t
from awry_tpu_torch.ops import count_locate_capped_t, counts_from_ranges, kernels, search_ranges_t, to_device

from .conftest import random_seq

K = 4
CAP = 4
AMBIGUITY = {"NUCLEOTIDE": b"N", "AMINO": b"X"}


def _case(alphabet: str, mark_ratio: int, n: int, row0_marked: bool, seed: int):
    """(JAX index, port index, the text's records, rng): three records with
    ambiguity runs at their ends, the last one's length chosen so that row
    0's SA value (bwt_len - 1) is a multiple of the mark ratio or not."""
    rng = np.random.default_rng(seed)
    amb = AMBIGUITY[alphabet]
    a, b = n // 2, n // 3
    seq = lambda size: random_seq(jx.Alphabet[alphabet], rng, size)  # noqa: E731
    head = [("r0", amb * 30 + seq(a)), ("r1", seq(b))]
    fixed = sum(len(s) for _, s in head) + 2  # two delimiters; the sentinel makes bwt_len one more
    rest = n - a - b
    # bwt_len - 1 = fixed + len(r2): pick len(r2) near `rest` on the wanted side of the mark ratio.
    rest += (-(fixed + rest)) % mark_ratio + (0 if row0_marked else 1)
    records = [*head, ("r2", seq(rest - 9) + amb * 9)]
    args = dict(lookup_table_kmer_len=K, locate_mark_ratio=mark_ratio)
    jidx = jx.build_from_records(records, jx.FmBuildArgs(alphabet=jx.Alphabet[alphabet], **args))
    tidx = pt.build_from_records(records, pt.FmBuildArgs(alphabet=pt.Alphabet[alphabet], **args))
    assert tidx.resolved_mark_ratio == mark_ratio
    assert ((tidx.bwt_len - 1) % mark_ratio == 0) == row0_marked
    return jidx, tidx, records, rng


def _queries(records, rng, count: int = 300) -> list[bytes]:
    """Reads of the text of lengths 2 to 25 (short ones hit more often than
    the cap, long ones once), reads with an ambiguity symbol and random
    reads (no hit)."""
    text = b"".join(s for _, s in records)
    lengths = rng.choice([2, 3, 5, 8, 12, 25], size=count)
    starts = rng.integers(0, len(text) - 26, size=count)
    queries = [text[s : s + ln] for s, ln in zip(starts.tolist(), lengths.tolist())]
    letters = np.frombuffer(text[40:400], dtype=np.uint8)
    queries += [bytes(rng.choice(letters, size=20)) for _ in range(24)]
    return queries


def _walk_tail(dev, mark_ratio: int) -> tuple:
    return (dev.prefix_sums, dev.codes, dev.c2i, dev.num_planes, dev.mark_offset, dev.alphabet.ambiguity_idx,
            mark_ratio, dev.text_sampled_sa, dev.bwt_len)


def _jax_capped(jidx, alphabet: str, queries, cap: int):
    """The JAX package's count_locate_capped_t over the encoded batch, as
    int64 numpy arrays (counts, text_pos, starts, ends), and the batch."""
    qsyms, qlens = encode_query_batch(jx.Alphabet[alphabet], queries)
    out = jax_count_locate_capped_t(jax_to_device(jidx), jnp.asarray(qsyms.T.astype(np.int32)), jnp.asarray(qlens), cap)
    return [np.asarray(x).astype(np.int64) for x in out], qsyms, qlens


@pytest.mark.parametrize("alphabet", ["NUCLEOTIDE", "AMINO"])
@pytest.mark.parametrize("mark_ratio,row0_marked", [(2, False), (4, True), (32, False), (32, True)])
def test_ranges_plain_equals_jax_capped_locate(alphabet, mark_ratio, row0_marked):
    """marked_walk_ranges_plain over the port's ranges of a batch equals the
    JAX count_locate_capped_t text positions in every slot; the batch has
    counts 0, below the cap and above it; the idle slots hold row 0's
    walk; the port's count_locate_capped_t on CPU tensors gives the JAX
    arrays and counts no launch."""
    jidx, tidx, records, rng = _case(alphabet, mark_ratio, 24_000, row0_marked, 100 + mark_ratio + row0_marked)
    queries = _queries(records, rng)
    (jcounts, jpos, jstarts, jends), qsyms, qlens = _jax_capped(jidx, alphabet, queries, CAP)
    counts = jcounts[: len(queries)]
    assert (counts == 0).any() and ((counts > 0) & (counts < CAP)).any() and (counts > CAP).any()

    dev = to_device(tidx, "cpu")
    qt, ql = torch.from_numpy(qsyms.T.astype(np.int32)), torch.from_numpy(qlens.astype(np.int64))
    starts, ends = search_ranges_t(dev, qt, ql)
    tcounts = counts_from_ranges(starts, ends)
    np.testing.assert_array_equal(tcounts.numpy(), jcounts)
    got = kernels.marked_walk_ranges_plain(dev.blocks, starts, tcounts, CAP, *_walk_tail(dev, mark_ratio))
    np.testing.assert_array_equal(got.numpy(), jpos)

    live = torch.arange(CAP)[None, :] < tcounts.clamp(0, CAP)[:, None]
    row0 = kernels.marked_walk_plain(dev.blocks, torch.zeros(1, dtype=torch.int64), *_walk_tail(dev, mark_ratio))
    assert (~live).any() and set(got[~live].tolist()) == {int(row0[0])}
    assert int(row0[0]) == dev.bwt_len - 1  # row 0's SA value: the sentinel's position

    before = (kernels.marked_walk.launches, kernels.marked_walk_ranges.launches)
    out = count_locate_capped_t(dev, qt, ql, CAP)
    assert (kernels.marked_walk.launches, kernels.marked_walk_ranges.launches) == before
    for x, want in zip(out, (jcounts, jpos, jstarts, jends)):
        np.testing.assert_array_equal(x.numpy(), want)


@pytest.mark.parametrize("alphabet", ["NUCLEOTIDE", "AMINO"])
def test_capped_locate_takes_the_ranges_entry(alphabet, monkeypatch):
    """count_locate_capped_t at mark ratio > 1 calls marked_walk_ranges once
    and builds no padded rows for the walk (kernels.slot_rows); at mark
    ratio 1 it keeps its one SA read over the padded rows."""
    jidx, tidx, records, rng = _case(alphabet, 4, 12_000, False, 7)
    dev = to_device(tidx, "cpu")
    qsyms, qlens = encode_query_batch(jx.Alphabet[alphabet], _queries(records, rng, 100))
    qt, ql = torch.from_numpy(qsyms.T.astype(np.int32)), torch.from_numpy(qlens.astype(np.int64))
    calls, outside, inside = [], [], [False]
    real, real_rows = kernels.marked_walk_ranges, kernels.slot_rows

    def ranges(*a):  # the call, and the padded rows its plain version builds on the CPU
        calls.append(a)
        inside[0] = True
        try:
            return real(*a)
        finally:
            inside[0] = False

    def rows(*a):
        if not inside[0]:
            outside.append(a)
        return real_rows(*a)

    monkeypatch.setattr(kernels, "marked_walk_ranges", ranges)
    monkeypatch.setattr(kernels, "slot_rows", rows)
    monkeypatch.setattr(kernels, "marked_walk", lambda *a: pytest.fail("the flat marked walk ran"))
    counts, text_pos, _, _ = count_locate_capped_t(dev, qt, ql, CAP)
    assert len(calls) == 1 and not outside and text_pos.shape == (qsyms.shape[0], CAP)
    monkeypatch.undo()
    one = pt.build_from_records(records, pt.FmBuildArgs(alphabet=pt.Alphabet[alphabet], lookup_table_kmer_len=K,
                                                        locate_mark_ratio=1))
    monkeypatch.setattr(kernels, "marked_walk_ranges", lambda *a: pytest.fail("the walk ran at mark ratio 1"))
    counts1, text_pos1, _, _ = count_locate_capped_t(to_device(one, "cpu"), qt, ql, CAP)
    live = torch.arange(CAP)[None, :] < counts.clamp(0, CAP)[:, None]
    assert torch.equal(counts1, counts) and torch.equal(text_pos1[live], text_pos[live])


@pytest.mark.parametrize("alphabet", ["NUCLEOTIDE", "AMINO"])
@pytest.mark.parametrize("mark_ratio", [2, 4, 32])
def test_ranges_wide_plain_equals_narrow(alphabet, mark_ratio, monkeypatch):
    """marked_walk_ranges_wide_plain on a wide-shipped copy of the index
    (groups of 2 blocks, so the group bases matter) equals
    marked_walk_ranges_plain on the narrow one, ranges past the end
    included; the wide count_locate_capped_t gives the narrow arrays."""
    monkeypatch.setattr(wide_mod, "GROUP_SHIFT", 1)
    _, tidx, records, rng = _case(alphabet, mark_ratio, 20_000, mark_ratio == 4, 300 + mark_ratio)
    narrow, wide = to_device(tidx, "cpu"), wide_mod.to_device_wide(tidx, "cpu")
    n = narrow.bwt_len
    b = 400
    starts = torch.from_numpy(rng.integers(0, n + 3, size=b))
    counts = torch.from_numpy(np.resize(np.array([0, 1, CAP - 1, CAP, CAP + 5]), b))
    want = kernels.marked_walk_ranges_plain(narrow.blocks, starts, counts, CAP, *_walk_tail(narrow, mark_ratio))
    got = kernels.marked_walk_ranges_wide_plain(wide.blocks, wide.bases, starts, counts, CAP,
                                                *_walk_tail(wide, mark_ratio))
    assert torch.equal(got, want)
    got = kernels.marked_walk_ranges_wide(wide.blocks, wide.bases, starts, counts, CAP, *_walk_tail(wide, mark_ratio))
    assert torch.equal(got, want)
    qsyms, qlens = encode_query_batch(jx.Alphabet[alphabet], _queries(records, rng, 120))
    qt, ql = torch.from_numpy(qsyms.T.astype(np.int32)), torch.from_numpy(qlens.astype(np.int64))
    for x, y in zip(count_locate_capped_t(wide, qt, ql, CAP), count_locate_capped_t(narrow, qt, ql, CAP)):
        assert torch.equal(x, y)


def test_ranges_refuse_a_bad_cap(monkeypatch):
    """Both ranges entries refuse a cap outside [1, 2**20] on any device, the
    CPU's plain path included."""
    monkeypatch.setattr(wide_mod, "GROUP_SHIFT", 1)
    _, tidx, _, _ = _case("NUCLEOTIDE", 4, 6_000, False, 9)
    narrow, wide = to_device(tidx, "cpu"), wide_mod.to_device_wide(tidx, "cpu")
    starts, counts = torch.zeros(3, dtype=torch.int64), torch.ones(3, dtype=torch.int64)
    for cap in (0, 2**20 + 1):
        with pytest.raises(ValueError, match="cap"):
            kernels.marked_walk_ranges(narrow.blocks, starts, counts, cap, *_walk_tail(narrow, 4))
        with pytest.raises(ValueError, match="cap"):
            kernels.marked_walk_ranges_wide(wide.blocks, wide.bases, starts, counts, cap, *_walk_tail(wide, 4))
