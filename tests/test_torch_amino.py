"""Amino serving: the port's engine against the JAX engine on a protein
index, on the CPU.

A two-record 20 kres amino index with X runs, at mark ratios 1 and 4 and
k-mer lengths 3 and 4, served by the port with the slot regime on and off
(it applies at mark 1, k 4) and by the JAX engine with plain gathers
(``use_sweep=False``).  The batches go over the raw int8 wire with 8-bit
text symbols: 12-mers, reads of a planted repeat, short and 30-residue
reads, '*' (not a residue: the ambiguity symbol), X runs, an empty query,
300-residue reads past the verify window (the classic path), and at k 4 a
batch of 12-mers alone (the slot regime's window).  Counts, hits and offsets must be
equal."""

import numpy as np
import pytest

import awry_tpu as jx
import awry_tpu.ops.engine as jengine
import awry_tpu_torch as pt
from awry_tpu.ops import FmQueryEngine as JaxEngine
from awry_tpu_torch.ops import FmQueryEngine, slot_regime_capable

from .conftest import random_seq

CAP = 8
SLAB = 4096  # the JAX engine's over-cap walk slab, cut from 8M rows


def _records():
    """~20 kres in two records: X runs at the ends and inside, a 50-residue
    unit planted 10 times (over the cap) and a 36-residue one 3 times."""
    rng = np.random.default_rng(41)
    seq = lambda n: random_seq(jx.Alphabet.AMINO, rng, n)  # noqa: E731
    unit10, unit3 = seq(50), seq(36)
    parts = []
    for i in range(10):
        parts += [seq(1_800), unit10, unit3 if i % 4 == 0 else b""]
    body = b"".join(parts)
    return [("sp|P1|first", b"X" * 12 + body[:11_000]), ("sp|P2|second", body[11_000:15_000] + b"XXXXX"
                                                          + body[15_000:] + b"X" * 8)], unit10, unit3


def _batches(records, unit10, unit3, twelve_mers: bool):
    rng = np.random.default_rng(42)
    text = records[0][1] + records[1][1]

    def draw(n, ln):
        return [text[s : s + ln] for s in rng.integers(0, len(text) - ln, size=n)]

    short = draw(120, 12) + draw(40, 30) + draw(20, 5) + draw(10, 2)
    short += [unit10[i : i + 12] for i in range(0, 36, 4)] + [unit3[i : i + 30] for i in range(0, 6, 2)]
    short += [b"", b"*", b"AC*DE", b"X" * 3, b"X" * 12, b"XXXXXACDEF", records[1][1][-14:], b"acdefg"]
    short += [random_seq(jx.Alphabet.AMINO, rng, 12) for _ in range(20)]
    long = draw(14, 300) + [records[0][1][:300], unit10 * 6]
    if not twelve_mers:
        return [short, long]
    # 12-mers alone pad to 16: the slot regime's window holds them.
    twelve = draw(200, 12) + [unit10[i : i + 12] for i in range(0, 38, 2)] + [b"X" * 12, b"AC*DEFGHIKLM"]
    return [short, long, twelve]


@pytest.fixture(scope="module", params=[(1, 3), (1, 4), (4, 3), (4, 4)], ids=lambda p: f"mark{p[0]}-k{p[1]}")
def amino(request):
    mark, k = request.param
    records, unit10, unit3 = _records()
    args = dict(alphabet=jx.Alphabet.AMINO, lookup_table_kmer_len=k, locate_mark_ratio=mark)
    jidx = jx.build_from_records(records, jx.FmBuildArgs(**args))
    tidx = pt.build_from_records(records, pt.FmBuildArgs(**{**args, "alphabet": pt.Alphabet.AMINO}))
    # The 12-mer batch at k 4 only: the slot regime needs it there, and at
    # mark 1, k 3 the JAX engine takes about 50 s to compile for it.
    batches = _batches(records, unit10, unit3, twelve_mers=k == 4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "_OVERCAP_WALK_SLAB", SLAB)
        jeng = JaxEngine(jidx, use_sweep=False)
        assert jeng._verify_enabled
        want = list(jeng.count_locate_stream(batches, cap=CAP))
    return mark, k, tidx, records, batches, want


@pytest.mark.parametrize("slots", [True, False], ids=["slots", "switch"])
def test_amino_stream_matches_jax(amino, slots):
    mark, k, tidx, records, batches, want = amino
    eng = FmQueryEngine(tidx, device="cpu", slots=slots)
    assert eng._verify_slots == (slots and slot_regime_capable(tidx))
    assert eng._verify_slots == (slots and (mark, k) == (1, 4))
    wire = eng.encode_queries(batches[0])[0]
    assert wire.dtype == np.int8 and wire.shape[1] == 32  # the raw wire
    got = list(eng.count_locate_stream(batches, cap=CAP))
    for b, (g, w) in enumerate(zip(got, want)):
        for name, x, y in zip(("counts", "seq_idx", "local", "offsets"), g, w):
            np.testing.assert_array_equal(x, np.asarray(y), err_msg=f"batch {b} {name}")
    counts = got[0][0]
    assert set(counts[190:199].tolist()) == {10} and set(counts[199:202].tolist()) == {3}
    # The 300-residue batch takes the classic path; so does the short one in
    # the slot regime, whose window (k + 12 residues) its 32-wide pad exceeds.
    assert eng.stats["verify_batches"] == len(batches) - 1 - eng._verify_slots
    if len(batches) == 3:
        assert set(got[2][0][200:219].tolist()) == {10}
    # Every hit spells its query ('*' and lowercase as canonicalized) in
    # the joined text, whose X delimiter between the records X runs match.
    text = records[0][1] + b"X" + records[1][1]
    starts = [0, len(records[0][1]) + 1]
    for b, (counts, seq_idx, local, offsets) in enumerate(got):
        for i, q in enumerate(batches[b]):
            canon = q.upper().replace(b"*", b"X")
            for s, p in zip(seq_idx[offsets[i] : offsets[i + 1]], local[offsets[i] : offsets[i + 1]]):
                assert text[starts[s] + p : starts[s] + p + len(q)] == canon
