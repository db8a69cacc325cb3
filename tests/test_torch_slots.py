"""The port's occ kernel, device k-mer build and slot-verify regime against
the JAX package, on the CPU.

``occ`` runs its plain version here; the Pallas rank it replaces
(``occurrence_sweep``: ``_occ_kernel_anchored``, and ``_occ_kernel`` with
``USE_ANCHORED`` off) runs in interpret mode.  The device k-mer build runs
through ``occ``'s plain version on ``device="cpu"``.  The slot engine is
held to the JAX engine in its slot mode (``use_sweep=True``) and to the
host engine.  Indexes are built by the JAX package and carried over with
``from_numpy_index``; every comparison is exact integer equality."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import awry_tpu as jx
import awry_tpu.host_engine as he
import awry_tpu.ops.kmer as jkmer
import awry_tpu.ops.rank as jrank
import awry_tpu.ops.sweep as jsweep
import awry_tpu_torch as pt
import awry_tpu_torch.ops.kmer as tkmer
from awry_tpu.ops import FmQueryEngine as JaxEngine
from awry_tpu.ops import to_device as jax_to_device
from awry_tpu.ops.device_index import _build_verify_windows
from awry_tpu.ops.device_index import slot_regime_capable as jax_slot_capable
from awry_tpu_torch.ops import (
    FmQueryEngine,
    build_verify_windows,
    count_locate_slots_t,
    from_numpy_index,
    kernels,
    populate_kmer_table_device,
    rank,
    slot_regime_capable,
    to_device,
)
from awry_tpu_torch.ops.verify import SLOT_EXT, WIDE_CAP, unpack_verify_bundle, wide_groups

from .conftest import random_seq


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _u32(a):
    return jnp.asarray(a, dtype=jnp.uint32)


def _carry(jidx) -> pt.FmIndexData:
    """The JAX-built index as the port's FmIndexData (numpy arrays only)."""
    arrays, meta = {}, {}
    for f in dataclasses.fields(jidx):
        v = getattr(jidx, f.name)
        if isinstance(v, np.ndarray):
            arrays[f.name] = v
        else:
            meta[f.name] = v.name if f.name == "alphabet" else v
    return from_numpy_index(arrays, meta)


def _build(alphabet: str, n: int, k: int, seed: int, mark_ratio: int = 1):
    rng = np.random.default_rng(seed)
    ja = jx.Alphabet[alphabet]
    records = [("r0", random_seq(ja, rng, n))]
    jidx = jx.build_from_records(
        records, jx.FmBuildArgs(alphabet=ja, lookup_table_kmer_len=k, locate_mark_ratio=mark_ratio)
    )
    return jidx, _carry(jidx), records, rng


# -- occ ---------------------------------------------------------------------------


@pytest.mark.parametrize("anchored", [True, False])
@pytest.mark.parametrize("alphabet", ["NUCLEOTIDE", "AMINO"])
def test_occ_matches_occurrence_sweep(alphabet, anchored, monkeypatch):
    """occ equals occurrence_sweep (the anchored kernel :1108, or with
    USE_ANCHORED off its blocked twin :291) and the JAX plain-gather rank,
    at position 0, bwt_len - 1, block edges and random positions."""
    jidx, tidx, _, rng = _build(alphabet, 60_000, 4, seed=31)
    tdev = to_device(tidx, "cpu")
    n = jidx.bwt_len
    r = 4000  # not a multiple of the sweep's 128-lane chunk
    pos = rng.integers(0, n, size=r)
    pos[:8] = [0, n - 1, 255, 256, 511, 512, n - 2, 1]
    sym = rng.integers(0, jidx.alphabet.cardinality, size=r).astype(np.int32)

    got = kernels.occ(tdev.blocks, _t(pos), _t(sym), tdev.codes, tdev.num_planes).numpy().view(np.uint32)

    jdev = jax_to_device(jidx, build_sweep=True)
    monkeypatch.setattr(jsweep, "USE_ANCHORED", anchored)
    jax.clear_caches()  # the flag is read at trace time
    try:
        before = jsweep.TRACE_COUNTS["occurrence_sweep"]
        j_occ, cov = jsweep.occurrence_sweep(jdev, _u32(pos), jnp.asarray(sym), interpret=True)
        assert jsweep.TRACE_COUNTS["occurrence_sweep"] == before + 1
    finally:
        jax.clear_caches()
    assert np.asarray(cov).all()
    np.testing.assert_array_equal(got, np.asarray(j_occ))
    np.testing.assert_array_equal(got, np.asarray(jrank.occurrence(jdev, _u32(pos), jnp.asarray(sym))))
    np.testing.assert_array_equal(rank.occurrence(tdev, _t(pos), _t(sym)).numpy(), got.astype(np.int64))
    np.testing.assert_array_equal(rank.occurrence_plain(tdev, _t(pos), _t(sym)).numpy(), got.astype(np.int64))


def test_occ_clamps_and_routes_cpu_tensors_to_plain():
    """Positions past either end and symbols outside the alphabet clamp, in
    occ as in occ_pair; CPU tensors count no launch."""
    _, tidx, _, _ = _build("NUCLEOTIDE", 3_000, 3, seed=32)
    tdev = to_device(tidx, "cpu")
    last = tdev.blocks.shape[0] * 256 - 1
    pos = torch.tensor([-5, 0, last, last + 40, 700, 700])
    sym = torch.tensor([2, 2, 3, 3, -1, 99], dtype=torch.int32)
    want = torch.tensor([0, 0, last, last, 700, 700])
    card = tdev.codes.shape[0]
    want_sym = sym.clamp(0, card - 1)
    n0 = kernels.occ.launches
    got = kernels.occ(tdev.blocks, pos, sym, tdev.codes, tdev.num_planes)
    assert kernels.occ.launches == n0
    pair = kernels.occ_pair(tdev.blocks, want, want, want_sym, tdev.codes, tdev.num_planes)[0]
    np.testing.assert_array_equal(got.numpy(), pair.numpy())


# -- device k-mer build ----------------------------------------------------------------


@pytest.mark.parametrize("alphabet,k,cap", [
    ("NUCLEOTIDE", 1, None),
    ("NUCLEOTIDE", 3, None),
    ("NUCLEOTIDE", 5, None),
    ("AMINO", 2, None),
    ("NUCLEOTIDE", 4, 50),  # levels of 64 and 256 in chunks of 32
    ("AMINO", 2, 50),  # the level of 400 in chunks of 40
])
def test_device_kmer_table(alphabet, k, cap, monkeypatch):
    """populate_kmer_table_device on a minimal CPU index equals the JAX device
    build and host_engine.populate_kmer_table, through occ (never occ_pair);
    without k a minimal index raises; the builder flag gives the counting
    build's table, and without a card and without device= it raises."""
    jidx, tidx, records, _ = _build(alphabet, 800, k, seed=33 + k)
    if cap is not None:
        monkeypatch.setattr(tkmer, "_LEVEL_CHUNK", cap)
        monkeypatch.setattr(jkmer, "_LEVEL_CHUNK", cap)
        base = tidx.alphabet.num_encoding_symbols
        assert tkmer._level_chunk(base, base**k) < base**k  # a level of several chunks

    calls = []
    real_occ = kernels.occ

    def counting_occ(*args):
        calls.append(args[1].shape[0])
        return real_occ(*args)

    def refuse(*args):
        raise AssertionError("the k-mer build must rank through occ, not occ_pair")

    monkeypatch.setattr(kernels, "occ", counting_occ)
    monkeypatch.setattr(kernels, "occ_pair", refuse)
    minimal = to_device(tidx, "cpu", minimal=True)
    assert minimal.kmer_len == 0 and minimal.text_packed.numel() == 1
    got = populate_kmer_table_device(minimal, k)
    assert got.dtype == np.uint64 and (len(calls) > 0) == (k > 1)
    assert all(c % 2 == 0 for c in calls)  # [starts - 1, ends] of each chunk in one batch
    np.testing.assert_array_equal(got, he.populate_kmer_table(jidx))
    np.testing.assert_array_equal(got, jkmer.populate_kmer_table_device(jax_to_device(jidx, minimal=True), k))
    with pytest.raises(ValueError, match="kmer_len"):
        populate_kmer_table_device(minimal)

    args = pt.FmBuildArgs(alphabet=pt.Alphabet[alphabet], lookup_table_kmer_len=k, build_kmer_table_on_device=True)
    built = pt.build_from_records(records, args, device="cpu")
    counted = pt.build_from_records(records, dataclasses.replace(args, build_kmer_table_on_device=False))
    assert built.kmer_table.dtype == counted.kmer_table.dtype
    np.testing.assert_array_equal(built.kmer_table, counted.kmer_table)
    np.testing.assert_array_equal(built.kmer_table, jidx.kmer_table)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.build_from_records(records, args)


# -- slot rows and capability ------------------------------------------------------------


@pytest.mark.parametrize("alphabet,n,k", [("NUCLEOTIDE", 50_000, 8), ("AMINO", 30_000, 4)])
def test_slot_rows_match_reference(alphabet, n, k):
    """The slim fat rows (3 window words + SA, aligned at s = k) equal the
    reference's _build_verify_windows word for word, padding row included
    (bwt_len is odd here), and to_device ships exactly them."""
    jidx, tidx, _, _ = _build(alphabet, n, k, seed=34)
    assert jidx.bwt_len % 2 == 1
    want, s, w = _build_verify_windows(jidx, jidx.text_sampled_sa, s=k, row_words=4)
    assert (s, w) == (k, 3) and want.shape == (jidx.bwt_len + 1, 4)
    tdev = to_device(tidx, "cpu")
    bits = 4 if alphabet == "NUCLEOTIDE" else 8
    got = build_verify_windows(tdev.text_packed, tdev.text_sampled_sa, bits)
    np.testing.assert_array_equal(got.numpy().view(np.uint32).reshape(-1, 4), want)
    assert slot_regime_capable(tidx)
    np.testing.assert_array_equal(tdev.vw_flat.numpy(), got.numpy())
    assert (tdev.verify_windows_s, tdev.verify_windows_w, tdev.vw_row_words) == (k, 3, 4)
    assert to_device(tidx, "cpu", slots=False).vw_flat is None


@pytest.mark.parametrize("alphabet,n,k,mark,capable", [
    ("NUCLEOTIDE", 50_000, 8, 1, True),
    ("NUCLEOTIDE", 50_000, 4, 1, False),  # expected seed width 50,001 / 256
    ("NUCLEOTIDE", 50_000, 8, 4, False),  # marks too sparse for the fat row's SA
    ("NUCLEOTIDE", 3_000, 1, 1, False),  # k < 2
    ("AMINO", 20_000, 4, 1, True),
    ("AMINO", 20_000, 3, 1, False),  # 20,001 > 1.6 * 20**3
])
def test_slot_regime_capable_agrees(alphabet, n, k, mark, capable):
    jidx, tidx, _, _ = _build(alphabet, n, k, seed=35, mark_ratio=mark)
    assert slot_regime_capable(tidx) == jax_slot_capable(jidx) == capable
    eng = FmQueryEngine(tidx, device="cpu")
    assert eng._verify_slots == capable
    assert not FmQueryEngine(tidx, device="cpu", slots=False)._verify_slots


# -- the slot engine ---------------------------------------------------------------------

K = 8


@pytest.fixture(scope="module")
def slot_index():
    """50,000 symbols at k = 8, mark 1: a 60 bp segment pasted 3 times (multi-hit
    lanes); 8-mers planted after 12 bp prefixes: ``s_ext`` after 6 distinct
    prefixes (a seed width in the SLOT_EXT band, one true hit per query),
    ``s_multi`` after 6 prefixes with one prefix twice (band, 2 true hits)
    and ``s_over`` after 10 (width past SLOT_EXT)."""
    rng = np.random.default_rng(36)
    nuc = jx.Alphabet.NUCLEOTIDE
    seq = bytearray(random_seq(nuc, rng, 50_000))
    seg = bytes(seq[1000:1060])
    for r in range(3):
        seq[5000 + 4000 * r : 5060 + 4000 * r] = seg
    s_ext, s_multi, s_over = (random_seq(nuc, rng, K) for _ in range(3))
    pfx = [random_seq(nuc, rng, 12) for _ in range(SLOT_EXT + 2)]
    spot = 20_000
    plants = [(pfx[i], s_ext) for i in range(WIDE_CAP + 2)]
    plants += [(pfx[i], s_over) for i in range(SLOT_EXT + 2)]
    plants += [(pfx[1 if i == 2 else i], s_multi) for i in range(WIDE_CAP + 2)]
    for p, s in plants:
        seq[spot : spot + 20] = p + s
        spot += 600
    seq = bytes(seq)
    jidx = jx.build_from_records([("s", seq)], jx.FmBuildArgs(lookup_table_kmer_len=K, locate_mark_ratio=1))
    tidx = _carry(jidx)
    assert slot_regime_capable(tidx)
    assert WIDE_CAP < he.count(jidx, s_ext) <= SLOT_EXT and WIDE_CAP < he.count(jidx, s_multi) <= SLOT_EXT
    assert he.count(jidx, s_over) > SLOT_EXT
    ext = {"single": pfx[0] + s_ext, "multi": pfx[1] + s_multi, "over": pfx[0] + s_over}
    return seq, jidx, tidx, ext


def _query_mix(seq, ext, rng):
    """tests/test_slots.py's mix: drawn, multi-hit, over-cap, ambiguity,
    short, empty, G x 25, exactly k; plus the SLOT_EXT-band lanes."""
    queries = [seq[s : s + 25] for s in rng.integers(0, len(seq) - 25, size=2500)]
    queries += [
        seq[1010 : 1010 + 25], seq[1005 : 1005 + 30], seq[10:14] * 3, b"ACGTNACGTNAC",
        b"AC", b"", b"G" * 25, seq[100 : 100 + K],
        ext["single"], ext["multi"], ext["over"],
    ]
    return queries


@pytest.fixture(scope="module")
def slot_engines(slot_index):
    """Both engines in slot mode, two batches (the query mix; the band's
    single-hit lane among drawn single-hit reads) and the JAX engine's
    count_locate_stream output for them (computed once: each new batch
    shape costs the JAX engine a compile and an interpret-mode run)."""
    seq, jidx, tidx, ext = slot_index
    jeng = JaxEngine(jidx, use_sweep=True)
    assert jeng._verify_slots and jeng._verify_s == K
    eng = FmQueryEngine(tidx, device="cpu")
    assert eng._verify_slots and eng._verify_s == tidx.kmer_len == K
    assert eng._verify_max_len == K + 8 * 3
    rng = np.random.default_rng(37)
    mix = _query_mix(seq, ext, rng)
    # Drawn before the planted 8-mers (from 20,000 on), so no seed is theirs.
    single = [ext["single"]] + [seq[s : s + 20] for s in rng.integers(0, 19_000, size=200)]
    single = [q for q in single if he.count(jidx, q) == 1]
    assert single[0] == ext["single"]
    want = list(jeng.count_locate_stream([mix, single], cap=2))
    return eng, (mix, single), want


def _hits(result, i):
    counts, seq_idx, local, offsets = result
    return sorted(zip(seq_idx[offsets[i] : offsets[i + 1]].tolist(), local[offsets[i] : offsets[i + 1]].tolist()))


def _assert_same_answers(got, want, queries, jidx):
    for i, q in enumerate(queries):
        assert int(got[0][i]) == int(want[0][i]) == he.count(jidx, q), (i, q)
        assert _hits(got, i) == _hits(want, i) == sorted(he.locate(jidx, q)), (i, q)


def test_slot_engine_matches_jax_and_host(slot_index, slot_engines):
    _, jidx, _, _ = slot_index
    eng, (mix, _), want = slot_engines
    got = eng.count_locate_arrays(mix, cap=2)
    _assert_same_answers(got, want[0], mix, jidx)
    counts = got[0]
    assert int(counts[2500]) >= 3  # the pasted segment: multi-hit
    assert int(counts[-3]) == 1 and int(counts[-2]) == 2 and int(counts[-1]) == 1
    assert eng.stats["redis_lanes"] > 0 and eng.stats["multi_hit_queries"] > 0


def test_slot_engine_stream_settles_the_band(slot_index, slot_engines):
    """count_locate_stream: the mix, then a pre-encoded batch whose every
    lane has one hit, with the SLOT_EXT-band lane among them: that lane
    settles in the dispatch, so the batch takes the fast path with no
    re-dispatched lane."""
    _, jidx, _, _ = slot_index
    eng, (mix, single), want = slot_engines
    wire, qlens = eng.encode_queries(single)
    assert wire.dtype == np.int8  # crumb wire
    for key in eng.stats:
        eng.stats[key] = 0
    got = list(eng.count_locate_stream([mix, (wire, qlens, len(single))], cap=2))
    _assert_same_answers(got[0], want[0], mix, jidx)
    _assert_same_answers(got[1], want[1], single, jidx)
    assert eng.stats["fast_path_batches"] == 1 and eng.stats["redis_lanes"] > 0
    for key in eng.stats:
        eng.stats[key] = 0
    list(eng.count_locate_stream([single], cap=2))
    assert eng.stats["redis_lanes"] == 0 and eng.stats["fast_path_batches"] == 1


def test_slot_kernel_lane_flags(slot_index, slot_engines):
    """count_locate_slots_t's own flags: the exactly-k and the short lane
    with hits are re-dispatched (their positions are not walked), the empty
    lane and a missing read settle with 0, a drawn read settles with its
    position, the band's single-hit lane settles, its multi-hit and
    over-band lanes re-dispatch."""
    seq, jidx, _, ext = slot_index
    eng = slot_engines[0]
    queries = [seq[100 : 100 + K], seq[200:203], b"", b"T" * 25, seq[300:325],
               ext["single"], ext["multi"], ext["over"]]
    assert he.count(jidx, b"T" * 25) == 0
    wire, qlens = eng.encode_queries(queries)
    qt, ql, flags = eng._upload(wire, qlens)
    bundle, _, _ = count_locate_slots_t(eng.device_index, qt, ql, K, **flags)
    b = qt.shape[1]
    pos, counts, redis, _, _, _ = unpack_verify_bundle(bundle.numpy(), b, wide_groups(b))
    assert redis[:8].tolist() == [True, True, False, False, False, False, True, True]
    assert counts[2:6].tolist() == [0, 0, 1, 1]
    assert int(pos[4]) == 300 and int(pos[5]) == he.locate(jidx, ext["single"])[0][1]
    with pytest.raises(ValueError, match="seed step"):
        count_locate_slots_t(eng.device_index, qt, ql, K + 1, **flags)


def test_slot_long_queries_fall_back_and_switch_step_agrees(slot_index, slot_engines):
    """Queries longer than the fat window take the classic path per
    dispatch; slots=False serves the same index through the switch step
    with the same answers."""
    seq, jidx, tidx, ext = slot_index
    eng = slot_engines[0]
    long_q = [seq[i : i + 120] for i in range(0, 400, 40)]
    assert eng._wire_len(eng.encode_queries(long_q)[0]) > eng._verify_max_len
    before = eng.stats["verify_batches"]
    got = eng.count_locate_arrays(long_q, cap=2)
    assert eng.stats["verify_batches"] == before  # no verify batch
    for i, q in enumerate(long_q):
        assert int(got[0][i]) == he.count(jidx, q) and _hits(got, i) == sorted(he.locate(jidx, q))

    switch = FmQueryEngine(tidx, device="cpu", slots=False)
    assert not switch._verify_slots and switch._verify_s > K
    queries = _query_mix(seq, ext, np.random.default_rng(39))
    _assert_same_answers(eng.count_locate_arrays(queries), switch.count_locate_arrays(queries), queries, jidx)
