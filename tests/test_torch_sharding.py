"""The port's multi-device serving on the CPU: awry_tpu_torch's
``ShardedFmEngine`` (Mode A, replicated, and Mode B, range-sharded) and
``FmQueryEngine(mesh=...)`` over meshes of ``["cpu"] * n`` slots (every
kernel through its plain version), against the JAX package's host engine
and its ``ShardedFmEngine`` on the conftest's 8 virtual CPU devices; then
the shard kernels' plain versions over the windows against
rank.update_range and sampled_walk_plain on the whole table, the merge of
a shard on another device and the walk's step cap.  Twins of tests/test_sharding.py; every
comparison is exact, inputs come from numpy seeds."""

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import awry_tpu as jx
import awry_tpu.host_engine as he
import awry_tpu_torch as pt
from awry_tpu.parallel import ShardedFmEngine as JaxSharded
from awry_tpu_torch.alphabet import code_to_index_table, index_to_code_table
from awry_tpu_torch.ops import (
    FmQueryEngine,
    build_fused_blocks,
    from_numpy_index,
    fused_row_words,
    kernels,
    rank,
    to_device,
)
from awry_tpu_torch.parallel import DATA_AXIS, SHARD_AXIS, ShardedFmEngine, make_mesh
from awry_tpu_torch.parallel.distributed import make_global_mesh
from awry_tpu_torch.parallel import sharding
from awry_tpu_torch.parallel.sharding import MAX_ROUND_PASSES, Shard, merge_owned, round_passes, walk_rounds

from .conftest import random_seq
from .oracle import kmer_position_map, localize


def _to_port(jidx) -> pt.FmIndexData:
    names = [f.name for f in dataclasses.fields(jx.FmIndexData)]
    arrays = {k: getattr(jidx, k) for k in names if isinstance(getattr(jidx, k), np.ndarray)}
    meta = {k: getattr(jidx, k) for k in names if k not in arrays and k != "alphabet"}
    meta = {k: v for k, v in meta.items() if v is not None}
    return from_numpy_index(arrays, {"alphabet": jidx.alphabet.name, **meta})


def _build(alphabet, seed, n=900, kmer_len=3, sa_ratio=None, mark_ratio=None):
    rng = np.random.default_rng(seed)
    records = [("seq_0", random_seq(alphabet, rng, n))]
    args = jx.FmBuildArgs(alphabet=alphabet, lookup_table_kmer_len=kmer_len, suffix_array_compression_ratio=sa_ratio,
                          locate_mark_ratio=mark_ratio)
    jidx = jx.build_from_records(records, args)
    return jidx, _to_port(jidx), records[0][1]


def _cpu_mesh(n, shard_size=1):
    return make_mesh(devices=["cpu"] * n, shard_size=shard_size)


def _hits(res, i):
    counts, seq_idx, local, offsets = res
    return sorted(zip(seq_idx[offsets[i] : offsets[i + 1]].tolist(), local[offsets[i] : offsets[i + 1]].tolist()))


@pytest.mark.parametrize("shard_size", [1, 2, 4, 8])
def test_sharded_count_matches_host(shard_size):
    jidx, tidx, text = _build(jx.Alphabet.NUCLEOTIDE, 31, n=1100)
    engine = ShardedFmEngine(tidx, _cpu_mesh(8, shard_size))
    assert engine.num_shards == shard_size and engine.data_size == 8 // shard_size
    queries = list(kmer_position_map(text, 10).keys())[:64] + [b"GGGGGGGGGGGG", b"A", b""]
    got = engine.count_batch(queries)
    np.testing.assert_array_equal(got.astype(np.int64), [he.count(jidx, q) for q in queries])
    jgot = JaxSharded(jidx, shard_size=shard_size, use_sweep=False).count_batch(queries)
    np.testing.assert_array_equal(got, jgot)


@pytest.mark.parametrize("shard_size", [1, 4])
def test_sharded_locate_matches_host(shard_size):
    jidx, tidx, text = _build(jx.Alphabet.NUCLEOTIDE, 32, n=700, sa_ratio=8)
    engine = ShardedFmEngine(tidx, _cpu_mesh(8, shard_size))
    kmap = kmer_position_map(text, 7)
    queries = list(kmap.keys())[:48]
    for q, got in zip(queries, engine.locate_batch(queries)):
        assert sorted(got) == sorted(localize(kmap[q], jidx.seq_starts)), q


def test_sharded_amino():
    jidx, tidx, text = _build(jx.Alphabet.AMINO, 33, n=300, kmer_len=2)
    engine = ShardedFmEngine(tidx, _cpu_mesh(8, 2))
    kmap = kmer_position_map(text, 4)
    queries = list(kmap.keys())[:32]
    np.testing.assert_array_equal(engine.count_batch(queries).astype(np.int64), [len(kmap[q]) for q in queries])
    for q, got in zip(queries, engine.locate_batch(queries)):
        assert sorted(got) == sorted(he.locate(jidx, q)), q


def test_mesh_shapes_and_refusals():
    jidx, tidx, _ = _build(jx.Alphabet.NUCLEOTIDE, 34, n=600)
    mesh = make_mesh(num_devices=4, shard_size=2, devices=["cpu"] * 8)
    assert mesh.shape == {DATA_AXIS: 2, SHARD_AXIS: 2} and mesh.devices.shape == (2, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.reshape(-1))
    engine = ShardedFmEngine(tidx, mesh)
    assert engine.num_shards == 2 and engine.data_size == 2
    assert int(engine.count_batch([b"ACG"])[0]) == he.count(jidx, b"ACG")
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(devices=["cpu"] * 6, shard_size=4)
    with pytest.raises(ValueError, match="not divisible"):
        make_global_mesh(shard_size=3, devices=["cpu"] * 4)
    assert make_global_mesh(shard_size=2, devices=["cpu"] * 4).shape == {DATA_AXIS: 2, SHARD_AXIS: 2}
    with pytest.raises(ValueError, match="size 1"):
        FmQueryEngine(tidx, mesh=mesh)
    with pytest.raises(ValueError, match="power of two"):
        FmQueryEngine(tidx, mesh=_cpu_mesh(3))
    with pytest.raises(ValueError, match="not both"):
        FmQueryEngine(tidx, device="cpu", mesh=_cpu_mesh(2))
    if not torch.cuda.is_available():
        # No devices named: the CUDA devices, and no fallback to the CPU.
        for build in (make_mesh, make_global_mesh, lambda: ShardedFmEngine(tidx)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()


def test_range_sharding_actually_shards():
    """Each shard holds only its ceil-split range of blocks (the last two of
    8 shards over 12 blocks hold none), as views of one shipped tensor."""
    jidx, tidx, text = _build(jx.Alphabet.NUCLEOTIDE, 35, n=3000)
    engine = ShardedFmEngine(tidx, _cpu_mesh(8, 8))
    fused = torch.from_numpy(build_fused_blocks(tidx).view(np.int32))
    nb = fused.shape[0]
    assert nb == 12
    (shards,) = engine.shards
    per = -(-nb // 8)
    storage = {sh.blocks.untyped_storage().data_ptr() for sh in shards}
    assert len(storage) == 1
    for i, sh in enumerate(shards):
        lo, hi = min(i * per, nb), min((i + 1) * per, nb)
        assert sh.first_block == lo and sh.blocks.shape == (hi - lo, fused.shape[1])
        assert torch.equal(sh.blocks, fused[lo:hi])
    assert [sh.blocks.shape[0] for sh in shards] == [2, 2, 2, 2, 2, 2, 0, 0]
    queries = [text[i : i + 9] for i in range(0, 2900, 61)]
    np.testing.assert_array_equal(engine.count_batch(queries).astype(np.int64), [he.count(jidx, q) for q in queries])


def test_sharded_locate_cap_overflow():
    """Queries over locate_cap expand their rows and share one extra walk;
    count_locate_arrays equals the JAX engine's arrays."""
    jidx, tidx, text = _build(jx.Alphabet.NUCLEOTIDE, 36, n=800, kmer_len=2)
    queries = [b"A", b"AC", text[3:9], b"", b"ACGTN"]
    for shard_size in (1, 2):
        engine = ShardedFmEngine(tidx, _cpu_mesh(2 * shard_size, shard_size), locate_cap=2)
        res = engine.count_locate_arrays(queries)
        for i, q in enumerate(queries):
            assert _hits(res, i) == sorted(he.locate(jidx, q)), q
        jres = JaxSharded(jidx, shard_size=shard_size, locate_cap=2, use_sweep=False).count_locate_arrays(queries)
        for got, want in zip(res, jres, strict=True):
            np.testing.assert_array_equal(got, want)


def test_mode_b_count_locate_arrays_overflow():
    """Mode B's ragged assembly, the over-cap walk included, on a text whose
    3-mers are far over the cap, and on an index without marks."""
    jidx, tidx, text = _build(jx.Alphabet.NUCLEOTIDE, 37, n=3000, kmer_len=3, mark_ratio=4)
    queries = [text[i : i + 3] for i in range(0, 40, 5)] + [text[10:40], b"ACGTACGTACGT"]
    markless = dataclasses.replace(tidx, mark_bits=None, mark_milestones=None, text_sampled_sa=None, mark_ratio=0)
    for index in (tidx, markless):
        engine = ShardedFmEngine(index, _cpu_mesh(2, 2), locate_cap=2)
        counts, seq_idx, local, offsets = res = engine.count_locate_arrays(queries)
        for i, q in enumerate(queries):
            assert _hits(res, i) == sorted(he.locate(jidx, q)), q
            assert int(counts[i]) == he.count(jidx, q)
        # The single engine's arrays exactly: the same hits in BWT-row order.
        _same_results(res, FmQueryEngine(index, device="cpu").count_locate_arrays(queries, cap=2))


def _same_results(a, b):
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("slots", [2, 8])
def test_mesh_engine_matches_single(slots):
    """FmQueryEngine(mesh=...) over 2 and 8 slots gives the single engine's
    answers through count_batch, count_locate_arrays and
    count_locate_stream, on the crumb and the nibble wire, and its stats
    add up over the slices."""
    jidx, tidx, text = _build(jx.Alphabet.NUCLEOTIDE, 38, n=20_000, kmer_len=4, mark_ratio=1)
    rng = np.random.default_rng(39)
    starts = rng.integers(0, len(text) - 25, size=1000)
    pure = [text[s : s + 25] for s in starts] + [text[5:9] * 6, b"A", b""]
    with_n = [b"ACGTNACGT", b"NNN"] + pure[:37]
    mesh = _cpu_mesh(slots)
    eng = FmQueryEngine(tidx, mesh=mesh)
    ref = FmQueryEngine(tidx, device="cpu")
    assert eng._data_shards == slots and eng._verify_enabled
    assert {id(e) for e in eng._slot_engines} == {id(eng)}  # one device: one shipped copy
    for queries in (pure, with_n):
        np.testing.assert_array_equal(eng.count_batch(queries), ref.count_batch(queries))
        _same_results(eng.count_locate_arrays(queries, cap=2), ref.count_locate_arrays(queries, cap=2))
        np.testing.assert_array_equal(eng.count_batch(queries), [he.count(jidx, q) for q in queries])
    batches = [eng.encode_queries(pure) + (len(pure),), eng.encode_queries(with_n) + (len(with_n),)]
    assert batches[0][0].dtype == np.int8 and batches[1][0].dtype == np.uint8  # crumb, nibble
    for k in eng.stats:
        eng.stats[k] = ref.stats[k] = 0
    outs = list(eng.count_locate_stream(batches, cap=2))
    refs = list(ref.count_locate_stream(batches, cap=2))
    for o, r in zip(outs, refs, strict=True):
        _same_results(o, r)
    # A batch counts once, each of its verify slices as a verify batch; lane
    # counters add up to the same.
    assert eng.stats["queries"] == ref.stats["queries"] == len(pure) + len(with_n)
    assert eng.stats["batches"] == ref.stats["batches"] == len(batches)
    assert eng.stats["verify_batches"] == slots * ref.stats["verify_batches"]
    for key in ("multi_hit_queries",):
        assert eng.stats[key] == ref.stats[key]
    assert eng.stats["wide_lanes"] + eng.stats["redis_lanes"] == ref.stats["wide_lanes"] + ref.stats["redis_lanes"]
    np.testing.assert_array_equal(eng.count_batch_dispatch(batches[0]).numpy(),
                                  ref.count_batch_dispatch(batches[0]).numpy())
    assert eng.device_sustained_qps(batches, cap=2, trials=1) > 0


def _shard_windows(nb, shards):
    per = -(-nb // shards)
    return [(min(i * per, nb), min((i + 1) * per, nb)) for i in range(shards)]


def _random_rank_tables(a, rng, nb):
    blocks = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(nb, fused_row_words(a))).astype(np.int32))
    codes = torch.from_numpy(index_to_code_table(a).astype(np.int32))
    prefix = torch.from_numpy(np.sort(rng.integers(0, 2**31, size=a.cardinality + 1)).astype(np.int64))
    return blocks, codes, prefix


UNSET = -(2**62)  # no range update writes this


@pytest.mark.parametrize("alphabet", ["NUCLEOTIDE", "AMINO"])
@pytest.mark.parametrize("shards", [1, 2, 3, 5])
def test_shard_plain_versions_sum_to_narrow(alphabet, shards):
    """occ_pair_shard_plain over the windows writes each endpoint of the
    step's new ranges once, from the window that owns its (clamped) block,
    and together they equal rank.update_range on the whole table, with row
    0, the last row, block and shard edges, and positions below 0 and past
    the end among the requests; a symbol outside the alphabet is clamped."""
    a = pt.Alphabet[alphabet]
    rng = np.random.default_rng(40 + shards)
    nb = 13
    blocks, codes, prefix = _random_rank_tables(a, rng, nb)
    windows = _shard_windows(nb, shards)
    top = nb * 256
    edges = [0, top - 1, top, top + 17, -1, -300, 255, 256, 257]
    edges += [e for lo, hi in windows for e in (lo * 256 - 1, lo * 256, hi * 256 - 1, hi * 256)]
    pos = torch.tensor(edges + rng.integers(-5, top + 5, size=200).tolist(), dtype=torch.int64)
    starts = pos + 1
    ends = pos + torch.from_numpy(rng.integers(0, 600, size=pos.shape[0]))
    sym = torch.from_numpy(rng.integers(0, a.cardinality, size=pos.shape[0]).astype(np.int32))
    nplanes = a.num_planes
    narrow = SimpleNamespace(wide=False, blocks=blocks, codes=codes, num_planes=nplanes, prefix_sums=prefix)
    want = rank.update_range(narrow, starts, ends, sym)

    new = (torch.full_like(starts, UNSET), torch.full_like(ends, UNSET))
    for lo, hi in windows:
        view = blocks[lo:hi]
        alone = kernels.occ_pair_shard(view, lo, nb, starts, ends, sym, codes, prefix, nplanes,
                                       torch.full_like(starts, UNSET), torch.full_like(ends, UNSET))
        assert all(t.dtype == torch.int64 for t in alone)
        for out, p, prev in zip(alone, (starts - 1, ends), new):
            written = out != UNSET
            assert torch.equal(written, kernels.owned_by(p, lo, hi - lo, top))
            assert not (written & (prev != UNSET)).any()  # every entry has one owner
        new = kernels.occ_pair_shard(view, lo, nb, starts, ends, sym, codes, prefix, nplanes, *new)
        for out, got in zip(alone, new):
            assert torch.equal(got[out != UNSET], out[out != UNSET])
    assert torch.equal(new[0], want[0]) and torch.equal(new[1], want[1])

    wild = sym.clone()
    wild[::7] = -1
    wild[3::7] = a.cardinality + 2
    clamped = wild.clamp(0, a.cardinality - 1)
    for lo, hi in windows:
        got = kernels.occ_pair_shard(blocks[lo:hi], lo, nb, starts, ends, wild, codes, prefix, nplanes,
                                     torch.zeros_like(starts), torch.zeros_like(ends))
        ref = kernels.occ_pair_shard(blocks[lo:hi], lo, nb, starts, ends, clamped, codes, prefix, nplanes,
                                     torch.zeros_like(starts), torch.zeros_like(ends))
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def _sharded_tables(alphabet, seed, n, shards, sa_ratio):
    """A mark-less index's device tables on the CPU and its shards over
    the ceil-split windows (views of one fused table)."""
    _, tidx, _ = _build(alphabet, seed, n=n, kmer_len=2, sa_ratio=sa_ratio)
    markless = dataclasses.replace(tidx, mark_bits=None, mark_milestones=None, text_sampled_sa=None, mark_ratio=0)
    dev = to_device(markless, "cpu")
    nb = dev.blocks.shape[0]
    shards = [Shard(dev.blocks[lo:hi], lo, dev.codes, dev.c2i, dev.prefix_sums) for lo, hi in _shard_windows(nb, shards)]
    return dev, shards


def _walk_args(dev):
    return dev.num_planes, dev.alphabet.ambiguity_idx, dev.sa_ratio, dev.bwt_len


@pytest.mark.parametrize("alphabet", [jx.Alphabet.NUCLEOTIDE, jx.Alphabet.AMINO])
@pytest.mark.parametrize("shards", [1, 2, 3, 5])
def test_sampled_walk_shard_plain_in_rounds(alphabet, shards):
    """sampled_walk_shard_plain in rounds over the windows (walk_rounds)
    gives sampled_walk_plain's text positions for every row of a small
    index (row 0 and the sampled rows among them, and walks that cross
    every window several times), and the round sizes only fall."""
    dev, shs = _sharded_tables(alphabet, 50 + shards, 2900, shards, 32)
    nb = dev.blocks.shape[0]
    rows = torch.cat([torch.arange(dev.bwt_len), torch.tensor([0, -3, dev.bwt_len + 5, 32, 64])])
    pos, steps, rounds = walk_rounds(shs, nb, rows, *_walk_args(dev))
    round_rows = [r for r, _ in rounds]
    assert not bool((pos % dev.sa_ratio).any())
    got = kernels._text_pos_mod(kernels._sa_values(kernels.window_read_plain, dev.sampled_sa, pos // dev.sa_ratio),
                                steps, dev.bwt_len)
    want = kernels.sampled_walk_plain(dev.blocks, rows, dev.prefix_sums, dev.codes, dev.c2i, dev.num_planes,
                                      dev.alphabet.ambiguity_idx, dev.sa_ratio, dev.sampled_sa, dev.bwt_len)
    assert torch.equal(got, want)
    assert round_rows == sorted(round_rows, reverse=True) and round_rows[0] < rows.shape[0]
    if shards == 1:
        assert len(round_rows) == 1
        return
    # The longest walk's rows, by narrow LF steps, visit every window twice or more.
    row = int(torch.argmax(steps))
    path = [row]
    for _ in range(int(steps[row])):
        stepped, _ = kernels.backstep_plain(dev.blocks, torch.tensor([path[-1]]), dev.prefix_sums, dev.codes,
                                            dev.c2i, dev.num_planes, dev.mark_offset, dev.alphabet.ambiguity_idx)
        path.append(int(stepped[0]))
    owner = [next(i for i, sh in enumerate(shs) if sh.first_block <= p >> 8 < sh.first_block + sh.blocks.shape[0])
             for p in path[:-1]]
    runs = [owner[0]] + [y for x, y in zip(owner, owner[1:]) if x != y]
    visits = [runs.count(i) for i in range(len(shs))]
    assert min(v for v, sh in zip(visits, shs) if sh.blocks.shape[0]) >= 2, visits


@pytest.mark.parametrize(
    "live, shards, sa_ratio, survival, want",
    [
        # The first round of a chr1-scale batch's cap slots (4 shards, SA
        # ratio 8): a pass ends at a sample 1 time in 3.625.
        (458_694, 4, 8, None, math.ceil(math.log(458_694 / math.log(2)) / -math.log(1 - 1 / 3.625))),
        (458_694, 4, 32, None, math.ceil(math.log(458_694 / math.log(2)) / -math.log(1 - 1 / 12.625))),
        (1000, 1, 8, None, 1),  # one window: a pass ends only at a sample
        (1, 4, 8, None, 2),
        (10, 4, 8, 0.5, 4),  # ln(10 / ln 2) / ln 2 = 3.85
        (10, 4, 8, 0.0, 1),
        (10, 4, 8, 1.0, MAX_ROUND_PASSES),  # no row finished: the cap
        (10**9, 4, 8, 0.9999, MAX_ROUND_PASSES),
    ],
)
def test_round_passes(live, shards, sa_ratio, survival, want):
    """round_passes: the passes after which a round's rows are all sampled
    with probability one half, from the model of random walks in a first
    round and from the last round's survival after it, within [1,
    MAX_ROUND_PASSES]."""
    assert round_passes(live, shards, sa_ratio, survival) == want


def test_walk_rounds_sizes_rounds_by_survival(monkeypatch):
    """Each round after the first gets round_passes of the share of the
    first round's rows that stayed live per pass over the rounds before;
    the first gets the model's (no survival).  Rounds are held to 2 passes
    here so that there are several."""
    dev, shs = _sharded_tables(jx.Alphabet.NUCLEOTIDE, 71, 2900, 4, 32)
    asked = []

    def short(live, num_shards, sa_ratio, survival=None):
        asked.append((live, num_shards, sa_ratio, survival))
        return min(2, round_passes(live, num_shards, sa_ratio, survival))

    monkeypatch.setattr(sharding, "round_passes", short)
    rows = torch.arange(dev.bwt_len)
    pos, steps, rounds = walk_rounds(shs, dev.blocks.shape[0], rows, *_walk_args(dev))
    assert len(rounds) >= 3 and not bool((pos % dev.sa_ratio).any())
    assert [(r, p) for r, p in rounds] == [(a[0], min(2, round_passes(*a))) for a in asked]
    assert asked[0][1:] == (4, dev.sa_ratio, None)
    for k, a in enumerate(asked[1:], 1):
        assert a[3] == pytest.approx((rounds[k][0] / rounds[0][0]) ** (1 / sum(p for _, p in rounds[:k])))


def test_merge_owned_matches_in_place():
    """A shard on another device works on copies: its rank-step buffers and
    its walked rows, merged back by the window test (merge_owned), equal
    the in-place writes of a shard on the slot's device."""
    dev, shs = _sharded_tables(jx.Alphabet.NUCLEOTIDE, 60, 2900, 3, 16)
    nb = dev.blocks.shape[0]
    rng = np.random.default_rng(61)
    starts = torch.from_numpy(rng.integers(-3, dev.bwt_len + 3, size=500))
    ends = starts + torch.from_numpy(rng.integers(0, 300, size=500))
    sym = torch.from_numpy(rng.integers(0, 6, size=500).astype(np.int32))
    in_place = (torch.full_like(starts, UNSET), torch.full_like(ends, UNSET))
    merged = tuple(t.clone() for t in in_place)
    for sh in shs:
        args = (sh.blocks, sh.first_block, nb, starts, ends, sym, sh.codes, sh.prefix_sums, dev.num_planes)
        kernels.occ_pair_shard(*args, *in_place)
        a, b = kernels.occ_pair_shard(*args, torch.empty_like(starts), torch.empty_like(ends))
        merged = (merge_owned(merged[0], a, starts - 1, sh, nb * 256), merge_owned(merged[1], b, ends, sh, nb * 256))
    assert torch.equal(merged[0], in_place[0]) and torch.equal(merged[1], in_place[1])
    assert not (merged[0] == UNSET).any()

    rows = torch.from_numpy(rng.integers(0, dev.bwt_len, size=700))
    r, s = rows.clone(), torch.from_numpy(rng.integers(0, 3, size=700))
    r2, s2 = r.clone(), s.clone()
    tail = (dev.prefix_sums, dev.codes, dev.c2i, *_walk_args(dev))
    for sh in shs:
        kernels.sampled_walk_shard(sh.blocks, sh.first_block, nb, r, s, *tail)
        rr, ss = kernels.sampled_walk_shard(sh.blocks, sh.first_block, nb, r2.clone(), s2.clone(), *tail)
        r2, s2 = merge_owned(r2, rr, r2, sh, dev.bwt_len), merge_owned(s2, ss, r2, sh, dev.bwt_len)
    assert torch.equal(r, r2) and torch.equal(s, s2)
    assert bool((s > 0).any()) and not torch.equal(r, rows)


def test_walk_rounds_step_cap_raises():
    """A walk that never reaches a sampled row (a corrupt index: every row
    holds one symbol and LF maps each row to itself) raises once its rows
    have taken bwt_len steps, as the single-device walk does."""
    a = pt.Alphabet.NUCLEOTIDE
    nb, v, sym_a = 4, a.num_planes, 1
    code = int(index_to_code_table(a)[sym_a])
    blocks = np.zeros((nb, fused_row_words(a)), dtype=np.int64)
    for p in range(v):
        blocks[:, p * 8 : (p + 1) * 8] = -1 if (code >> p) & 1 else 0
    blocks[:, v * 8 + sym_a] = np.arange(nb) * 256
    blocks = torch.from_numpy(blocks.astype(np.int32))
    prefix = torch.zeros(a.cardinality + 1, dtype=torch.int64)
    codes = torch.from_numpy(index_to_code_table(a).astype(np.int32))
    c2i = torch.from_numpy(code_to_index_table(a).astype(np.int32))
    stepped, _ = kernels.backstep_plain(blocks, torch.arange(nb * 256), prefix, codes, c2i, v, v * 8 + a.cardinality,
                                        a.ambiguity_idx)
    assert torch.equal(stepped, torch.arange(nb * 256))  # LF is the identity
    shs = [Shard(blocks[lo:hi], lo, codes, c2i, prefix) for lo, hi in _shard_windows(nb, 2)]
    rows = torch.tensor([0, 8, 3, 700])
    with pytest.raises(RuntimeError, match="1024 LF steps without reaching a sampled row"):
        walk_rounds(shs, nb, rows, v, a.ambiguity_idx, 8, nb * 256)
