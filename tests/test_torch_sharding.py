"""The port's multi-device serving on the CPU: awry_tpu_torch's
``ShardedFmEngine`` (Mode A, replicated, and Mode B, range-sharded) and
``FmQueryEngine(mesh=...)`` over meshes of ``["cpu"] * n`` slots (every
kernel through its plain version), against the JAX package's host engine
and its ``ShardedFmEngine`` on the conftest's 8 virtual CPU devices; then
the shard kernels' plain versions, summed over the shards, against the
narrow kernels' on the whole table.  Twins of tests/test_sharding.py; every
comparison is exact, inputs come from numpy seeds."""

import dataclasses

import numpy as np
import pytest
import torch

import awry_tpu as jx
import awry_tpu.host_engine as he
import awry_tpu_torch as pt
from awry_tpu.parallel import ShardedFmEngine as JaxSharded
from awry_tpu_torch.alphabet import code_to_index_table, index_to_code_table
from awry_tpu_torch.ops import FmQueryEngine, build_fused_blocks, from_numpy_index, fused_row_words, kernels
from awry_tpu_torch.parallel import DATA_AXIS, SHARD_AXIS, ShardedFmEngine, make_mesh
from awry_tpu_torch.parallel.distributed import make_global_mesh

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
    # Each verify slice counts as a batch; lane counters add up to the same.
    assert eng.stats["queries"] == ref.stats["queries"] == len(pure) + len(with_n)
    assert eng.stats["batches"] == slots * ref.stats["batches"]
    for key in ("multi_hit_queries",):
        assert eng.stats[key] == ref.stats[key]
    assert eng.stats["wide_lanes"] + eng.stats["redis_lanes"] == ref.stats["wide_lanes"] + ref.stats["redis_lanes"]
    np.testing.assert_array_equal(eng.count_batch_dispatch(batches[0]).numpy(),
                                  ref.count_batch_dispatch(batches[0]).numpy())
    assert eng.device_sustained_qps(batches, cap=2, trials=1) > 0


def _shard_windows(nb, shards):
    per = -(-nb // shards)
    return [(min(i * per, nb), min((i + 1) * per, nb)) for i in range(shards)]


@pytest.mark.parametrize("alphabet", ["NUCLEOTIDE", "AMINO"])
@pytest.mark.parametrize("shards", [1, 2, 3, 5])
def test_shard_plain_versions_sum_to_narrow(alphabet, shards):
    """occ_pair_shard_plain and backstep_shard_plain summed over the shards
    equal occ_pair_plain and backstep_plain on the whole table, with row 0,
    the last row, block and shard edges, and positions below 0 and past the
    end among the requests."""
    a = pt.Alphabet[alphabet]
    rng = np.random.default_rng(40 + shards)
    nb = 13
    rw = fused_row_words(a)
    blocks = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(nb, rw)).astype(np.int32))
    codes = torch.from_numpy(index_to_code_table(a).astype(np.int32))
    c2i = torch.from_numpy(code_to_index_table(a).astype(np.int32))
    prefix = torch.from_numpy(np.sort(rng.integers(0, 2**31, size=a.cardinality + 1)).astype(np.int64))
    windows = _shard_windows(nb, shards)
    top = nb * 256
    edges = [0, top - 1, top, top + 17, -1, -300, 255, 256, 257]
    edges += [e for lo, hi in windows for e in (lo * 256 - 1, lo * 256, hi * 256 - 1, hi * 256)]
    pos = torch.tensor(edges + rng.integers(-5, top + 5, size=200).tolist(), dtype=torch.int64)
    pos_b = pos + torch.from_numpy(rng.integers(0, 600, size=pos.shape[0]))
    sym = torch.from_numpy(rng.integers(-1, a.cardinality + 1, size=pos.shape[0]).astype(np.int32))
    nplanes, mark_offset = a.num_planes, a.num_planes * 8 + a.cardinality

    want_a, want_b = kernels.occ_pair_plain(blocks, pos, pos_b, sym, codes, nplanes)
    want_step, want_mark = kernels.backstep_plain(blocks, pos, prefix, codes, c2i, nplanes, mark_offset,
                                                  a.ambiguity_idx)
    sum_a = torch.zeros_like(want_a)
    sum_b = torch.zeros_like(want_b)
    sum_step = torch.zeros_like(want_step)
    sum_mark = torch.zeros_like(want_mark)
    owners = torch.zeros(pos.shape[0], dtype=torch.int64)
    for lo, hi in windows:
        view = blocks[lo:hi]
        oa, ob = kernels.occ_pair_shard(view, lo, nb, pos, pos_b, sym, codes, nplanes)
        step, mark = kernels.backstep_shard(view, lo, nb, pos, prefix, codes, c2i, nplanes, mark_offset,
                                            a.ambiguity_idx)
        assert oa.dtype == torch.int32 and step.dtype == torch.int64 and mark.dtype == torch.int32
        blk = pos.clamp(0, top - 1) >> 8
        owned = (blk >= lo) & (blk < hi)
        owners += owned.to(torch.int64)
        assert not oa[~owned].any() and not step[~owned].any() and not mark[~owned].any()
        sum_a += oa
        sum_b += ob
        sum_step += step
        sum_mark += mark
    assert bool((owners == 1).all())
    assert torch.equal(sum_a, want_a) and torch.equal(sum_b, want_b)
    assert torch.equal(sum_step, want_step) and torch.equal(sum_mark, want_mark)
