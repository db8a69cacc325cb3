"""The port's federation on the CPU: awry_tpu_torch.parallel.PartitionedFmIndex
(device="cpu": every kernel through its plain version) against the JAX
package's PartitionedFmIndex and a monolithic index on the same records:
partition caps 150, 300 and 10,000, queries across record delimiters and
partition boundaries, over-long queries refused, a 2-worker spawned build
equal to the serial one, and save/load across the two packages in both
directions.  Every comparison is exact; inputs come from numpy seeds."""

import numpy as np
import pytest
import torch

import awry_tpu as jx
import awry_tpu.host_engine as he
import awry_tpu_torch as pt
from awry_tpu.parallel.partitioned import PartitionedFmIndex as JaxFederation
from awry_tpu_torch.parallel import PartitionedFmIndex

from .conftest import random_seq


def _records(seed, n=10, lo=20, hi=120):
    rng = np.random.default_rng(seed)
    return [(f"r{i}", random_seq(jx.Alphabet.NUCLEOTIDE, rng, int(rng.integers(lo, hi)))) for i in range(n)]


def _queries(records, seq_starts, seed, max_len=24):
    """Drawn substrings of the joined text (some across delimiters), every
    delimiter crossing, and odd ones (the delimiter alone, a short read, an
    empty query)."""
    rng = np.random.default_rng(seed)
    text = b"N".join(seq for _, seq in records)
    queries = []
    for _ in range(60):
        ln = int(rng.integers(1, max_len))
        s = int(rng.integers(0, len(text) - ln))
        queries.append(text[s : s + ln])
    for i in range(len(records) - 1):
        d = int(seq_starts[i + 1]) - 1  # the delimiter's position
        queries.append(text[max(0, d - 8) : d + 9])
    return queries + [b"N", b"ACGT", b""]


def _sorted_hits(res, i):
    counts, rec, loc, offsets = res
    return sorted(zip(rec[offsets[i] : offsets[i + 1]].tolist(), loc[offsets[i] : offsets[i + 1]].tolist()))


@pytest.mark.parametrize("cap", [150, 300, 10_000])
def test_partitioned_matches_reference(cap):
    """Counts, sorted hits and count_locate_arrays equal the JAX package's
    federation (its host engine) and a monolithic index."""
    records = _records(1)
    args = dict(lookup_table_kmer_len=2)
    mono = jx.build_from_records(records, jx.FmBuildArgs(**args))
    ref = JaxFederation.build_from_records(records, jx.FmBuildArgs(**args), max_partition_symbols=cap,
                                           max_query_len=24)
    fed = PartitionedFmIndex.build_from_records(records, pt.FmBuildArgs(**args), max_partition_symbols=cap,
                                                max_query_len=24, device="cpu")
    assert len(fed.partitions) == len(ref.partitions) and (cap == 10_000) == (len(fed.partitions) == 1)
    for p, q in zip(fed.partitions, ref.partitions):
        assert (p.global_start, p.owned_len) == (q.global_start, q.owned_len)
        assert (p.tail_syms is None) == (q.tail_syms is None)
    np.testing.assert_array_equal(fed.seq_starts, ref.seq_starts)
    queries = _queries(records, fed.seq_starts, 2)
    counts = fed.count_batch(queries)
    np.testing.assert_array_equal(counts, ref.count_batch(queries, use_device=False))
    np.testing.assert_array_equal(counts, [he.count(mono, q) for q in queries])
    np.testing.assert_array_equal(fed.count_batch(queries, use_device=False), counts)
    got, want = fed.locate_batch(queries), ref.locate_batch(queries, use_device=False)
    for q, g, w in zip(queries, got, want):
        assert sorted(g) == sorted(w) == sorted(he.locate(mono, q)), q
    res = fed.count_locate_arrays(queries, cap=2)
    np.testing.assert_array_equal(res[0], counts)
    for i, q in enumerate(queries):
        assert _sorted_hits(res, i) == sorted(he.locate(mono, q)), q
    assert fed.count(queries[0]) == int(counts[0]) and sorted(fed.locate(queries[0])) == sorted(got[0])


def test_partitioned_count_locate_arrays_equal_reference():
    """The bulk path returns the JAX federation's arrays exactly (the same
    partition-major, BWT-row order) at mark 2, through its device engines
    (JAX on the CPU; two partitions keep its compiles few)."""
    records = _records(4, n=6, lo=100, hi=300)
    args = dict(lookup_table_kmer_len=3, locate_mark_ratio=2)
    ref = JaxFederation.build_from_records(records, jx.FmBuildArgs(**args), max_partition_symbols=800,
                                           max_query_len=20)
    fed = PartitionedFmIndex.build_from_records(records, pt.FmBuildArgs(**args), max_partition_symbols=800,
                                                max_query_len=20, device="cpu")
    assert len(fed.partitions) == 2
    queries = [records[i % 6][1][j : j + 9] for i, j in enumerate(range(0, 80, 4))]
    queries += [b"ACG", b"", b"G" * 19]
    for a, b in zip(fed.count_locate_arrays(queries, cap=2), ref.count_locate_arrays(queries, cap=2)):
        np.testing.assert_array_equal(a, b)


def test_partitioned_rejects_and_degenerates():
    """An over-long query raises; a federation of one partition has no
    tail; empty input raises; no device= means the card, which the CPU
    lacks."""
    records = _records(5, n=3)
    fed = PartitionedFmIndex.build_from_records(records, pt.FmBuildArgs(lookup_table_kmer_len=2),
                                                max_partition_symbols=100, max_query_len=10, device="cpu")
    with pytest.raises(ValueError, match="max_query_len"):
        fed.count_batch([b"A" * 11])
    with pytest.raises(ValueError, match="max_query_len"):
        fed.count_locate_arrays([b"A" * 11])
    one = PartitionedFmIndex.build_from_records(records[:2], pt.FmBuildArgs(lookup_table_kmer_len=2),
                                                max_partition_symbols=10_000, max_query_len=8, device="cpu")
    assert len(one.partitions) == 1 and one.partitions[0].tail_syms is None
    with pytest.raises(ValueError, match="no sequence records"):
        PartitionedFmIndex.build_from_records([], pt.FmBuildArgs(), max_partition_symbols=100, max_query_len=4,
                                              device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PartitionedFmIndex.build_from_records(records, pt.FmBuildArgs(lookup_table_kmer_len=2),
                                                  max_partition_symbols=100, max_query_len=10)


def test_partitioned_parallel_build_matches_serial():
    """num_workers=2 (spawned workers, the host k-mer build) builds the same
    partitions as the serial path."""
    records = _records(6, n=6, lo=40, hi=90)
    args = pt.FmBuildArgs(lookup_table_kmer_len=2)
    serial = PartitionedFmIndex.build_from_records(records, args, max_partition_symbols=150, max_query_len=10,
                                                   device="cpu")
    parallel = PartitionedFmIndex.build_from_records(records, args, max_partition_symbols=150, max_query_len=10,
                                                     num_workers=2, device="cpu")
    assert len(parallel.partitions) == len(serial.partitions) > 1
    for ps, pp in zip(serial.partitions, parallel.partitions):
        for name in ("planes", "milestones", "sampled_sa", "kmer_table", "mark_bits", "text_sampled_sa"):
            np.testing.assert_array_equal(getattr(ps.index, name), getattr(pp.index, name))
        assert (ps.global_start, ps.owned_len) == (pp.global_start, pp.owned_len)
    text = b"N".join(s for _, s in records)
    rng = np.random.default_rng(7)
    queries = [text[s : s + 8] for s in rng.integers(0, len(text) - 8, size=12)]
    np.testing.assert_array_equal(serial.count_batch(queries), parallel.count_batch(queries))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_partitioned_save_load_across_packages(writer, tmp_path):
    """A federation saved by one package loads in the other and serves the
    same counts and hits."""
    records = _records(8, n=6, lo=150, hi=400)
    args = dict(lookup_table_kmer_len=3)
    ref = JaxFederation.build_from_records(records, jx.FmBuildArgs(**args), max_partition_symbols=500,
                                           max_query_len=24)
    fed = PartitionedFmIndex.build_from_records(records, pt.FmBuildArgs(**args), max_partition_symbols=500,
                                                max_query_len=24, device="cpu")
    d = str(tmp_path / "federation")
    if writer == "jax":
        ref.save(d)
        loaded, other = PartitionedFmIndex.load(d, device="cpu"), fed
    else:
        fed.save(d)
        loaded, other = JaxFederation.load(d), ref
    assert len(loaded.partitions) == len(other.partitions)
    assert loaded.headers == other.headers and loaded.max_query_len == other.max_query_len
    queries = [records[i % 6][1][j : j + 12] for i, j in enumerate(range(0, 60, 5))]
    kw = {"use_device": False}
    np.testing.assert_array_equal(loaded.count_batch(queries, **kw), other.count_batch(queries, **kw))
    a, b = loaded.locate_batch(queries, **kw), other.locate_batch(queries, **kw)
    assert [sorted(x) for x in a] == [sorted(y) for y in b]
