"""The PyTorch port's host layer (awry_tpu_torch) against the JAX package:
index builds, the device tables and the numpy index hand-over are equal
field by field on the same inputs."""

import dataclasses

import numpy as np
import pytest

import awry_tpu as jx
import awry_tpu_torch as pt
from awry_tpu.ops import to_device as jax_to_device
from awry_tpu_torch.ops import FmQueryEngine, from_numpy_index, to_device

from .conftest import random_seq


def _assert_index_equal(a, b):
    """Every FmIndexData field of the JAX index equals the port's."""
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "alphabet":
            assert va.name == vb.name
        elif isinstance(vb, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


def _numpy_fields(index):
    arrays = {}
    meta = {}
    for f in dataclasses.fields(index):
        v = getattr(index, f.name)
        if isinstance(v, np.ndarray):
            arrays[f.name] = v
        elif f.name == "alphabet":
            meta[f.name] = v.name
        else:
            meta[f.name] = v
    return arrays, meta


@pytest.mark.parametrize("alphabet", ["NUCLEOTIDE", "AMINO"])
def test_build_from_records_matches_jax(alphabet, rng):
    ja, ta = jx.Alphabet[alphabet], pt.Alphabet[alphabet]
    records = [("r0", random_seq(ja, rng, 30_000)), ("r1", random_seq(ja, rng, 20_000))]
    k = 6 if alphabet == "NUCLEOTIDE" else 3
    jidx = jx.build_from_records(records, jx.FmBuildArgs(alphabet=ja, lookup_table_kmer_len=k, locate_mark_ratio=1))
    tidx = pt.build_from_records(records, pt.FmBuildArgs(alphabet=ta, lookup_table_kmer_len=k, locate_mark_ratio=1))
    _assert_index_equal(jidx, tidx)


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_build_index_from_file_matches_jax(fmt, tmp_path, rng):
    """Lowercase letters, N runs, RNA U and several records, read from a file."""
    seqs = [random_seq(jx.Alphabet.NUCLEOTIDE, rng, n) for n in (20_000, 15_000, 25_000)]
    seqs[1] = seqs[1][:5000].lower() + b"NNNNNNNNNN" + seqs[1][5010:]
    seqs[2] = seqs[2].replace(b"T", b"U", 50)
    path = tmp_path / f"in.{'fa' if fmt == 'fasta' else 'fq'}"
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            if fmt == "fasta":
                f.write(b">rec%d desc\n" % i)
                for j in range(0, len(s), 70):
                    f.write(s[j : j + 70] + b"\n")
            else:
                f.write(b"@rec%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))
    jidx = jx.build_index(jx.FmBuildArgs(input_file_src=str(path), lookup_table_kmer_len=5))
    tidx = pt.build_index(pt.FmBuildArgs(input_file_src=str(path), lookup_table_kmer_len=5))
    assert tidx.headers == [f"rec{i}" + (" desc" if fmt == "fasta" else "") for i in range(3)]
    _assert_index_equal(jidx, tidx)


def test_from_numpy_index_round_trip(rng):
    """A JAX-built index carried over by from_numpy_index equals it and serves."""
    seq = random_seq(jx.Alphabet.NUCLEOTIDE, rng, 50_000)
    jidx = jx.build_from_records([("x", seq)], jx.FmBuildArgs(lookup_table_kmer_len=5, locate_mark_ratio=1))
    tidx = from_numpy_index(*_numpy_fields(jidx))
    _assert_index_equal(jidx, tidx)
    eng = FmQueryEngine(tidx, device="cpu")
    q = [seq[100:125], seq[40_000:40_030], b"ACGTTGCA"]
    np.testing.assert_array_equal(eng.count_batch(q), [jx.count(jidx, x) for x in q])
    with pytest.raises(ValueError, match="not FmIndexData fields"):
        from_numpy_index({"bogus": np.zeros(1)}, {"alphabet": "NUCLEOTIDE"})
    arrays, meta = _numpy_fields(jidx)
    arrays["prefix_sums"] = arrays["prefix_sums"][:-1]
    with pytest.raises(ValueError, match="bad prefix_sums shape"):
        from_numpy_index(arrays, meta)


@pytest.mark.parametrize("alphabet", ["NUCLEOTIDE", "AMINO"])
def test_device_tables_match_jax(alphabet, rng):
    """The port ships the same words as the JAX device index: fused rows,
    prefix sums, k-mer table, padded text, SA and record starts."""
    ja, ta = jx.Alphabet[alphabet], pt.Alphabet[alphabet]
    records = [("r0", random_seq(ja, rng, 40_000)), ("r1", random_seq(ja, rng, 9_000))]
    args = dict(lookup_table_kmer_len=4, locate_mark_ratio=1)
    jdev = jax_to_device(jx.build_from_records(records, jx.FmBuildArgs(alphabet=ja, **args)))
    tdev = to_device(pt.build_from_records(records, pt.FmBuildArgs(alphabet=ta, **args)), "cpu")

    def u32(t):
        return t.numpy().view(np.uint32)

    np.testing.assert_array_equal(u32(tdev.blocks), np.asarray(jdev.blocks))
    np.testing.assert_array_equal(tdev.prefix_sums.numpy(), np.asarray(jdev.prefix_sums))
    np.testing.assert_array_equal(u32(tdev.kmer_flat), np.asarray(jdev.kmer_table).reshape(-1))
    np.testing.assert_array_equal(u32(tdev.text_packed), np.asarray(jdev.text_packed))
    np.testing.assert_array_equal(u32(tdev.text_sampled_sa), np.asarray(jdev.text_sampled_sa))
    np.testing.assert_array_equal(tdev.seq_starts.numpy(), np.asarray(jdev.seq_starts))
    assert tdev.blocks.shape[1] == (40 if alphabet == "NUCLEOTIDE" else 72)
