"""The range-fed row-sampled walk (``sampled_walk_ranges``) on the CPU.

The classic path of an index without marks walks its query ranges' live
slots in one ``sampled_walk_ranges`` launch.  Its plain version must equal
the composition it replaced (the padded rows ``starts + j`` or row 0,
walked by ``sampled_walk_plain``) bit for bit, and its live slots must
equal the JAX package's row-sampled walk (``lf_walk`` of an index without
marks: ``_row_sampled_walk``) on the same ``.awry`` index.  A walk that
cannot end makes the engine raise at assembly.  Every comparison is exact;
inputs come from numpy seeds."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import awry_tpu as jx
import awry_tpu_torch as pt
from awry_tpu.io import awry_format as jx_awry
from awry_tpu.ops import to_device as jax_to_device
from awry_tpu.ops.locate import lf_walk as jax_lf_walk
from awry_tpu_torch.ops import FmQueryEngine, count_locate_capped_t, kernels, to_device

from .conftest import random_seq

K = 4
CAP = 8


def _markless(alphabet: str, sa_ratio: int, n: int, seed: int, tmp_path):
    """A two-record JAX build of ~n symbols saved to .awry, loaded by both
    packages: (the port's device index on the CPU, the JAX device index,
    the port's host index, the text body)."""
    rng = np.random.default_rng(seed)
    body = random_seq(jx.Alphabet[alphabet], rng, n)
    amb = b"N" if alphabet == "NUCLEOTIDE" else b"X"
    records = [("a", amb * 9 + body[: n // 2]), ("b", body[n // 2 :] + amb * 3)]
    built = jx.build_from_records(records, jx.FmBuildArgs(alphabet=jx.Alphabet[alphabet], lookup_table_kmer_len=K,
                                                         suffix_array_compression_ratio=sa_ratio))
    path = str(tmp_path / "i.awry")
    jx_awry.save_awry(built, path)
    tidx = pt.load_awry(path, device="cpu")
    assert not tidx.has_marks and tidx.sa_ratio == sa_ratio
    return to_device(tidx, "cpu"), jax_to_device(jx_awry.load_awry(path, kmer_on_device=False)), tidx, body


def _walk_args(dev):
    return (dev.prefix_sums, dev.codes, dev.c2i, dev.num_planes, dev.alphabet.ambiguity_idx, dev.sa_ratio,
            dev.sampled_sa, dev.bwt_len)


def _glue_then_flat_walk(dev, starts, counts, cap):
    """The composition the range-fed walk replaced: the padded [B, cap]
    rows (starts + j where j < min(count, cap), else row 0), flattened and
    walked by sampled_walk_plain."""
    offs = torch.arange(cap)
    rows = starts[:, None] + offs[None, :]
    valid = offs[None, :] < counts.clamp_max(cap)[:, None]
    flat = torch.where(valid, rows, 0).reshape(-1)
    return kernels.sampled_walk_plain(dev.blocks, flat, *_walk_args(dev)).reshape(-1, cap)


def _ranges(rng, n: int, b: int, cap: int):
    """Query ranges: counts 0, 1, cap and over cap in turn, starts anywhere
    in the index and some right below its end (rows past bwt_len clamp)."""
    counts = np.resize(np.array([0, 1, cap, cap + 9, 3], dtype=np.int64), b)
    starts = rng.integers(0, n, size=b).astype(np.int64)
    starts[::7] = n - 1 - rng.integers(0, 3, size=starts[::7].shape[0])
    return torch.from_numpy(starts), torch.from_numpy(counts)


@pytest.mark.parametrize("alphabet,sa_ratio", [("NUCLEOTIDE", 1), ("NUCLEOTIDE", 6), ("NUCLEOTIDE", 8),
                                               ("NUCLEOTIDE", 32), ("AMINO", 8), ("AMINO", 6)])
def test_ranges_plain_equals_the_flat_composition_and_jax(alphabet, sa_ratio, tmp_path):
    """sampled_walk_ranges (the plain version, CPU tensors) equals the glue
    + sampled_walk_plain slot for slot, over batches of one query, of
    none, and of every count class; its live slots equal the JAX walk of
    the same rows."""
    dev, jdev, _, _ = _markless(alphabet, sa_ratio, 12_000, 200 + sa_ratio, tmp_path)
    n = dev.bwt_len
    rng = np.random.default_rng(sa_ratio)
    for b, cap in ((300, CAP), (1, CAP), (0, CAP), (40, 1), (25, 3)):
        starts, counts = _ranges(rng, n, b, cap)
        got = kernels.sampled_walk_ranges(dev.blocks, starts, counts, cap, *_walk_args(dev))
        want = _glue_then_flat_walk(dev, starts, counts, cap)
        assert got.shape == (b, cap) and got.dtype == torch.int64
        assert torch.equal(got, want)
        live = torch.arange(cap)[None, :] < counts.clamp_max(cap)[:, None]
        rows = (starts[:, None] + torch.arange(cap)[None, :])[live].clamp(0, n - 1)
        if rows.numel():
            jwant = np.asarray(jax_lf_walk(jdev, jnp.asarray(rows.numpy(), dtype=jnp.uint32))).astype(np.int64)
            np.testing.assert_array_equal(got[live].numpy(), jwant)
        # Idle slots hold the walk of row 0: its SA value.
        assert set(got[~live].tolist()) <= {int(dev.sampled_sa[0]) & 0xFFFFFFFF}


def test_ranges_every_slot_live_and_every_row(tmp_path):
    """Every row of the index as the slots of ranges that tile it (every
    slot live): the JAX walk of each row, and the flat entry's walk."""
    dev, jdev, _, _ = _markless("NUCLEOTIDE", 8, 8_000, 301, tmp_path)
    n = dev.bwt_len
    starts = torch.arange(0, n, CAP)
    counts = torch.full_like(starts, CAP)
    got = kernels.sampled_walk_ranges(dev.blocks, starts, counts, CAP, *_walk_args(dev)).reshape(-1)[:n]
    rows = torch.arange(n)
    want = np.asarray(jax_lf_walk(jdev, jnp.asarray(rows.numpy(), dtype=jnp.uint32))).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(kernels.sampled_walk(dev.blocks, rows, *_walk_args(dev)), got)
    assert torch.equal(got.sort().values, rows)  # a permutation of the text's positions


def test_ranges_refuses_bad_arguments(tmp_path):
    dev = _markless("NUCLEOTIDE", 8, 4_000, 302, tmp_path)[0]
    starts, counts = torch.zeros(3, dtype=torch.int64), torch.ones(3, dtype=torch.int64)
    args = list(_walk_args(dev))
    with pytest.raises(ValueError, match="cap"):
        kernels.sampled_walk_ranges(dev.blocks, starts, counts, 0, *args)
    args[5] = 3  # sa_ratio that does not fit the sampled SA's length
    with pytest.raises(ValueError, match="sa_ratio"):
        kernels.sampled_walk_ranges(dev.blocks, starts, counts, CAP, *args)


def test_capped_locate_walks_ranges(tmp_path, monkeypatch):
    """count_locate_capped_t on an index without marks, with the crumb
    wire's flags, launches the range-fed walk once and no flat walk, with
    the same positions as the composition it replaced."""
    dev, _, tidx, body = _markless("NUCLEOTIDE", 8, 12_000, 303, tmp_path)
    eng = FmQueryEngine(tidx, device="cpu")
    rng = np.random.default_rng(5)
    queries = [body[s : s + ln] for s, ln in zip(rng.integers(0, 11_000, 40), rng.integers(4, 30, 40))]
    queries += [body[100:104], b"", b"ACGT" * 5]
    qt, ql, flags = eng._upload(*eng.encode_queries(queries))
    assert flags["no_sentinel"] and flags["seeded_floor"]
    calls = []
    real = kernels.sampled_walk_ranges
    monkeypatch.setattr(kernels, "sampled_walk_ranges", lambda *a: calls.append(a) or real(*a))
    monkeypatch.setattr(kernels, "sampled_walk", lambda *a: pytest.fail("the flat walk ran"))
    counts, text_pos, starts, _ = count_locate_capped_t(dev, qt, ql, CAP, **flags)
    assert len(calls) == 1 and (counts > CAP).any() and (counts == 0).any()
    assert torch.equal(text_pos, _glue_then_flat_walk(dev, starts, counts, CAP))


def test_engine_refuses_an_endless_walk_at_assembly(tmp_path):
    """An index whose walks cannot end (every row's LF is row 3 at SA
    ratio 8) makes count_locate_stream raise RuntimeError, from the
    assembly's check of the range-fed walk's positions."""
    rng = np.random.default_rng(304)
    body = random_seq(jx.Alphabet.NUCLEOTIDE, rng, 3_000)
    built = pt.build_from_records([("r", body)], pt.FmBuildArgs(lookup_table_kmer_len=K))
    pt.save_awry(built, str(tmp_path / "i.awry"))
    eng = FmQueryEngine(pt.load_awry(str(tmp_path / "i.awry"), device="cpu"), device="cpu")
    # A K-mer of the text with at most CAP hits: its range comes from the
    # k-mer table alone, so the search does not read the corrupted rows.
    queries = [body[s : s + K] for s in range(0, 2_000, 7)]
    counts = eng.count_batch(queries)
    pick = [q for q, c in zip(queries, counts) if 1 <= c <= CAP][:4]
    assert pick
    dev = eng.device_index
    # Zero planes read code 0 (the ambiguity symbol) with no occurrence of
    # its own code, so LF(row) = C[N] - 1 = 3 for every row.
    prefix_sums = dev.prefix_sums.clone()
    prefix_sums[dev.alphabet.ambiguity_idx] = 4
    eng.device_index = dataclasses.replace(dev, blocks=torch.zeros_like(dev.blocks), prefix_sums=prefix_sums)
    with pytest.raises(RuntimeError, match="sampled_walk_ranges.*corrupt index"):
        next(eng.count_locate_stream([pick], cap=CAP))
