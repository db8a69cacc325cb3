"""The marked LF walk: ``kernels.marked_walk_plain`` (the plain version of
the ``marked_walk`` kernel) against the JAX package's walk, on the CPU.

Each index holds three records with runs of the ambiguity symbol (N for
nucleotide, X for amino) at their ends, about 51k symbols, so walks step
over ambiguity and sentinel symbols.  Mark ratios 2, 4 and 32; rows include
0, the sentinel row (the row of SA value 0) and the last row.  Every
comparison is exact; inputs come from a numpy seed.  The CUDA kernel is held
against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import awry_tpu as jx
import awry_tpu_torch as pt
from awry_tpu.ops import to_device as jax_to_device
from awry_tpu.ops.locate import lf_walk as jax_lf_walk
from awry_tpu_torch.ops import kernels, lf_walk, to_device

from .conftest import random_seq

AMBIGUITY = {"NUCLEOTIDE": b"N", "AMINO": b"X"}
K = 4


def _build(alphabet: str, records, mark_ratio: int):
    args = dict(lookup_table_kmer_len=K, locate_mark_ratio=mark_ratio)
    return (
        jx.build_from_records(records, jx.FmBuildArgs(alphabet=jx.Alphabet[alphabet], **args)),
        pt.build_from_records(records, pt.FmBuildArgs(alphabet=pt.Alphabet[alphabet], **args)),
    )


@pytest.fixture(scope="module", params=["NUCLEOTIDE", "AMINO"])
def walk_case(request):
    """(alphabet, records, the whole SA as int64) for one alphabet."""
    alphabet = request.param
    rng = np.random.default_rng(51 if alphabet == "NUCLEOTIDE" else 52)
    seq = lambda n: random_seq(jx.Alphabet[alphabet], rng, n)  # noqa: E731
    run = AMBIGUITY[alphabet] * 60
    records = [("r0", run + seq(30_000) + run), ("r1", seq(9_000) + run), ("r2", run + seq(12_000))]
    full = pt.build_from_records(records, pt.FmBuildArgs(alphabet=pt.Alphabet[alphabet], lookup_table_kmer_len=K,
                                                         locate_mark_ratio=1))
    return alphabet, records, full.text_sampled_sa.astype(np.int64)


def _rows(sa: np.ndarray, seed: int) -> np.ndarray:
    """Row 0, the sentinel row, the last row and 4,000 random rows."""
    n = sa.shape[0]
    sentinel_row = int(np.flatnonzero(sa == 0)[0])
    rng = np.random.default_rng(seed)
    return np.concatenate([[0, sentinel_row, n - 1], rng.integers(0, n, size=4000)])


def _walk_args(tdev):
    return (tdev.prefix_sums, tdev.codes, tdev.c2i, tdev.num_planes, tdev.mark_offset, tdev.alphabet.ambiguity_idx)


@pytest.mark.parametrize("mark_ratio", [2, 4, 32])
def test_marked_walk_plain_matches_jax_walk(walk_case, mark_ratio):
    """marked_walk_plain equals the JAX package's lf_walk (_marked_walk,
    plain gathers) and recovers each row's SA value."""
    alphabet, records, sa = walk_case
    jidx, tidx = _build(alphabet, records, mark_ratio)
    assert tidx.resolved_mark_ratio == mark_ratio
    tdev = to_device(tidx, "cpu")
    rows = _rows(sa, mark_ratio)
    got = kernels.marked_walk_plain(
        tdev.blocks, torch.from_numpy(rows), *_walk_args(tdev), mark_ratio, tdev.text_sampled_sa, tdev.bwt_len
    ).numpy()
    want = np.asarray(jax_lf_walk(jax_to_device(jidx), jnp.asarray(rows, dtype=jnp.uint32)))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(got, sa[rows])


def test_lf_walk_on_cpu_tensors_is_the_plain_walk(walk_case):
    """lf_walk at mark ratio 4 on CPU tensors is marked_walk_plain, and
    neither marked_walk nor backstep counts a launch."""
    alphabet, records, sa = walk_case
    _, tidx = _build(alphabet, records, 4)
    tdev = to_device(tidx, "cpu")
    rows = torch.from_numpy(_rows(sa, 7))
    before = (kernels.marked_walk.launches, kernels.backstep.launches, kernels.window_read.launches)
    got = lf_walk(tdev, rows)
    via_wrapper = kernels.marked_walk(tdev.blocks, rows, *_walk_args(tdev), 4, tdev.text_sampled_sa, tdev.bwt_len)
    assert (kernels.marked_walk.launches, kernels.backstep.launches, kernels.window_read.launches) == before
    want = kernels.marked_walk_plain(tdev.blocks, rows, *_walk_args(tdev), 4, tdev.text_sampled_sa, tdev.bwt_len)
    assert torch.equal(got, want) and torch.equal(via_wrapper, want)
    np.testing.assert_array_equal(got.numpy(), sa[rows.numpy()])


def _walk_one(tdev, row: int, mark_ratio: int) -> int:
    """One row's walk, visit by visit through backstep_plain on a single
    row, with the marked SA read and the modulo written out."""
    args = _walk_args(tdev)
    pos, steps = row, 0
    for _ in range(mark_ratio - 1):
        stepped, packed = kernels.backstep_plain(tdev.blocks, torch.tensor([pos]), *args)
        if int(packed[0]) & 1:
            break
        pos, steps = int(stepped[0]), steps + 1
    _, packed = kernels.backstep_plain(tdev.blocks, torch.tensor([pos]), *args)
    rank = (int(packed[0]) & 0xFFFFFFFF) >> 1
    sa = int(tdev.text_sampled_sa[min(rank, tdev.text_sampled_sa.shape[0] - 1)]) & 0xFFFFFFFF
    t = sa + steps
    return t - tdev.bwt_len if t >= tdev.bwt_len else t


@pytest.mark.parametrize("mark_ratio", [4, 32])
def test_marked_walk_plain_clamps_rows(walk_case, mark_ratio):
    """Rows past either end of the table walk as the clamped row does (0, or
    the last row of the last block), and every lane equals the walk written
    out visit by visit through backstep_plain."""
    alphabet, records, _ = walk_case
    _, tidx = _build(alphabet, records, mark_ratio)
    tdev = to_device(tidx, "cpu")
    n, nbits = tdev.bwt_len, tdev.blocks.shape[0] * 256
    rows = torch.tensor([-7, -1, 0, 1, n - 1, n, n + 300, nbits - 1, nbits, nbits + 5])
    args = (*_walk_args(tdev), mark_ratio, tdev.text_sampled_sa, n)
    got = kernels.marked_walk_plain(tdev.blocks, rows, *args)
    clamped = kernels.marked_walk_plain(tdev.blocks, rows.clamp(0, nbits - 1), *args)
    assert torch.equal(got, clamped)
    assert got.tolist() == [_walk_one(tdev, int(r), mark_ratio) for r in rows]
