"""backstep's one visit on the CPU: ``rank.backstep_mark``,
``kernels.backstep_plain`` and ``kernels.backstep_wide_plain`` against the
JAX package's ``backstep_mark_sweep`` (Pallas interpret mode) and its host
engine's LF step, on small DNA and amino indexes at mark ratios 1, 4 and
32, over the rows of tests/backstep_cases.py (the card tests run the same
rows through the CUDA kernels).  Rows past either end are held to the
sweep on the clamped rows; the host engine takes the rows inside the
text.  The wide index cuts its milestone groups to 2 blocks, so that the
group bases take part.  Every comparison is exact."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import awry_tpu as jx
import awry_tpu.host_engine as he
import awry_tpu_torch.ops.wide as wide_mod
from awry_tpu.ops import to_device as jax_to_device
from awry_tpu.ops.sweep import backstep_mark_sweep
from awry_tpu_torch.ops import from_numpy_index, kernels, rank, to_device

from .backstep_cases import CASES, case_rows, clamped
from .conftest import random_seq

SYMBOLS = 30_000


@dataclasses.dataclass
class _Setup:
    jidx: object
    tdev: object
    wdev: object
    rows: dict
    want: dict  # case -> (stepped, packed) of the JAX sweep on the clamped rows


def _to_port(jidx):
    names = [f.name for f in dataclasses.fields(jx.FmIndexData)]
    arrays = {k: getattr(jidx, k) for k in names if isinstance(getattr(jidx, k), np.ndarray)}
    meta = {k: getattr(jidx, k) for k in names if k not in arrays and k != "alphabet"}
    return from_numpy_index(arrays, {"alphabet": jidx.alphabet.name, **{k: v for k, v in meta.items() if v is not None}})


@functools.lru_cache(maxsize=None)
def _setup(alphabet: str, mark: int) -> _Setup:
    """The index, its narrow and wide device indexes on the CPU, every
    case's rows, and one sweep over all of them."""
    import jax.numpy as jnp

    rng = np.random.default_rng(mark)
    ja = jx.Alphabet[alphabet]
    records = [("r0", random_seq(ja, rng, SYMBOLS)), ("r1", random_seq(ja, rng, SYMBOLS // 7))]
    jidx = jx.build_from_records(records, jx.FmBuildArgs(alphabet=ja, lookup_table_kmer_len=3,
                                                         locate_mark_ratio=mark))
    port = _to_port(jidx)
    tdev = to_device(port, "cpu")
    saved = wide_mod.GROUP_SHIFT
    wide_mod.GROUP_SHIFT = 1
    try:
        wdev = wide_mod.to_device_wide(port, "cpu")
    finally:
        wide_mod.GROUP_SHIFT = saved
    nbits = tdev.blocks.shape[0] * 256
    sentinel = int(np.flatnonzero(he.symbol_at(jidx, np.arange(jidx.bwt_len)) == 0)[0])
    rows = {case: case_rows(case, jidx.bwt_len, nbits, sentinel, seed=i) for i, case in enumerate(CASES)}
    every = np.concatenate([clamped(r, nbits) for r in rows.values()])
    stepped, packed, cov = backstep_mark_sweep(jax_to_device(jidx, build_sweep=True),
                                               jnp.asarray(every, dtype=jnp.uint32), interpret=True)
    assert np.asarray(cov).all()
    stepped, packed = np.asarray(stepped).astype(np.int64), np.asarray(packed)
    want, at = {}, 0
    for case, r in rows.items():
        want[case] = (stepped[at : at + r.shape[0]], packed[at : at + r.shape[0]])
        at += r.shape[0]
    return _Setup(jidx, tdev, wdev, rows, want)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mark", [1, 4, 32])
@pytest.mark.parametrize("alphabet", ["NUCLEOTIDE", "AMINO"])
def test_backstep_matches_sweep_and_host(alphabet, mark, case):
    s = _setup(alphabet, mark)
    rows = s.rows[case]
    want_stepped, want_packed = s.want[case]
    rows_t = torch.from_numpy(rows)
    dev, wdev = s.tdev, s.wdev
    lf = (dev.prefix_sums, dev.codes, dev.c2i, dev.num_planes, dev.mark_offset, dev.alphabet.ambiguity_idx)

    stepped, packed = kernels.backstep_plain(dev.blocks, rows_t, *lf)
    np.testing.assert_array_equal(stepped.numpy(), want_stepped)
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), want_packed)
    w_stepped, w_mark = kernels.backstep_wide_plain(wdev.blocks, wdev.bases, rows_t, *lf)
    assert wdev.bases.shift == 1 and wdev.bases.marks.shape[0] > 1
    np.testing.assert_array_equal(w_stepped.numpy(), want_stepped)
    np.testing.assert_array_equal(w_mark.numpy(), want_packed.astype(np.int64))

    for d in (dev, wdev):
        got_stepped, bit, mark_rank = rank.backstep_mark(d, rows_t)
        np.testing.assert_array_equal(got_stepped.numpy(), want_stepped)
        np.testing.assert_array_equal(bit.numpy(), (want_packed & 1) == 1)
        np.testing.assert_array_equal(mark_rank.numpy(), want_packed.astype(np.int64) >> 1)

    inside = (rows >= 0) & (rows < s.jidx.bwt_len)
    np.testing.assert_array_equal(want_stepped[inside], he.backstep(s.jidx, rows[inside]))
    if mark == 1:
        assert (want_packed[inside] & 1).all()
