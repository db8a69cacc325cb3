"""The order of the device k-mer build's rank requests, on the CPU.

The ``occ`` kernel stages a CTA's span of rows in shared memory when the
tile's positions touch few rows; the k-mer build keeps those spans short
because it ranks in address order, which is lexicographic.  These tests
record every request batch the build hands ``occ`` (through a wrapping
stand-in; the plain version answers on the CPU) and hold that order, and
the build's table to the host counting build."""

import numpy as np
import pytest

import awry_tpu_torch as pt
import awry_tpu_torch.ops.kmer as tkmer
from awry_tpu_torch.build.kmer_count import populate_kmer_table_counting
from awry_tpu_torch.alphabet import encode_ascii
from awry_tpu_torch.ops import kernels, populate_kmer_table_device, to_device

LETTERS = {"NUCLEOTIDE": b"ACGT", "AMINO": b"ACDEFGHIKLMNPQRSTVWY"}


@pytest.mark.parametrize("alphabet,k,cap", [
    ("NUCLEOTIDE", 6, None),  # ~60 kbp, every level one chunk of 4 symbol runs
    ("AMINO", 3, None),  # 20 symbol runs per level
    ("NUCLEOTIDE", 5, 64),  # levels of 256 and 1024 updates in chunks of 64
])
def test_kmer_build_requests_rise_within_each_symbol_run(alphabet, k, cap, monkeypatch):
    """Each batch is [starts - 1, ends] of one chunk's range updates, one
    symbol per update in both halves.  Within each half the symbols never
    decrease and, within each symbol's run, the positions never decrease;
    a half descends only where its symbol changes.  starts - 1 <= ends
    entry by entry."""
    rng = np.random.default_rng(40 + k)
    seq = bytes(rng.choice(np.frombuffer(LETTERS[alphabet], dtype=np.uint8), size=60_000))
    al = pt.Alphabet[alphabet]
    index = pt.build_from_records([("r", seq)], pt.FmBuildArgs(alphabet=al, lookup_table_kmer_len=k, locate_mark_ratio=1))
    if cap is not None:
        monkeypatch.setattr(tkmer, "_LEVEL_CHUNK", cap)
    batches = []
    real_occ = kernels.occ

    def recording_occ(blocks, pos, sym, codes, nplanes):
        batches.append((pos.numpy().copy(), sym.numpy().copy()))
        return real_occ(blocks, pos, sym, codes, nplanes)

    monkeypatch.setattr(kernels, "occ", recording_occ)
    table = populate_kmer_table_device(to_device(index, "cpu", minimal=True), k)
    np.testing.assert_array_equal(table, populate_kmer_table_counting(encode_ascii(al, np.frombuffer(seq, np.uint8)), al, k))

    assert len(batches) >= k - 1
    for pos, sym in batches:
        n = pos.shape[0] // 2
        assert pos.shape[0] == 2 * n and np.array_equal(sym[:n], sym[n:])
        assert (pos[:n] <= pos[n:]).all()
        for half in (pos[:n], pos[n:]):
            s = sym[:n]
            assert (np.diff(s) >= 0).all()
            same_symbol = s[1:] == s[:-1]
            assert (np.diff(half)[same_symbol] >= 0).all()
            assert int((np.diff(half) < 0).sum()) <= int((~same_symbol).sum())
