"""The port's kernels (awry_tpu_torch.ops.kernels) against the JAX package.

On the CPU every wrapper runs its plain PyTorch version; the Pallas sweeps
they replace run in interpret mode, as tests/test_sweep.py runs them.  All
comparisons are exact integer equality.  The CUDA kernels themselves are
held against the plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py)."""

import numpy as np
import pytest
import torch

import awry_tpu as jx
import awry_tpu.host_engine as he
import awry_tpu.ops.rank as jrank
import awry_tpu.ops.sweep as jsweep
import awry_tpu_torch as pt
from awry_tpu.ops import to_device as jax_to_device
from awry_tpu.ops.sweep import backstep_mark_sweep, occurrence_sweep_pair, seeded_pair_chain, window_sweep
from awry_tpu_torch.ops import kernels, rank, to_device

from .conftest import random_seq


def _indexes(alphabet: str, n: int, k: int, seed: int, mark_ratio: int = 1):
    """The same records built by both packages, shipped to both devices."""
    rng = np.random.default_rng(seed)
    ja, ta = jx.Alphabet[alphabet], pt.Alphabet[alphabet]
    records = [("r0", random_seq(ja, rng, n)), ("r1", random_seq(ja, rng, n // 7))]
    args = dict(lookup_table_kmer_len=k, locate_mark_ratio=mark_ratio)
    jidx = jx.build_from_records(records, jx.FmBuildArgs(alphabet=ja, **args))
    tidx = pt.build_from_records(records, pt.FmBuildArgs(alphabet=ta, **args))
    return jidx, jax_to_device(jidx, build_sweep=True), to_device(tidx, "cpu"), rng


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("alphabet", ["NUCLEOTIDE", "AMINO"])
def test_occ_pair_plain_matches_sweep_and_rank(alphabet):
    import jax.numpy as jnp

    jidx, jdev, tdev, rng = _indexes(alphabet, 60_000, 4, seed=11)
    r = 4000  # not a multiple of the sweep's 128-lane chunk
    pos_a = rng.integers(0, jidx.bwt_len, size=r)
    pos_a[:3] = [0, jidx.bwt_len - 1, 255]  # table edges and a block edge
    pos_b = np.minimum(pos_a + rng.integers(0, 40, size=r), jidx.bwt_len - 1)
    sym = rng.integers(0, jidx.alphabet.cardinality, size=r).astype(np.int32)

    occ_a, occ_b = kernels.occ_pair(
        tdev.blocks, _t(pos_a), _t(pos_b), _t(sym), tdev.codes, tdev.num_planes
    )
    got_a = occ_a.numpy().view(np.uint32)
    got_b = occ_b.numpy().view(np.uint32)

    j_a, j_b, cov = occurrence_sweep_pair(
        jdev, jnp.asarray(pos_a, dtype=jnp.uint32), jnp.asarray(pos_b, dtype=jnp.uint32),
        jnp.asarray(sym), interpret=True,
    )
    assert np.asarray(cov).all()
    np.testing.assert_array_equal(got_a, np.asarray(j_a))
    np.testing.assert_array_equal(got_b, np.asarray(j_b))
    plain_rank = jrank.occurrence(jdev, jnp.asarray(pos_b, dtype=jnp.uint32), jnp.asarray(sym))
    np.testing.assert_array_equal(got_b, np.asarray(plain_rank))
    np.testing.assert_array_equal(
        rank.occurrence_plain(tdev, _t(pos_a), _t(sym)).numpy(), got_a.astype(np.int64)
    )


@pytest.mark.parametrize("table", ["text", "sa"])
def test_window_read_plain_matches_window_sweep(table):
    """window_read over the padded text (k = 3, 4) and the SA (k = 2) equals
    the JAX window sweep, including the clamped extremes of
    tests/test_sweep.py: below k-1, exactly k-1, and past the end."""
    import jax.numpy as jnp

    from awry_tpu.ops.sweep import text_window_sweep

    jidx, jdev, tdev, rng = _indexes("NUCLEOTIDE", 80_000, 4, seed=12)
    flat = tdev.text_packed if table == "text" else tdev.text_sampled_sa
    n = flat.shape[0]
    for k in ((3, 4) if table == "text" else (2,)):
        r = 4000  # not a multiple of 128; dense enough for small sweep windows
        wbase = np.concatenate([
            rng.integers(k, n, size=r - 6),
            [n + 100, k, k + 1, n - 1, k - 1, 0],
        ])
        got = kernels.window_read(flat, _t(wbase), k).numpy().view(np.uint32)
        wb = jnp.asarray(wbase, dtype=jnp.uint32)
        if table == "text":
            want = text_window_sweep(jdev, wb, k, interpret=True)
        else:
            want = window_sweep(jdev.sa_sweep, jdev.text_sampled_sa, wb, k, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(want))
        # And against the host arrays directly, clamp spelled out.
        host = flat.numpy().view(np.uint32)
        c = np.clip(wbase, k - 1, n - 1)
        np.testing.assert_array_equal(got, host[c[:, None] - np.arange(k)[None, :]])


def test_window_read_seed_pairs():
    """The k-mer seed shape: wbase = 2a + 1 reads (end, start) of entry a."""
    _, _, tdev, rng = _indexes("NUCLEOTIDE", 50_000, 6, seed=13)
    a = rng.integers(0, tdev.kmer_flat.shape[0] // 2, size=512)
    pair = kernels.window_read(tdev.kmer_flat, _t(2 * a + 1), 2).numpy()
    flat = tdev.kmer_flat.numpy()
    np.testing.assert_array_equal(pair[:, 1], flat[2 * a])
    np.testing.assert_array_equal(pair[:, 0], flat[2 * a + 1])


def test_post_seed_chain_matches_seeded_pair_chain():
    """Four post-seed LF steps through occ_pair give the same ranges as the
    JAX sorted-domain chain (interpret mode).  Emptiness and counts are
    compared, not the raw endpoints of empty ranges (the chain canonicalises
    empties to (1, 0), the masked loop keeps them frozen)."""
    import jax.numpy as jnp

    jidx, jdev, tdev, rng = _indexes("NUCLEOTIDE", 60_000, 6, seed=14)
    from awry_tpu.alphabet import encode_ascii, index_to_ascii_table, index_to_dense_table

    text = jidx.text_packed  # reads are drawn from the index's own text
    k, steps, L, B = 6, 4, 16, 4000

    ascii_tab = index_to_ascii_table(jidx.alphabet)
    spw = 8
    syms = (text[:, None] >> (4 * np.arange(spw, dtype=np.uint32))[None, :]) & 0xF
    syms = syms.reshape(-1)[: jidx.bwt_len - 1].astype(np.uint8)
    starts = rng.integers(0, syms.shape[0] - L, size=B)
    reads = [bytes(ascii_tab[syms[s : s + L]]) for s in starts]
    reads[:4] = [b"ACGTACGTTTTTTTTT", b"GGGGGGGGGGGGGGGG", b"ACGT" * 4, b"TTTTTTACGTAC" + b"ACGT"]
    qt = np.stack([encode_ascii(jidx.alphabet, np.frombuffer(r, np.uint8)) for r in reads]).T
    qt = np.ascontiguousarray(qt.astype(np.int32))
    qlens = np.full(B, L, dtype=np.int32)
    qlens[5:20] = rng.integers(k, k + steps, size=15)  # lanes that freeze mid-chain

    # Seed ranges from the k-mer table (both packages ship the same table).
    dense = index_to_dense_table(jidx.alphabet).astype(np.int64)
    addr = sum(dense[qt[L - 1 - j]] * 4**j for j in range(k))
    s0, e0 = jidx.kmer_table[addr, 0].astype(np.int64), jidx.kmer_table[addr, 1].astype(np.int64)

    js, je = seeded_pair_chain(
        jdev, jnp.asarray(s0, jnp.uint32), jnp.asarray(e0, jnp.uint32), jnp.asarray(qt),
        jnp.asarray(qlens), k, k + steps, interpret=True,
    )
    js, je = np.asarray(js).astype(np.int64), np.asarray(je).astype(np.int64)

    ts, te = _t(s0), _t(e0)
    ql = _t(qlens.astype(np.int64))
    for i in range(k, k + steps):
        active = (i < ql) & (ts <= te)
        ns, ne = rank.update_range(tdev, ts, te, _t(qt[L - 1 - i]))
        ts, te = torch.where(active, ns, ts), torch.where(active, ne, te)
    ts, te = ts.numpy(), te.numpy()

    np.testing.assert_array_equal(ts <= te, js <= je)
    live = js <= je
    np.testing.assert_array_equal(ts[live], js[live])
    np.testing.assert_array_equal(te[live], je[live])
    assert 0 < live.sum() < B  # both empty and non-empty lanes were exercised


def _backstep(tdev, rows):
    return kernels.backstep(
        tdev.blocks, _t(rows), tdev.prefix_sums, tdev.codes, tdev.c2i, tdev.num_planes,
        tdev.mark_offset, tdev.alphabet.ambiguity_idx,
    )


@pytest.mark.parametrize("alphabet", ["NUCLEOTIDE", "AMINO"])
def test_backstep_plain_matches_sweep_and_host(alphabet):
    """backstep at mark ratio 4 equals backstep_mark_sweep (interpret mode)
    and the host engine's LF step, with the decoded mark bit and mark rank
    equal to the JAX plain-gather ones; rows include the table edges, a
    block edge and the two-band layout of tests/test_sweep.py (an LF walk's
    post-step shape)."""
    import jax.numpy as jnp

    from awry_tpu.ops.locate import _mark_bit_t, _mark_rank_t

    jidx, jdev, tdev, rng = _indexes(alphabet, 60_000, 4, seed=15, mark_ratio=4)
    n = jidx.bwt_len
    rows = np.concatenate([
        [0, n - 1, 255, 256],
        rng.integers(0, 2_000, size=300),
        rng.integers(n - 2_000, n, size=300),
        rng.integers(0, n, size=3_400),
    ])
    stepped, packed = _backstep(tdev, rows)
    stepped, packed = stepped.numpy(), packed.numpy().view(np.uint32)

    jrows = jnp.asarray(rows, dtype=jnp.uint32)
    j_st, j_mark, cov = backstep_mark_sweep(jdev, jrows, interpret=True)
    assert np.asarray(cov).all()
    np.testing.assert_array_equal(stepped, np.asarray(j_st).astype(np.int64))
    np.testing.assert_array_equal(packed, np.asarray(j_mark))
    np.testing.assert_array_equal(stepped, he.backstep(jidx, rows))
    rows_t = jrank.fetch_rows_t(jdev, jrows)
    np.testing.assert_array_equal(packed & 1, np.asarray(_mark_bit_t(jdev, rows_t, jrows)))
    np.testing.assert_array_equal(packed >> 1, np.asarray(_mark_rank_t(jdev, rows_t, jrows)))
    assert (packed & 1).any() and not (packed & 1).all()

    t_rows = _t(rows)
    np.testing.assert_array_equal(rank.symbol_at(tdev, t_rows).numpy(), np.asarray(jrank.symbol_at(jdev, jrows)))
    np.testing.assert_array_equal(rank.backstep(tdev, t_rows).numpy(), stepped)
    _, bit, mrank = rank.backstep_mark(tdev, t_rows)
    np.testing.assert_array_equal(bit.numpy(), (packed & 1) == 1)
    np.testing.assert_array_equal(mrank.numpy(), packed >> 1)


def test_blocked_twins_match_plain(monkeypatch):
    """The blocked-window twins (_text_kernel, _occ_pair_kernel,
    _backstep_kernel: the reference with USE_ANCHORED off) compute the same
    functions as window_read, occ_pair and backstep."""
    import jax
    import jax.numpy as jnp

    from awry_tpu.ops.sweep import text_window_sweep

    jidx, jdev, tdev, rng = _indexes("NUCLEOTIDE", 60_000, 4, seed=16, mark_ratio=4)
    n = jidx.bwt_len
    r = 4000
    nw = tdev.text_packed.shape[0]
    wbase = np.concatenate([rng.integers(3, nw, size=r - 3), [nw + 50, 2, nw - 1]])
    pos_a = rng.integers(0, n, size=r)
    pos_b = np.minimum(pos_a + rng.integers(0, 40, size=r), n - 1)
    sym = rng.integers(0, jidx.alphabet.cardinality, size=r).astype(np.int32)
    rows = np.concatenate([[0, n - 1], rng.integers(0, n, size=r - 2)])
    u32 = lambda a: jnp.asarray(a, dtype=jnp.uint32)  # noqa: E731

    monkeypatch.setattr(jsweep, "USE_ANCHORED", False)
    jax.clear_caches()  # the flag is read at trace time
    try:
        before = jsweep.TRACE_COUNTS["window_sweep_anchored"]
        j_text = np.asarray(text_window_sweep(jdev, u32(wbase), 3, interpret=True))
        assert jsweep.TRACE_COUNTS["window_sweep_anchored"] == before
        j_a, j_b, cov_p = occurrence_sweep_pair(jdev, u32(pos_a), u32(pos_b), jnp.asarray(sym), interpret=True)
        j_st, j_mark, cov_b = backstep_mark_sweep(jdev, u32(rows), interpret=True)
    finally:
        jax.clear_caches()
    assert np.asarray(cov_p).all() and np.asarray(cov_b).all()

    np.testing.assert_array_equal(
        kernels.window_read(tdev.text_packed, _t(wbase), 3).numpy().view(np.uint32), j_text
    )
    occ_a, occ_b = kernels.occ_pair(tdev.blocks, _t(pos_a), _t(pos_b), _t(sym), tdev.codes, tdev.num_planes)
    np.testing.assert_array_equal(occ_a.numpy().view(np.uint32), np.asarray(j_a))
    np.testing.assert_array_equal(occ_b.numpy().view(np.uint32), np.asarray(j_b))
    stepped, packed = _backstep(tdev, rows)
    np.testing.assert_array_equal(stepped.numpy(), np.asarray(j_st).astype(np.int64))
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), np.asarray(j_mark))


def test_wrappers_route_cpu_tensors_to_plain():
    """CPU tensors take the plain version and count no launch; tensors on
    two different devices are refused."""
    flat = torch.arange(100, dtype=torch.int32)
    counts = lambda: (kernels.window_read.launches, kernels.occ_pair.launches, kernels.backstep.launches)  # noqa: E731
    before = counts()
    out = kernels.window_read(flat, torch.tensor([5, 50], dtype=torch.int64), 3)
    assert out.tolist() == [[5, 4, 3], [50, 49, 48]]
    assert kernels.window_read(flat, torch.tensor([0, 99, 500], dtype=torch.int64), 1).tolist() == [[0], [99], [99]]
    assert counts() == before
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        kernels.window_read(flat, torch.zeros(2, dtype=torch.int64, device="meta"), 2)
