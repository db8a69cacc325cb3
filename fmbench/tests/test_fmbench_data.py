"""The generators: deterministic per seed, and shaped as configured."""

import numpy as np
import pytest

from fmbench import data

CFG = {"symbols": 50_000, "text_seed": 7, "repeats": {"length": 300, "subfamilies": 4, "divergence": 0.1,
                                                       "coverage": 0.1}}
GRCH = dict(CFG, n_run=200, record_lengths=[5, 3, 2])
MIX = {"read_len": 30, "source": "uniform", "substitution_rate": 0.01, "n_read_share": 0.05, "batch": 64, "pool": 3}


@pytest.mark.parametrize("cfg", [CFG, GRCH], ids=["one_record", "chromosomes"])
def test_text_follows_its_text_seed(cfg):
    a, b = data.make_text(cfg), data.make_text(cfg)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    other = data.make_text(dict(cfg, text_seed=8))
    assert not np.array_equal(a[0], other[0])


def test_records_have_their_n_runs_and_delimiters():
    text, starts, lengths, copies = data.make_text(GRCH)
    assert text.shape[0] == int(lengths.sum()) + len(lengths) - 1
    for s, ln in zip(starts.tolist(), lengths.tolist()):
        assert (text[s : s + 200] == data.N).all() and (text[s + ln - 200 : s + ln] == data.N).all()
        assert not (text[s + 200 : s + ln - 200] == data.N).any()
    assert copies.size and np.all(np.diff(copies) >= 0)


@pytest.mark.parametrize("source", ["uniform", "repeats"])
def test_pool_follows_the_seed(source):
    text, starts, lengths, copies = data.make_text(GRCH)
    mix = dict(MIX, source=source)
    seed = 2**31 + 2**33 + 5  # past 32 bits (negative seeds fold into 64 bits)
    a = data.draw_pool(text, starts, lengths, copies, GRCH, mix, seed)
    b = data.draw_pool(text, starts, lengths, copies, GRCH, mix, seed)
    c = data.draw_pool(text, starts, lengths, copies, GRCH, mix, seed + 1)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    reads, origins, has_n, in_repeat = a
    assert reads.shape == (MIX["batch"] * MIX["pool"], 30)
    assert ((reads == data.N).sum(axis=1) == has_n).all()  # one N in each read that has one
    if source == "repeats":
        assert in_repeat.all()


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 2**40 + 3, -5])
def test_any_whole_seed_draws(seed):
    text, starts, lengths, copies = data.make_text(CFG)
    reads = data.draw_pool(text, starts, lengths, copies, CFG, MIX, seed)[0]
    assert reads.shape == (MIX["batch"] * MIX["pool"], MIX["read_len"])
