"""The plain reference against hand-made cases and a brute-force scan."""

import numpy as np
import pytest

from fmbench.reference.exact_match import find_all, localize


def brute(text: bytes, q: bytes) -> list[int]:
    return [i for i in range(len(text) - len(q) + 1) if text[i : i + len(q)] == q]


def arr(b: bytes) -> np.ndarray:
    return np.frombuffer(b, dtype=np.uint8).copy()


def test_hand_cases():
    text = b"ACGTACGTACGTNNNNACGTTTTTTTTTTTTGGNACGTACGTACGTAC"
    t = arr(text)
    cases = {
        b"ACGTACGTAC": [0, 34, 38],  # overlapping repeats
        b"TTTTTTTTTTT": [19, 20],
        b"GTNNNNACGTTT": [10],  # N matches N only
        b"GGNACGTACGT": [31],
        b"ACGTAC": [0, 4, 34, 38, 42],  # shorter than the anchor: a direct scan
        b"NNNN": [12],
        b"ACGTACGTACGTACGTACGT": [],
        b"CGTACGTAC": [1, 35, 39],
        b"ACGTACGTACGTAC": [34],  # at the text's end
    }
    got = find_all(t, [arr(q) for q in cases])
    for (q, want), g in zip(cases.items(), got):
        assert g.tolist() == want == brute(text, q), q


def test_record_edges_localize():
    starts = np.asarray([0, 10, 25], dtype=np.int64)
    rec, local = localize(np.asarray([0, 9, 10, 24, 25, 40]), starts)
    assert rec.tolist() == [0, 0, 1, 1, 2, 2]
    assert local.tolist() == [0, 9, 0, 14, 0, 15]


@pytest.mark.parametrize("seed", [1, 2])
def test_random_text_against_brute_force(seed):
    rng = np.random.default_rng(seed)
    t = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 20_000)].copy()
    t[5000:5400] = t[100:500]  # a repeat
    t[9000:9050] = ord("N")
    reads = [t[s : s + L].copy() for s, L in zip(rng.integers(0, 19_900, 40), rng.choice([12, 30, 60], 40))]
    reads += [t[8990:9020].copy(), t[19_970:20_000].copy(), t[150:180].copy()]
    reads[0][5] = ord("N")
    got = find_all(t, reads)
    text = t.tobytes()
    for q, g in zip(reads, got):
        assert g.tolist() == brute(text, q.tobytes())


def test_chunk_edges_and_second_anchor(monkeypatch):
    from fmbench.reference import exact_match

    monkeypatch.setattr(exact_match, "CHUNK", 97)  # many chunk edges inside the reads
    rng = np.random.default_rng(9)
    t = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 5_000)].copy()
    t[1000:1100] = t[200:300]  # a repeat: the first anchor matches twice
    t[3020:3040] = t[210:230]  # only a prefix repeats: the last anchor rejects it
    t[4000:4003] = ord("N")
    reads = [t[s : s + L].copy() for s, L in zip(rng.integers(0, 4_900, 60), rng.choice([11, 30, 100], 60))]
    reads += [t[200:300].copy(), t[205:235].copy(), t[210:240].copy(), t[3990:4020].copy()]
    got = find_all(t, reads)
    text = t.tobytes()
    for q, g in zip(reads, got):
        assert g.tolist() == brute(text, q.tobytes())
    assert got[-4].tolist() == [200, 1000] and got[-3].tolist() == [205, 1005]
    assert got[-2].tolist() == [210, 1010]  # not 3020, where only its first anchor recurs
