"""Seeded texts and reads: the benchmark's own generators.

Frozen copies, so that a later change to the program cannot move the
yardstick:

* ``plant_repeat_family`` is ``bench.py``'s ``synth_repetitive_dna``
  (bench.py:267-283) with its coverage, element length, family size and
  divergence taken from the configuration file and its copies placed inside
  given intervals (the records' non-N interiors);
* ``grch38_records`` is ``chip_smoke.py``'s ``grch38_text`` (chip_smoke.py:759)
  with the total length, N-run length and chromosome lengths taken from the
  configuration file;
* ``interior_starts`` is ``chip_smoke.py``'s ``draw_positions``
  (chip_smoke.py:797) for any read length.

A configuration's text follows its ``text_seed`` alone; ``--seed`` draws the
reads (``draw_pool``).  Texts are uint8 ASCII over ``ACGTN``, records joined
by one ``N``, the way the port's builder joins them.
"""

from __future__ import annotations

import numpy as np

LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)
N = ord("N")


def plant_repeat_family(text: np.ndarray, rng: np.random.Generator, fam: dict, lo: np.ndarray,
                        hi: np.ndarray) -> np.ndarray:
    """Overwrite ``fam["coverage"]`` of ``text`` with point-mutated copies of
    a family of ``fam["subfamilies"]`` random elements of ``fam["length"]``
    symbols; each copy lies in one interval ``[lo, hi)`` (chosen by length)
    and overlapping copies overwrite each other, as nested repeats do.
    Returns the copies' start positions, sorted."""
    rep_len, n_family, mut = int(fam["length"]), int(fam["subfamilies"]), float(fam["divergence"])
    room = (hi - lo - rep_len).astype(np.int64)
    m = int(int(room.sum()) * float(fam["coverage"]) / rep_len)
    family = rng.choice(LETTERS, size=(n_family, rep_len))
    inst = family[rng.integers(0, n_family, size=m)]  # [m, rep_len]
    mut_mask = rng.random((m, rep_len), dtype=np.float32) < mut
    inst = np.where(mut_mask, rng.choice(LETTERS, size=(m, rep_len)), inst)
    cum = np.cumsum(room)
    u = rng.integers(0, cum[-1], size=m)
    r = np.searchsorted(cum, u, side="right")
    starts = lo[r] + (u - (cum[r] - room[r]))
    for s in range(0, m, 1 << 16):  # bounded temporaries
        idx = starts[s : s + (1 << 16), None] + np.arange(rep_len)[None, :]
        text[idx.reshape(-1)] = inst[s : s + (1 << 16)].reshape(-1)
    return np.sort(starts)


def grch38_records(rng: np.random.Generator, total: int, n_run: int, lengths: list[int]):
    """The joined text of ``len(lengths)`` records in those proportions
    summing to ``total`` symbols, each seeded random ACGT between two
    ``n_run`` N runs, joined by the N delimiter; with record starts and
    lengths."""
    w = np.asarray(lengths, dtype=np.float64)
    rec = np.floor(w / w.sum() * total).astype(np.int64)
    rec[0] += total - int(rec.sum())
    starts = np.concatenate([[0], np.cumsum(rec + 1)[:-1]]).astype(np.int64)
    text = LETTERS[rng.integers(0, 4, size=int(rec.sum()) + len(rec) - 1, dtype=np.uint8)]
    for s, ln in zip(starts.tolist(), rec.tolist()):
        text[s : s + n_run] = N
        text[s + ln - n_run : s + ln + 1] = N  # the closing run and the delimiter
    return text, starts, rec


def make_text(cfg: dict):
    """(text uint8, record starts int64, record lengths int64, repeat copy
    starts int64) of a configuration, from its text keys alone."""
    rng = np.random.default_rng(int(cfg["text_seed"]))
    n, margin = int(cfg["symbols"]), int(cfg.get("n_run", 0))
    if "record_lengths" in cfg:
        text, starts, lengths = grch38_records(rng, n, margin, cfg["record_lengths"])
    else:
        text = LETTERS[rng.integers(0, 4, size=n, dtype=np.uint8)]
        starts, lengths = np.zeros(1, np.int64), np.asarray([n], np.int64)
    copies = plant_repeat_family(text, rng, cfg["repeats"], starts + margin, starts + lengths - margin)
    return text, starts, lengths, copies


def interior_starts(rng, starts, lengths, margin: int, qlen: int, n: int) -> np.ndarray:
    """n read starts uniform over the records' interiors (``margin`` inside
    each end)."""
    valid = lengths - 2 * margin - qlen + 1
    cum = np.cumsum(valid)
    u = rng.integers(0, cum[-1], size=n)
    r = np.searchsorted(cum, u, side="right")
    return starts[r] + margin + (u - (cum[r] - valid[r]))


def repeat_overlap(origins: np.ndarray, qlen: int, copies: np.ndarray, rep_len: int) -> np.ndarray:
    """Whether each read [origin, origin + qlen) overlaps a repeat copy."""
    first = np.searchsorted(copies, origins - rep_len + 1, side="left")
    return (first < copies.shape[0]) & (copies[np.minimum(first, copies.shape[0] - 1)] < origins + qlen)


def seed_words(seed: int, stream: int) -> list[int]:
    """Entropy for ``np.random.default_rng`` from any whole ``--seed``
    (negative or past 64 bits included) and a stream tag."""
    s = int(seed) % 2**64
    return [s & 0xFFFFFFFF, s >> 32, stream]


def draw_pool(text: np.ndarray, starts, lengths, copies, cfg: dict, mix: dict, seed: int):
    """The pool of reads a run serves, from ``--seed``: ``(reads uint8
    [pool * batch, qlen], origins int64, has_n bool, in_repeat bool)``.
    ``mix["source"]``: ``uniform`` over the records' interiors, or
    ``repeats`` (inside the repeat copies only).  Each read then takes
    per-base substitutions at ``substitution_rate`` and, with
    ``n_read_share``, one N at a random place."""
    rng = np.random.default_rng(seed_words(seed, 0x5EED))
    qlen, total = int(mix["read_len"]), int(mix["batch"]) * int(mix["pool"])
    margin = int(cfg.get("n_run", 0))
    rep_len = int(cfg["repeats"]["length"])
    if mix["source"] == "uniform":
        origins = interior_starts(rng, starts, lengths, margin, qlen, total)
    elif mix["source"] == "repeats":
        origins = copies[rng.integers(0, copies.shape[0], size=total)] + rng.integers(0, rep_len - qlen + 1, size=total)
    else:
        raise ValueError(f"unknown read source {mix['source']!r}")
    reads = np.empty((total, qlen), dtype=np.uint8)
    ar = np.arange(qlen)
    for s in range(0, total, 1 << 18):
        reads[s : s + (1 << 18)] = text[origins[s : s + (1 << 18), None] + ar]
    # Substitutions at ``substitution_rate`` per base: a binomial count of
    # places drawn uniformly (a place drawn twice is changed once).
    nsub = rng.binomial(total * qlen, float(mix["substitution_rate"]))
    sub = np.unique(rng.integers(0, total * qlen, size=nsub))
    flat = reads.reshape(-1)
    # A substitution changes the base: one of the three other letters.
    code = np.searchsorted(LETTERS, flat[sub])
    flat[sub] = LETTERS[(code + rng.integers(1, 4, size=sub.shape[0])) % 4]
    has_n = rng.random(total) < float(mix.get("n_read_share", 0.0))
    rows = np.flatnonzero(has_n)
    reads[rows, rng.integers(0, qlen, size=rows.shape[0])] = N
    return reads, origins, has_n, repeat_overlap(origins, qlen, copies, rep_len)
