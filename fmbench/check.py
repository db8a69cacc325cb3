"""The comparison that decides ``correct``, and the controls that must fail it.

Every answer a run got back for a sampled lane (``harness.Sampler``) is
held to the plain reference (``reference/exact_match.py``): its count, and
for count+locate its whole set of (record, position) hits.  Both are exact,
so each limit is 0 (``max``).
"""

from __future__ import annotations

import numpy as np

from .reference.exact_match import localize


def sample_answers(result, lanes: np.ndarray):
    """The sampled lanes' answers in one returned batch: ``(lanes, counts)``
    of a count batch, ``(lanes, counts, hits per lane, records, positions)``
    of a count+locate batch (``(counts, seq_idx, local, offsets)``)."""
    if not isinstance(result, tuple):
        return lanes, np.asarray(result)[lanes].astype(np.int64)
    counts, seq_idx, local, offsets = result
    lo = offsets[lanes]
    ln = offsets[lanes + 1] - lo
    idx = np.repeat(lo - (np.cumsum(ln) - ln), ln) + np.arange(int(ln.sum()))
    return lanes, counts[lanes].astype(np.int64), ln, seq_idx[idx].astype(np.int64), local[idx].astype(np.int64)


def _keys(rec: np.ndarray, pos: np.ndarray) -> np.ndarray:
    return (rec << 40) | pos


def _reference_of(lanes: np.ndarray, b: int, want: dict, record_starts: np.ndarray):
    """(hits per lane, sorted (record, local) keys) the reference gives the
    lanes ``lanes`` of pool batch ``b``."""
    pos = [want[(b, int(lane))] for lane in lanes]
    lens = np.asarray([p.shape[0] for p in pos], dtype=np.int64)
    flat = np.concatenate(pos) if pos else np.zeros(0, np.int64)
    rec, local = localize(flat, record_starts)
    return lens, _keys(rec, local)


def compare(answers: list, want: dict, record_starts: np.ndarray, locate: bool) -> tuple[dict, int]:
    """(numbers compared, each with its limit; lanes compared): sampled
    lanes whose count differs from the reference's, and (count+locate) whose
    sorted hit set differs.  ``answers``: ``(pool batch, sample_answers(...))``
    of each returned batch; ``want[(batch, lane)]``: the reference's sorted
    global positions."""
    count_bad = hit_bad = compared = 0
    for b, ans in answers:
        lanes, counts = ans[0], ans[1]
        lens, keys = _reference_of(lanes, b, want, record_starts)
        compared += lanes.shape[0]
        count_bad += int((counts != lens).sum())
        if not locate:
            continue
        ln, got = ans[2], _keys(ans[3], ans[4])
        lane_of = np.repeat(np.arange(lanes.shape[0]), ln)
        got = got[np.lexsort((got, lane_of))]
        bad = ln != lens
        if not bad.any():
            bad[lane_of[got != keys]] = True
        else:  # lengths differ: lane by lane
            ends, rends = np.cumsum(ln), np.cumsum(lens)
            for i in np.flatnonzero(~bad):
                if not np.array_equal(got[ends[i] - ln[i] : ends[i]], keys[rends[i] - lens[i] : rends[i]]):
                    bad[i] = True
        hit_bad += int(bad.sum())
    out = {"count_mismatches": {"value": count_bad, "max": 0}}
    if locate:
        out["hit_set_mismatches"] = {"value": hit_bad, "max": 0}
    return out, compared


CONTROLS = ("truncate", "prefix16")


def control_answers(kind: str, answers: list, want: dict, reads: dict, text, record_starts, cap: int,
                    locate: bool = True) -> list:
    """The returned batches ``answers`` again, each sampled lane answered by
    the reference with one guarantee broken, in the program's place:
    ``truncate`` keeps each count but stops each locate at ``cap`` hits (the
    over-cap expansion dropped); ``prefix16`` answers for each read's first
    16 symbols only (the seed and three rank steps without the verify
    compare).  ``reads[(batch, lane)]``: the read."""
    from .reference.exact_match import find_all

    if kind == "prefix16":
        keys = list(want)
        got = dict(zip(keys, find_all(text, [reads[k][:16] for k in keys])))
    out = []
    for b, ans in answers:
        lanes = ans[0]
        full = [want[(b, int(lane))] for lane in lanes]
        pos = [p[:cap] for p in full] if kind == "truncate" else [got[(b, int(lane))] for lane in lanes]
        counts = np.asarray([p.shape[0] for p in (full if kind == "truncate" else pos)], dtype=np.int64)
        if not locate:
            out.append((b, (lanes, counts)))
            continue
        ln = np.asarray([p.shape[0] for p in pos], dtype=np.int64)
        flat = np.concatenate(pos) if pos else np.zeros(0, np.int64)
        rec, local = localize(flat, record_starts)
        out.append((b, (lanes, counts, ln, rec, local)))
    return out
