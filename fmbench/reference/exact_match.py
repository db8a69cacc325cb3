"""Plain exact matching: every place a read occurs in a text.

The reference that decides ``correct``.  It knows nothing of FM-indexes: it
finds the reads' anchor k-mers by one rolling scan of the text, keeps the
places where the read's last clean k-mer matches too, then checks each
candidate place symbol by symbol.  Symbols match literally (``N``
matches ``N`` only), over the joined text the index is built on, and a hit's
record is the last record start at or before it.  NumPy only; it imports
nothing of the program.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

K = 10  # anchor length: 4**10 keys, a 1 MiB table that stays in cache
CHUNK = 1 << 24
THREADS = 8  # chunks scanned at once (NumPy drops the GIL in these passes)
_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i


def _anchors(read: np.ndarray) -> tuple[int, int]:
    """Offsets of the first and the last window of K A/C/G/T symbols in
    ``read`` ((-1, -1) if none)."""
    bad = _CODE[read] > 3
    run = np.convolve(bad.astype(np.int32), np.ones(K, dtype=np.int32), mode="valid") if read.shape[0] >= K else []
    free = np.flatnonzero(np.asarray(run) == 0)
    return (int(free[0]), int(free[-1])) if free.size else (-1, -1)


def _key(codes: np.ndarray) -> int:
    v = 0
    for c in codes.tolist():
        v = (v << 2) | c
    return v


def _rolling_keys(codes: np.ndarray):
    """(key of the K-mer at each start, whether it holds only A/C/G/T) for
    the ``len(codes) - K + 1`` starts of a chunk: two 4-mers and a 2-mer."""
    n4 = codes.shape[0] - 3
    k4 = np.zeros(n4, dtype=np.uint8)
    bad4 = np.zeros(n4, dtype=np.uint8)
    for j in range(4):
        c = codes[j : j + n4]
        k4 = (k4 << 2) | (c & 3)
        bad4 |= c >> 2
    m = codes.shape[0] - K + 1
    k2 = ((codes[8 : 8 + m] & 3) << 2) | (codes[9 : 9 + m] & 3)
    key = (k4[:m].astype(np.uint32) << 12) | (k4[4 : 4 + m].astype(np.uint32) << 4) | k2
    ok = (bad4[:m] | bad4[4 : 4 + m] | (codes[8 : 8 + m] >> 2) | (codes[9 : 9 + m] >> 2)) == 0
    return key, ok


def find_all(text: np.ndarray, reads: list[np.ndarray]) -> list[np.ndarray]:
    """Sorted int64 start positions of each read in ``text`` (uint8 ASCII)."""
    n = text.shape[0]
    out: list[np.ndarray] = [np.zeros(0, dtype=np.int64) for _ in reads]
    anchored, keys, offs, keys2, offs2 = [], [], [], [], []
    for i, r in enumerate(reads):
        a, a2 = _anchors(r)
        if a < 0:  # no anchor: a direct scan (short reads or runs of N)
            out[i] = _scan(text, r)
        else:
            anchored.append(i)
            keys.append(_key(_CODE[r[a : a + K]]))
            offs.append(a)
            keys2.append(_key(_CODE[r[a2 : a2 + K]]))
            offs2.append(a2)
    if not anchored:
        return out
    keys_a = np.asarray(keys, dtype=np.uint32)
    order = np.argsort(keys_a, kind="stable")
    keys_s, read_s = keys_a[order], np.asarray(anchored, dtype=np.int64)[order]
    offs_s = np.asarray(offs, dtype=np.int64)[order]
    keys2_s = np.asarray(keys2, dtype=np.uint32)[order]
    offs2_s = np.asarray(offs2, dtype=np.int64)[order]
    table = np.zeros(1 << (2 * K), dtype=bool)
    table[keys_s] = True

    def scan(c0: int):
        chunk = text[c0 : min(n, c0 + CHUNK + K - 1)]
        key, ok = _rolling_keys(_CODE[chunk])
        p = np.flatnonzero(table[key] & ok)
        kv = key[p]
        lo = np.searchsorted(keys_s, kv, side="left")
        cnt = np.searchsorted(keys_s, kv, side="right") - lo
        pos = np.repeat(p.astype(np.int64), cnt)
        j = np.repeat(lo - np.cumsum(cnt) + cnt, cnt) + np.arange(int(cnt.sum()))
        # The last clean K-mer has to match as well where it lies in this
        # chunk; a place whose last K-mer lies past it stays a candidate.
        q = pos - offs_s[j] + offs2_s[j]
        inside = (q >= 0) & (q < key.shape[0])
        qi = np.where(inside, q, 0)
        keep = ~inside | (ok[qi] & (key[qi] == keys2_s[j]))
        pos, j = pos[keep], j[keep]
        return pos + c0 - offs_s[j], read_s[j]

    with ThreadPoolExecutor(THREADS) as pool:
        found = list(pool.map(scan, range(0, max(n - K + 1, 0), CHUNK)))
    cand_pos = [f[0] for f in found]
    cand_read = [f[1] for f in found]
    if not cand_pos:
        return out
    start = np.concatenate(cand_pos)
    which = np.concatenate(cand_read)
    lens = np.asarray([r.shape[0] for r in reads], dtype=np.int64)
    keep = (start >= 0) & (start + lens[which] <= n)
    start, which = start[keep], which[keep]
    hits = np.zeros(start.shape[0], dtype=bool)
    for L in np.unique(lens[which]).tolist():
        # The reads of one length as one matrix, and each read's row in it.
        same = np.flatnonzero(lens == L)
        mat = np.stack([reads[i] for i in same.tolist()])
        row = np.zeros(len(reads), dtype=np.int64)
        row[same] = np.arange(same.shape[0])
        sel = np.flatnonzero(lens[which] == L)
        for s in range(0, sel.shape[0], 1 << 20):
            part = sel[s : s + (1 << 20)]
            got = text[start[part, None] + np.arange(L)]
            hits[part] = (got == mat[row[which[part]]]).all(axis=1)
    start, which = start[hits], which[hits]
    order = np.lexsort((start, which))
    start, which = start[order], which[order]
    bounds = np.searchsorted(which, np.arange(len(reads) + 1))
    for i in anchored:
        out[i] = start[bounds[i] : bounds[i + 1]]
    return out


def _scan(text: np.ndarray, read: np.ndarray) -> np.ndarray:
    """All starts of ``read`` by repeated ``bytes.find`` (overlaps included)."""
    t, q, pos, i = text.tobytes(), read.tobytes(), [], 0
    if not q:
        return np.zeros(0, dtype=np.int64)
    while (i := t.find(q, i)) >= 0:
        pos.append(i)
        i += 1
    return np.asarray(pos, dtype=np.int64)


def localize(positions: np.ndarray, record_starts: np.ndarray):
    """Global positions -> (record index, position inside the record)."""
    rec = np.searchsorted(record_starts, positions, side="right") - 1
    return rec, positions - record_starts[rec]
