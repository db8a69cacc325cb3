"""Counting-based k-mer seed-table construction (host, O(N*k + base**k)).

The port's copy of ``awry_tpu/build/kmer_count.py``.  The table entry for
k-mer ``w`` is the BWT row range of suffixes prefixed by ``w``, which depends
only on suffix order truncated to k symbols:

    start(w) = #{suffixes s : s <_lex w within the first k symbols}
    end(w)   = start(w) + #{suffixes whose first k symbols == w} - 1

so it is built straight from the text by a radix histogram:

  1. cnt[a]  = #windows of k encoding symbols with dense address a;
  2. every remaining suffix (a window holding the ambiguity symbol or
     reaching the final virtual sentinel) adds +1 to start(a) for every a
     above its lexicographic insert point, which depends only on the digits
     before its FIRST non-encoding symbol (a sentinel sorts below every
     encoding symbol; the ambiguity symbol at a fixed rank among them);
  3. start(a) = exclusive-cumsum(cnt)[a] + #{insert points <= a}.
"""

from __future__ import annotations

import numpy as np

from ..alphabet import Alphabet, index_to_dense_table

# Invalid-window insert points are processed in bounded chunks so texts with
# huge ambiguity runs never materialize an m x k matrix at once.
_INVALID_CHUNK = 1 << 24


def _window_addresses(dense: np.ndarray, k: int, b: int) -> np.ndarray:
    """Base-``b`` address of every k-symbol window, ``addr[i] = sum_j
    dense[i+j] * b**(k-1-j)``, valid wherever all k digits are >= 0 (lanes
    with a negative digit hold wrapped garbage the caller masks).  O(log k)
    whole-array multiply-add passes by width doubling."""
    L = dense.shape[0]
    d1 = dense.astype(np.uint32)  # -1 digits wrap; masked by the caller
    cur, m = d1, 1
    for bit in bin(k)[3:]:  # binary expansion below the MSB
        p = np.uint32(b) ** np.uint32(m)
        nlen = L - 2 * m + 1
        nxt = cur[:nlen] * p
        nxt += cur[m : m + nlen]
        cur, m = nxt, 2 * m
        if bit == "1":
            nlen = L - m
            nxt = cur[:nlen] * np.uint32(b)
            nxt += d1[m : m + nlen]
            cur, m = nxt, m + 1
    return cur


def populate_kmer_table_counting(
    text_syms: np.ndarray, alphabet: Alphabet, k: int
) -> np.ndarray:
    """Build the dense k-mer seed table by counting, from the raw text.

    ``text_syms``: uint8 symbol indices of the concatenated text (no
    sentinel).  Returns [base**k, 2] ranges, uint32 when every row index fits
    (bwt_len <= 2**32), else uint64; empty entries hold the canonical (1, 0).
    """
    if k == 0:  # table disabled: single canonical-empty entry, never read
        return np.array([[1, 0]], dtype=np.uint64)
    b = alphabet.num_encoding_symbols
    n = int(text_syms.shape[0])
    total = b**k
    assert total < 1 << 32, "b**k table would exceed addressable/host memory"
    dense_tab = index_to_dense_table(alphabet)
    # rank_above: #encoding symbols whose raw index sorts below the ambiguity
    # symbol (A,C,G for nucleotide N; 19 aminos below X).
    rank_above = int(
        ((dense_tab >= 0) & (np.arange(dense_tab.shape[0]) < alphabet.ambiguity_idx)).sum()
    )

    # Dense digits over the bwt text, padded to n + k; padding and the
    # sentinel are -1, so any window touching them takes the invalid path.
    dense = np.full(n + k, -1, dtype=np.int8)
    dense[:n] = dense_tab[text_syms]
    bad = dense < 0
    any_bad_text = bool(bad[:n].any())

    # --- valid windows: chunked addresses + histogram ------------------------
    n_starts = n - k + 1  # window starts fully inside the text
    m_invalid_text = 0
    inv_text_parts: list[np.ndarray] = []
    narrow = n + 1 <= (1 << 32)  # uint32 counts and table entries
    cnt32 = np.zeros(total, dtype=np.uint32) if narrow else None
    cnt64 = None if narrow else np.zeros(total, dtype=np.int64)
    chunk = 1 << 28
    for lo in range(0, max(n_starts, 0), chunk):
        hi = min(lo + chunk, n_starts)
        sub = dense[lo : hi + k - 1]
        addr = _window_addresses(sub, k, b)[: hi - lo]
        if any_bad_text:
            bsub = bad[lo : hi + k - 1]
            bc = np.zeros(bsub.shape[0] + 1, dtype=np.int64)
            np.cumsum(bsub, out=bc[1:])
            valid = (bc[k:] - bc[: hi - lo]) == 0
            n_inv = int(hi - lo - valid.sum())
            if n_inv:
                inv_text_parts.append(lo + np.flatnonzero(~valid))
                m_invalid_text += n_inv
                addr = addr[valid]
        if narrow:
            from .suffix_array import kmer_hist_native

            kmer_hist_native(addr, cnt32)
        else:
            cnt64 += np.bincount(addr, minlength=total)
        del addr

    # --- invalid windows: lexicographic insert points ------------------------
    n_tail = n + 1 - max(n_starts, 0)  # starts in (n-k, n] reach the sentinel
    m = m_invalid_text + n_tail
    insert_parts = []
    if m:
        inv_starts_text = (
            np.concatenate(inv_text_parts)
            if inv_text_parts
            else np.zeros(0, dtype=np.int64)
        )
        tail = np.arange(max(n_starts, 0), n + 1, dtype=np.int64)
        inv_starts = np.concatenate([inv_starts_text, tail])
        pow_b = b ** np.arange(k + 1, dtype=np.int64)  # pow_b[j] = b**j
        for lo in range(0, inv_starts.shape[0], _INVALID_CHUNK):
            s = inv_starts[lo : lo + _INVALID_CHUNK]
            win = dense[s[:, None] + np.arange(k, dtype=np.int64)[None, :]].astype(
                np.int64
            )  # [m_c, k]
            is_bad = win < 0
            j = np.argmax(is_bad, axis=1)  # first bad digit (exists by construction)
            # Sentinel (position n or padding past it) sorts at rank 0, the
            # ambiguity symbol at rank_above.
            first_bad_pos = s + j
            is_sentinel = first_bad_pos >= n
            rank = np.where(is_sentinel, 0, rank_above)
            # prefix = digits 0..j-1 as a base-b number.
            masked = np.where(np.arange(k)[None, :] < j[:, None], win, 0)
            prefix = (masked * pow_b[k - 1 :: -1][None, :]).sum(axis=1) // pow_b[k - j]
            insert_parts.append((prefix * b + rank) * pow_b[k - 1 - j])
    inserts = (
        np.sort(np.concatenate(insert_parts)) if insert_parts else np.zeros(0, dtype=np.int64)
    )
    counted = int(cnt32.sum(dtype=np.int64) if narrow else cnt64.sum())
    assert counted + m == n + 1, "every suffix must be counted exactly once"

    # --- assemble -------------------------------------------------------------
    if narrow:
        from .suffix_array import kmer_fill_native

        return kmer_fill_native(cnt32, inserts)

    cnt = cnt64
    inv_hist = np.bincount(inserts, minlength=total + 1) if m else np.zeros(total + 1, dtype=np.int64)
    starts = np.zeros(total, dtype=np.int64)
    np.cumsum(cnt[:-1], out=starts[1:])  # exclusive cumsum of bucket sizes
    starts += np.cumsum(inv_hist[:total])  # inserts at <= a shift start(a) up
    ends = starts + cnt - 1
    table = np.empty((total, 2), dtype=np.uint64)
    table[:, 0] = starts.astype(np.uint64)
    table[:, 1] = ends.astype(np.uint64)
    empty = cnt == 0
    table[empty, 0] = 1  # canonical empty range
    table[empty, 1] = 0
    return table
