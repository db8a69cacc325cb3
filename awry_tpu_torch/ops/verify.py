"""Seed-walk-verify: the fused count+locate serving path.

On genome-scale indexes a backward-search range collapses almost at once:
after S consumed symbols the expected width is bwt_len / 4^S << 1.  This
path stops the search at the switch step S, reads the single candidate
row's text position (lf_walk: one SA read at mark ratio 1, a marked LF
walk above it), and confirms the
remaining qlen - S query symbols against the packed text - replacing the
other rank steps with one window read and static compares, with locate
free for verified hits.  Results are exact:

* width 0 at S, or qlen <= S: the search already finished;
* width 1, qlen > S: the full query occurs iff the text just before the
  candidate suffix equals the query's remaining prefix;
* width 2..WIDE_CAP ("wide"): the candidate rows are compacted into
  ``wide_groups(B)`` groups and verified alongside;
* wider, or past the group budget: flagged ``redis`` for the caller's
  classic full-depth re-dispatch.

Slot-capable indexes (device_index.slot_regime_capable) take the slot
regime instead (count_locate_slots_t): the search stops at the k-mer seed
and every candidate row is verified against its slim fat row, which holds
the row's SA value and its pre-aligned text window.

Text layout: the packed text (4 bits per symbol for cardinality <= 16, else
8, little-endian within uint32 words) with TEXT_PAD_WORDS zero words in
front, so the backward window read never clamps into real text (zero is the
sentinel, which matches no query symbol).  All arithmetic on uint32 words
runs in int64 on values in [0, 2**32).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import kernels
from .device_index import TEXT_PAD_WORDS, FmDeviceIndex
from .locate import lf_walk
from .search import counts_from_ranges, search_ranges_t

_FULL = 0xFFFFFFFF

# Expected spurious candidates per lane at the search->walk handover.
SPURIOUS_TARGET = 0.06
WIDE_CAP = 4  # candidate rows verified per wide lane
# Slot regime: lanes whose seed width is WIDE_CAP+1..SLOT_EXT verify through
# ext_groups(B) compacted groups of SLOT_EXT candidate slots.
SLOT_EXT = 8


def switch_step(dev: FmDeviceIndex) -> int:
    """Consumed-symbol count at which the search hands over to the verify:
    deep enough that the expected residual width bwt_len / base^S on random
    text drops under SPURIOUS_TARGET, never below the k-mer seed."""
    base = max(2, dev.alphabet.cardinality - 2)  # dense searchable symbols
    need = math.ceil(math.log(max(2.0, dev.bwt_len / SPURIOUS_TARGET), base))
    return max(2, dev.kmer_len, need)


def wide_groups(batch: int) -> int:
    """Compacted wide-lane budget: lanes whose step-s range is 2..WIDE_CAP
    wide settle on the card through this many group slots; overflow falls
    back to the classic re-dispatch."""
    return max(16, batch // 16)


def ext_groups(batch: int) -> int:
    """Extended-slot budget of the slot regime: lanes in the WIDE_CAP+1..
    SLOT_EXT width band (the Poisson tail of a seed width near 1) settle
    through this many groups; overflow falls back to the classic
    re-dispatch."""
    return max(16, batch // 32)


def _reverse_symbols(word: torch.Tensor, bits: int) -> torch.Tensor:
    """Reverse the symbol order within each uint32 word (int64 values)."""
    w = word
    if bits == 4:
        w = ((w & 0x0F0F0F0F) << 4) | ((w >> 4) & 0x0F0F0F0F)
    w = ((w & 0x00FF00FF) << 8) | ((w >> 8) & 0x00FF00FF)
    return ((w << 16) | (w >> 16)) & _FULL


def compare_text_suffixes_t(
    dev: FmDeviceIndex, e: torch.Tensor, qt: torch.Tensor, qlens: torch.Tensor, s: int
) -> torch.Tensor:
    """True per lane iff text[e - d] == the query symbol at distance d from
    its end, for every d in [s, qlen).  e: int64[B] anchor positions (the
    last already-matched symbol); qt int32[L, B].

    The K backward text words around e come from one window_read; a funnel
    shift then puts distance d at a static slot, and L - s static compares
    finish the check."""
    bits = 4 if dev.alphabet.cardinality <= 16 else 8
    spw = 32 // bits
    lg = 3 if bits == 4 else 2
    L = qt.shape[0]
    # Only distances d in [s, L) are compared, so only backward words
    # jlo..jhi around e are needed.
    jlo = s // spw
    jhi = (L - 1) // spw + 1
    if jhi > TEXT_PAD_WORDS:
        raise ValueError(f"padded query length {L} exceeds verify window")
    K = jhi - jlo + 1
    wb = (e >> lg) + TEXT_PAD_WORDS - jlo
    words = kernels.window_read(dev.text_packed, wb, K).to(torch.int64) & _FULL  # [B, K]
    rev = _reverse_symbols(words, bits)

    # Align so distance d sits at slot d: drop spw-1 - (e % spw) symbols of
    # lead-in from the reversed stream.
    sh = (spw - 1 - (e & (spw - 1))) * bits
    aligned = {}
    for j in range(jlo, jhi):
        lo = rev[:, j - jlo] >> sh
        hi = torch.where(sh == 0, 0, (rev[:, j + 1 - jlo] << (32 - sh)) & _FULL)
        aligned[j] = lo | hi

    mask_sym = (1 << bits) - 1
    ok = torch.ones(e.shape, dtype=torch.bool, device=e.device)
    for d in range(s, L):
        tsym = (aligned[d // spw] >> (bits * (d % spw))) & mask_sym
        ok &= (tsym == qt[L - 1 - d]) | (d >= qlens)
    return ok


def _compact(flags: torch.Tensor, groups: int):
    """(lane of each of ``groups`` groups, valid): group g serves the g-th
    flagged lane, the first index where the running count reaches g + 1;
    groups past the flagged total get B (empty).  Also the running count."""
    csum = torch.cumsum(flags.to(torch.int64), 0)
    lane = torch.searchsorted(csum, torch.arange(1, groups + 1, device=flags.device), side="left")
    return lane, lane < flags.shape[0], csum


def count_locate_verify_t(
    dev: FmDeviceIndex,
    qt: torch.Tensor,
    qlens: torch.Tensor,
    s: int,
    *,
    no_sentinel: bool = False,
    seeded_floor: bool = False,
    stats=None,
):
    """Fused seed-walk-verify count+locate.  qt: int32[L, B] transposed
    right-aligned queries; qlens int64[B].

    Returns ``(bundle, starts, ends)``: ``bundle`` packs every host-bound
    result into one tensor (see unpack_verify_bundle) - counts (exact for
    every lane with redis False), the global match position of each
    settled single-hit lane, the redis flags, and the wide groups (lane,
    per-slot positions, verified-slot bits, slots in BWT-row order);
    (starts, ends) are the step-``s`` ranges.  ``stats``: search_ranges_t's."""
    starts, ends = search_ranges_t(
        dev, qt, qlens, num_steps=s, no_sentinel=no_sentinel, seeded_floor=seeded_floor, stats=stats
    )
    width = counts_from_ranges(starts, ends)
    long_enough = qlens > s
    candidate = (width == 1) & long_enough
    wide = (width >= 2) & long_enough

    B = starts.shape[0]
    G = wide_groups(B)
    device = starts.device

    # Group g serves the g-th lane whose width fits WIDE_CAP.
    lane_of_group, valid_g, _ = _compact(wide & (width <= WIDE_CAP), G)
    lane_safe = torch.where(valid_g, lane_of_group, 0)
    # Empty groups read evenly spaced rows; their slots are discarded.
    spread_g = torch.arange(G, device=device) * max(1, (dev.bwt_len - 1) // max(1, G))
    g_start = torch.where(valid_g, starts[lane_safe], spread_g)
    g_width = torch.where(valid_g, width[lane_safe], 0)
    jslot = torch.arange(WIDE_CAP, device=device)
    slot_valid = jslot[None, :] < g_width[:, None]  # [G, WIDE_CAP]
    # Invalid slots repeat the group's last row.
    jclip = torch.minimum(jslot[None, :], g_width.clamp_min(1)[:, None] - 1)
    slot_rows = g_start[:, None] + jclip

    # One LF walk and one text compare serve singleton lanes and wide slots;
    # non-candidate lanes read their own (clamped) start row.
    rows_main = starts.clamp_max(dev.bwt_len - 1)
    qt_g = qt[:, lane_safe]  # [L, G]
    l_g = qlens[lane_safe]
    p_all = lf_walk(dev, torch.cat([rows_main, slot_rows.reshape(-1)]))
    p = p_all[:B]
    p_slot = p_all[B:].reshape(G, WIDE_CAP)
    qt_all = torch.cat([qt, qt_g.repeat_interleave(WIDE_CAP, dim=1)], dim=1)
    l_all = torch.cat([qlens, l_g.repeat_interleave(WIDE_CAP)])
    ok_all = compare_text_suffixes_t(dev, p_all + (s - 1), qt_all, l_all, s)
    matches = ok_all[:B]
    ok_slot_cmp = ok_all[B:].reshape(G, WIDE_CAP)

    rem = torch.where(long_enough, qlens - s, 0)
    rem_g = rem[lane_safe]
    verified = candidate & matches & (p >= rem)
    ok_slot = ok_slot_cmp & slot_valid & (p_slot >= rem_g[:, None])
    pos_slot = p_slot - rem_g[:, None]
    wide_counts = ok_slot.sum(dim=1)

    # Scatter wide-group results back to lanes (dump slot B for empties).
    lane_or_dump = torch.where(valid_g, lane_of_group, B)
    settled_w = torch.zeros(B + 1, dtype=torch.bool, device=device)
    settled_w[lane_or_dump] = valid_g
    settled_w = settled_w[:B]
    counts_w = torch.zeros(B + 1, dtype=torch.int64, device=device)
    counts_w[lane_or_dump] = wide_counts
    counts_w = counts_w[:B]
    counts = torch.where(candidate, verified.to(torch.int64), width)
    counts = torch.where(settled_w, counts_w, counts)
    redis = (wide & ~settled_w) | ((counts > 0) & ~long_enough)
    text_pos = p - rem

    bundle = _pack_result_bundle(dev, text_pos, counts, redis, lane_or_dump, pos_slot, ok_slot)
    return bundle, starts, ends


def _read_fat(dev: FmDeviceIndex, rows: torch.Tensor) -> torch.Tensor:
    """int32[N, rw] fat rows (uint32 bit patterns, ascending word order) of
    int64[N] BWT rows, from one window_read over the flat rows."""
    rw = dev.vw_row_words
    return kernels.window_read(dev.vw_flat, rows * rw + (rw - 1), rw).flip(1)


def _compare_fat(fat, qt, qlens, s: int, bits: int) -> torch.Tensor:
    """bool[N, slots]: every query symbol at distance d in [s, qlen) equals
    the fat row's symbol at word (d - s) // spw, slot (d - s) % spw.
    fat int32[N, slots, rw]; qt int32[L, N]; qlens int64[N]."""
    L = qt.shape[0]
    shifts = torch.arange(0, 32, bits, dtype=torch.int32, device=fat.device)
    # Column j holds the text symbol at query distance s + j.
    tsyms = ((fat[:, :, :-1, None] >> shifts) & ((1 << bits) - 1)).flatten(2)[:, :, : L - s]
    q = qt[: L - s].flip(0).T  # [N, L - s]: the query symbol at distance s + j
    dead = torch.arange(s, L, device=fat.device)[None, :] >= qlens[:, None]  # past the query's start
    return ((tsyms == q[:, None, :]) | dead[:, None, :]).all(dim=2)


def count_locate_slots_t(
    dev: FmDeviceIndex,
    qt: torch.Tensor,
    qlens: torch.Tensor,
    s: int,
    *,
    no_sentinel: bool = False,
    seeded_floor: bool = False,
    stats=None,
):
    """Slot-verify count+locate: no post-seed rank step.  qt: int32[L, B]
    transposed right-aligned queries; qlens int64[B].

    The search stops at the seed (s == kmer_len).  Every lane with 1 <=
    width <= WIDE_CAP verifies all its candidate rows against their fat
    rows (invalid slots repeat the lane's last valid row); lanes of width
    WIDE_CAP+1..SLOT_EXT verify through ext_groups(B) groups of SLOT_EXT
    slots and settle when at most one candidate survives; wider lanes,
    multi-hit extended lanes, lanes with qlen <= s and hits, and multi-hit
    lanes past the wide_groups(B) budget are flagged redis.  Multi-hit
    settled lanes carry their slot positions in the wide groups.  Returns
    the same ``(bundle, starts, ends)`` as count_locate_verify_t.
    ``stats``: search_ranges_t's."""
    if s != dev.kmer_len or dev.vw_flat is None:
        raise ValueError("the slot path needs fat rows aligned at the seed step (s == kmer_len)")
    starts, ends = search_ranges_t(
        dev, qt, qlens, num_steps=s, no_sentinel=no_sentinel, seeded_floor=seeded_floor, stats=stats
    )
    width = counts_from_ranges(starts, ends)
    long_enough = qlens > s
    B = starts.shape[0]
    L = qt.shape[0]
    bits = 4 if dev.alphabet.cardinality <= 16 else 8
    w = dev.verify_windows_w
    if L > s + (32 // bits) * w:
        raise ValueError(f"padded query length {L} exceeds the slot fat window")
    device = starts.device

    jslot = torch.arange(WIDE_CAP, device=device)
    fits = long_enough & (width >= 1) & (width <= WIDE_CAP)
    slot_valid = fits[:, None] & (jslot[None, :] < width[:, None])  # [B, WIDE_CAP]
    jclip = torch.minimum(jslot[None, :], width.clamp_min(1)[:, None] - 1)
    fat = _read_fat(dev, (starts[:, None] + jclip).reshape(-1)).reshape(B, WIDE_CAP, -1)
    p_slot = fat[:, :, w].to(torch.int64) & _FULL
    rem = torch.where(long_enough, qlens - s, 0)
    ok = _compare_fat(fat, qt, qlens, s, bits) & slot_valid & (p_slot >= rem[:, None])
    pos_adj = (p_slot - rem[:, None]) & _FULL  # uint32 wrap on unsettled slots
    counts_v = ok.sum(dim=1)
    settled = fits

    # Extended band: compacted groups of SLOT_EXT slots; empty groups read
    # evenly spaced rows, and their slots are discarded.
    ext = long_enough & (width > WIDE_CAP) & (width <= SLOT_EXT)
    Gx = ext_groups(B)
    lane_xg, valid_x, _ = _compact(ext, Gx)
    lane_sx = torch.where(valid_x, lane_xg, 0)
    w_x = torch.where(valid_x, width[lane_sx], 0)
    jx = torch.arange(SLOT_EXT, device=device)
    sv_x = jx[None, :] < w_x[:, None]  # [Gx, SLOT_EXT]
    jclip_x = torch.minimum(jx[None, :], w_x.clamp_min(1)[:, None] - 1)
    spread_x = torch.arange(Gx, device=device) * max(1, (dev.bwt_len - 1) // max(1, Gx))
    base_x = torch.where(valid_x, starts[lane_sx], spread_x)
    fat_x = _read_fat(dev, (base_x[:, None] + jclip_x).reshape(-1)).reshape(Gx, SLOT_EXT, -1)
    p_x = fat_x[:, :, w].to(torch.int64) & _FULL
    rem_x = rem[lane_sx]
    ok_x = _compare_fat(fat_x, qt[:, lane_sx], qlens[lane_sx], s, bits) & sv_x & (p_x >= rem_x[:, None])
    cnt_x = ok_x.sum(dim=1)
    settle_xg = valid_x & (cnt_x <= 1)
    first_x = torch.argmax(ok_x.to(torch.uint8), dim=1)  # first True (0 when none)
    pos_x = (p_x - rem_x[:, None]).gather(1, first_x[:, None])[:, 0] & _FULL
    dump_x = torch.where(settle_xg, lane_xg, B)
    settled_x = torch.zeros(B + 1, dtype=torch.bool, device=device)
    settled_x[dump_x] = settle_xg
    counts_x = torch.zeros(B + 1, dtype=torch.int64, device=device)
    counts_x[dump_x] = cnt_x
    pos_xl = torch.zeros(B + 1, dtype=torch.int64, device=device)
    pos_xl[dump_x] = pos_x
    settled_x, counts_x, pos_xl = settled_x[:B], counts_x[:B], pos_xl[:B]

    counts = torch.where(settled, counts_v, width)
    counts = torch.where(settled_x, counts_x, counts)
    redis = (long_enough & (width >= 1) & ~(settled | settled_x)) | ((width >= 1) & ~long_enough)
    first = torch.argmax(ok.to(torch.uint8), dim=1)
    text_pos = pos_adj.gather(1, first[:, None])[:, 0]
    text_pos = torch.where(settled_x, pos_xl, text_pos)

    # Multi-hit settled lanes carry their slot positions through the wide
    # groups; lanes past the budget re-dispatch.
    multi = settled & (counts_v >= 2)
    G = wide_groups(B)
    lane_of_group, valid_g, csum = _compact(multi, G)
    lane_safe = torch.where(valid_g, lane_of_group, 0)
    ok_g = ok[lane_safe] & valid_g[:, None]
    redis |= multi & (csum > G)
    lane_of_group = torch.where(valid_g, lane_of_group, B)
    bundle = _pack_result_bundle(dev, text_pos, counts, redis, lane_of_group, pos_adj[lane_safe], ok_g)
    return bundle, starts, ends


def _packed_bundle(dev: FmDeviceIndex) -> bool:
    """u32-per-lane bundle mode: positions fit 28 bits and exact non-redis
    counts (<= WIDE_CAP) fit 3."""
    return dev.bwt_len < (1 << 28) and WIDE_CAP <= 7


def _pack_result_bundle(dev, text_pos, counts, redis, lane_of_group, pos_slot, ok_slot):
    """Pack the lane words and the wide-group meta into one tensor (int32
    bit patterns in the u32 lane-word mode, else uint8 bytes of the split
    pos + flags form); unpack_verify_bundle is the host side."""
    as_i32 = kernels.as_int32_bits
    okbits = (ok_slot.to(torch.int64) << torch.arange(WIDE_CAP, device=ok_slot.device)).sum(dim=1)
    wide_meta = as_i32(torch.cat([lane_of_group[:, None], pos_slot, okbits[:, None]], dim=1))
    if _packed_bundle(dev):
        # One u32 per lane: [28b pos | 3b count | 1b redis].
        lane_words = (
            (text_pos & 0x0FFFFFFF) | (counts.clamp_max(7) << 28) | (redis.to(torch.int64) << 31)
        )
        return torch.cat([as_i32(lane_words), wide_meta.reshape(-1)])
    flags = counts.clamp_max(127) | (redis.to(torch.int64) << 7)
    return torch.cat([
        as_i32(text_pos).view(torch.uint8),
        flags.to(torch.uint8),
        wide_meta.reshape(-1).view(torch.uint8),
    ])


def unpack_verify_bundle(bundle: np.ndarray, batch: int, groups: int):
    """Host view of the packed result buffer (uint32 lane-word mode when the
    buffer is 4-byte, else the split pos + flags uint8 mode).

    Returns (pos uint32[B], counts int64[B], redis bool[B], lane_g int64[G],
    pos_slot uint32[G, WIDE_CAP], ok_slot bool[G, WIDE_CAP])."""
    if bundle.dtype.itemsize == 4:
        bundle = bundle.view(np.uint32)
        lane_words = bundle[:batch]
        pos = lane_words & np.uint32(0x0FFFFFFF)
        counts = ((lane_words >> 28) & 7).astype(np.int64)
        redis = (lane_words >> 31).astype(bool)
        meta = bundle[batch:].reshape(groups, 2 + WIDE_CAP)
    else:
        b4 = 4 * batch
        pos = bundle[:b4].view(np.uint32)
        flags = bundle[b4 : b4 + batch]
        meta = bundle[b4 + batch :].view(np.uint32).reshape(groups, 2 + WIDE_CAP)
        counts = (flags & 0x7F).astype(np.int64)
        redis = (flags >> 7).astype(bool)
    lane_g = meta[:, 0].astype(np.int64)
    pos_slot = meta[:, 1 : 1 + WIDE_CAP]
    ok_slot = ((meta[:, 1 + WIDE_CAP][:, None] >> np.arange(WIDE_CAP)) & 1).astype(bool)
    return pos, counts, redis, lane_g, pos_slot, ok_slot
