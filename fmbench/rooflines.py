"""Frozen roofline arithmetic: the card's peaks and the bytes and operations
a kernel call must move.

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S`` and ``INT32_OPS_PER_S`` at
chip_smoke.py:294-295, ``window_read_bound`` at :1133, ``occ_pair_bound`` at
:1143, ``marked_walk_trace`` at :1205 and ``marked_walk_ranges_bound`` at
:1272) so that a later change to the program cannot move the yardstick.  The
marked walk's bound follows each live slot's walk over the index's fused
rows, so the LF step it needs (``awry_tpu_torch/ops/kernels.py``'s plain
``_fetch_rows``, ``_occ_rows``, ``_symbol_rows``, ``_bit_at``,
``_backstep_rows`` and ``slot_rows``, narrow rows only) is copied here too.  A
kernel's share of its roofline is the least time its calls could take (the
larger of bytes over the memory rate and operations over the 32-bit rate)
over the time the device trace measured for them.
"""

from __future__ import annotations

import re

import torch

# NVIDIA H100 SXM data sheet (at its 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12


def window_read_bound(flat, wbase, k) -> tuple[float, float]:
    """(bytes, ops) the call must move: each distinct 32 B sector of the
    table its requests touch, the int64 request and the k output words."""
    wb = wbase.clamp(k - 1, flat.shape[0] - 1)
    words = (wb[:, None] - torch.arange(k, device=wb.device)).reshape(-1)
    sectors = torch.unique(words >> 3).numel()
    r = wbase.shape[0]
    return float(sectors * 32 + r * 8 + r * k * 4), 0.0


def occ_pair_bound(blocks, pos_a, pos_b, sym, codes, nplanes) -> tuple[float, float]:
    """(bytes, ops): each distinct 32 B sector touched (V plane sectors per
    distinct row, the milestone's sector per distinct (row, sector)), the
    20 B of request and 8 B of result per request; ops: per endpoint V*8
    XOR + V*8 AND + 8 mask AND + 8 popcount + 8 add + 1 milestone add."""
    rw = blocks.shape[1]
    spr = rw // 8  # 32 B sectors per row
    nbits = blocks.shape[0] * 256
    rows = torch.cat([pos_a.clamp(0, nbits - 1), pos_b.clamp(0, nbits - 1)]) >> 8
    s2 = torch.cat([sym, sym]).to(torch.int64)
    plane = (rows[:, None] * spr + torch.arange(nplanes, device=rows.device)).reshape(-1)
    mile = rows * spr + ((nplanes * 8 + s2) >> 3)
    sectors = torch.unique(torch.cat([plane, mile])).numel()
    r = pos_a.shape[0]
    ops = 2 * r * (nplanes * 16 + 8 * 3 + 1)
    return float(sectors * 32 + r * 28), float(ops)


def kernel_share(rec: dict, metric: str, pattern: str) -> float | None:
    """A roofline share in %: the mean least time of a call the recording
    pass made for ``metric`` (over every pool batch) over the mean device
    time of a launch of the kernels whose name matches ``pattern`` in the
    profiled slice.  None when either side is missing."""
    bound = rec.get("recorded", {}).get(metric)
    kernels = rec.get("trace", {}).get("kernels", {})
    hits = [v for name, v in kernels.items() if re.search(pattern, name)]
    if not bound or not bound["calls"] or not hits:
        return None
    launches = sum(n for n, _ in hits)
    seconds = sum(s for _, s in hits)
    if seconds <= 0:
        return None
    least = max(bound["bytes"] / HBM_BYTES_PER_S, bound["ops"] / INT32_OPS_PER_S)
    return 100.0 * (least / bound["calls"]) / (seconds / launches)


# -- the marked walk's bound, with the LF step it follows ------------------------

_FULL = 0xFFFFFFFF


def _popcount32(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _FULL) >> 24


def _fetch_rows(blocks, pos):
    p = pos.clamp(0, blocks.shape[0] * 256 - 1)
    return p, blocks[p >> 8].to(torch.int64) & _FULL


def _word_masks(local, in_word):
    word = (local >> 5)[:, None]
    lane = torch.arange(8, device=local.device)[None, :]
    return torch.where(lane < word, _FULL, torch.where(lane == word, in_word[:, None], 0))


def _occ_rows(rows, p, sym, codes, nplanes):
    code = codes[sym].to(torch.int64)
    occv = torch.full((p.shape[0], 8), _FULL, dtype=torch.int64, device=p.device)
    for v in range(nplanes):
        pol = (((code >> v) & 1) - 1) & _FULL
        occv &= rows[:, v * 8 : (v + 1) * 8] ^ pol[:, None]
    local = p & 255
    pop = _popcount32(occv & _word_masks(local, _FULL >> (31 - (local & 31)))).sum(dim=1)
    return rows.gather(1, (nplanes * 8 + sym.to(torch.int64))[:, None])[:, 0] + pop


def _bit_at(rows, offset, p):
    local = p & 255
    word = rows.gather(1, (offset + (local >> 5))[:, None])[:, 0]
    return (word >> (local & 31)) & 1


def _symbol_rows(rows, p, c2i, nplanes):
    return c2i[sum(_bit_at(rows, v * 8, p) << v for v in range(nplanes))].to(torch.int64)


def _backstep(blocks, rows, prefix_sums, codes, c2i, nplanes, mark_offset, ambiguity_idx):
    """(LF-stepped row, mark rank) of each row."""
    p, r = _fetch_rows(blocks, rows)
    sym = _symbol_rows(r, p, c2i, nplanes)
    safe = torch.where(sym == 0, ambiguity_idx, sym)
    stepped = torch.where(sym == 0, 0, prefix_sums[safe] + _occ_rows(r, p, safe, codes, nplanes) - 1)
    local = p & 255
    before = _word_masks(local, (1 << (local & 31)) - 1)
    rank = r[:, mark_offset + 8] + _popcount32(r[:, mark_offset : mark_offset + 8] & before).sum(dim=1)
    return stepped, rank


def marked_walk_bound(blocks, rows, prefix_sums, codes, c2i, nplanes, mark_offset, ambiguity_idx, mark_ratio,
                      sampled_sa, bwt_len, sa_word_bytes: int = 4) -> tuple[float, float]:
    """(bytes, ops) of the walks these rows take: each distinct 32 B sector
    the visits touch (a stepping visit: the sector of the row's mark word,
    the V plane sectors and the stepped symbol's milestone sector; a final
    visit: the sectors of the mark words up to the row's word and of the
    mark milestone), each distinct sector of the marked SA read, and 16 B per
    lane (the row in, the text position out); ops: backstep's per stepping
    visit, the mark rank and 4 more per lane."""
    spr = blocks.shape[1] // 8
    visit = (prefix_sums, codes, c2i, nplanes, mark_offset, ambiguity_idx)
    sectors, sa_sectors, stepping = [], [], 0
    n = rows.shape[0]
    pos = rows
    for v in range(1, mark_ratio + 1):
        p, r = _fetch_rows(blocks, pos)
        base = (p >> 8) * spr
        word = (p & 255) >> 5
        final = (_bit_at(r, mark_offset, p) == 1) | (v == mark_ratio)
        sym = _symbol_rows(r, p, c2i, nplanes)
        del r
        safe = torch.where(sym == 0, ambiguity_idx, sym)
        step = ~final
        sectors += [
            base + ((mark_offset + word) >> 3),
            base[final] + (mark_offset >> 3),
            base[final] + ((mark_offset + 8) >> 3),
            (base[step][:, None] + torch.arange(nplanes, device=p.device)).reshape(-1),
            base[step] + ((nplanes * 8 + safe[step]) >> 3),
        ]
        rank = _backstep(blocks, pos[final], *visit)[1].clamp_max(sampled_sa.shape[0] - 1)
        sa_sectors.append((rank * sa_word_bytes) >> 5)
        stepping += int(step.sum())
        pos = _backstep(blocks, pos[step], *visit)[0]
        if not pos.numel():
            break
    distinct = torch.unique(torch.cat(sectors)).numel() + torch.unique(torch.cat(sa_sectors)).numel()
    ops = stepping * (nplanes * 3 + nplanes * 16 + 8 * 3 + 2 + 3) + n * (8 * 3 + 4 + 4)
    return float(distinct * 32 + n * 16), float(ops)


def marked_walk_ranges_bound(blocks, starts, counts, cap, *walk, sa_word_bytes: int = 4) -> tuple[float, float]:
    """marked_walk_bound of what the range-fed entry walks (each range's live
    slots, then row 0 once for the idle slots), its I/O counted as the entry
    moves it: starts and counts in (16 B per query), the int64[B, cap]
    positions out."""
    offs = torch.arange(cap, device=starts.device)
    live = offs[None, :] < counts.clamp(0, cap)[:, None]
    rows = torch.where(live, starts[:, None] + offs[None, :], 0).reshape(-1)
    walked = torch.cat([rows[live.reshape(-1)], rows.new_zeros(1)])
    nbytes, ops = marked_walk_bound(blocks, walked, *walk, sa_word_bytes=sa_word_bytes)
    io = starts.shape[0] * 16 + rows.shape[0] * 8 - walked.shape[0] * 16
    return nbytes + io, ops
