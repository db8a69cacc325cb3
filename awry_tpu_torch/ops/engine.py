"""FmQueryEngine: the user-facing batch count/locate API on the card.

Every call is a batch: queries are encoded and padded on the host (bucketed
shapes), packed into the densest wire the batch admits (2-bit crumbs for
pure A/C/G/T batches, 4-bit nibbles otherwise, raw bytes for amino),
served by the verify path (ops/verify.py) when the padded length fits its
window, else by the classic full-depth path (ops/locate.py), and assembled
on the host with vectorized NumPy.  The verify path is the slot regime
(count_locate_slots_t) on slot-capable indexes, else the switch step
(count_locate_verify_t).

The engine runs on the card: ``device=None`` means ``cuda:0`` and raises
when no CUDA device exists; ``device="cpu"`` runs the kernels' plain
PyTorch versions on the host (the tests do this).
"""

from __future__ import annotations

import numpy as np
import torch

from ..alphabet import encode_ascii
from ..index import FmIndexData
from .device_index import TEXT_PAD_WORDS, resolve_device, to_device
from .locate import count_locate_capped_t, lf_walk
from .search import count_batch_kernel_t, search_ranges_t, unpack_crumbs_t, unpack_nibbles_t
from .verify import count_locate_slots_t, count_locate_verify_t, switch_step, unpack_verify_bundle, wide_groups

# Rows per over-cap locate slab (bounds the device expansion's memory).
_OVERCAP_WALK_SLAB = 8 * 1024 * 1024


def _bucket(n: int, minimum: int = 16) -> int:
    """Round up to the next power of two (bounded set of padded shapes)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def pack_wire(qsyms: np.ndarray, qlens: np.ndarray, crumb_lut: np.ndarray | None):
    """[B, L] int8 symbol matrix -> the densest wire it admits: crumb (2-bit,
    int8) when every in-range symbol is a dense encoding symbol, nibble
    (4-bit, uint8) otherwise; ``crumb_lut`` None (cardinality > 16) returns
    qsyms unchanged.  The wire dtype is the mode tag (int8 = crumb / raw,
    uint8 = nibble)."""
    if crumb_lut is None:
        return qsyms
    dense = crumb_lut[qsyms]  # int8 [B, L], -1 = not dense
    L = qsyms.shape[1]
    in_range = np.arange(L, dtype=np.int32)[None, :] >= (L - qlens[:, None])
    if ((dense >= 0) | ~in_range).all():
        d = np.maximum(dense, 0).astype(np.uint8)
        return (
            d[:, 0::4] | (d[:, 1::4] << 2) | (d[:, 2::4] << 4) | (d[:, 3::4] << 6)
        ).astype(np.uint8).view(np.int8)
    return (qsyms[:, 0::2] | (qsyms[:, 1::2] << 4)).astype(np.uint8)


def encode_query_batch(alphabet, queries, *, min_batch: int = 16, min_len: int = 8):
    """list of str/bytes -> (int8[B, L] RIGHT-ALIGNED symbols, int32[B]
    lengths) with power-of-two-bucketed padded shapes.  Uniform-length
    batches take one vectorized pass."""
    qbytes = [q.encode() if isinstance(q, str) else bytes(q) for q in queries]
    lens = [len(q) for q in qbytes]
    B = _bucket(max(1, len(qbytes)), minimum=min_batch)
    L = _bucket(max(lens, default=1), minimum=min_len)
    qlens = np.zeros((B,), dtype=np.int32)
    qlens[: len(lens)] = lens
    qsyms = np.zeros((B, L), dtype=np.int8)
    if qbytes and len(set(lens)) == 1 and lens[0] > 0:
        flat = np.frombuffer(b"".join(qbytes), dtype=np.uint8)
        qsyms[: len(qbytes), L - lens[0] :] = encode_ascii(alphabet, flat).reshape(len(qbytes), lens[0])
    else:
        for i, q in enumerate(qbytes):
            if len(q):
                qsyms[i, L - len(q) :] = encode_ascii(alphabet, q)
    return qsyms, qlens


class FmQueryEngine:
    """Batch count/locate engine over an FM-index shipped to one device."""

    def __init__(self, index: FmIndexData, *, device=None, slots: bool = True):
        """``slots``: serve through the slot regime when the index is
        slot-capable (False: the switch-step path on any index)."""
        self.device = resolve_device(device)
        self.device_index = dev = to_device(index, self.device, slots=slots)
        # Serving-shape counters, updated per verify batch.
        self.stats = {
            "batches": 0,
            "queries": 0,
            "fast_path_batches": 0,
            "wide_lanes": 0,
            "redis_lanes": 0,
            "multi_hit_queries": 0,
        }
        self._wire_packed = dev.alphabet.cardinality <= 16
        if self._wire_packed:
            dense_lut = dev.dense.cpu().numpy().astype(np.int8)
            self._crumb_lut = dense_lut  # symbol index -> dense code or -1
            self._crumb_inv = torch.from_numpy(np.flatnonzero(dense_lut >= 0).astype(np.int32)).to(self.device)
        else:
            self._crumb_lut = self._crumb_inv = None
        spw = 8 if self._wire_packed else 4
        self._verify_slots = dev.vw_flat is not None
        if self._verify_slots:
            # The search stops at the seed; the compare reads only the fat
            # window words, so longer batches take the classic path.
            self._verify_s = dev.kmer_len
            self._verify_kernel = count_locate_slots_t
            self._verify_max_len = dev.kmer_len + spw * dev.verify_windows_w
        else:
            self._verify_s = switch_step(dev)
            self._verify_kernel = count_locate_verify_t
            # Longest padded query the backward text-window read covers.
            self._verify_max_len = TEXT_PAD_WORDS * spw
        self._seq_starts_host = np.asarray(index.seq_starts, dtype=np.int64)

    # -- host-side encoding ----------------------------------------------------
    def encode_queries(self, queries) -> tuple[np.ndarray, np.ndarray]:
        """Encode + pad str/bytes queries into the host wire: (wire, qlens)
        numpy arrays (qlens uint8 when every query is <= 255 symbols)."""
        qsyms, qlens = encode_query_batch(self.device_index.alphabet, queries)
        wire = pack_wire(qsyms, qlens, self._crumb_lut)
        if qlens.max(initial=0) <= 255:
            qlens = qlens.astype(np.uint8)
        return wire, qlens

    def _wire_len(self, wire: np.ndarray) -> int:
        """Padded query length of a wire batch (its dtype tags the mode)."""
        if not self._wire_packed:
            return wire.shape[1]
        return wire.shape[1] * (4 if wire.dtype == np.int8 else 2)

    def _upload(self, wire: np.ndarray, qlens: np.ndarray):
        """Wire batch -> (qt int32[L, B], qlens int64[B], kernel flags) on the
        device.  ``seeded_floor`` holds when no lane is live before step k:
        crumb lanes k-mer-seed whenever qlen >= k."""
        w = torch.from_numpy(np.ascontiguousarray(wire)).to(self.device)
        ql = torch.from_numpy(np.ascontiguousarray(qlens)).to(self.device).to(torch.int64)
        crumb = self._wire_packed and wire.dtype == np.int8
        if crumb:
            qt = unpack_crumbs_t(w, self._crumb_inv)
        elif self._wire_packed:
            qt = unpack_nibbles_t(w)
        else:
            qt = w.T.to(torch.int32).contiguous()
        k = self.device_index.kmer_len
        q = qlens.astype(np.int64)
        floor = crumb and k > 0 and qt.shape[0] >= k and bool(((q <= 1) | (q >= k)).all())
        return qt, ql, {"no_sentinel": crumb, "seeded_floor": floor}

    # -- public API --------------------------------------------------------------
    def count_batch(self, queries) -> np.ndarray:
        """Occurrence count per query (uint64)."""
        qt, ql, flags = self._upload(*self.encode_queries(queries))
        counts = count_batch_kernel_t(self.device_index, qt, ql, **flags)
        return counts.cpu().numpy()[: len(queries)].astype(np.uint64)

    def count_locate_arrays(self, queries, *, cap: int = 8):
        """Bulk count+locate of one batch.  Returns ``(counts, seq_idx, local,
        offsets)``: hits of query ``i`` are ``zip(seq_idx, local)[offsets[i]:
        offsets[i+1]]``, in BWT-row order."""
        return next(self.count_locate_stream([queries], cap=cap))

    def count_locate_batch(self, queries, *, cap: int = 8):
        """Counts and, per query, its (record index, local position) hits as
        a list of pairs in BWT-row order."""
        counts, seq_idx, local, offsets = self.count_locate_arrays(queries, cap=cap)
        pairs = list(zip(seq_idx.tolist(), local.tolist()))
        return counts, [pairs[offsets[i] : offsets[i + 1]] for i in range(len(queries))]

    def locate_batch(self, queries, *, cap: int = 8) -> list[list[tuple[int, int]]]:
        """(record index, local position) hits per query, in BWT-row order."""
        return self.count_locate_batch(queries, cap=cap)[1]

    def search_ranges_batch(self, queries) -> tuple[np.ndarray, np.ndarray]:
        """Final BWT ranges per query (int64, inclusive; empty iff start > end)."""
        qt, ql, flags = self._upload(*self.encode_queries(queries))
        starts, ends = search_ranges_t(self.device_index, qt, ql, **flags)
        n = len(queries)
        return starts.cpu().numpy()[:n], ends.cpu().numpy()[:n]

    def count(self, query) -> int:
        """Occurrence count of one query."""
        return int(self.count_batch([query])[0])

    def locate(self, query) -> list[tuple[int, int]]:
        """(record index, local position) hits of one query."""
        return self.locate_batch([query])[0]

    def release(self) -> None:
        """Drop this engine's device tensors now, so that a server cycling
        through indexes on one card can free the memory
        (``torch.cuda.empty_cache()`` returns it to the driver).  The engine
        is unusable afterwards."""
        self.device_index = None
        self._crumb_inv = None

    def count_locate_stream(self, query_batches, *, cap: int = 8, depth: int = 2):
        """Pipelined bulk serving: a generator over batches, each a list of
        str/bytes or a pre-encoded ``(wire, qlens, n)`` tuple from
        encode_queries (n = true query count).  At most ``depth`` batches are
        dispatched but unassembled: each one's results copy into pinned host
        memory without blocking, and an event marks when they have landed, so
        host assembly of one batch overlaps the device work of the next.
        Each item matches count_locate_arrays' return."""
        inflight: list[tuple] = []
        for batch in query_batches:
            inflight.append(self._dispatch(batch, cap))
            if len(inflight) >= depth:
                yield self._assemble(*inflight.pop(0), cap)
        while inflight:
            yield self._assemble(*inflight.pop(0), cap)

    # -- dispatch / assembly -------------------------------------------------------
    def _to_host(self, *tensors):
        """Start device->host copies into pinned buffers; returns the host
        tensors and an event recorded after the copies (None on the CPU)."""
        if self.device.type != "cuda":
            return list(tensors), None
        hosts = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            hosts.append(h)
        event = torch.cuda.Event()
        event.record()
        return hosts, event

    def _dispatch(self, batch, cap):
        if isinstance(batch, tuple):
            wire, qlens, n = batch
        else:
            wire, qlens = self.encode_queries(batch)
            n = len(batch)
        qt, ql, flags = self._upload(wire, qlens)
        if self._wire_len(wire) <= self._verify_max_len:
            bundle, starts, _ = self._verify_kernel(self.device_index, qt, ql, self._verify_s, **flags)
            return ("verify", n, wire, qlens, *self._to_host(bundle), starts.shape[0])
        counts, text_pos, starts, _ = count_locate_capped_t(self.device_index, qt, ql, cap, **flags)
        return ("classic", n, wire, qlens, *self._to_host(counts, text_pos, starts), None)

    def _assemble(self, kind, n, wire, qlens, hosts, event, batch, cap):
        if event is not None:
            event.synchronize()
        arrays = [h.numpy() for h in hosts]
        if kind == "verify":
            counts, flat_pos, offsets = self._flat_verify_finish(n, wire, qlens, cap, arrays[0], batch)
        else:
            counts, flat_pos, offsets = self._flat_classic(arrays, n, cap)
        seq_idx, local = self._localize(flat_pos)
        return counts.astype(np.uint64), seq_idx, local, offsets

    def _flat_classic(self, arrays, n, cap):
        counts, text_pos, starts = (a[:n] for a in arrays)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        flat_pos = self._assemble_flat_positions(counts, text_pos, starts, offsets, cap)
        return counts.astype(np.int64), flat_pos, offsets

    def _flat_verify_finish(self, n, wire, qlens, cap, bundle, batch):
        """Host side of one verify batch: unpack the bundle and serve the
        re-dispatched (redis) lanes through the classic full-depth path on
        the device; then the fast path when every lane has one hit, else
        scatter settled lanes, wide groups and redis lanes."""
        pos_u, counts_b, redis_b, lane_g, pos_slot, ok_slot = unpack_verify_bundle(
            bundle, batch, wide_groups(batch)
        )
        counts = counts_b[:n]
        redis = redis_b[:n]
        st = self.stats
        st["batches"] += 1
        st["queries"] += n
        vg = lane_g < n
        # Redis lanes first, so that a stray one (about one per 512k batch at
        # chr1 scale) does not knock the batch off the fast path.
        sub_counts = sub_flat = sub_offsets = None
        idxs = np.nonzero(redis)[0]
        if len(idxs):
            b = _bucket(len(idxs))
            pad_idx = np.zeros(b, dtype=np.int64)  # padding rows repeat row 0, sliced off
            pad_idx[: len(idxs)] = idxs
            qt, ql, flags = self._upload(wire[pad_idx], qlens[pad_idx])
            out = count_locate_capped_t(self.device_index, qt, ql, cap, **flags)
            sub_counts, sub_flat, sub_offsets = self._flat_classic(
                [t.cpu().numpy() for t in out[:3]], len(idxs), cap
            )
        c_nr = counts[~redis]
        if c_nr.min(initial=2) == 1 and c_nr.max(initial=0) == 1 and (
            sub_counts is None or (sub_counts == 1).all()
        ):
            # Fast path: every lane has exactly one hit (the common serving
            # shape); wide-settled and redis lanes scatter their one position.
            st["fast_path_batches"] += 1
            flat = pos_u[:n].astype(np.int64)
            nw = int(vg.sum())
            if nw:
                st["wide_lanes"] += nw
                slot = np.argmax(ok_slot[vg], axis=1)
                flat[lane_g[vg]] = pos_slot[vg, slot].astype(np.int64)
            if len(idxs):
                st["redis_lanes"] += len(idxs)
                counts[redis] = 1
                flat[idxs] = sub_flat
            return counts, flat, np.arange(n + 1, dtype=np.int64)

        if len(idxs):
            counts[redis] = sub_counts
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        flat_pos = np.empty(int(offsets[-1]), dtype=np.int64)
        wide_settled = np.zeros(n, dtype=bool)
        wide_settled[lane_g[vg]] = True
        st["wide_lanes"] += int(wide_settled.sum())
        st["redis_lanes"] += len(idxs)
        st["multi_hit_queries"] += int((counts > 1).sum())
        settled = (~redis) & (counts == 1) & ~wide_settled
        flat_pos[offsets[:-1][settled]] = pos_u[:n][settled].astype(np.int64)
        # Wide groups: verified slots land at the lane's offsets in BWT-row order.
        sel = ok_slot & vg[:, None]
        if sel.any():
            ranks = np.cumsum(sel, axis=1) - 1
            lane_mat = np.broadcast_to(lane_g[:, None], sel.shape)
            flat_pos[offsets[:-1][lane_mat[sel]] + ranks[sel]] = pos_slot[sel].astype(np.int64)
        if sub_flat is not None and sub_flat.shape[0]:
            within = np.arange(sub_flat.shape[0], dtype=np.int64) - np.repeat(sub_offsets[:-1], sub_counts)
            flat_pos[np.repeat(offsets[:-1][redis], sub_counts) + within] = sub_flat
        return counts, flat_pos, offsets

    def _assemble_flat_positions(self, counts, text_pos, starts, offsets, cap):
        """Ragged assembly of the walked positions; queries over ``cap``
        expand their BWT rows on the device (from range start + cumulative
        count pairs) and walk them through lf_walk."""
        counts = counts.astype(np.int64)
        flat_pos = np.empty(int(offsets[-1]), dtype=np.int64)
        over = counts > cap
        nov = np.where(over, 0, counts)
        valid = np.arange(cap, dtype=np.int64)[None, :] < nov[:, None]
        vals = text_pos[valid].astype(np.int64)
        within = np.arange(vals.shape[0], dtype=np.int64) - np.repeat(
            np.concatenate(([0], np.cumsum(nov)[:-1])), nov
        )
        flat_pos[np.repeat(offsets[:-1], nov) + within] = vals
        if over.any():
            o_counts = counts[over]
            o_total = int(o_counts.sum())
            o_cum = np.cumsum(o_counts)
            o_within = np.arange(o_total, dtype=np.int64) - np.repeat(o_cum - o_counts, o_counts)
            dst = np.repeat(offsets[:-1][over], o_counts) + o_within
            d_starts = torch.from_numpy(starts[over].astype(np.int64)).to(self.device)
            d_cum = torch.from_numpy(o_cum).to(self.device)
            for s0 in range(0, o_total, _OVERCAP_WALK_SLAB):
                m = min(_OVERCAP_WALK_SLAB, o_total - s0)
                h = torch.arange(s0, s0 + m, device=self.device)
                qid = torch.searchsorted(d_cum, h, right=True)
                prev = torch.where(qid > 0, d_cum[(qid - 1).clamp_min(0)], 0)
                walked = lf_walk(self.device_index, d_starts[qid] + (h - prev))
                flat_pos[dst[s0 : s0 + m]] = walked.cpu().numpy()
        return flat_pos

    def _localize(self, text_pos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Global text positions -> (record index, local position)."""
        starts = self._seq_starts_host
        if len(starts) == 1:
            return np.zeros(len(text_pos), dtype=np.int64), text_pos.astype(np.int64) - starts[0]
        seq_idx = np.searchsorted(starts, text_pos, side="right") - 1
        return seq_idx, text_pos.astype(np.int64) - starts[seq_idx]
