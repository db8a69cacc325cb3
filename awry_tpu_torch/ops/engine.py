"""FmQueryEngine: the user-facing batch count/locate API on the card.

Every call is a batch: queries are encoded and padded on the host (bucketed
shapes), packed into the densest wire the batch admits (2-bit crumbs for
pure A/C/G/T batches, 4-bit nibbles otherwise, raw bytes for amino),
served by the verify path (ops/verify.py) when the padded length fits its
window, else by the classic full-depth path (ops/locate.py), and assembled
on the host with vectorized NumPy.  The verify path is the slot regime
(count_locate_slots_t) on slot-capable indexes, else the switch step
(count_locate_verify_t).  An index without marks or packed text (loaded
from a ``.awry`` file) is served by the classic path alone, its locate by
the row-sampled walk; ``use_verify=False`` forces the classic path on any
index.  A text of 2**32 symbols and more ships in the 64-bit layout
(ops/wide.py) and is served by the classic path alone (``wide``).

The engine runs on the card: ``device=None`` means ``cuda:0`` and raises
when no CUDA device exists; ``device="cpu"`` runs the kernels' plain
PyTorch versions on the host (the tests do this).

``mesh=`` (parallel/mesh.py, a mesh whose ``shard`` axis has size 1) serves
data-parallel, Mode A (the counterpart of awry_tpu/ops/engine.py's mesh
seam): the index ships once per distinct device of the ``data`` axis, each
padded wire batch is cut into ``data`` equal contiguous slices, each slice
is served on its slot's device through the path above, and the results
merge in query order.  The JAX seam wraps every kernel in ``shard_map``;
here a slice is simply served by the engine of its slot's device.

Spans (``utils.profiling.span``, recorded only while a ``torch.profiler``
runs) name the parts of serving, nested as they run: ``awry.encode``;
``awry.dispatch#n`` (the engine's n-th batch) holding ``awry.upload``,
``awry.launch`` and ``awry.to_host``; ``awry.assemble#n`` (the same n)
holding ``awry.d2h_wait``, ``awry.verify_finish`` (with ``awry.redispatch``
and ``awry.redis_layout``) on a verify batch or ``awry.flat_positions``
(with ``awry.overcap_expand``) on a classic one, and ``awry.localize``.
``engine.stats`` counts what serving did (``STATS``).
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from ..alphabet import encode_ascii, index_to_ascii_table
from ..index import FmIndexData
from ..utils.profiling import Counters, span
from . import kernels
from .device_index import TEXT_PAD_WORDS, resolve_device, to_device
from .locate import count_locate_capped_t, lf_walk
from .search import count_batch_kernel_t, counts_from_ranges, search_ranges_t, unpack_crumbs_t, unpack_nibbles_t
from .verify import count_locate_slots_t, count_locate_verify_t, switch_step, unpack_verify_bundle, wide_groups
from .wide import to_device_wide

# Rows per over-cap locate slab (bounds the device expansion's memory).
_OVERCAP_WALK_SLAB = 8 * 1024 * 1024

# engine.stats: batches and queries assembled; slices served by the verify
# path, those of them on the fast path, their wide-settled and re-dispatched
# lanes and queries with more than one hit; queries over cap and the rows
# their expansion walks (on a verify slice: its re-dispatched lanes over cap
# and their hits); bytes read from the device outside the pinned copies;
# blocking device reads; hits the device laid out at their final offsets.
STATS = ("batches", "queries", "verify_batches", "fast_path_batches", "wide_lanes", "redis_lanes",
         "multi_hit_queries", "overcap_queries", "overcap_rows", "pageable_d2h_bytes", "host_syncs",
         "laid_positions")


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


def upload_wire(wire: np.ndarray, qlens: np.ndarray, device: torch.device, crumb_inv: torch.Tensor | None,
                wire_packed: bool, kmer_len: int):
    """Wire batch -> (qt int32[L, B], qlens int64[B], kernel flags) on
    ``device``; ``crumb_inv`` (on ``device``) maps dense codes to symbol
    indexes.  ``seeded_floor`` holds when no lane is live before step k:
    crumb lanes k-mer-seed whenever qlen >= k."""
    w = torch.from_numpy(np.ascontiguousarray(wire)).to(device)
    ql = torch.from_numpy(np.ascontiguousarray(qlens)).to(device).to(torch.int64)
    crumb = wire_packed and wire.dtype == np.int8
    if crumb:
        qt = unpack_crumbs_t(w, crumb_inv)
    elif wire_packed:
        qt = unpack_nibbles_t(w)
    else:
        qt = w.T.to(torch.int32).contiguous()
    k = kmer_len
    q = qlens.astype(np.int64)
    floor = crumb and k > 0 and qt.shape[0] >= k and bool(((q <= 1) | (q >= k)).all())
    return qt, ql, {"no_sentinel": crumb, "seeded_floor": floor}


def _data_slots(mesh) -> int:
    """The size of a data-parallel mesh's ``data`` axis; raises ValueError
    for a mesh that shards the index or whose data axis is no power of two."""
    for axis, size in mesh.shape.items():
        if axis != "data" and size != 1:
            raise ValueError(
                f"FmQueryEngine mesh axis {axis!r} must be size 1 (use ShardedFmEngine for range sharding)"
            )
    data = mesh.shape["data"]
    if data & (data - 1):
        raise ValueError("mesh data axis size must be a power of two")
    return data


class FmQueryEngine:
    """Batch count/locate engine over an FM-index shipped to one device (or
    to each device of a data-parallel mesh)."""

    def __init__(self, index: FmIndexData, *, device=None, slots: bool = True, use_verify: bool | None = None,
                 strict: bool = False, wide: bool | None = None, mesh=None):
        """``slots``: serve through the slot regime when the index is
        slot-capable (False: the switch-step path on any index).
        ``use_verify``: None serves through the verify path whenever the
        index has marks and packed text; False forces the classic path.
        ``strict``: value-validate the index before shipping it
        (FmIndexData.validate(strict=True)), and check pre-encoded wire
        batches for symbols and lengths out of range, which would otherwise
        be clamped into wrong answers.  ``wide``: None ships the index in
        the 64-bit layout (ops/wide.py) exactly when ``bwt_len >= 2**32``;
        True forces it on any index, False refuses it.  The wide index is
        served by the classic path alone (no verify path, no slot rows).
        ``mesh``: data-parallel serving over the mesh's ``data`` slots (the
        module docstring); its ``shard`` axis must have size 1 (range
        sharding is parallel.sharding.ShardedFmEngine) and its ``data``
        axis a power of two (padded batches are powers of two).  It names
        the devices, so ``device`` must be None."""
        if mesh is not None:
            data = _data_slots(mesh)
            if device is not None:
                raise ValueError("FmQueryEngine: pass either device= or mesh=, not both")
            device = mesh.devices[0, 0]
        self.device = resolve_device(device)
        self.strict = strict
        if strict:
            index.validate(strict=True)
        self.wide = index.bwt_len >= 2**32 if wide is None else bool(wide)
        self._verify_enabled = (use_verify is None or use_verify) and index.has_marks and (
            index.text_packed is not None
        ) and not self.wide
        if self.wide:
            self.device_index = dev = to_device_wide(index, self.device)
        else:
            self.device_index = dev = to_device(index, self.device, slots=slots and self._verify_enabled)
        self.stats = Counters(STATS)
        self._batch_seq = itertools.count()
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
        elif self._verify_enabled:
            self._verify_s = switch_step(dev)
            self._verify_kernel = count_locate_verify_t
            # Longest padded query the backward text-window read covers.
            self._verify_max_len = TEXT_PAD_WORDS * spw
        self._seq_starts_host = np.asarray(index.seq_starts, dtype=np.int64)
        # Data-parallel slots: the engine of each data slot's device (this
        # one for its own device), all adding into this engine's stats.
        self._data_shards = 1
        self._slot_engines = None
        if mesh is not None:
            self._data_shards = data
            engines = {self.device: self}
            for dev in mesh.devices[:, 0]:
                dev = resolve_device(dev)
                if dev not in engines:
                    engines[dev] = FmQueryEngine(index, device=dev, slots=slots, use_verify=use_verify, wide=wide)
                    engines[dev].stats = self.stats
            self._slot_engines = [engines[resolve_device(dev)] for dev in mesh.devices[:, 0]]

    def _engines(self) -> list:
        """This engine and the other slot devices' engines, once each."""
        if self._slot_engines is None:
            return [self]
        return list({id(e): e for e in [self, *self._slot_engines]}.values())

    def _slices(self, wire: np.ndarray, qlens: np.ndarray, n: int) -> list[tuple]:
        """(engine, wire, qlens, true count) of each data slot's contiguous
        slice of a wire batch, in query order (the whole batch without a
        mesh)."""
        if self._slot_engines is None:
            return [(self, wire, qlens, n)]
        d = len(self._slot_engines)
        if wire.shape[0] % d:
            raise ValueError(f"a wire batch of {wire.shape[0]} rows does not split into {d} equal slices")
        per = wire.shape[0] // d
        return [(eng, wire[i * per : (i + 1) * per], qlens[i * per : (i + 1) * per], min(max(n - i * per, 0), per))
                for i, eng in enumerate(self._slot_engines)]

    # -- host-side encoding ----------------------------------------------------
    def encode_queries(self, queries) -> tuple[np.ndarray, np.ndarray]:
        """Encode + pad str/bytes queries into the host wire: (wire, qlens)
        numpy arrays (qlens uint8 when every query is <= 255 symbols)."""
        with span("awry.encode"):
            qsyms, qlens = encode_query_batch(self.device_index.alphabet, queries, min_batch=max(16, self._data_shards))
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
        device (upload_wire); the flags carry this engine's stats, where the
        search counts its host syncs."""
        with span("awry.upload"):
            qt, ql, flags = upload_wire(wire, qlens, self.device, self._crumb_inv, self._wire_packed,
                                        self.device_index.kmer_len)
        return qt, ql, {**flags, "stats": self.stats}

    # -- public API --------------------------------------------------------------
    def count_batch(self, queries) -> np.ndarray:
        """Occurrence count per query (uint64)."""
        wire, qlens = self.encode_queries(queries)
        parts = []
        for eng, w, q, m in self._slices(wire, qlens, len(queries)):
            qt, ql, flags = eng._upload(w, q)
            parts.append((count_batch_kernel_t(eng.device_index, qt, ql, **flags), m))
        return np.concatenate([c.cpu().numpy()[:m] for c, m in parts]).astype(np.uint64)

    def count_batch_dispatch(self, encoded) -> torch.Tensor:
        """Counts of a pre-encoded batch (``(wire, qlens[, n])`` from
        encode_queries) as the device's int64 tensor, padded to the wire's
        batch, with no host sync: every search step runs, masked, so a
        caller can dispatch several engines before it reads any.  With a
        mesh the slices' counts are gathered on this engine's device."""
        wire, qlens = encoded[:2]
        out = []
        for eng, w, q, _ in self._slices(wire, qlens, wire.shape[0]):
            qt, ql, flags = eng._upload(w, q)
            out.append(count_batch_kernel_t(eng.device_index, qt, ql, **flags, skip_idle=False).to(self.device))
        return out[0] if len(out) == 1 else torch.cat(out)

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
        wire, qlens = self.encode_queries(queries)
        starts, ends = [], []
        for eng, w, q, m in self._slices(wire, qlens, len(queries)):
            qt, ql, flags = eng._upload(w, q)
            s, e = search_ranges_t(eng.device_index, qt, ql, **flags)
            starts.append(s.cpu().numpy()[:m])
            ends.append(e.cpu().numpy()[:m])
        return np.concatenate(starts), np.concatenate(ends)

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
        for eng in self._engines():
            eng.device_index = None
            eng._crumb_inv = None

    def count_locate_stream(self, query_batches, *, cap: int = 8, depth: int = 2):
        """Pipelined bulk serving: a generator over batches, each a list of
        str/bytes or a pre-encoded ``(wire, qlens, n)`` tuple from
        encode_queries (n = true query count).  At most ``depth`` batches are
        dispatched but unassembled: each one's results copy into pinned host
        memory without blocking, and an event marks when they have landed, so
        host assembly of one batch overlaps the device work of the next.
        Each item matches count_locate_arrays' return."""
        inflight: list[list] = []
        for batch in query_batches:
            inflight.append(self._dispatch(batch, cap))
            if len(inflight) >= depth:
                yield self._assemble(inflight.pop(0), cap)
        while inflight:
            yield self._assemble(inflight.pop(0), cap)

    # -- dispatch / assembly -------------------------------------------------------
    def _to_host(self, *tensors):
        """Start device->host copies into pinned buffers; returns the host
        tensors and an event recorded after the copies (None on the CPU)."""
        if self.device.type != "cuda":
            return list(tensors), None
        with span("awry.to_host"):
            hosts = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                hosts.append(h)
            event = torch.cuda.Event()
            event.record()
        return hosts, event

    def _verify_for(self, wire: np.ndarray) -> bool:
        """The verify path serves this wire batch (it is on, and the padded
        length fits its window)."""
        return self._verify_enabled and self._wire_len(wire) <= self._verify_max_len

    def _check_wire(self, wire: np.ndarray, qlens: np.ndarray) -> None:
        """Strict mode: a pre-encoded batch with a length or symbol out of
        range raises instead of being clamped on the device."""
        width = self._wire_len(wire)
        ql = np.asarray(qlens).astype(np.int64)
        if (ql < 0).any() or (ql > width).any():
            raise ValueError(f"wire batch: query length outside [0, {width}]")
        if self._wire_packed and wire.dtype == np.int8:
            return  # every 2-bit crumb decodes to a dense symbol
        syms = np.concatenate([wire & 0xF, wire >> 4], axis=None) if self._wire_packed else wire
        card = self.device_index.alphabet.cardinality
        if (syms.astype(np.int64) < 0).any() or (syms.astype(np.int64) >= card).any():
            raise ValueError(f"wire batch: symbol index outside [0, {card})")

    def _wire_of(self, batch):
        """(wire, qlens, n) of a batch: a list of queries, encoded here, or a
        pre-encoded (wire, qlens, n) tuple, checked in strict mode."""
        if isinstance(batch, tuple):
            wire, qlens, n = batch
            if self.strict:
                self._check_wire(wire, qlens)
            return wire, qlens, n
        return (*self.encode_queries(batch), len(batch))

    def _device_outputs(self, wire, qlens, cap):
        """Upload one wire batch and launch its path: (kind, the outputs the
        host assembles from, the padded batch size of a verify bundle)."""
        qt, ql, flags = self._upload(wire, qlens)
        with span("awry.launch"):
            if self._verify_for(wire):
                bundle, starts, _ = self._verify_kernel(self.device_index, qt, ql, self._verify_s, **flags)
                return "verify", (bundle,), starts.shape[0]
            counts, text_pos, starts, _ = count_locate_capped_t(self.device_index, qt, ql, cap, **flags)
            return "classic", (counts, text_pos, starts), None

    def _dispatch(self, batch, cap) -> tuple[int, list[tuple]]:
        """Launch one batch: its number n (``awry.dispatch#n``, and the
        ``awry.assemble#n`` of its assembly) and, per data slice, its engine
        and what its assembly needs."""
        wire, qlens, n = self._wire_of(batch)
        seq = next(self._batch_seq)
        with span("awry.dispatch", seq):
            return seq, [(eng, eng._dispatch_slice(w, q, m, cap)) for eng, w, q, m in self._slices(wire, qlens, n)]

    def _dispatch_slice(self, wire, qlens, n, cap):
        kind, outs, padded = self._device_outputs(wire, qlens, cap)
        return (kind, n, wire, qlens, *self._to_host(*outs), padded)

    def _digests(self, batches, cap: int) -> torch.Tensor:
        """int64[len(batches)] on the device: per batch, the sum of every
        output its dispatch hands the host (over its slices, with a mesh)."""
        digests = []
        for batch in batches:
            total = torch.zeros((), dtype=torch.int64, device=self.device)
            for eng, w, q, _ in self._slices(*self._wire_of(batch)):
                outs = eng._device_outputs(w, q, cap)[1]
                total = total + torch.stack([o.to(torch.int64).sum() for o in outs]).sum().to(self.device)
            digests.append(total)
        return torch.stack(digests)

    def device_sustained_qps(self, batches, *, cap: int = 8, trials: int = 3) -> float:
        """Capacity-planning probe: the rate at which the device serves
        ``batches`` (pre-encoded ``(wire, qlens, n)`` tuples from
        encode_queries) through the same dispatch as count_locate_stream,
        with every output reduced on the device to one int64 per batch and
        one ``.item()`` per pass, so that host assembly and result copies
        drop out.  Returns the best of ``trials`` passes in queries/s, after
        one pass that warms up."""
        total = sum(n for _, _, n in batches)
        self._digests(batches, cap).sum().item()
        best = 0.0
        for _ in range(trials):
            t0 = time.perf_counter()
            self._digests(batches, cap).sum().item()
            best = max(best, total / (time.perf_counter() - t0))
        return best

    def warmup(self, *, batch_sizes=(16,), query_lens=(8,), cap: int = 8) -> None:
        """Build the kernel library (on the card) and run each dispatch kind
        (count, classic count+locate, verify where it applies) once per wire
        mode and padded-shape bucket that batches of the given sizes and
        lengths land in, so that a server's first real batch pays no build
        and runs on a card already busy.  The batches go through
        encode_queries: an ambiguity letter takes the nibble (or raw) wire,
        a dense letter the crumb wire."""
        if self.device.type == "cuda":
            kernels.build()
        alphabet = self.device_index.alphabet
        letters = [chr(index_to_ascii_table(alphabet)[alphabet.ambiguity_idx])]
        if self._wire_packed:
            letters.append(chr(index_to_ascii_table(alphabet)[int(self._crumb_inv[0])]))
        for b in batch_sizes:
            for length in query_lens:
                for letter in letters:
                    wire, qlens = self.encode_queries([letter * max(1, length)] * max(1, b))
                    for eng, w, q, _ in self._slices(wire, qlens, wire.shape[0]):
                        qt, ql, flags = eng._upload(w, q)
                        count_batch_kernel_t(eng.device_index, qt, ql, **flags)
                        eng._device_outputs(w, q, cap)
        for eng in self._engines():
            if eng.device.type == "cuda":
                torch.cuda.synchronize(eng.device)

    def _assemble(self, dispatched: tuple, cap):
        """The slices' results of one dispatched batch, merged in query
        order."""
        seq, parts = dispatched
        with span("awry.assemble", seq):
            out = [eng._assemble_slice(*item, cap) for eng, item in parts]
            self.stats.add(batches=1, queries=sum(item[1] for _, item in parts))
            if len(out) == 1:
                return out[0]
            offsets, total = [np.zeros(1, dtype=np.int64)], 0
            for o in out:
                offsets.append(o[3][1:] + total)
                total += int(o[3][-1])
            return (*(np.concatenate([o[i] for o in out]) for i in range(3)), np.concatenate(offsets))

    def _assemble_slice(self, kind, n, wire, qlens, hosts, event, batch, cap):
        if event is not None:
            with span("awry.d2h_wait"):
                event.synchronize()
            self.stats.add(host_syncs=1)
        arrays = [h.numpy() for h in hosts]
        if kind == "verify":
            with span("awry.verify_finish"):
                counts, flat_pos, offsets = self._flat_verify_finish(n, wire, qlens, cap, arrays[0], batch)
        else:
            counts, flat_pos, offsets = self._flat_classic(arrays, n, cap)
        with span("awry.localize"):
            seq_idx, local = self._localize(flat_pos)
        return counts.astype(np.uint64), seq_idx, local, offsets

    def _flat_classic(self, arrays, n, cap):
        counts, text_pos, starts = (a[:n] for a in arrays)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        with span("awry.flat_positions"):
            flat_pos = self._assemble_flat_positions(counts, text_pos, starts, offsets, cap)
        return counts.astype(np.int64), flat_pos, offsets

    def _flat_verify_finish(self, n, wire, qlens, cap, bundle, batch):
        """Host side of one verify batch: unpack the bundle and count the
        re-dispatched (redis) lanes by a full-depth search on the device;
        lay out the redis lanes' hits on the device, each at its final
        offset (_lay_out_rows); then write the settled lanes' and the wide
        groups' positions on the host, by the fast path when every lane has
        one hit."""
        pos_u, counts_b, redis_b, lane_g, pos_slot, ok_slot = unpack_verify_bundle(
            bundle, batch, wide_groups(batch)
        )
        counts = counts_b[:n]
        redis = redis_b[:n]
        vg = lane_g < n
        # Redis lanes first, so that a stray one (about one per 512k batch at
        # chr1 scale) does not knock the batch off the fast path.
        idxs = np.nonzero(redis)[0]
        if len(idxs):
            with span("awry.redispatch"):
                starts_d, counts_d, sub_counts = self._redis_counts(wire, qlens, idxs)
            counts[redis] = sub_counts
            over = sub_counts > cap
            self.stats.add(overcap_queries=int(over.sum()), overcap_rows=int(sub_counts[over].sum()))
        fast = counts.min(initial=2) == 1 and counts.max(initial=0) == 1
        if fast:
            offsets = np.arange(n + 1, dtype=np.int64)
        else:
            offsets = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(counts, out=offsets[1:])
        laid = int(counts[idxs].sum())
        if laid:
            with span("awry.redis_layout"):
                flat_pos = self._lay_out_rows(starts_d, counts_d, offsets[idxs], laid, int(offsets[-1]))
        else:
            flat_pos = np.empty(int(offsets[-1]), dtype=np.int64)

        if fast:
            # Fast path: every lane has exactly one hit (the common serving
            # shape); wide-settled lanes scatter their one position.
            np.copyto(flat_pos, pos_u[:n], where=~redis)
            nw = int(vg.sum())
            if nw:
                slot = np.argmax(ok_slot[vg], axis=1)
                flat_pos[lane_g[vg]] = pos_slot[vg, slot].astype(np.int64)
            self.stats.add(verify_batches=1, fast_path_batches=1, wide_lanes=nw, redis_lanes=len(idxs))
            return counts, flat_pos, offsets

        wide_settled = np.zeros(n, dtype=bool)
        wide_settled[lane_g[vg]] = True
        self.stats.add(verify_batches=1, wide_lanes=int(wide_settled.sum()), redis_lanes=len(idxs),
                       multi_hit_queries=int((counts > 1).sum()))
        settled = (~redis) & (counts == 1) & ~wide_settled
        flat_pos[offsets[:-1][settled]] = pos_u[:n][settled].astype(np.int64)
        # Wide groups: verified slots land at the lane's offsets in BWT-row order.
        sel = ok_slot & vg[:, None]
        if sel.any():
            ranks = np.cumsum(sel, axis=1) - 1
            lane_mat = np.broadcast_to(lane_g[:, None], sel.shape)
            flat_pos[offsets[:-1][lane_mat[sel]] + ranks[sel]] = pos_slot[sel].astype(np.int64)
        return counts, flat_pos, offsets

    def _read_back(self, tensor: torch.Tensor) -> np.ndarray:
        """A device tensor on the host, through _to_host's pinned buffer (the
        tensor itself on the CPU): one blocking read."""
        (host,), event = self._to_host(tensor)
        if event is not None:
            event.synchronize()
        self.stats.add(host_syncs=1)
        return host.numpy()

    def _redis_counts(self, wire, qlens, idxs):
        """Full-depth search of the redis lanes ``idxs`` of a verify batch
        (their wire rows, re-bucketed): their range starts and counts on the
        device, and the counts on the host."""
        m = len(idxs)
        pad_idx = np.zeros(_bucket(m), dtype=np.int64)  # padding rows repeat row 0, sliced off
        pad_idx[:m] = idxs
        qt, ql, flags = self._upload(wire[pad_idx], qlens[pad_idx])
        starts, ends = search_ranges_t(self.device_index, qt, ql, **flags)
        counts = counts_from_ranges(starts[:m], ends[:m])
        return starts[:m], counts, self._read_back(counts)

    def _lay_out_rows(self, starts, counts, dst, laid: int, total: int) -> np.ndarray:
        """int64[total] flat positions on the host: query i's ``counts[i]``
        BWT rows from ``starts[i]`` (device tensors) are walked through
        lf_walk and written, in row order, at ``dst[i]`` (host offsets)
        onwards of one device buffer, which comes back in one pinned copy.
        ``laid`` is the sum of the counts; every other entry is left for the
        host to write."""
        flat = torch.empty(total, dtype=torch.int64, device=self.device)
        cum = torch.cumsum(counts, 0)
        # Row h of the whole (query i's are cum[i] - counts[i] .. cum[i] - 1)
        # is BWT row row0[i] + h, written at dst0[i] + h.
        row0 = starts - (cum - counts)
        dst0 = torch.from_numpy(dst).to(self.device) - (cum - counts)
        for s0 in range(0, laid, _OVERCAP_WALK_SLAB):
            h = torch.arange(s0, min(s0 + _OVERCAP_WALK_SLAB, laid), device=self.device)
            q = torch.searchsorted(cum, h, right=True)
            flat[dst0[q] + h] = lf_walk(self.device_index, row0[q] + h)
        self.stats.add(laid_positions=laid)
        return self._read_back(flat)

    def _assemble_flat_positions(self, counts, text_pos, starts, offsets, cap):
        """Ragged assembly of the walked positions; the rows of queries over
        ``cap`` are walked and laid out on the device (_lay_out_rows), and
        the host writes the capped walks' positions into that buffer.  On an
        index without marks a position read here that is -1 (a walk that
        could not end) raises RuntimeError: the range-fed walk leaves that
        check to this point, where the host waits on the batch anyway."""
        counts = counts.astype(np.int64)
        over = counts > cap
        if over.any():
            with span("awry.overcap_expand"):
                o_counts = counts[over]
                o_total = int(o_counts.sum())
                flat_pos = self._lay_out_rows(
                    torch.from_numpy(starts[over].astype(np.int64)).to(self.device),
                    torch.from_numpy(o_counts).to(self.device), offsets[:-1][over], o_total, int(offsets[-1]),
                )
            self.stats.add(overcap_queries=len(o_counts), overcap_rows=o_total)
        else:
            flat_pos = np.empty(int(offsets[-1]), dtype=np.int64)
        nov = np.where(over, 0, counts)
        valid = np.arange(cap, dtype=np.int64)[None, :] < nov[:, None]
        vals = text_pos[valid].astype(np.int64)
        if not self.device_index.has_marks and vals.size and vals.min() < 0:
            raise RuntimeError(
                f"sampled_walk_ranges: a row took {self.device_index.bwt_len} LF steps without reaching a "
                "sampled row (a corrupt index)"
            )
        within = np.arange(vals.shape[0], dtype=np.int64) - np.repeat(
            np.concatenate(([0], np.cumsum(nov)[:-1])), nov
        )
        flat_pos[np.repeat(offsets[:-1], nov) + within] = vals
        return flat_pos

    def _localize(self, text_pos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Global text positions -> (record index, local position)."""
        starts = self._seq_starts_host
        if len(starts) == 1:
            return np.zeros(len(text_pos), dtype=np.int64), text_pos.astype(np.int64) - starts[0]
        seq_idx = np.searchsorted(starts, text_pos, side="right") - 1
        return seq_idx, text_pos.astype(np.int64) - starts[seq_idx]
