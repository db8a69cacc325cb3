"""Multi-device engines: replicated and range-sharded indexes.

The counterpart of ``awry_tpu/parallel/sharding.py``, over a ``('data',
'shard')`` mesh (parallel/mesh.py):

* Mode A (``shard_size=1``): the index is replicated on every data slot's
  device (once per distinct device) and each slot serves its contiguous
  slice of a batch through the single-device search (``search_ranges_t``:
  ``window_read`` seed, ``occ_pair`` steps) and walk (``lf_walk``:
  ``window_read``, ``marked_walk`` or ``sampled_walk``).  No collective.
* Mode B (``shard_size > 1``): the fused block rows are range-split over
  the ``shard`` axis, shard i holding a contiguous, ceil-split range of
  blocks; slots on one device share one shipped copy, each shard a view of
  it.  The prefix sums, codes, k-mer table and the row-sampled SA are
  replicated to each data slot's device (its first slot's).  Each rank step
  runs one ``occ_pair_shard`` launch per shard: a shard finishes the range
  update (``C[sym] + Occ``) for the endpoints its window owns and writes
  them straight into the step's new ranges on the slot's device (each
  endpoint has one owner, and milestones count over the whole BWT), so no
  partial sum is taken: the port's psum.  Locate is the row-sampled walk in
  rounds over the live rows (``walk_rounds``): each round compacts the
  rows not yet sampled and makes ``round_passes`` passes over the shards,
  one ``sampled_walk_shard`` launch per shard and pass, each walking the
  rows its window holds until they are sampled or step out of it; then
  ``sampled_sa[row // sa_ratio]`` plus the steps, modulo bwt_len.  A shard
  on another device works on a copy, merged back by the window test
  (``merge_owned``).  The JAX zero-block padding is not needed: the
  kernels' window test replaces it.

The sweep layouts of the JAX engine (``use_sweep``) are TPU workarounds and
have no counterpart.  The wire formats are the single-device engine's
(crumb for pure A/C/G/T batches, nibble otherwise, raw bytes for amino).

In a run of several processes (parallel/distributed.py) every process
passes the same global query list and serves, on its own mesh, the slice
``process_local_queries`` names; ``count_batch`` and
``count_locate_arrays`` return that slice.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..alphabet import code_to_index_table, index_to_code_table, index_to_dense_table
from ..index import FmIndexData
from ..ops import kernels
from ..ops.device_index import FmDeviceIndex, build_fused_blocks, resolve_device, to_device
from ..ops.engine import _OVERCAP_WALK_SLAB, _bucket, encode_query_batch, pack_wire, upload_wire
from ..ops.locate import lf_walk
from ..ops.search import counts_from_ranges, search_ranges_t
from .distributed import process_count, process_local_queries
from .mesh import DATA_AXIS, SHARD_AXIS, make_mesh


@dataclasses.dataclass(frozen=True)
class Shard:
    """One shard of a range-sharded index: the fused rows of blocks
    [first_block, first_block + blocks.shape[0]) and the rank tables on its
    device."""

    blocks: torch.Tensor  # int32 [local_blocks, row_words], a view of its device's shipped rows
    first_block: int
    codes: torch.Tensor
    c2i: torch.Tensor
    prefix_sums: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.blocks.device


class _Slot:
    """A data slot: its device, its index tables there (the whole index in
    Mode A; the replicated tables and its row of shards in Mode B) and the
    wire's dense-code table there."""

    def __init__(self, dev: FmDeviceIndex, crumb_inv, shards: list[Shard] | None, total_blocks: int):
        self.dev = dev
        self.crumb_inv = crumb_inv
        self.shards = shards
        self.total_blocks = total_blocks

    @property
    def device(self) -> torch.device:
        return self.dev.device

    def search(self, qt, ql, flags):
        """Final BWT ranges of an uploaded slice."""
        update = None if self.shards is None else self.update
        return search_ranges_t(self.dev, qt, ql, **flags, update_fn=update)

    def update(self, starts, ends, sym):
        """One LF range update with collective ranks: one occ_pair_shard
        launch per shard, each writing the entries its window owns straight
        into the step's new (starts, ends) on this device; a shard on
        another device writes a buffer there, merged here by the window
        test."""
        new_starts, new_ends = torch.empty_like(starts), torch.empty_like(ends)
        sym32 = sym.to(torch.int32)
        nbits = self.total_blocks * 256
        for sh in self.shards:
            args = (sh.blocks, sh.first_block, self.total_blocks)
            if sh.device == self.device:
                kernels.occ_pair_shard(*args, starts, ends, sym32, sh.codes, sh.prefix_sums, self.dev.num_planes,
                                       new_starts, new_ends)
                continue
            a, b = (torch.empty(starts.shape, dtype=torch.int64, device=sh.device) for _ in range(2))
            kernels.occ_pair_shard(*args, starts.to(sh.device), ends.to(sh.device), sym32.to(sh.device), sh.codes,
                                   sh.prefix_sums, self.dev.num_planes, a, b)
            new_starts = merge_owned(new_starts, a.to(self.device), starts - 1, sh, nbits)
            new_ends = merge_owned(new_ends, b.to(self.device), ends, sh, nbits)
        return new_starts, new_ends

    def walk(self, rows):
        """int64 text position of each row: lf_walk in Mode A; in Mode B the
        row-sampled walk in rounds over the shards (walk_rounds), then the
        sampled SA read here."""
        if self.shards is None:
            return lf_walk(self.dev, rows)
        dev = self.dev
        pos, steps, _ = walk_rounds(self.shards, self.total_blocks, rows, dev.num_planes, dev.alphabet.ambiguity_idx,
                                    dev.sa_ratio, dev.bwt_len)
        sa = kernels._sa_values(kernels.window_read, dev.sampled_sa, pos // dev.sa_ratio)
        return kernels._text_pos_mod(sa, steps, dev.bwt_len)


def merge_owned(dst: torch.Tensor, src: torch.Tensor, pos: torch.Tensor, shard: Shard, limit: int) -> torch.Tensor:
    """A shard's writes made on another device, brought to ``dst``'s device
    as ``src``, merged by the window test: ``src`` where the shard owns the
    block of ``pos`` (clamped into [0, limit)), ``dst`` elsewhere."""
    own = kernels.owned_by(pos, shard.first_block, shard.blocks.shape[0], limit)
    return torch.where(own, src, dst)


# The most passes round_passes gives one round.
MAX_ROUND_PASSES = 1024


def round_passes(live: int, num_shards: int, sa_ratio: int, survival: float | None = None) -> int:
    """Passes over the shards for a round of ``live`` rows of walk_rounds:
    the passes after which every one of them is sampled with probability
    one half, if each stays live through a pass with probability q
    independently: ln(live / ln 2) / -ln(q), at least 1 and at most
    MAX_ROUND_PASSES.  q is ``survival``, what the rounds before showed,
    or in a round with none before it that of walks over random rows: an LF
    step reaches a sampled row 1 time in sa_ratio and otherwise lands
    outside the window in num_shards - 1 of num_shards, in an earlier one
    (which ends the row's pass) half of those times, so a pass ends at a
    sample 1 time in 1 + (sa_ratio - 1)(num_shards - 1) / (2 num_shards).
    Fewer passes add rounds, each a compaction and a host sync; more run
    launches over finished rows."""
    if survival is None:
        survival = 1 - 1 / (1 + (sa_ratio - 1) * (num_shards - 1) / (2 * num_shards))
    if survival <= 0:
        return 1
    if survival >= 1:
        return MAX_ROUND_PASSES
    return max(1, min(MAX_ROUND_PASSES, math.ceil(math.log(live / math.log(2)) / -math.log(survival))))


def walk_rounds(shards: list[Shard], total_blocks: int, rows, nplanes: int, ambiguity_idx: int, sa_ratio: int,
                bwt_len: int):
    """The row-sampled walk of each row (clamped into [0, bwt_len)) over a
    range-sharded index, in rounds over the live rows: (final rows, steps,
    [(live rows, passes)] of each round).

    A round compacts the rows not yet sampled (one host sync) and gives
    them to each shard in order, one sampled_walk_shard launch each, for
    round_passes passes over the shards, sized by the share of the rows
    that stayed live per pass over all the rounds before (one round's few
    last rows alone give too coarse a share); a shard walks the rows its
    window holds until they are sampled or step out of it, so a row can
    cross into later windows within a pass and go on in the next.  A shard on
    another device walks a copy of the round's rows, merged back by the
    window test.  A row still unsampled after bwt_len steps (a corrupt
    index) raises."""
    dev = rows.device
    pos = rows.clamp(0, bwt_len - 1)
    steps = torch.zeros_like(pos)
    idx = torch.nonzero(pos % sa_ratio != 0)[:, 0]
    rounds, survival, first, done = [], None, int(idx.numel()), 0
    while idx.numel():
        live = int(idx.numel())
        passes = round_passes(live, len(shards), sa_ratio, survival)
        rounds.append((live, passes))
        r, s = pos[idx], steps[idx]
        # One zeroed work counter for each launch of the round on this device.
        cursors = torch.zeros(passes * len(shards), dtype=torch.int64, device=dev)
        for k, sh in enumerate(shards * passes):
            args = (sh.blocks, sh.first_block, total_blocks)
            tail = (sh.prefix_sums, sh.codes, sh.c2i, nplanes, ambiguity_idx, sa_ratio, bwt_len)
            if sh.device == dev:
                kernels.sampled_walk_shard(*args, r, s, *tail, cursor=cursors[k : k + 1])
                continue
            rr, ss = kernels.sampled_walk_shard(*args, r.to(sh.device), s.to(sh.device), *tail)
            r, s = merge_owned(r, rr.to(dev), r, sh, bwt_len), merge_owned(s, ss.to(dev), r, sh, bwt_len)
        pos[idx], steps[idx] = r, s
        idx = idx[torch.nonzero((r % sa_ratio != 0) & (s < bwt_len))[:, 0]]
        done += passes
        survival = (idx.numel() / first) ** (1 / done)
    if bool((pos % sa_ratio != 0).any()):
        raise RuntimeError(f"a row took {bwt_len} LF steps without reaching a sampled row (a corrupt index)")
    return pos, steps, rounds


class ShardedFmEngine:
    """Multi-device count/locate engine over a ``('data', 'shard')`` mesh.

    ``mesh`` None builds ``make_mesh(shard_size=shard_size)`` over every
    CUDA device (raising without one).  ``locate_cap``: hits per query
    walked with the search; queries with more expand their rows on the host
    and share one extra walk per slab (the JAX engine's contract)."""

    def __init__(self, index: FmIndexData, mesh=None, *, shard_size: int = 1, locate_cap: int = 8):
        if index.bwt_len >= 2**32:
            raise NotImplementedError(
                f"bwt_len={index.bwt_len}: the multi-device engines serve the narrow layout; a text of 2**32 "
                "symbols and more is served by FmQueryEngine(index, wide=True)"
            )
        self.mesh = mesh if mesh is not None else make_mesh(shard_size=shard_size)
        self.num_shards = self.mesh.shape[SHARD_AXIS]
        self.data_size = self.mesh.shape[DATA_AXIS]
        self.alphabet = index.alphabet
        self.locate_cap = locate_cap
        self._wire_packed = self.alphabet.cardinality <= 16
        dense_lut = index_to_dense_table(self.alphabet)
        self._crumb_lut = dense_lut if self._wire_packed else None
        crumb_inv = np.flatnonzero(dense_lut >= 0).astype(np.int32)
        self._seq_starts_host = np.asarray(index.seq_starts, dtype=np.int64)

        self.total_blocks = index.num_blocks
        devices = [[resolve_device(d) for d in row] for row in self.mesh.devices]
        # Slots on one device share one copy of every table.
        shipped: dict[torch.device, FmDeviceIndex] = {}
        if self.num_shards == 1:
            for row in devices:
                if row[0] not in shipped:
                    shipped[row[0]] = to_device(index, row[0], slots=False)
            shards = [None] * self.data_size
        else:
            shards = self._ship_shards(index, devices)
            # The replicated tables: an index without blocks or marks ships
            # the prefix sums, codes, k-mer table and the row-sampled SA.
            bare = dataclasses.replace(
                index, planes=index.planes[:0], milestones=index.milestones[:0], mark_bits=None,
                mark_milestones=None, text_sampled_sa=None, text_packed=None,
            )
            for row in devices:
                if row[0] not in shipped:
                    shipped[row[0]] = to_device(bare, row[0], slots=False)
        inv = {dev: torch.from_numpy(crumb_inv).to(dev) for dev in shipped}
        self._slots = [_Slot(shipped[row[0]], inv[row[0]], sh, self.total_blocks) for row, sh in zip(devices, shards)]
        self.device_index = self._slots[0].dev

    def _ship_shards(self, index: FmIndexData, devices) -> list[list[Shard]]:
        """Ceil-split the fused rows into num_shards windows, ship to each
        device the span of the windows its slots hold (once), and give each
        slot row its shards as views of its devices' copies."""
        fused = build_fused_blocks(index).view(np.int32)
        nb = fused.shape[0]
        per = -(-nb // self.num_shards)
        windows = [(min(i * per, nb), min((i + 1) * per, nb)) for i in range(self.num_shards)]
        spans: dict[torch.device, tuple[int, int]] = {}
        for row in devices:
            for dev, (lo, hi) in zip(row, windows):
                a, b = spans.get(dev, (lo, hi))
                spans[dev] = (min(a, lo), max(b, hi))
        tables = {}
        for dev, (lo, hi) in spans.items():
            tables[dev] = dict(
                rows=torch.from_numpy(np.ascontiguousarray(fused[lo:hi])).to(dev), lo=lo,
                codes=torch.from_numpy(index_to_code_table(index.alphabet).astype(np.int32)).to(dev),
                c2i=torch.from_numpy(code_to_index_table(index.alphabet).astype(np.int32)).to(dev),
                prefix_sums=torch.from_numpy(index.prefix_sums.astype(np.int64)).to(dev),
            )
        out = []
        for row in devices:
            shards = []
            for dev, (lo, hi) in zip(row, windows):
                t = tables[dev]
                shards.append(Shard(t["rows"][lo - t["lo"] : hi - t["lo"]], lo, t["codes"], t["c2i"],
                                    t["prefix_sums"]))
            out.append(shards)
        return out

    @property
    def shards(self) -> list[list[Shard]] | None:
        """Each data slot's shards (Mode B), None in Mode A."""
        return None if self.num_shards == 1 else [slot.shards for slot in self._slots]

    # -- host-side encoding ----------------------------------------------------
    def _encode(self, queries):
        """(wire, qlens, n) of this process's slice of ``queries``, padded to
        a multiple of the data axis."""
        if process_count() > 1:
            queries = process_local_queries(queries, self.mesh)
        qsyms, qlens = encode_query_batch(self.alphabet, queries, min_batch=self.data_size)
        return pack_wire(qsyms, qlens, self._crumb_lut), qlens, len(queries)

    def _slices(self, wire, qlens, n):
        per = wire.shape[0] // self.data_size
        return [(slot, wire[i * per : (i + 1) * per], qlens[i * per : (i + 1) * per], min(max(n - i * per, 0), per))
                for i, slot in enumerate(self._slots)]

    def _upload(self, slot: _Slot, wire, qlens):
        return upload_wire(wire, qlens, slot.device, slot.crumb_inv, self._wire_packed, slot.dev.kmer_len)

    # -- public API --------------------------------------------------------------
    def count_batch(self, queries) -> np.ndarray:
        """Counts per query (uint64).  In a run of several processes every
        process passes the same global list and receives the counts of its
        slice (process_local_queries)."""
        parts = []
        for slot, w, q, m in self._slices(*self._encode(queries)):
            starts, ends = slot.search(*self._upload(slot, w, q))
            parts.append((counts_from_ranges(starts, ends), m))
        return np.concatenate([c.cpu().numpy()[:m] for c, m in parts]).astype(np.uint64)

    def _walk_rows(self, rows: np.ndarray) -> np.ndarray:
        """Text positions of BWT rows (a padded slab split over the data
        slots, each walking its slice)."""
        padded = np.zeros(_bucket(rows.shape[0], minimum=self.data_size), dtype=np.int64)
        padded[: rows.shape[0]] = rows
        per = padded.shape[0] // self.data_size
        walked = [slot.walk(torch.from_numpy(padded[i * per : (i + 1) * per]).to(slot.device))
                  for i, slot in enumerate(self._slots)]
        return np.concatenate([w.cpu().numpy() for w in walked])[: rows.shape[0]]

    def count_locate_arrays(self, queries):
        """Bulk serving form (FmQueryEngine.count_locate_arrays' contract):
        ``(counts uint64[n], seq_idx int64[T], local int64[T], offsets
        int64[n + 1])``, the hits of query i at [offsets[i], offsets[i+1])
        in BWT-row order.  Each slot searches and walks up to locate_cap
        rows per query; over-cap queries expand their rows on the host and
        share one extra walk per slab.  Several processes: this process's
        slice, as count_batch."""
        cap = self.locate_cap
        parts = []
        for slot, w, q, m in self._slices(*self._encode(queries)):
            starts, ends = slot.search(*self._upload(slot, w, q))
            counts = counts_from_ranges(starts, ends)
            text_pos = slot.walk(kernels.slot_rows(starts, counts, cap).reshape(-1)).reshape(-1, cap)
            parts.append((counts, text_pos, starts, m))
        counts, text_pos, starts = (np.concatenate([p[i].cpu().numpy()[: p[3]] for p in parts]) for i in range(3))
        n = counts.shape[0]

        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        flat_pos = np.empty(int(offsets[-1]), dtype=np.int64)
        over = counts > cap
        nov = np.where(over, 0, counts)
        valid = np.arange(cap, dtype=np.int64)[None, :] < nov[:, None]
        vals = text_pos[valid]
        within = np.arange(vals.shape[0], dtype=np.int64) - np.repeat(np.concatenate(([0], np.cumsum(nov)[:-1])), nov)
        flat_pos[np.repeat(offsets[:-1], nov) + within] = vals
        if over.any():
            o_counts = counts[over]
            o_total = int(o_counts.sum())
            o_cum = np.concatenate(([0], np.cumsum(o_counts)))
            o_within = np.arange(o_total, dtype=np.int64) - np.repeat(o_cum[:-1], o_counts)
            all_rows = np.repeat(starts[over], o_counts) + o_within
            dst = np.repeat(offsets[:-1][over], o_counts) + o_within
            for s0 in range(0, o_total, _OVERCAP_WALK_SLAB):
                chunk = all_rows[s0 : s0 + _OVERCAP_WALK_SLAB]
                flat_pos[dst[s0 : s0 + chunk.shape[0]]] = self._walk_rows(chunk)

        seq_idx = np.searchsorted(self._seq_starts_host, flat_pos, side="right") - 1
        local = flat_pos - self._seq_starts_host[seq_idx]
        return counts.astype(np.uint64), seq_idx, local, offsets

    def locate_batch(self, queries) -> list[list[tuple[int, int]]]:
        """(record index, local position) hits per query, in BWT-row order."""
        counts, seq_idx, local, offsets = self.count_locate_arrays(queries)
        pairs = list(zip(seq_idx.tolist(), local.tolist()))
        return [pairs[offsets[i] : offsets[i + 1]] for i in range(len(counts))]

