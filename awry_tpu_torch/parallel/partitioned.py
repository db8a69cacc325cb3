"""Partitioned FM-index federation: exact count and locate over a corpus of
many records as one index of record groups (the pan-genome configuration).

The port's counterpart of ``awry_tpu/parallel/partitioned.py``, with its
semantics:

* the GLOBAL text is all records joined by the delimiter, exactly as one
  monolithic index would store them;
* records are packed greedily, in order, into partitions of at most
  ``max_partition_symbols`` (a record larger than the cap forms its own);
* partition p indexes global_text[s_p : s_{p+1} + overlap), overlap =
  max_query_len - 1, so any match short enough to be queried that starts
  in p's owned range [s_p, s_{p+1}) lies wholly in p's text;
* a match is OWNED by p iff it starts in p's owned range.  Counts subtract
  the matches that start in p's overlap tail (at most max_query_len - 1
  symbols, scanned directly): owned_count(p) = count_p(q) - tail_count_p(q);
  locate drops hits whose local start is >= owned_len and maps the rest to
  global (record, local) positions.

Queries longer than max_query_len raise ValueError.

Each partition is served by its own ``FmQueryEngine``.  ``device`` None
means the card: engines go round-robin over ``torch.cuda.device_count()``
devices, and without a card the federation raises; ``device="cpu"`` runs
the kernels' plain versions.  A failed engine raises: nothing falls back to
another device.  ``use_device=False`` serves each partition with
``FmQueryEngine(index, device="cpu")``.  The reference's ``lean=True``
engine option drops a slim copy of the rows that this port never makes, so
it has no counterpart here.

``save`` and ``load`` read and write the reference's layout (``meta.json``,
``globals.npz``, ``part_<i>.npz`` artifacts): a federation saved by either
package loads in the other.  This module imports no torch until an engine
is built: the spawned build workers import only the host layer.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from ..alphabet import Alphabet, encode_ascii, normalize_text
from ..index import FmBuildArgs, FmIndexData


def _build_partition_worker(task):
    """Build one partition in a spawned worker (NumPy and the native SA-IS
    only: the host k-mer build, no torch) and hand it back as an
    uncompressed artifact file.  The global text travels through a shared
    temporary file, not pickling: each worker reads only its slice."""
    gi, text_path, g_start, end_with_overlap, args, tmpdir = task
    from ..build.builder import build_from_records
    from ..io.artifact import save_artifact

    with open(text_path, "rb") as f:
        f.seek(g_start)
        text = f.read(end_with_overlap - g_start)
    index = build_from_records([(f"partition_{gi}", text)], args)
    path = os.path.join(tmpdir, f"part_{gi}.npz")
    save_artifact(index, path, compress=False)
    return gi, path


@dataclasses.dataclass
class _Partition:
    index: FmIndexData
    tail_syms: np.ndarray | None  # encoded overlap-tail text (None for the last partition)
    global_start: int  # global text offset of this partition's owned range
    owned_len: int  # length of the owned range (without the overlap tail)
    engine: object | None = None  # the partition's engine on the federation's device, built on first use
    host_engine: object | None = None  # its engine on the CPU (use_device=False), built on first use


def _engine_devices(device) -> list:
    """The devices partition engines go round-robin over: every CUDA device
    for None (raises without one), else the one named."""
    import torch

    from ..ops.device_index import resolve_device

    resolved = resolve_device(device)
    if device is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [resolved]


class PartitionedFmIndex:
    """Federation of per-partition FM-indexes with exact global semantics."""

    def __init__(self, partitions, seq_starts, headers, alphabet, max_query_len, *, device=None):
        self.partitions: list[_Partition] = partitions
        self.seq_starts = seq_starts  # global record starts, int64
        self.headers = headers
        self.alphabet = alphabet
        self.max_query_len = max_query_len
        self._devices = _engine_devices(device)

    # -- construction ------------------------------------------------------
    @classmethod
    def build_from_records(
        cls,
        records: list[tuple[str, bytes]],
        args: FmBuildArgs,
        *,
        max_partition_symbols: int,
        max_query_len: int,
        num_workers: int = 1,
        consume_input: bool = False,
        device=None,
    ):
        """Split records into partitions of at most max_partition_symbols
        and build each with ``args`` (alphabet, ratios and k-mer length
        apply to every partition).  The serial build (``num_workers`` 1)
        builds a k-mer table on ``device`` when ``args`` asks for the
        device build.

        ``num_workers > 1`` builds partitions in parallel spawned worker
        processes, which use the host k-mer build and hand indexes back as
        uncompressed artifacts on disk.  ``consume_input`` clears the
        caller's record list once the global text holds it."""
        from ..build.builder import build_from_records

        if max_query_len < 1:
            raise ValueError("max_query_len must be >= 1")
        if not records:
            raise ValueError("input contains no sequence records")
        _engine_devices(device)  # no card for device=None: raise before the build
        alphabet = args.alphabet
        delim = alphabet.delimiter
        # Partition builds must not share the caller's SA-cache path (equal
        # partition texts would reuse each other's cached SA).
        part_args = dataclasses.replace(args, suffix_array_output_src=None)

        headers = [h for h, _ in records]
        seqs = [normalize_text(alphabet, s).tobytes() for _, s in records]
        if consume_input:
            records.clear()
        seq_starts = np.zeros(len(seqs), dtype=np.int64)
        off = 0
        for i, s in enumerate(seqs):
            if i > 0:
                off += 1
            seq_starts[i] = off
            off += len(s)
        global_text = delim.join(seqs)

        # Greedy record packing into partitions.
        groups: list[list[int]] = []
        cur: list[int] = []
        cur_len = 0
        for i, s in enumerate(seqs):
            add = len(s) + (1 if cur else 0)
            if cur and cur_len + add > max_partition_symbols:
                groups.append(cur)
                cur, cur_len = [], 0
                add = len(s)
            cur.append(i)
            cur_len += add
        if cur:
            groups.append(cur)
        del seqs

        overlap = max_query_len - 1
        spans = []  # (gi, g_start, g_end, owned_len)
        for gi, group in enumerate(groups):
            g_start = int(seq_starts[group[0]])
            g_end = int(seq_starts[groups[gi + 1][0]]) if gi + 1 < len(groups) else len(global_text)
            text_len = min(g_end + overlap, len(global_text)) - g_start
            if text_len + 1 >= 2**32:
                raise ValueError(
                    f"partition {gi} is {text_len} symbols, beyond the 32-bit position space; lower "
                    "max_partition_symbols (a single record larger than the cap forms its own partition)"
                )
            spans.append((gi, g_start, g_end, g_end - g_start))

        def part_text(g_start, g_end):
            return global_text[g_start : min(g_end + overlap, len(global_text))]

        indexes: dict[int, FmIndexData] = {}
        if num_workers > 1 and len(spans) > 1:
            import multiprocessing as mp
            import tempfile
            from concurrent.futures import ProcessPoolExecutor

            from ..io.artifact import load_artifact

            worker_args = dataclasses.replace(part_args, build_kmer_table_on_device=False)
            with tempfile.TemporaryDirectory() as tmpdir:
                text_path = os.path.join(tmpdir, "global_text.bin")
                with open(text_path, "wb") as f:
                    f.write(global_text)
                tasks = [
                    (gi, text_path, s, min(e + overlap, len(global_text)), worker_args, tmpdir)
                    for gi, s, e, _ in spans
                ]
                with ProcessPoolExecutor(max_workers=num_workers, mp_context=mp.get_context("spawn")) as pool:
                    for gi, path in pool.map(_build_partition_worker, tasks):
                        indexes[gi] = load_artifact(path)
        else:
            for gi, g_start, g_end, _ in spans:
                indexes[gi] = build_from_records(
                    [(f"partition_{gi}", part_text(g_start, g_end))], part_args, device=device
                )

        partitions: list[_Partition] = []
        for gi, g_start, g_end, owned_len in spans:
            # The overlap tail (<= max_query_len - 1 symbols): counting a
            # query in it is a direct scan of the encoded tail, equal to an
            # FM count on the tail text.
            tail_text = part_text(g_start, g_end)[owned_len:]
            tail_syms = encode_ascii(alphabet, tail_text) if tail_text else None
            partitions.append(
                _Partition(index=indexes[gi], tail_syms=tail_syms, global_start=g_start, owned_len=owned_len)
            )
        return cls(partitions, seq_starts, headers, alphabet, max_query_len, device=device)

    # -- queries -----------------------------------------------------------
    def _check(self, queries) -> list[bytes]:
        qbytes = [q.encode() if isinstance(q, str) else bytes(q) for q in queries]
        for q in qbytes:
            if len(q) > self.max_query_len:
                raise ValueError(f"query length {len(q)} exceeds max_query_len={self.max_query_len}")
        return qbytes

    def _part_engine(self, part: _Partition, use_device: bool = True):
        """The partition's engine, built on first use: round-robin over the
        federation's devices, or on the CPU when not ``use_device``."""
        from ..ops.engine import FmQueryEngine

        if not use_device:
            if part.host_engine is None:
                part.host_engine = FmQueryEngine(part.index, device="cpu")
            return part.host_engine
        if part.engine is None:
            slot = next(i for i, q in enumerate(self.partitions) if q is part)
            part.engine = FmQueryEngine(part.index, device=self._devices[slot % len(self._devices)])
        return part.engine

    def _tail_counts(self, tail_syms: np.ndarray, enc_queries: list[np.ndarray]) -> np.ndarray:
        """Matches of each query inside an overlap tail: one sliding-window
        scan per query over the (<= max_query_len - 1 symbol) encoded tail,
        equal by construction to an FM count on the tail text.  A Python
        loop per query: bulk serving goes through count_locate_arrays."""
        counts = np.zeros(len(enc_queries), dtype=np.int64)
        n = tail_syms.shape[0]
        for i, qs in enumerate(enc_queries):
            m = qs.shape[0]
            if 0 < m <= n:
                w = np.lib.stride_tricks.sliding_window_view(tail_syms, m)
                counts[i] = (w == qs).all(axis=1).sum()
        return counts

    def count_batch(self, queries, *, use_device: bool = True) -> np.ndarray:
        """Exact global counts: the sum over partitions of (count - tail
        count).  Every partition's count is dispatched first
        (``count_batch_dispatch``, no host sync) and read only after the
        tail counts, which run on the host meanwhile."""
        qbytes = self._check(queries)
        encoded = None
        pending = []
        for part in self.partitions:
            engine = self._part_engine(part, use_device)
            if encoded is None:
                encoded = engine.encode_queries(qbytes)
            pending.append(engine.count_batch_dispatch(encoded))
        totals = np.zeros(len(qbytes), dtype=np.int64)
        enc_queries = [encode_ascii(self.alphabet, q) for q in qbytes]
        for part in self.partitions:
            if part.tail_syms is not None:
                totals -= self._tail_counts(part.tail_syms, enc_queries)
        for counts in pending:
            totals += counts.cpu().numpy()[: len(qbytes)]
        return totals.astype(np.uint64)

    def _owned_hits(self, part: _Partition, qbytes, cap: int, use_device: bool):
        """(query index, record, local position) of the partition's hits
        that start in its owned range."""
        _, _, local, offsets = self._part_engine(part, use_device).count_locate_arrays(qbytes, cap=cap)
        qidx = np.repeat(np.arange(len(qbytes), dtype=np.int64), np.diff(offsets))
        keep = local < part.owned_len
        gpos = part.global_start + local[keep]
        rec = np.searchsorted(self.seq_starts, gpos, side="right") - 1
        return qidx[keep], rec, gpos - self.seq_starts[rec]

    def locate_batch(self, queries, *, use_device: bool = True) -> list[list[tuple[int, int]]]:
        """Exact global locate: each query's (record, local position) hits,
        partition by partition."""
        qbytes = self._check(queries)
        results: list[list[tuple[int, int]]] = [[] for _ in qbytes]
        for part in self.partitions:
            qidx, rec, loc = self._owned_hits(part, qbytes, 8, use_device)
            for qi, r, lp in zip(qidx.tolist(), rec.tolist(), loc.tolist()):
                results[qi].append((r, lp))
        return results

    def count_locate_arrays(self, queries, *, cap: int = 2):
        """Bulk federation serving, FmQueryEngine.count_locate_arrays'
        contract: (counts uint64[n], seq_idx int64[T], local int64[T],
        offsets int64[n+1]).  Each partition's count+locate yields its owned
        hits; one stable argsort over query ids merges them.  Hit order:
        partition-major, BWT-row order within a partition (a federation has
        no global BWT order)."""
        qbytes = self._check(queries)
        nq = len(qbytes)
        parts = [self._owned_hits(part, qbytes, cap, True) for part in self.partitions]
        qidx, rec, loc = (np.concatenate([p[i] for p in parts]) for i in range(3))
        order = np.argsort(qidx, kind="stable")
        counts = np.bincount(qidx, minlength=nq).astype(np.int64)
        offsets = np.zeros(nq + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return counts.astype(np.uint64), rec[order], loc[order], offsets

    def count(self, query) -> int:
        return int(self.count_batch([query])[0])

    def locate(self, query) -> list[tuple[int, int]]:
        return self.locate_batch([query])[0]

    # -- persistence ---------------------------------------------------------
    def save(self, directory: str) -> None:
        """Write the federation: one uncompressed artifact per partition
        and the meta sidecars, in the reference's layout."""
        from ..io.artifact import save_artifact

        os.makedirs(directory, exist_ok=True)
        meta = {
            "version": 1,
            "alphabet": self.alphabet.name,
            "max_query_len": self.max_query_len,
            "headers": self.headers,
            "partitions": [
                {"global_start": int(p.global_start), "owned_len": int(p.owned_len),
                 "has_tail": p.tail_syms is not None}
                for p in self.partitions
            ],
        }
        with open(os.path.join(directory, "meta.json"), "w") as f:
            json.dump(meta, f)
        np.savez(
            os.path.join(directory, "globals.npz"),
            seq_starts=self.seq_starts,
            **{f"tail_{i}": p.tail_syms for i, p in enumerate(self.partitions) if p.tail_syms is not None},
        )
        for i, p in enumerate(self.partitions):
            save_artifact(p.index, os.path.join(directory, f"part_{i}.npz"), compress=False)

    @classmethod
    def load(cls, directory: str, *, device=None):
        """Read a federation that ``save`` (of either package) wrote; its
        engines serve on ``device`` as for build_from_records."""
        from ..io.artifact import load_artifact

        with open(os.path.join(directory, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("version") != 1:
            raise ValueError(f"unsupported partitioned-index version {meta.get('version')}")
        globs = np.load(os.path.join(directory, "globals.npz"))
        partitions = [
            _Partition(
                index=load_artifact(os.path.join(directory, f"part_{i}.npz")),
                tail_syms=globs[f"tail_{i}"] if pm["has_tail"] else None,
                global_start=pm["global_start"],
                owned_len=pm["owned_len"],
            )
            for i, pm in enumerate(meta["partitions"])
        ]
        return cls(
            partitions, globs["seq_starts"].astype(np.int64), list(meta["headers"]), Alphabet[meta["alphabet"]],
            meta["max_query_len"], device=device,
        )
