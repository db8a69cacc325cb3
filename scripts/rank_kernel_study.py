#!/usr/bin/env python3
"""The kernels of awry_tpu_torch timed on one NVIDIA GPU against other builds
of their sources, in turns, at the shapes chip_smoke.py's paths give them:
the rank kernels (occ_pair, occ), window_read, the marked LF walk, the
row-sampled walk and backstep's one visit (and its 64-bit twin).

    python3 scripts/rank_kernel_study.py [--baseline DIR ...]
        [--kernels occ_pair,occ,window_read,marked_walk,sampled_walk,backstep,backstep_wide]
        [--paths chr1,chr20,grch38,pangenome,markless,amino,modeb] [--pairs] [--out PATH]

backstep's study (``--kernels backstep,backstep_wide --paths
grch38,pangenome,amino --baseline DIR``, DIR holding the parent's
backstep.cu):

- sites: one visit over the verify walk's rows (``grch38``: the 1 Gbp
  table, far larger than L2; ``pangenome``: one partition's 655,360 rows
  at mark 32, whose 40 MB of rows fit in L2), over 262,144 random rows of the
  amino layout (``amino``: the V = 5 rows, 72 words), and backstep_wide
  over the GRCh38 classic ranges' live rows at cap 8 on the wide index
  (beside its narrow twin on the same rows);
- contenders, in turns: every build, and the ``designs`` build (the
  package's backstep.cu with ``DESIGNS`` appended) by designs (a) and
  (b) and by the two read floors, each with its largest error against
  the plain version (recorded, enforced for the package's build only), the
  summed sectors a visit reads and their rate;
- the one-row launch (FmIndex.backstep's shape) of every contender, in
  turns, after each site.

Builds (nvcc with the package's own flags, all started together):

- ``new``: the package's sources as the package builds them; every call
  must equal the plain version;
- ``--baseline DIR`` (repeatable): whichever of ``DIR/occ_pair.cu``,
  ``DIR/window_read.cu`` and ``DIR/backstep.cu`` exist, another revision
  (``git show REV:awry_tpu_torch/csrc/NAME.cu``) or a copy cut down for an
  ablation, built into one library named by DIR's last part, its entry
  points renamed.  Its largest error against the plain version is recorded,
  not enforced: a cut that does not compute the function is timed all the
  same.  A kernel whose source DIR lacks runs the package's build.

Inputs, recorded from the paths (each kernel's full-batch calls of the
path's first batch):

- ``chr1`` (250 Mbp, k = 13, mark 1): occ_pair's rank steps; window_read's
  seed, SA and text reads;
- ``chr20`` (64 Mbp, k = 13): occ over every full chunk of the k-mer build
  (levels 11, 12 and 13) and their sum; window_read's seed read and slot
  fat rows (the slot regime's serving);
- ``grch38`` (1 Gbp, mark 4): occ_pair's rank steps; window_read's seed
  and text reads; the verify walk's rows (marked_walk);
- ``markless`` (chip_smoke's chr20 index without its marks, as load_awry
  gives it: SA ratio 8): the classic batch's query ranges (starts, counts;
  524,288 queries, cap 8), walked by sampled_walk;
- ``amino`` (20 Mres of seeded random amino acids, k = 5, SA ratio 8, no
  marks; bench.py's Swiss-Prot shape): the ranges of a 262,144-query batch
  of drawn 12-mers, cap 8;
- ``modeb`` (the chr1 index range-sharded 4 ways on the card, as
  chip_smoke's phase 20 serves it): the 4 occ_pair_shard calls of a full
  rank step, timed as one step by every build; Mode B's walk of a batch's
  cap slots with the package's passes per round (``round_passes``) and
  with each fixed count in ``WALK_PASSES``, over each (shards, SA ratio)
  of ``WALK_LAYOUTS`` (mode_b_study).

Each site: every build in turns (b1 .. bk, then bk .. b1, twice), 20
launches each timed by chip_smoke's ``time_ms`` (L2 flushed by a read
before each launch); a build's ms is the median of its 4 turns, each turn
kept in the record.  window_read sites add PyTorch's ``flat[idx]`` to the turns.  The
walk is timed whole (events around the call): a build with marked_walk in
one launch, a build without it (the parent's) as mark_ratio backstep
launches, the glue between them and the k=1 window_read of the marked SA
(kernels.walk_by_visits); ``new, by visits`` runs the new build that way.
The sampled walk is timed as one function from the ranges to the
``int64[B, cap]`` positions: a build with sampled_walk_ranges launches it
(schedule (c), persistent warps refilling lanes) and, as ``NAME, glue +
flat``, walks the padded rows (kernels.slot_rows) with its flat entry; a
build without it (the parent's) walks the padded rows with its flat
kernel, one thread per row (schedule (a)); ``schedule_b`` is schedule
(b), built onto a copy of the package's backstep.cu from ``SCHEDULE_B``
below: a torch prefix sum of min(count, cap), then one thread per live
slot.  Beside it,
how the walks' tail weighs: the new build's range-fed walk over the first
half of the batch, and over the batch with the queries whose walks take
more than the p99 of steps emptied (``tail``).
``--pairs``: occ_pair also on the chr1 calls with every pair moved into one
block, then into two blocks.  The full record goes to ``--out`` as JSON;
the last line printed is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from awry_tpu_torch import Alphabet, FmBuildArgs, build_from_records  # noqa: E402
from awry_tpu_torch.ops import FmQueryEngine, kernels, populate_kmer_table_device, to_device  # noqa: E402
from awry_tpu_torch.ops.kmer import _level_chunk  # noqa: E402

STUDY_DIR = os.path.join(kernels.BUILD_DIR, "study")
REPS = 20
TURN_PAIRS = 2  # forward and backward turns per site, each REPS launches
P = ctypes.c_void_p
I64 = ctypes.c_int64
I32 = ctypes.c_int
WALK = [I32, P, I64, I32, I32, P, P, P, I32, ctypes.c_uint32, P, I64, I64]  # the sampled walks' shared head
MARKED = [I32, P, I64, I32, I32, P, P, P, I32, I32, I32]  # the marked walks' shared head
BACKSTEP = [I32, P, I64, I32, I32, P, P, P, I32, I32, P, I64, P, P, P]
BACKSTEP_WIDE = [I32, P, I64, I32, I32, P, P, P, I32, P, P, I32, I32, I32, P, I64, P, P, P]
# Each source's entry points and their argument types.
ENTRIES = {
    "occ_pair.cu": {
        "occ_pair": [I32, P, I64, I32, I32, I32, P, P, P, P, I64, P, P, P],
        "occ": [I32, P, I64, I32, I32, I32, P, P, P, I64, P, P],
        "occ_pair_shard": [I32, P, I64, I64, I64, I32, I32, I32, P, P, P, P, P, I64, P, P, P],
    },
    "window_read.cu": {"window_read": [I32, P, I64, P, I64, I32, P, P]},
    "backstep.cu": {
        "backstep": BACKSTEP,
        "backstep_wide": BACKSTEP_WIDE,
        **{f"backstep_{d}": BACKSTEP for d in ("tile", "ring", "floor_thread", "floor_coop")},
        **{f"backstep_wide_{d}": BACKSTEP_WIDE for d in ("tile", "ring")},
        "marked_walk": [*MARKED, P, I64, I64, P, I64, P, P],
        "marked_walk_ranges": [*MARKED, I32, P, I64, I64, P, P, I64, I32, P, P, P],
        "sampled_walk": [*WALK, P, I64, P, P, P],
        "sampled_walk_ranges": [*WALK, P, P, I64, I32, P, P, P],
        "sampled_walk_compact": [*WALK, P, P, P, I64, I32, P, P, P, P],
    },
}
# The flat sampled walk of a backstep.cu without sampled_walk_ranges (the
# parent's: one thread per row, sa_ratio an int, no cursor).
PARENT_SAMPLED_WALK = [I32, P, I64, I32, I32, P, P, P, I32, I32, P, I64, I64, P, I64, P, P]
KINDS = ("occ_pair", "occ", "window_read", "marked_walk", "sampled_walk", "backstep", "backstep_wide")
# Schedule (b) of the range-fed walk, appended to a copy of the package's
# backstep.cu (it uses that file's LF core): the caller's inclusive prefix
# sum `incl` of min(count, cap) places each query's live slots;
# compact_slots_kernel (one thread per query) writes their clamped rows and
# output slots in that order and the query's idle slots, then
# compact_walk_kernel walks one live slot per thread.  live_rows (uint32)
# and live_slots (int64): scratch of nq * cap entries.
SCHEDULE_B = r"""
namespace {

__global__ void compact_slots_kernel(const WalkTables t, const int64_t* __restrict__ starts,
                                     const int64_t* __restrict__ counts, const int64_t* __restrict__ incl,
                                     int64_t nq, int cap, uint32_t* __restrict__ live_rows,
                                     int64_t* __restrict__ live_slots, int64_t* __restrict__ out) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  const int64_t c = counts[q];
  const int live = (int)(c < 0 ? 0 : (c > cap ? cap : c));
  const int64_t before = incl[q] - live;
  const int64_t idle = text_pos_of(__ldg(t.sa), 0, t.bwt_len);
  for (int j = 0; j < cap; ++j) {
    if (j < live) {
      live_rows[before + j] = clamp_row(starts[q] + j, t.bwt_len);
      live_slots[before + j] = q * cap + j;
    } else {
      out[q * cap + j] = idle;
    }
  }
}

template <int V>
__global__ void compact_walk_kernel(const WalkTables t, const RowSampling smp, const int64_t* __restrict__ incl,
                                    int64_t nq, const uint32_t* __restrict__ live_rows,
                                    const int64_t* __restrict__ live_slots, int64_t* __restrict__ out) {
  __shared__ CodeStep tab[1 << V];
  load_code_steps<V>(tab, t.prefix_sums, t.codes, t.c2i, t.ambiguity_idx);
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (nq == 0 || i >= incl[nq - 1]) return;
  uint32_t pos = live_rows[i], steps = 0;
  int64_t* o = out + live_slots[i];
  while (!sampled_step<V>(t, smp, tab, pos, steps, o)) {
  }
}

}  // namespace

extern "C" int awry_sampled_walk_compact(int device, const void* blocks, int64_t num_blocks, int row_words,
                                         int nplanes, const void* prefix_sums, const void* codes,
                                         const void* c2i, int ambiguity_idx, uint32_t sa_ratio,
                                         const void* sampled_sa, int64_t sa_len, int64_t bwt_len,
                                         const void* starts, const void* counts, const void* incl, int64_t nq,
                                         int cap, void* live_rows, void* live_slots, void* out, void* stream) {
  set_device(device);
  const WalkTables t = walk_tables(blocks, num_blocks, row_words, prefix_sums, codes, c2i,
                                   ambiguity_idx, sampled_sa, sa_len, bwt_len);
  cudaStream_t st = (cudaStream_t)stream;
  if (nq > 0) {
    if (nplanes != 3 && nplanes != 5) return (int)cudaErrorInvalidValue;
    compact_slots_kernel<<<blocks_for(nq), kThreads, 0, st>>>(t, (const int64_t*)starts, (const int64_t*)counts,
                                                              (const int64_t*)incl, nq, cap,
                                                              (uint32_t*)live_rows, (int64_t*)live_slots,
                                                              (int64_t*)out);
    const RowSampling smp = RowSampling::of(sa_ratio);
    const unsigned grid = blocks_for(nq * cap);
    if (nplanes == 3) {
      compact_walk_kernel<3><<<grid, kThreads, 0, st>>>(t, smp, (const int64_t*)incl, nq,
                                                         (const uint32_t*)live_rows, (const int64_t*)live_slots,
                                                         (int64_t*)out);
    } else {
      compact_walk_kernel<5><<<grid, kThreads, 0, st>>>(t, smp, (const int64_t*)incl, nq,
                                                         (const uint32_t*)live_rows, (const int64_t*)live_slots,
                                                         (int64_t*)out);
    }
  }
  return (int)cudaGetLastError();
}
"""
# backstep's other designs and its read floors, appended to a copy of the
# package's backstep.cu (they use that file's row layout, step table,
# staged rows and bulk copies), built as the baseline ``designs``; each C
# entry takes awry_backstep's (or awry_backstep_wide's) arguments.
#
# (a) cooperative loads into shared memory: a warp per tile of 32 rows
# loads the rows' 16 B pieces in order (each warp load 32 consecutive
# pieces: 3.2 nucleotide rows), stages them, then steps a row per thread
# (staged_visit); blocks of 8 warps (nucleotide) or 4 (amino).
# (b) the package's bulk copies into a ring: persistent warps, each with
# two tiles of 32 staged rows in flight, stepping one tile while the next
# one's copies run; blocks of 4 warps (nucleotide) or 2 (amino).
#
# The read floors write one XOR word per row (to mark; stepped is left
# as it is): floor_thread reads as the parent did, one thread per row and
# its 13 loads (load_row, load_marks; amino: one milestone word beside the
# planes, not after them); floor_coop reads as (a) does, the tile's 16 B
# pieces in order, each lane's pieces XORed into its row's word in shared
# memory.
DESIGNS = r"""
namespace {

// Loads a lane keeps in flight while (a) stages its tile: every piece of a
// nucleotide tile (10 per lane), an amino tile in three rounds of 6.
template <int V>
constexpr int kStageBatch = V == 3 ? 10 : 6;

// The warp's tile of `live` rows (lane q's row block blk) copied into
// `tile` by 16 B loads, 32 consecutive pieces per warp load.
template <int V>
__device__ __forceinline__ void stage_tile(const WalkTables& t, uint32_t blk, int live, unsigned lane,
                                           uint32_t* tile) {
  const int pieces = t.row_words >> 2;
  const int sw = staged_words(t.row_words);
  const int total = live * pieces;
  const int dq = 32 / pieces, dc = 32 - dq * pieces;  // a round moves a lane 32 pieces on
  int q = (int)lane / pieces, c = (int)lane - q * pieces;
  for (int base = 0; base < total; base += 32 * kStageBatch<V>) {
    uint4 v[kStageBatch<V>];
    int dst[kStageBatch<V>];
#pragma unroll
    for (int k = 0; k < kStageBatch<V>; ++k) {
      const uint32_t b = __shfl_sync(kFull, blk, q & 31);
      dst[k] = -1;
      if (base + 32 * k + (int)lane < total) {
        v[k] = __ldg(reinterpret_cast<const uint4*>(t.blocks + (int64_t)b * t.row_words) + c);
        dst[k] = q * sw + 4 * c;
      }
      c += dc;
      q += dq;
      if (c >= pieces) {
        c -= pieces;
        ++q;
      }
    }
#pragma unroll
    for (int k = 0; k < kStageBatch<V>; ++k) {
      if (dst[k] >= 0) *reinterpret_cast<uint4*>(tile + dst[k]) = v[k];
    }
  }
  __syncwarp();
}

template <int V, bool kWide>
__global__ void __launch_bounds__(kThreads) backstep_tile_kernel(const WalkTables t, int mark_offset,
                                                                 const int64_t* __restrict__ rows, int64_t n,
                                                                 int64_t* __restrict__ stepped,
                                                                 MarkRank<kWide>* __restrict__ mark) {
  extern __shared__ uint4 staged[];
  __shared__ CodeStep tab[1 << V];
  load_code_steps<V>(tab, t.prefix_sums, t.codes, t.c2i, t.ambiguity_idx);
  const unsigned lane = threadIdx.x & 31u;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31u);
  if (first >= n) return;
  const int live = n - first < 32 ? (int)(n - first) : 32;
  const int64_t i = first + lane;
  const RowAt r = row_at(t.blocks, t.nbits, t.row_words, (int)lane < live ? rows[i] : 0);
  const int sw = staged_words(t.row_words);
  uint32_t* tile = reinterpret_cast<uint32_t*>(staged) + (threadIdx.x >> 5) * 32 * sw;
  stage_tile<V>(t, r.blk, live, lane, tile);
  if ((int)lane < live) staged_visit<V, kWide>(tile + lane * sw, r, mark_offset, tab, t, i, stepped, mark);
}

template <int V, bool kWide>
__global__ void __launch_bounds__(kThreads) backstep_ring_kernel(const WalkTables t, int mark_offset,
                                                                 const int64_t* __restrict__ rows, int64_t n,
                                                                 int64_t* __restrict__ stepped,
                                                                 MarkRank<kWide>* __restrict__ mark) {
  extern __shared__ uint4 staged[];
  __shared__ uint64_t bars[kWarps][2];
  __shared__ CodeStep tab[1 << V];
  const unsigned lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  if (lane == 0) {
    bar_init(smem_u32(&bars[warp][0]));
    bar_init(smem_u32(&bars[warp][1]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_code_steps<V>(tab, t.prefix_sums, t.codes, t.c2i, t.ambiguity_idx);
  const int sw = staged_words(t.row_words);
  uint32_t* ring = reinterpret_cast<uint32_t*>(staged) + warp * 2 * 32 * sw;
  const int64_t ntiles = (n + 31) >> 5;
  const int64_t step = (int64_t)gridDim.x * warps;
  int64_t tile = (int64_t)blockIdx.x * warps + warp;
  if (tile >= ntiles) return;
  RowAt cur = issue_tile(t, rows, n, tile, ring, smem_u32(&bars[warp][0]), lane);
  for (uint32_t j = 0; tile < ntiles; ++j, tile += step) {
    // The j-th tile sits in stage j & 1, that stage's (j >> 1)-th use.
    RowAt nxt = cur;
    if (tile + step < ntiles) {
      const uint32_t s = (j + 1) & 1u;
      // The stage's last reads were generic: order them before the copies' writes.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      nxt = issue_tile(t, rows, n, tile + step, ring + s * 32 * sw, smem_u32(&bars[warp][s]), lane);
    }
    bar_wait(smem_u32(&bars[warp][j & 1u]), (j >> 1) & 1u);
    const int64_t i = tile * 32 + lane;
    if (i < n) staged_visit<V, kWide>(ring + (j & 1u) * 32 * sw + lane * sw, cur, mark_offset, tab, t, i, stepped, mark);
    __syncwarp();
    cur = nxt;
  }
}

template <int V>
__global__ void floor_thread_kernel(const WalkTables t, int mark_offset, const int64_t* __restrict__ rows, int64_t n,
                                    uint32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const RowAt r = row_at(t.blocks, t.nbits, t.row_words, rows[i]);
  RowWords<V> x;
  load_row(r, x);
  MarkWords m;
  load_marks<false>(r, mark_offset, m, t);
  uint32_t acc = m.mile;
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int w = 0; w < 8; ++w) acc ^= x.plane[v][w];
  }
  if constexpr (RowWords<V>::kMiles) {
#pragma unroll
    for (int w = 0; w < 8; ++w) acc ^= x.mile[w];
  } else {
    acc ^= __ldg(r.row + V * 8 + (r.bit & 15u));
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) acc ^= m.w[w];
  out[i] = acc;
}

template <int V>
__global__ void __launch_bounds__(kThreads) floor_coop_kernel(const WalkTables t, const int64_t* __restrict__ rows,
                                                              int64_t n, uint32_t* __restrict__ out) {
  __shared__ uint32_t acc[kThreads];
  const unsigned lane = threadIdx.x & 31u;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31u);
  if (first >= n) return;
  const int live = n - first < 32 ? (int)(n - first) : 32;
  const int64_t i = first + lane;
  const RowAt r = row_at(t.blocks, t.nbits, t.row_words, (int)lane < live ? rows[i] : 0);
  uint32_t* a = acc + (threadIdx.x & ~31u);
  a[lane] = 0;
  __syncwarp();
  const int pieces = t.row_words >> 2;
  const int total = live * pieces;
  const int dq = 32 / pieces, dc = 32 - dq * pieces;
  int q = (int)lane / pieces, c = (int)lane - q * pieces;
  for (int base = 0; base < total; base += 32 * kStageBatch<V>) {
    uint32_t x[kStageBatch<V>];
    int dst[kStageBatch<V>];
#pragma unroll
    for (int k = 0; k < kStageBatch<V>; ++k) {
      const uint32_t b = __shfl_sync(kFull, r.blk, q & 31);
      dst[k] = -1;
      if (base + 32 * k + (int)lane < total) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(t.blocks + (int64_t)b * t.row_words) + c);
        x[k] = v.x ^ v.y ^ v.z ^ v.w;
        dst[k] = q;
      }
      c += dc;
      q += dq;
      if (c >= pieces) {
        c -= pieces;
        ++q;
      }
    }
#pragma unroll
    for (int k = 0; k < kStageBatch<V>; ++k) {
      if (dst[k] >= 0) atomicXor(a + dst[k], x[k]);
    }
  }
  __syncwarp();
  if ((int)lane < live) out[i] = a[lane];
}

// (a): a tile per warp, blocks of as many warps as their tiles fit
// kStageBudget.  (b): persistent, as many blocks as fit the card, each
// warp's two tiles in kStageBudget.
template <bool kWide, bool kRing>
int launch_design(int device, const WalkTables& t, int nplanes, int mark_offset, const void* rows, int64_t n,
                  void* stepped, void* mark, void* stream) {
  set_device(device);
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  const int warp_bytes = (kRing ? 2 : 1) * 32 * staged_words(t.row_words) * (int)sizeof(uint32_t);
  const int fit = kStageBudget / warp_bytes;
  const int warps = fit < kWarps ? fit : kWarps;
  if (warps < 1 || (nplanes != 3 && nplanes != 5)) return (int)cudaErrorInvalidValue;
  auto kernel = kRing ? (nplanes == 3 ? backstep_ring_kernel<3, kWide> : backstep_ring_kernel<5, kWide>)
                      : (nplanes == 3 ? backstep_tile_kernel<3, kWide> : backstep_tile_kernel<5, kWide>);
  const size_t smem = (size_t)warps * warp_bytes;
  int64_t grid = (n + 32 * warps - 1) / (32 * warps);
  if (kRing) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * warps, smem);
    const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    grid = grid < resident ? grid : resident;
  }
  kernel<<<(unsigned)grid, 32 * warps, smem, st>>>(t, mark_offset, (const int64_t*)rows, n, (int64_t*)stepped,
                                                   (MarkRank<kWide>*)mark);
  return (int)cudaGetLastError();
}

template <bool kCoop>
int launch_floor(int device, const WalkTables& t, int nplanes, int mark_offset, const void* rows, int64_t n,
                 void* out, void* stream) {
  set_device(device);
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  if (nplanes != 3 && nplanes != 5) return (int)cudaErrorInvalidValue;
  const int64_t* r = (const int64_t*)rows;
  uint32_t* o = (uint32_t*)out;
  if constexpr (kCoop) {
    if (nplanes == 3) {
      floor_coop_kernel<3><<<blocks_for(n), kThreads, 0, st>>>(t, r, n, o);
    } else {
      floor_coop_kernel<5><<<blocks_for(n), kThreads, 0, st>>>(t, r, n, o);
    }
  } else {
    if (nplanes == 3) {
      floor_thread_kernel<3><<<blocks_for(n), kThreads, 0, st>>>(t, mark_offset, r, n, o);
    } else {
      floor_thread_kernel<5><<<blocks_for(n), kThreads, 0, st>>>(t, mark_offset, r, n, o);
    }
  }
  return (int)cudaGetLastError();
}

WalkTables narrow_tables(const void* blocks, int64_t num_blocks, int row_words, const void* prefix_sums,
                         const void* codes, const void* c2i, int ambiguity_idx) {
  return walk_tables(blocks, num_blocks, row_words, prefix_sums, codes, c2i, ambiguity_idx, nullptr, 0, 0);
}

WalkTables wide_tables(const void* blocks, int64_t num_blocks, int row_words, const void* prefix_sums,
                       const void* codes, const void* c2i, int card, const void* ms_base, const void* mark_base,
                       int group_shift, int ambiguity_idx) {
  return widen(narrow_tables(blocks, num_blocks, row_words, prefix_sums, codes, c2i, ambiguity_idx), card, ms_base,
               mark_base, group_shift, nullptr);
}

}  // namespace

#define NARROW_ENTRY(NAME, CALL)                                                                                   \
  extern "C" int NAME(int device, const void* blocks, int64_t num_blocks, int row_words, int nplanes,             \
                      const void* prefix_sums, const void* codes, const void* c2i, int mark_offset,                \
                      int ambiguity_idx, const void* rows, int64_t n, void* stepped, void* mark, void* stream) {   \
    const WalkTables t = narrow_tables(blocks, num_blocks, row_words, prefix_sums, codes, c2i, ambiguity_idx);    \
    return CALL;                                                                                                   \
  }
#define WIDE_ENTRY(NAME, CALL)                                                                                     \
  extern "C" int NAME(int device, const void* blocks, int64_t num_blocks, int row_words, int nplanes,             \
                      const void* prefix_sums, const void* codes, const void* c2i, int card, const void* ms_base,  \
                      const void* mark_base, int group_shift, int mark_offset, int ambiguity_idx, const void* rows, \
                      int64_t n, void* stepped, void* mark, void* stream) {                                        \
    const WalkTables t = wide_tables(blocks, num_blocks, row_words, prefix_sums, codes, c2i, card, ms_base,        \
                                     mark_base, group_shift, ambiguity_idx);                                       \
    return CALL;                                                                                                   \
  }

NARROW_ENTRY(awry_backstep_tile, (launch_design<false, false>(device, t, nplanes, mark_offset, rows, n, stepped, mark, stream)))
NARROW_ENTRY(awry_backstep_ring, (launch_design<false, true>(device, t, nplanes, mark_offset, rows, n, stepped, mark, stream)))
NARROW_ENTRY(awry_backstep_floor_thread, (launch_floor<false>(device, t, nplanes, mark_offset, rows, n, mark, stream)))
NARROW_ENTRY(awry_backstep_floor_coop, (launch_floor<true>(device, t, nplanes, mark_offset, rows, n, mark, stream)))
WIDE_ENTRY(awry_backstep_wide_tile, (launch_design<true, false>(device, t, nplanes, mark_offset, rows, n, stepped, mark, stream)))
WIDE_ENTRY(awry_backstep_wide_ring, (launch_design<true, true>(device, t, nplanes, mark_offset, rows, n, stepped, mark, stream)))
"""
# Swiss-Prot-shaped amino path (bench.py): 20 Mres, k = 5, 12-mer queries.
AMINO_SYMBOLS = 20_000_000
AMINO_KMER_LEN = 5
AMINO_QLEN = 12
AMINO_BATCH = 262_144


def log(msg: str) -> None:
    print(msg, flush=True)


# -- builds ------------------------------------------------------------------------


def _start_baseline(directory: str) -> tuple[str, str, list, subprocess.Popen]:
    """Start nvcc on DIR's sources, their entry points renamed ``<name>_*``."""
    name = re.sub(r"\W", "_", os.path.basename(os.path.normpath(directory)))
    srcs, present, h = [], [], hashlib.sha256(" ".join(kernels.NVCC_FLAGS).encode())
    for source in ENTRIES:
        path = os.path.join(directory, source)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            text = re.sub(r"\bawry_", f"{name}_", f.read())
        src = os.path.join(STUDY_DIR, f"{name}_{source}")
        with open(src, "w") as f:
            f.write(text)
        h.update(text.encode())
        srcs.append(src)
        present.append(source)
    if not srcs:
        raise ValueError(f"{directory} holds none of {list(ENTRIES)}")
    out = os.path.join(STUDY_DIR, f"{name}-{h.hexdigest()[:12]}.so")
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", out, *srcs]
    return name, out, present, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


class _Build:
    """A baseline's entry points under the package's names; entries of the
    sources it lacks fall through to the package's own build.  It walks in
    one launch unless its backstep.cu has no marked_walk (the parent's)."""

    def __init__(self, path: str, name: str, present: list, fallback):
        self._lib = ctypes.CDLL(path)
        for source in present:
            for entry, argtypes in ENTRIES[source].items():
                if hasattr(self._lib, f"{name}_{entry}"):
                    fn = getattr(self._lib, f"{name}_{entry}")
                    fn.restype, fn.argtypes = I32, argtypes
                    setattr(self, f"awry_{entry}", fn)
        self.walks_fused = "backstep.cu" not in present or hasattr(self._lib, f"{name}_marked_walk")
        self.walks_ranges = "backstep.cu" not in present or hasattr(self._lib, f"{name}_sampled_walk_ranges")
        self.walks_compact = hasattr(self._lib, f"{name}_sampled_walk_compact")
        self.walks_marked_ranges = "backstep.cu" not in present or hasattr(self._lib, f"{name}_marked_walk_ranges")
        self.backstep_designs = hasattr(self._lib, f"{name}_backstep_tile")
        if not self.walks_ranges and hasattr(self._lib, f"{name}_sampled_walk"):
            self.awry_sampled_walk.argtypes = PARENT_SAMPLED_WALK
        self._fallback = fallback

    def __getattr__(self, attr):
        return getattr(self._fallback, attr)


def _appended_dir(name: str, source: str) -> str:
    """A directory holding the package's backstep.cu with ``source``
    appended, built as the baseline ``name``."""
    directory = os.path.join(STUDY_DIR, name)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(kernels.CSRC_DIR, "backstep.cu")) as f:
        text = f.read() + source
    with open(os.path.join(directory, "backstep.cu"), "w") as f:
        f.write(text)
    return directory


def build_all(baselines: list[str], schedule_b: bool, designs: bool) -> tuple[dict, dict]:
    """{name: lib} for every build ("new" first, then the baselines, with
    ``schedule_b`` schedule (b) and with ``designs`` backstep's DESIGNS),
    and each one's ptxas report."""
    os.makedirs(STUDY_DIR, exist_ok=True)
    if schedule_b:
        baselines = [*baselines, _appended_dir("schedule_b", SCHEDULE_B)]
    if designs:
        baselines = [*baselines, _appended_dir("designs", DESIGNS)]
    pending = [_start_baseline(d) for d in baselines]
    new = kernels._lib()  # the package's own build
    with open(kernels.library_path() + ".log") as f:
        ptxas = {"new": [ln.strip() for ln in f if "Compiling" in ln or "registers" in ln]}
    libs = {"new": new}
    for name, out, present, proc in pending:
        text = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        ptxas[name] = [ln.strip() for ln in text.splitlines() if "registers" in ln or "Compiling" in ln]
        libs[name] = _Build(out, name, present, new)
    return libs, ptxas


class _Entry:
    """``lib`` with ``entry`` in the place of its ``slot`` (awry_backstep or
    awry_backstep_wide): a design of DESIGNS called through the package's
    wrapper."""

    def __init__(self, lib, slot: str, entry):
        self._lib = lib
        setattr(self, slot, entry)

    def __getattr__(self, attr):
        return getattr(self._lib, attr)


@contextlib.contextmanager
def using(lib):
    """Route the kernel wrappers to ``lib`` inside the block."""
    saved = kernels._lib_handle
    kernels._lib_handle = lib
    try:
        yield
    finally:
        kernels._lib_handle = saved


# -- recorded inputs ------------------------------------------------------------------


def _table_names(dev) -> dict:
    return {id(dev.kmer_flat): "seed", id(dev.text_sampled_sa): "sa", id(dev.text_packed): "text",
            id(dev.vw_flat): "slot fat"}


def _serving_sites(run: dict, kinds, batch: int = cs.BATCH) -> list:
    """The full-batch calls of the path's first batch, labelled."""
    names, sites, steps = _table_names(run["engine"].device_index), [], 0
    if "backstep" in kinds:
        # backstep as one visit over each full-batch walk's rows, as chip_smoke times it.
        sites += [("backstep", f"one visit over the walk's rows (mark {a[8]})", a[:8])
                  for kind, a in run["calls"] if kind == "marked_walk" and a[1].shape[0] >= batch]
    for kind, a in run["calls"]:
        if kind.removesuffix("_ranges") not in kinds or a[1].shape[0] < batch:
            continue
        if kind == "occ_pair":
            steps += 1
            sites.append((kind, f"step {steps}", a))
        elif kind == "window_read":
            sites.append((kind, f"{names.get(id(a[0]), 'table')} k={a[2]}", a))
        elif kind == "marked_walk":
            sites.append((kind, f"walk rows (mark {a[8]})", a))
        elif kind == "marked_walk_ranges":
            sites.append((kind, f"ranges (mark {a[10]}, cap {a[3]})", a))
        elif kind == "sampled_walk_ranges":
            sites.append(("sampled_walk", f"ranges (SA ratio {a[9]}, cap {a[3]})", a))
    run["engine"].release()
    return sites


def _markless_sites(index, batch, device, kinds) -> list:
    """The sampled walk's ranges call of ``batch`` served by the classic
    path of ``index`` without its marks (what load_awry gives)."""
    markless = dataclasses.replace(index, mark_bits=None, mark_milestones=None, text_sampled_sa=None,
                                   text_packed=None)
    engine = FmQueryEngine(markless, device=device)
    calls: list = []
    with cs.recording_kernel_inputs(calls, lambda name, a: name == "sampled_walk_ranges"):
        next(engine.count_locate_stream([batch]))
    return _serving_sites({"engine": engine, "calls": calls}, kinds, len(batch))


def record_chr1(device, rng, kinds) -> list:
    return _serving_sites(cs.chr1_path(device, rng), kinds)


def record_chr20(device, rng, kinds) -> list:
    sites = []
    if "occ" in kinds:
        text_np = cs.LETTERS[rng.integers(0, 4, size=cs.C_SYMBOLS, dtype=np.uint8)]
        index = build_from_records(
            [("chr20_synthetic", text_np.tobytes())],
            FmBuildArgs(lookup_table_kmer_len=cs.KMER_LEN, locate_mark_ratio=1, suffix_array_compression_ratio=8),
        )
        minimal = to_device(index, device, minimal=True)
        full = 2 * _level_chunk(4, 4**cs.KMER_LEN)
        calls: list = []
        with cs.recording_kernel_inputs(calls, lambda name, a: name == "occ" and a[1].shape[0] == full):
            table = populate_kmer_table_device(minimal, cs.KMER_LEN)
        if not np.array_equal(table, index.kmer_table):
            raise AssertionError("the device k-mer table differs from the host counting table")
        # At k = 13 a full chunk is 4^11 updates: level 11 one, 12 four, 13 sixteen.
        sites += [("occ", f"level {11 if i == 0 else 12 if i < 5 else 13}, chunk {i + 1}", a)
                  for i, (_, a) in enumerate(calls)]
        del index, minimal, table
    if "window_read" in kinds:
        run = cs.chr20_path(device, rng)
        run.pop("index", None)
        sites += _serving_sites(run, kinds)
    return sites


def record_grch38(device, rng, kinds) -> list:
    """The GRCh38-shaped path's sites, and with the marked walk among the
    kernels the classic path's ranges of its first batch at cap 8 (the
    wide engine's walk, phase 17)."""
    run = cs.grch38_path(device, rng)
    sites = []
    if "marked_walk" in kinds or "backstep_wide" in kinds:
        ranges = classic_ranges(run["engine"], run["batches"][0], 8)
        if "marked_walk" in kinds:
            run["calls"].append(("marked_walk_ranges", ranges))
        if "backstep_wide" in kinds:
            sites.append(("backstep_wide", "one visit over the cap-8 ranges' live rows", wide_visit(run, ranges)))
    return sites + _serving_sites(run, kinds)


def wide_visit(run: dict, ranges: tuple) -> tuple:
    """backstep_wide's call over the live rows of a classic ranges call (as
    chip_smoke's phase 17 times it: the wide index of the path's host
    index), and its narrow twin's call on the same rows."""
    from awry_tpu_torch.ops.wide import to_device_wide

    narrow = run["engine"].device_index
    wide = to_device_wide(run["index"], narrow.blocks.device)
    blocks, starts, counts, cap, *_ = ranges
    live = torch.arange(cap, device=starts.device)[None, :] < counts.clamp(0, cap)[:, None]
    rows = kernels.slot_rows(starts, counts, cap)[live]
    tail = (narrow.num_planes, narrow.mark_offset, narrow.alphabet.ambiguity_idx)
    call = (wide.blocks, wide.bases, rows, wide.prefix_sums, wide.codes, wide.c2i, *tail)
    return call, (blocks, rows, narrow.prefix_sums, narrow.codes, narrow.c2i, *tail)


def record_pangenome(device, rng, kinds) -> list:
    """One partition of chip_smoke's federation (phase 19: the pan-genome
    widths, k = 11, mark 32, SA ratio 8, 30 bp reads, cap 2): 10 records of
    6.4 Mbp of seeded random ACGT joined by the N delimiter (64 Mbp), and a
    batch of 524,288 reads drawn from record interiors.  Sites: the verify
    path's walk of the batch (its B + 4 G rows, marked_walk), and the
    classic path's walk of the batch's ranges at cap 2 (count_locate_capped_t,
    marked_walk_ranges)."""
    n_rec, ln = cs.PAN_PER_PARTITION, cs.PAN_RECORD_SYMBOLS
    text_np = cs.LETTERS[rng.integers(0, 4, size=n_rec * (ln + 1) - 1, dtype=np.uint8)]
    rec_starts = np.arange(n_rec, dtype=np.int64) * (ln + 1)
    text_np[rec_starts[1:] - 1] = ord("N")
    text = text_np.tobytes()
    index = build_from_records(
        [(f"genome_{i}", text[s : s + ln]) for i, s in enumerate(rec_starts.tolist())],
        FmBuildArgs(lookup_table_kmer_len=cs.PAN_KMER_LEN, locate_mark_ratio=cs.PAN_MARK,
                    suffix_array_compression_ratio=8),
    )
    engine = FmQueryEngine(index, device=device)
    starts = rec_starts[rng.integers(0, n_rec, size=cs.BATCH)] + rng.integers(0, ln - cs.QLEN + 1, size=cs.BATCH)
    batch = [text[s : s + cs.QLEN] for s in starts.tolist()]
    calls: list = []
    with cs.recording_kernel_inputs(calls, lambda name, a: name == "marked_walk"):
        next(engine.count_locate_stream([batch], cap=cs.PAN_CAP))
    calls.append(("marked_walk_ranges", classic_ranges(engine, batch, cs.PAN_CAP)))
    return _serving_sites({"engine": engine, "calls": calls}, kinds, len(batch))


def classic_ranges(engine, batch, cap: int) -> tuple:
    """The marked_walk_ranges call the classic path makes for ``batch``: the
    ranges of its full search, at ``cap``."""
    from awry_tpu_torch.ops import counts_from_ranges, search_ranges_t

    dev = engine.device_index
    qt, ql, flags = engine._upload(*engine.encode_queries(batch))
    lo, hi = search_ranges_t(dev, qt, ql, **flags)
    return (dev.blocks, lo, counts_from_ranges(lo, hi), cap, dev.prefix_sums, dev.codes, dev.c2i, dev.num_planes,
            dev.mark_offset, dev.alphabet.ambiguity_idx, dev.mark_ratio, dev.text_sampled_sa, dev.bwt_len)


def record_markless(device, rng, kinds) -> list:
    """chip_smoke's chr20 index and first batch (phase 7), its marks
    stripped: phase 14's classic batch."""
    run = cs.chr20_path(device, rng)
    run["engine"].release()
    return _markless_sites(run["index"], run["batches"][0], device, kinds)


def record_amino(device, rng, kinds) -> list:
    letters = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
    text_np = letters[rng.integers(0, letters.shape[0], size=AMINO_SYMBOLS, dtype=np.uint8)]
    index = build_from_records(
        [("swissprot_shaped", text_np.tobytes())],
        FmBuildArgs(alphabet=Alphabet.AMINO, lookup_table_kmer_len=AMINO_KMER_LEN, suffix_array_compression_ratio=8),
    )
    starts = rng.integers(0, AMINO_SYMBOLS - AMINO_QLEN, size=AMINO_BATCH)
    batch = [text_np[s : s + AMINO_QLEN].tobytes() for s in starts.tolist()]
    sites = []
    if "backstep" in kinds:
        # The V = 5 layout (72-word rows, mark 4): AMINO_BATCH random rows, one visit each.
        dev = to_device(index, device)
        rows = torch.from_numpy(rng.integers(0, index.bwt_len, size=AMINO_BATCH)).to(device)
        sites.append(("backstep", f"{AMINO_BATCH} random rows (mark {dev.mark_ratio})",
                      (dev.blocks, rows, dev.prefix_sums, dev.codes, dev.c2i, dev.num_planes, dev.mark_offset,
                       dev.alphabet.ambiguity_idx)))
    if "sampled_walk" in kinds:
        sites += _markless_sites(index, batch, device, kinds)
    return sites


# -- timing ----------------------------------------------------------------------------


def _walk(lib, args):
    """The whole flat walk on ``lib``: one marked_walk launch if it has one,
    else by visits of its backstep and window_read."""
    with using(lib):
        if getattr(lib, "walks_fused", True):
            return kernels.marked_walk(*args)
        return kernels.walk_by_visits(kernels.backstep, kernels.window_read, *args)


@contextlib.contextmanager
def visit_mode(eager_from: int | None):
    """The package's range-fed marked walks with kernels.MARKED_EAGER_FROM
    patched (1: every visit reads the planes with the mark word; a mark
    ratio past any: after it), or as they are (None)."""
    saved = kernels.MARKED_EAGER_FROM
    if eager_from is not None:
        kernels.MARKED_EAGER_FROM = eager_from
    try:
        yield
    finally:
        kernels.MARKED_EAGER_FROM = saved


# The package build's range-fed marked walk in each visit mode, beside its
# own rule.
MODES = {"eager": 1, "lazy": 1 << 30}


def _padded_walk(lib, args):
    """A range call's padded rows (kernels.slot_rows) walked by ``lib``'s
    flat walk, as int64[B, cap]."""
    blocks, starts, counts, cap, *walk = args
    return _walk(lib, (blocks, kernels.slot_rows(starts, counts, cap).reshape(-1), *walk)).reshape(-1, cap)


def _marked_ranges_contenders(libs: dict, args) -> dict:
    """The range-fed marked walk on every build with the entry, and as
    ``NAME, glue + flat`` (the padded rows walked by its flat entry); a build
    without it (the parent's) walks the padded rows."""
    out = {}
    for name, lib in libs.items():
        if not getattr(lib, "walks_marked_ranges", hasattr(kernels, "marked_walk_ranges")):
            out[name] = lambda lib=lib: _padded_walk(lib, args)
            continue

        def ranges(lib=lib):
            with using(lib):
                return kernels.marked_walk_ranges(*args)

        out[name] = ranges
        out[f"{name}, glue + flat"] = lambda lib=lib: _padded_walk(lib, args)
    for mode, eager_from in MODES.items():
        out[f"new, {mode}"] = lambda e=eager_from: _moded(e, out["new"])
    return out


def _moded(eager_from: int, fn):
    with visit_mode(eager_from):
        return fn()


def _parent_sampled_walk(lib, args):
    """A parent build's walk of the padded rows, one thread per row (its
    flat kernel, whose end check is left out as the engine's was)."""
    blocks, starts, counts, cap, prefix_sums, codes, c2i, nplanes, amb, sa_ratio, sampled_sa, bwt_len = args
    rows = kernels.slot_rows(starts, counts, cap).reshape(-1)
    out = torch.empty(rows.shape[0], dtype=torch.int64, device=rows.device)
    rc = lib.awry_sampled_walk(
        blocks.device.index, blocks.data_ptr(), blocks.shape[0], blocks.shape[1], nplanes, prefix_sums.data_ptr(),
        codes.data_ptr(), c2i.data_ptr(), amb, sa_ratio, sampled_sa.data_ptr(), sampled_sa.shape[0], bwt_len,
        rows.data_ptr(), rows.shape[0], out.data_ptr(), kernels._stream(rows.device),
    )
    kernels._launch_check(rc, "parent sampled_walk")
    return out.reshape(-1, cap)


def _compact_sampled_walk(lib, args):
    """Schedule (b): live slots compacted by a prefix sum, one thread each."""
    blocks, starts, counts, cap, prefix_sums, codes, c2i, nplanes, amb, sa_ratio, sampled_sa, bwt_len = args
    b = starts.shape[0]
    incl = torch.cumsum(counts.clamp(0, cap), 0)
    live_rows = torch.empty(b * cap, dtype=torch.int32, device=starts.device)
    live_slots = torch.empty(b * cap, dtype=torch.int64, device=starts.device)
    out = torch.empty((b, cap), dtype=torch.int64, device=starts.device)
    rc = lib.awry_sampled_walk_compact(
        *kernels._walk_entry_args(blocks, prefix_sums, codes, c2i, nplanes, amb, sa_ratio, sampled_sa, bwt_len),
        starts.data_ptr(), counts.data_ptr(), incl.data_ptr(), b, cap, live_rows.data_ptr(), live_slots.data_ptr(),
        out.data_ptr(), kernels._stream(starts.device),
    )
    kernels._launch_check(rc, "sampled_walk_compact")
    return out


def _sampled_contenders(libs: dict, args) -> dict:
    """The range-fed walk's schedules on every build (module docstring)."""
    blocks, starts, counts, cap, *rest = args
    out = {}
    for name, lib in libs.items():
        if getattr(lib, "walks_compact", False):
            out[name] = lambda lib=lib: _compact_sampled_walk(lib, args)
            continue
        if not getattr(lib, "walks_ranges", True):
            out[name] = lambda lib=lib: _parent_sampled_walk(lib, args)
            continue

        def ranges(lib=lib):
            with using(lib):
                return kernels.sampled_walk_ranges(*args)

        def glue_flat(lib=lib):
            with using(lib):
                rows = kernels.slot_rows(starts, counts, cap).reshape(-1)
                return kernels.sampled_walk_launch(blocks, rows, *rest).reshape(-1, cap)

        out[name] = ranges
        out[f"{name}, glue + flat"] = glue_flat
    return out


# backstep's designs and read floors in the designs build, by the entry
# that takes the wrapper's slot.
BACKSTEP_DESIGNS = {
    "backstep": {"(a) staged loads": "backstep_tile", "(b) bulk ring": "backstep_ring",
                 "read floor, thread per row": "backstep_floor_thread",
                 "read floor, cooperative": "backstep_floor_coop"},
    "backstep_wide": {"(a) staged loads": "backstep_wide_tile", "(b) bulk ring": "backstep_wide_ring"},
}


def _backstep_contenders(libs: dict, kind: str, args, twin=None) -> dict:
    """backstep or backstep_wide on every build (the designs build by each
    of its designs and floors); the wide kernel also as its narrow twin
    (the package's backstep on the narrow rows: ``twin``)."""
    out = {}
    for name, lib in libs.items():
        if getattr(lib, "backstep_designs", False):
            for label, entry in BACKSTEP_DESIGNS[kind].items():
                out[label] = lambda e=_Entry(lib, f"awry_{kind}", getattr(lib, f"awry_{entry}")): _launch(e, kind, args)
        elif not getattr(lib, "walks_compact", False):
            out[name] = lambda lib=lib: _launch(lib, kind, args)
    if twin is not None:
        out["new, narrow twin"] = lambda: _launch(libs["new"], "backstep", twin)
    return out


def _launch(lib, kind: str, args):
    with using(lib):
        return getattr(kernels, kind)(*args)


def contenders(libs: dict, kind: str, args) -> dict:
    """{name: fn} timed in turns at a site."""
    if kind.startswith("backstep"):
        return _backstep_contenders(libs, kind, args)
    # The designs build is the package's but for backstep: its walks are not timed.
    libs = {name: lib for name, lib in libs.items() if not getattr(lib, "backstep_designs", False)}
    if kind == "sampled_walk":
        return _sampled_contenders(libs, args)
    libs = {name: lib for name, lib in libs.items() if not getattr(lib, "walks_compact", False)}
    if kind == "marked_walk_ranges":
        return _marked_ranges_contenders(libs, args)
    if kind == "marked_walk":
        out = {name: (lambda lib=lib: _walk(lib, args)) for name, lib in libs.items()}

        def by_visits():
            with using(libs["new"]):
                return kernels.walk_by_visits(kernels.backstep, kernels.window_read, *args)

        return out | {"new, by visits": by_visits}

    out = {name: (lambda lib=lib: _launch(lib, kind, args)) for name, lib in libs.items()}
    if kind == "window_read":
        flat, wbase, k = args
        idx = wbase.clamp(k - 1, flat.shape[0] - 1)[:, None] - torch.arange(k, device=flat.device)
        out["flat[idx]"] = lambda: flat[idx]
    return out


def in_turns(fns: dict, device, flush) -> tuple[dict, dict]:
    """Each fn's median ms over turns (forward, then backward, TURN_PAIRS
    times), and every turn."""
    times = {name: [] for name in fns}
    for name in (list(fns) + list(fns)[::-1]) * TURN_PAIRS:
        times[name].append(cs.time_ms(fns[name], device, REPS, flush))
    return {name: float(np.median(v)) for name, v in times.items()}, times


def _plain(kind: str, args):
    if kind == "sampled_walk":
        return kernels.sampled_walk_ranges_plain(*args)
    if kind == "marked_walk_ranges":
        blocks, starts, counts, cap, *walk = args
        return kernels.marked_walk_plain(blocks, kernels.slot_rows(starts, counts, cap).reshape(-1),
                                         *walk).reshape(-1, cap)
    return getattr(kernels, f"{kind}_plain")(*args)


def time_site(libs: dict, kind: str, args, device, flush) -> dict:
    """Each contender's largest error against the plain version, and its
    median ms over turns."""
    plain = _plain(kind, args)
    fns = contenders(libs, kind, args)
    errs = {name: cs.result_err(fn(), plain) for name, fn in fns.items()}
    if errs["new"] != 0:
        raise AssertionError(f"{kind} disagrees with its plain version: max abs err {errs['new']}")
    ms, times = in_turns(fns, device, flush)
    return {"max_abs_err": errs, "ms": ms, "turns_ms": times}


def marked_variants(libs: dict, kind: str, call, device, flush) -> dict:
    """What the marked walk's time follows (step 0 of the walk's redesign):
    every build's flat walk, in turns, over the flat call's rows, their
    first half and the rows sorted by walk length; over a range call's
    padded rows (kernels.slot_rows, as the parent's classic path walks
    them) and its live slots only.  Each variant with its bound, its summed
    sectors (chip_smoke.marked_walk_bound) and the rate they imply at each
    build's ms; each build's chain floor over the first variant's rows (the
    longest walk at the per-step time of its one-row walks)."""
    if kind == "marked_walk":
        blocks, rows, *walk = call
        steps = cs.marked_walk_trace(*call)[3]
        rows_of = {"every row": rows, "first half": rows[: rows.shape[0] // 2].clone(),
                   "sorted by walk length": rows[torch.argsort(steps, stable=True)]}
    else:
        blocks, starts, counts, cap, *walk = call
        padded = kernels.slot_rows(starts, counts, cap).reshape(-1)
        live = torch.arange(cap, device=starts.device)[None, :] < counts.clamp(0, cap)[:, None]
        rows_of = {"live slots only": padded[live.reshape(-1)], "padded rows": padded}
    libs = {name: lib for name, lib in libs.items()
            if not getattr(lib, "walks_compact", False) and not getattr(lib, "backstep_designs", False)}
    walkers = {name: (lambda a, lib=lib: _walk(lib, a)) for name, lib in libs.items()}
    out = {}
    fns = {}
    for label, rows in rows_of.items():
        nbytes, ops, info = cs.marked_walk_bound(blocks, rows, *walk)
        out[label] = {"rows": int(rows.shape[0]), "bytes": nbytes,
                      "bound_ms": max(nbytes / cs.HBM_BYTES_PER_S, ops / cs.INT32_OPS_PER_S) * 1e3,
                      "summed_bytes": info["summed_bytes"], "walk_steps": info["walk_steps"], "info": info}
        for name, walker in walkers.items():
            fns[(label, name)] = lambda walker=walker, rows=rows: walker((blocks, rows, *walk))
    ms, times = in_turns(fns, device, flush)
    first = next(iter(rows_of))
    for (label, name), t in ms.items():
        v = out[label]
        v.setdefault("ms", {})[name] = t
        v.setdefault("summed_rate_tb_s", {})[name] = v["summed_bytes"] / (t * 1e-3) / 1e12
        v.setdefault("turns_ms", {})[name] = times[(label, name)]
        if label == first:
            v.setdefault("chain", {})[name] = cs.chain_floor(lambda r, w=walkers[name]: w((blocks, r, *walk)),
                                                            v["info"], device, flush)
    for v in out.values():
        v.pop("info")
    return out


# Fixed passes over the shards per round of Mode B's walk (walk_rounds),
# timed against the package's round_passes and each other, on each (shards,
# SA ratio) layout of the chr1 index (SA ratio 32: the ratio-8 sampled SA
# cut to every fourth entry).
WALK_PASSES = (1, 4, 12, 48)
WALK_LAYOUTS = ((4, 8), (4, 32), (2, 8), (8, 8))


def mode_b_study(libs: dict, device, rng, flush) -> dict:
    """Mode B at chip_smoke phase 20's shape: the chr1 index (250 Mbp, k =
    13, mark 1, SA ratio 8) range-sharded 4 ways on one card, a batch of
    524,288 drawn reads.  The 4 occ_pair_shard calls of its first full rank
    step, timed as one step (chip_smoke's time_ms, L2 flushed before it, the
    card held busy until the host has issued the 4 launches) by every build
    in turns, each build's largest error against the plain version
    recorded.  The walk of its cap slots, for each layout of WALK_LAYOUTS
    (the index shipped again over that many shards, at that SA ratio):
    walk_rounds walks them whole with the package's round_passes and at
    each fixed count of passes per round (round_passes patched), on the
    host clock (synchronized), in turns (forward, then backward, twice),
    its positions held equal to the narrow sampled_walk's; then, on the
    first layout, one walk with the package's rule under the profiler:
    device busy time, rounds, and the host time of each PyTorch operation
    and of the sampled_walk_shard calls."""
    from awry_tpu_torch.ops import counts_from_ranges
    from awry_tpu_torch.parallel import ShardedFmEngine, make_mesh

    text = cs.LETTERS[rng.integers(0, 4, size=cs.N_SYMBOLS, dtype=np.uint8)].tobytes()
    index = build_from_records([("chr1_synthetic", text)], FmBuildArgs(
        lookup_table_kmer_len=cs.KMER_LEN, locate_mark_ratio=1, suffix_array_compression_ratio=8))
    starts = rng.integers(0, cs.N_SYMBOLS - cs.QLEN, size=cs.BATCH)
    batch = [text[s : s + cs.QLEN] for s in starts.tolist()]
    engine = ShardedFmEngine(index, make_mesh(devices=[device] * 4, shard_size=4))
    ((slot, w, q, _),) = engine._slices(*engine._encode(batch))
    calls: list = []
    with cs.recording_kernel_inputs(calls, lambda name, a: name == "occ_pair_shard"):
        lo, hi = slot.search(*engine._upload(slot, w, q))
    step = [a for _, a in calls if a[3].shape[0] == cs.BATCH][:4]
    plain = []
    for a in step:
        outs = (a[9].clone(), a[10].clone())
        plain.append(kernels.occ_pair_shard_plain(*a[:9], *outs))
    rank_step = {"requests": cs.BATCH, "max_abs_err": {}, "turns_ms": {name: [] for name in libs}}
    for name, lib in libs.items():
        with using(lib):
            got = [kernels.occ_pair_shard(*a) for a in step]
        rank_step["max_abs_err"][name] = max(cs.result_err(g, p) for g, p in zip(got, plain))
    if rank_step["max_abs_err"]["new"] != 0:
        raise AssertionError("occ_pair_shard disagrees with its plain version")
    for name in (list(libs) + list(libs)[::-1]) * TURN_PAIRS:
        with using(libs[name]):
            rank_step["turns_ms"][name].append(cs.time_ms(lambda: [kernels.occ_pair_shard(*a) for a in step],
                                                          device, REPS, flush, lead=cs.STEP_LEAD_CYCLES))
    rank_step["ms"] = {name: float(np.median(v)) for name, v in rank_step["turns_ms"].items()}
    log(json.dumps({"mode_b_rank_step": rank_step}))
    rows = kernels.slot_rows(lo, counts_from_ranges(lo, hi), engine.locate_cap).reshape(-1)
    del engine, slot
    gc.collect()
    torch.cuda.empty_cache()
    base = dataclasses.replace(index, mark_bits=None, mark_milestones=None, text_sampled_sa=None, text_packed=None)
    out = {"rank_step": rank_step, "rows": int(rows.shape[0]), "layouts": {}}
    for shards, sa_ratio in WALK_LAYOUTS:
        layout = dataclasses.replace(base, sampled_sa=np.ascontiguousarray(base.sampled_sa[:: sa_ratio // 8]),
                                     sa_ratio=sa_ratio)
        engine = ShardedFmEngine(layout, make_mesh(devices=[device] * shards, shard_size=shards))
        slot = engine._slots[0]
        out["layouts"][f"{shards} shards, SA ratio {sa_ratio}"] = walk_schedules(slot, layout, rows, device)
        if (shards, sa_ratio) == WALK_LAYOUTS[0]:
            out["profile"] = walk_profile(slot, rows, device)
        del engine, slot
        gc.collect()
        torch.cuda.empty_cache()
    log(json.dumps({"mode_b_walk": {k: v for k, v in out.items() if k != "rank_step"}}))
    return out


def _walk_positions(slot, rows):
    """walk_rounds of rows over the slot's shards, then the SA read: the
    text positions and the rounds."""
    from awry_tpu_torch.parallel import sharding

    dev = slot.dev
    pos, steps, rounds = sharding.walk_rounds(slot.shards, slot.total_blocks, rows, dev.num_planes,
                                              dev.alphabet.ambiguity_idx, dev.sa_ratio, dev.bwt_len)
    got = kernels._text_pos_mod(kernels._sa_values(kernels.window_read, dev.sampled_sa, pos // dev.sa_ratio), steps,
                                dev.bwt_len)
    return got, rounds


@contextlib.contextmanager
def _fixed_passes(passes):
    """round_passes patched to ``passes`` per round (None: the package's)."""
    from awry_tpu_torch.parallel import sharding

    real = sharding.round_passes
    if passes is not None:
        sharding.round_passes = lambda *a: passes
    try:
        yield
    finally:
        sharding.round_passes = real


def walk_schedules(slot, index, rows, device) -> dict:
    """The walk of rows over the slot's shards with the package's
    round_passes ("rule") and each fixed count of WALK_PASSES, each held
    equal to the narrow sampled_walk, then timed whole on the host clock in
    turns: rounds, passes and live rows of each round, the median and every
    turn."""
    dev = slot.dev
    narrow = to_device(index, device)
    want = kernels.sampled_walk(narrow.blocks, rows, narrow.prefix_sums, narrow.codes, narrow.c2i,
                                narrow.num_planes, narrow.alphabet.ambiguity_idx, dev.sa_ratio, dev.sampled_sa,
                                dev.bwt_len)
    del narrow
    names = ["rule", *WALK_PASSES]
    out = {}
    for name in names:
        with _fixed_passes(None if name == "rule" else name):
            got, rounds = _walk_positions(slot, rows)
        if not torch.equal(got, want):
            raise AssertionError(f"Mode B walk ({name} passes per round) differs from the narrow sampled_walk")
        out[str(name)] = {"rounds": len(rounds), "passes": sum(p for _, p in rounds),
                          "rows_per_round": [r for r, _ in rounds], "passes_per_round": [p for _, p in rounds],
                          "turns_ms": []}
    for name in (names + names[::-1]) * 2:
        with _fixed_passes(None if name == "rule" else name):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            _walk_positions(slot, rows)
            torch.cuda.synchronize(device)
        out[str(name)]["turns_ms"].append((time.perf_counter() - t0) * 1e3)
    for row in out.values():
        row["ms"] = float(np.median(row["turns_ms"]))
    log(json.dumps({f"walk, {len(slot.shards)} shards, SA ratio {dev.sa_ratio}":
                    {k: {"ms": v["ms"], "rounds": v["rounds"], "passes": v["passes"]} for k, v in out.items()}}))
    return out


def walk_profile(slot, rows, device) -> dict:
    """One walk with the package's round_passes under the profiler: wall
    time, device busy time, the sampled_walk_shard calls' host time, and the
    host time of each PyTorch operation."""
    from torch.profiler import ProfilerActivity, profile

    calls = {"n": 0, "host_ms": 0.0}
    real = kernels.sampled_walk_shard

    def timed(*a, **kw):
        t0 = time.perf_counter()
        r = real(*a, **kw)
        calls["host_ms"] += (time.perf_counter() - t0) * 1e3
        calls["n"] += 1
        return r

    timed.launches = 0  # the wrapper counts its launches here while patched
    kernels.sampled_walk_shard = timed
    try:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, rounds = _walk_positions(slot, rows)
            torch.cuda.synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        kernels.sampled_walk_shard = real
    events = prof.key_averages()
    top = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:14]
    return {
        "wall_ms": wall, "rounds": rounds, "sampled_walk_shard_calls": calls,
        "device_ms": sum(getattr(e, "self_device_time_total", 0) for e in events) / 1e3,
        "ops": [{"op": e.key, "count": e.count, "self_cpu_ms": e.self_cpu_time_total / 1e3,
                 "self_device_ms": getattr(e, "self_device_time_total", 0) / 1e3} for e in top],
    }


def _query_steps(call):
    """The longest walk (LF steps) of each query's live slots."""
    blocks, starts, counts, cap, prefix_sums, codes, c2i, nplanes, amb, sa_ratio, sampled_sa, bwt_len = call
    rows = kernels.slot_rows(starts, counts, cap).reshape(-1).clamp(0, bwt_len - 1)
    lf = (prefix_sums, codes, c2i, nplanes, nplanes * 8 + codes.shape[0], amb)
    steps = torch.zeros_like(rows)
    live = torch.nonzero(rows % sa_ratio != 0)[:, 0]
    while live.numel():
        rows[live] = kernels.backstep_plain(blocks, rows[live], *lf)[0].clamp(0, bwt_len - 1)
        steps[live] += 1
        live = live[rows[live] % sa_ratio != 0]
    return steps.reshape(-1, cap).max(dim=1).values


def walk_tail(libs, call, device, flush) -> dict:
    """The new build's range-fed walk (ms) over the whole batch, its first
    half, and the batch with every query whose walks exceed the p99 of
    steps emptied: what the walk-length tail costs."""
    blocks, starts, counts, cap, *rest = call
    steps = _query_steps(call)
    p99 = float(torch.quantile(steps[counts > 0].double(), 0.99))
    half = starts.shape[0] // 2
    variants = {"whole batch": (starts, counts), "first half": (starts[:half].clone(), counts[:half].clone()),
                f"walks of at most {p99:g} steps": (starts, torch.where(steps <= p99, counts, 0))}
    out = {"max_steps": int(steps.max())}
    with using(libs["new"]):
        for label, (st, ct) in variants.items():
            out[label] = cs.time_ms(lambda st=st, ct=ct: kernels.sampled_walk_ranges(blocks, st, ct, cap, *rest),
                                    device, REPS, flush)
    return out


def same_block(args):
    blocks, pos_a, pos_b, sym, codes, nplanes = args
    nbits = blocks.shape[0] * 256
    pa, pb = pos_a.clamp(0, nbits - 1), pos_b.clamp(0, nbits - 1)
    return (blocks, pa, (pa & ~255) | (pb & 255), sym, codes, nplanes)


def two_blocks(args):
    blocks, pos_a, pos_b, sym, codes, nplanes = args
    nb = blocks.shape[0]
    pa, pb = pos_a.clamp(0, nb * 256 - 1), pos_b.clamp(0, nb * 256 - 1)
    return (blocks, pa, (((pa >> 8) + 1) % nb << 8) | (pb & 255), sym, codes, nplanes)


BOUNDS = {"occ_pair": cs.occ_pair_bound, "occ": cs.occ_bound, "window_read": cs.window_read_bound,
          "marked_walk": cs.marked_walk_bound, "marked_walk_ranges": cs.marked_walk_ranges_bound,
          "sampled_walk": cs.sampled_walk_ranges_bound}


def _backstep_parts(kind: str, call) -> tuple:
    """(blocks, rows, the LF and mark arguments) of a backstep or
    backstep_wide call."""
    if kind == "backstep_wide":
        return call[0], call[2], call[3:]
    return call[0], call[1], call[2:]


def backstep_row(libs, path: str, kind: str, label: str, call, device, flush) -> dict:
    """backstep or backstep_wide at one site (backstep_wide's ``call``: its
    arguments and its narrow twin's): every build, design and read floor in
    turns beside the bound (chip_smoke.backstep_bound; the wide kernel's 4 B
    more per row), the summed sectors a visit reads (its row's whole
    sectors; the floors and designs read no more) and their rate at each
    contender's ms; then the one-row launch (FmIndex.backstep's shape) in
    turns.  Only the package's build is held to the plain version."""
    call, twin = call if kind == "backstep_wide" else (call, None)
    blocks, rows, rest = _backstep_parts(kind, call)
    nbytes, ops = cs.backstep_bound(blocks, rows, *rest)
    n = int(rows.shape[0])
    nbytes += n * 4 if twin is not None else 0
    summed = n * blocks.shape[1] * 4
    row = {"path": path, "kernel": kind, "site": label, "requests": n, "bytes": nbytes, "ops": ops,
           "bound_ms": max(nbytes / cs.HBM_BYTES_PER_S, ops / cs.INT32_OPS_PER_S) * 1e3,
           "summed_bytes": summed, "summed_sectors": summed // 32}
    plain = _plain(kind, call)
    twin_plain = kernels.backstep_plain(*twin) if twin is not None else None
    fns = _backstep_contenders(libs, kind, call, twin)
    errs = {name: cs.result_err(fn(), twin_plain if name == "new, narrow twin" else plain)
            for name, fn in fns.items()}
    if errs["new"] != 0 or errs.get("new, narrow twin", 0) != 0:
        raise AssertionError(f"{kind} disagrees with its plain version: max abs err {errs}")
    ms, times = in_turns(fns, device, flush)
    row.update(max_abs_err=errs, ms=ms, turns_ms=times,
               summed_rate_tb_s={name: summed / (t * 1e-3) / 1e12 for name, t in ms.items()})
    first = tuple(a[:1].clone() if a is rows else a for a in call)
    first_twin = None if twin is None else (twin[0], twin[1][:1].clone(), *twin[2:])
    ms1, times1 = in_turns(_backstep_contenders(libs, kind, first, first_twin), device, flush)
    row["one_row"] = {"ms": ms1, "turns_ms": times1}
    log(json.dumps(row))
    return row


def site_row(libs, path: str, kind: str, label: str, call, device, flush) -> dict:
    if kind.startswith("backstep"):
        return backstep_row(libs, path, kind, label, call, device, flush)
    nbytes, ops, *walks = BOUNDS[kind](*call)
    row = {"path": path, "kernel": kind, "site": label, "requests": int(call[1].shape[0]),
           "bound_ms": max(nbytes / cs.HBM_BYTES_PER_S, ops / cs.INT32_OPS_PER_S) * 1e3}
    if kind == "occ_pair":
        blocks, pos_a, pos_b = call[0], call[1], call[2]
        nbits = blocks.shape[0] * 256
        same = (pos_a.clamp(0, nbits - 1) >> 8) == (pos_b.clamp(0, nbits - 1) >> 8)
        row["same_block_share"] = float(same.float().mean())
    if walks:
        row["walk_steps"] = walks[0]
    row.update(time_site(libs, kind, call, device, flush))
    if kind == "sampled_walk":
        row["tail"] = walk_tail(libs, call, device, flush)
    if kind.startswith("marked_walk"):
        info = walks[0]
        row["walk_steps"] = info["walk_steps"]
        row["summed_bytes"] = info["summed_bytes"]
        row["summed_rate_tb_s"] = {name: info["summed_bytes"] / (t * 1e-3) / 1e12 for name, t in row["ms"].items()}
        row["variants"] = marked_variants(libs, kind, call, device, flush)
    log(json.dumps(row))
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", action="append", default=[], help="directory holding other kernel sources")
    parser.add_argument("--kernels", default="occ_pair,occ", help=f"comma-separated, of {','.join(KINDS)}")
    parser.add_argument("--paths", default="chr1,chr20",
                        help="comma-separated: chr1, chr20, grch38, pangenome, markless, amino, modeb")
    parser.add_argument("--pairs", action="store_true", help="occ_pair on chr1 pairs moved into one / two blocks")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", help="write the full record as JSON here")
    args = parser.parse_args()
    kinds = set(args.kernels.split(","))
    if not kinds <= set(KINDS):
        parser.error(f"--kernels: unknown {sorted(kinds - set(KINDS))}")
    if not torch.cuda.is_available():
        print("rank_kernel_study: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = cs.card_line()
    log(f"device: {card}")
    t0 = time.perf_counter()
    libs, ptxas = build_all(args.baseline, "sampled_walk" in kinds, bool(kinds & {"backstep", "backstep_wide"}))
    log(f"builds {list(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, lines in ptxas.items():
        for ln in lines:
            log(f"  ptxas {name}: {ln}")
    flush = cs.make_flush(device)
    rng = np.random.default_rng(args.seed)
    rows, sums = [], {}
    for path in args.paths.split(","):
        t0 = time.perf_counter()
        if path == "modeb":
            sums["modeb"] = mode_b_study(libs, device, rng, flush)
            gc.collect()
            torch.cuda.empty_cache()
            continue
        sites = {"chr1": record_chr1, "chr20": record_chr20, "grch38": record_grch38, "pangenome": record_pangenome,
                 "markless": record_markless, "amino": record_amino}[path](device, rng, kinds)
        log(f"{path}: {len(sites)} sites recorded in {time.perf_counter() - t0:.1f} s")
        for kind, label, call in sites:
            rows.append(site_row(libs, path, kind, label, call, device, flush))
            if args.pairs and path == "chr1" and kind == "occ_pair":
                for name, fn in (("one block", same_block), ("two blocks", two_blocks)):
                    rows.append(site_row(libs, path, kind, f"{label}, every pair in {name}", fn(call), device, flush))
        for kind in ("occ", "window_read"):
            ours = [r for r in rows if r["path"] == path and r["kernel"] == kind]
            if len(ours) > 1:
                sums[f"{path} {kind}"] = {"sites": len(ours), "bound_ms": sum(r["bound_ms"] for r in ours),
                                          "ms": {n: sum(r["ms"][n] for r in ours) for n in ours[0]["ms"]}}
                log(json.dumps({f"{path} {kind}": sums[f"{path} {kind}"]}))
        del sites
        gc.collect()
        torch.cuda.empty_cache()
    record = {"card": card, "ptxas": ptxas, "sites": rows, "sums": sums, "reps": REPS}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    log(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
