// backstep: one marked-walk visit per BWT row, from one fused-row read:
//   stepped[i] = LF(row) = C[safe] + Occ(row, safe) - 1, or 0 when the
//                row's BWT symbol is the sentinel (safe = the symbol, or the
//                ambiguity index in place of the sentinel);
//   mark[i]    = (mark_rank << 1) | mark_bit, where mark_bit says whether
//                the row's SA value is text-sampled and mark_rank counts the
//                marked rows strictly before it (its index into the marked
//                SA values).
//
// marked_walk: the whole marked LF walk of each row to its text position,
// one thread per row (below).  marked_walk_ranges: the same walks fed by
// query ranges, as the classic path asks for them: slot (q, j) of a [B,
// cap] output walks row starts[q] + j for j < min(counts[q], cap), and every
// other slot holds the walk of row 0, which is what the flat walk of the
// classic path's padded rows wrote there (awry_tpu/ops/locate.py
// count_locate_capped_t: "row 0 is sampled").
//
// sampled_walk: the reference's row-sampled LF walk of each row to its text
// position, for indexes without marks (loaded from .awry files): LF steps
// while row % sa_ratio != 0, then sampled_sa[row / sa_ratio] + steps.
// sampled_walk_ranges: the same walks fed by query ranges, as the classic
// path asks for them: slot (q, j) of a [B, cap] output walks row starts[q]
// + j for j < min(counts[q], cap), and every other slot holds the walk of
// row 0 (sampled: its SA value), which is what the flat walk of the
// classic path's padded rows wrote there.
//
// sampled_walk_shard: the part of each row's sampled walk that one shard's
// window of blocks holds (below), for the range-sharded index.
//
// backstep replaces awry_tpu/ops/sweep.py:_backstep_kernel_anchored as
// backstep_mark_sweep runs it (one visit) and its blocked twin
// _backstep_kernel; marked_walk and marked_walk_ranges replace the same
// kernel (sweep.py:1123) as marked_walk_sweep (sweep.py:883) runs it
// (mark_ratio visits, the glue between them and the marked SA read), with
// the semantics of awry_tpu/ops/locate.py:74 _marked_walk.  sampled_walk replaces awry_tpu/ops/locate.py
// _row_sampled_walk: a jax.lax.while_loop of rank.backstep gathers, the
// per-visit work of _backstep_kernel with another stop rule, whose
// jnp.any stays on the TPU; walked by visits from the host, the port would
// pay a host sync per visit over an unknown number of visits.
//
// A fused row holds V 256-bit occurrence planes (V*8 words; V = 3 for
// nucleotide, 5 for amino), the block's per-symbol milestones, the 8 mark
// words at mark_offset and the mark milestone at mark_offset + 8 (40 words
// per nucleotide row, 72 per amino row).  The symbol is bit (row & 255) of
// each plane; Occ = milestone[safe] + popcount of the AND over planes of
// (plane ^ polarity(safe's code bit v)), masked to bits [0..=row & 255];
// mark_rank = mark milestone + popcount of the mark words masked to bits
// [0, row & 255).
//
// The walks' LF core: one round trip to device memory per
// step.  A nucleotide row's planes are words 0-23 and its milestones words
// 24-29, so one 128 B request (8 uint4 loads) brings both, and the
// symbol's milestone is picked from registers (an amino step takes a
// second trip for its milestone word, RowWords).  The code -> step table
// (per occurrence code: the safe symbol, its code, C[safe] - 1 and the
// sentinel flag) sits in shared memory, loaded once per block, so the
// dependent global loads of c2i, codes and prefix_sums are gone.
//
// Bound: device-memory traffic of scattered reads.  Each visit reads one
// random row of a table far larger than L2 (625 MB of nucleotide rows at
// 1 Gbp): the V plane sectors, the milestone's sector, the mark words'
// sectors up to the row's word and the mark milestone's (at most the whole
// 160 B nucleotide row), plus 20 B of request/result I/O; a few dozen
// integer operations.  A walk is a chain of dependent round trips, so a
// batch also has a floor of its longest walk times one step's latency.
//
// backstep: a warp per tile of 32 rows.  Each row is copied whole into
// shared memory by one bulk copy (cp.async.bulk, issued by the row's lane
// and completed on the warp's mbarrier); then a thread per row steps it
// from there: lf_of's arithmetic with every word read from shared memory,
// an amino row's milestone too (staged_lf), and the mark rank and bit.
// Staged rows sit at a stride of row_words | 4 words, so a quarter-warp's
// 16 B reads fall in distinct banks; blocks of 8 warps (nucleotide, 44 KB
// of tiles) or 4 (amino, 38 KB).
//
// Why (measured in turns on one H100 80GB HBM3 at 700 W, PERF.md section 6,
// scripts/rank_kernel_study.py --kernels backstep,backstep_wide, L2 flushed
// before each launch): one visit over GRCh38's 655,360 verify-walk rows (a
// 625 MB table) takes 0.0505 ms against the parent's 0.0585 (a thread per
// row and its 13 scattered loads; bound 0.0275), over a mark-32
// partition's 655,360 rows (a 40 MB table) 0.0338 against 0.0388, over
// 262,144 amino rows 0.0252 against 0.0274, one row 0.0073 against 0.0075;
// backstep_wide 0.0474 against 0.0587.  The loads set the time, not the
// arithmetic: a read floor issuing the parent's loads with no arithmetic
// took 0.0617, one loading whole rows by 16 B pieces in order (each warp
// load 32 consecutive pieces) 0.0553, and those loads staged in shared
// memory with the arithmetic after them (design (a)) 0.0578.  The bulk
// copies read the rows at 2.08 TB/s of row bytes against the parent's
// 1.79.  Persistent warps with a ring of two tiles, stepping one while the
// next one's copies run (design (b)), took 0.0524: fewer warps resident,
// and nothing gained from the overlap.  The other designs and the floors
// are in the study script (DESIGNS).
//
// marked_walk: one thread per row.  Per visit it reads the mark word of
// the row's bit first; a marked row (or the walk's last visit) reads the
// other mark words and the mark milestone, already its final row, and
// stops; an unmarked row reads its planes and milestones and steps.  So a
// lane reads steps + 1 rows, the final one only in its mark sectors, then
// its SA word, and writes its text position: one launch, 16 B of I/O per
// lane.  Lanes of a warp that finish early idle until the warp's longest
// walk ends; marked walks are short (at most mark_ratio - 1 steps).
//
// Bound of the marked walks: the distinct sectors the walks touch (a
// stepping visit: the mark word's sector, the V plane sectors and the
// stepped symbol's milestone sector; a final visit: the mark words' and
// the mark milestone's sectors) and the marked SA words they end on, with
// their I/O; and the chain floor, the longest walk (mark_ratio - 1 steps)
// at the per-step time of a one-row walk.  A federation partition at mark
// 32 (64 Mbp: its 40 MB of rows stay in the 50 MB L2) asks far more of L2
// than of device memory: its 655,360 verify rows read 1.62 GB of sectors
// summed over visits (0.0172 ms bound from 57 MB of distinct sectors; chain
// floor 0.028 ms, 31 steps at 0.9 us).
//
// Why the flat walk stays one thread per row with the mark word read first
// (measured in turns on one H100 80GB HBM3 at 700 W, PERF.md section 6,
// scripts/rank_kernel_study.py --paths pangenome,grch38; L2 flushed): it
// is bound by the sector requests it makes of L2, not by its chain or its
// idle lanes.  Half the rows take 0.255 of 0.426 ms, the rows sorted by
// walk length 0.451; its variable part runs at about 150 G sectors/s, near
// the 159 G/s its padded rows reached.  Every design that read the planes
// with the mark word (one round trip per step) or refilled lanes as walks
// ended lost at mark 32 and at mark 4 (GRCh38, 1 Gbp: 0.1317 ms, bound
// 0.050): one trip per step with all mark words 0.531 / 0.153 ms, with the
// planes' upper halves on demand 0.4705; lanes refilled per free lane at
// 72-94 registers 0.500-0.522; a thread per row reading the planes with
// the mark word 0.4497 / 0.1532 (the final visit's planes: +5 % sectors);
// 64 registers forced 0.5706 (spills).  Fewer round trips buy nothing
// where the sectors are the limit.
//
// marked_walk_ranges: the refill schedule of the sampled walks (below)
// with the marked stop rule (walk_kernel, Stop::kMarked), so the idle
// slots of the classic path's [B, cap] output are not walked.  A warp
// hands out a tile's live slots only once all its lanes are free
// (per free lane 0.4687 / 0.1881 ms against 0.4481 / 0.1702 in
// lockstep).  A lane's iteration is one round trip of its phase
// (MarkedPhase): the probe (the row's mark word, eager: with its planes and
// milestones), the planes of an unmarked row (lazy), the final row's mark
// words, or its SA word; eager from mark 8 on (mark 32: 0.4483 eager, 0.4868
// lazy; mark 4: 0.1784 eager, 0.1703 lazy).  Row 0's walk, the idle slots'
// value, is walked once per launch by lane 0 of the warp that claims tile 0
// and published in the cursor buffer; after its last tile each warp claims
// tiles again and writes their idle slots (coalesced) once row 0's value is
// there.  Measured against the parent's padded rows walked by its flat
// kernel behind the slot_rows glue: cap 8, mark 4 (524,288 ranges, 524,318
// live slots of 4,194,304) 0.1698 ms against 0.2968; cap 2, mark 32
// (524,288 live of 1,048,576) 0.4483 against 0.4467.  One thread per slot
// (idle lanes idle, one walking row 0 per warp) lost at cap 8 (0.2421) and
// won at cap 2 (0.4067).
//
// sampled_walk needs no row read to stop: the stop rule is the row's own
// number (a mask for a power-of-two sa_ratio, else a multiplier computed on
// the host), so each step reads only the plane and milestone sectors, and
// the end reads one SA word.  Its walks have no bound but the cycle: their
// lengths are about geometric with mean sa_ratio - 1 and a long tail (p99
// 34, max 102 steps over a chr20-sized batch at sa_ratio 8).  Bound: the
// distinct sectors the walks touch and the SA words they end on, the I/O
// (8 B per row in, 8 B per position out; ranges: 16 B per query in), and
// the longest walk's chain of round trips.
//
// Design of the sampled walks: persistent warps that refill their lanes
// as walks end (walk_kernel).  The grid is what fits the card at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  A warp claims a
// tile of 32 queries (one per lane) with one atomic on a cursor the caller
// zeroes; a warp-scan of min(count, cap) numbers the tile's live slots, the
// warp writes the tile's idle slots (coalesced), and each lane whose walk
// ends takes the tile's next live slot (ballot and popc; its query found
// by a 5-step binary search over the scan with shuffles), so a warp waits
// for its longest walk only at the batch's tail.  The next tile's claim
// and query loads are issued a tile ahead.  A lane's iteration is one
// round trip: its row if it steps, its SA word if it ends.  A plane's
// upper 16 B is read only when the row's word lies in it (-1.2 %).  The
// flat-row entry is the same kernel with one live slot per row.
//
// Measured in turns on one H100 80GB HBM3 at 700 W (PERF.md section 6;
// scripts/rank_kernel_study.py, the chr20 classic batch of 524,288
// queries at cap 8, 525,360 live slots, L2 flushed): this design 0.269
// ms.  Its byte bound is 0.026 ms (86.7 MB: the distinct sectors the walks
// read, 16 B per query in, the int64 [B, 8] out) and its chain floor 0.085
// ms (the longest walk, 102 steps, at 0.83 us per step of a one-row walk).
// The others lost: (a), the parent's thread per padded row behind four
// elementwise passes of glue, 0.78-0.79 ms; (b), the live slots compacted by
// a prefix sum and one thread each (scripts/rank_kernel_study.py builds it
// onto a copy of this source), 0.35 ms: its warps wait for the longest of 32
// walks; this kernel behind the parent's glue 0.38-0.40 ms; the rows read by
// groups of 8 lanes (each load instruction one whole 128 B span, then a
// butterfly of shuffles handing each lane its row) 0.306 ms: fewer L1
// wavefronts, and slower, so the L1 is not what holds the walk; 64 registers
// forced (4 blocks per SM) 1 % slower: nor is occupancy.  What holds it: half
// the batch takes 0.170-0.177 ms, so about 0.19 ms per batch scales with the
// walks' 3.7 M steps of 4 sectors each (about 2.5 TB/s of scattered sector
// reads, the rows cold after the flush), and about 0.07 ms does not (the
// launch and the tail of long walks: emptying the 1 % of queries whose walks
// exceed 34 steps saves 0.025-0.034 ms).
//
// The wide variants (backstep_wide, marked_walk_wide and its range-fed
// entry, sampled_walk_wide and its range-fed entry: texts of 2^32 symbols
// and more, ops/wide.py) are the
// same kernels instantiated with kWide.  A wide index keeps this row layout
// with each row's milestones and mark milestone counted from the first block
// of its group of 2^group_shift blocks; the LF core adds the group's base for
// the stepped symbol (ms_base, int64 [groups, card], L2-resident: one more
// dependent read per step, issued once the planes name the symbol), and the
// mark rank adds mark_base[group] (int64).  Rows, steps and SA values are 64
// bits: the mark rank is whole (not backstep's 31 packed bits), SA values
// are int64, and the row sampling of a ratio that is no power of two takes a
// 64-bit remainder and quotient (RowSampling64: the multiplier above is
// exact only for 32-bit rows).  Bound: as the narrow twins, with 8-byte SA
// values and wider outputs.
//
// sampled_walk_shard is the range-sharded index's walk (Mode B,
// awry_tpu_torch/parallel/sharding.py): the sampled walk's template fed by
// one shard's window, blocks [first_block, first_block + local_blocks) of
// the table, over a round's rows and steps, walked in place (kShard).  A
// tile's lane takes its row only when the row is unsampled, its block lies
// in the window and its steps are below bwt_len, and walks it until the row
// is sampled, an LF step lands outside the window, or the walk has taken
// bwt_len steps; it writes back the row and the steps in all.  Other rows
// stay as they are, and the sampled SA (on the slot's device only) is never
// read.  The engine walks the live rows in rounds: a compaction, then
// passes over the shards, one launch per shard and pass, the shards of a
// device in order on the same arrays, so a row crosses into later windows
// within a pass and goes on in the next.  It replaces Mode B's collective
// LF walk (awry_tpu/parallel/sharding.py _sharded_backstep_fn: plain
// gathers of the local rows and two psums over the shard axis, under
// lf_walk's while loop), which has no Pallas kernel.  Bound: as
// sampled_walk's, over the launch's live row-steps in the window (the
// sectors they read), 8 B in per row (its row), 8 B more in (its steps)
// and 16 B out per walked row.
//
// ptxas (sm_90a, -Xptxas=-v), nucleotide / amino registers: backstep 34 / 41,
// backstep_wide 40 / 38; marked_walk 53 / 63, marked_walk_wide 48 / 64; the
// range-fed marked walk 72 / 80, wide 76 / 91; the range-fed sampled walk
// 65 / 78, wide 64 / 80; the flat-row walk 64 / 77, wide 64 / 79;
// sampled_walk_shard 63 / 76.  No spills.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// A read-only int64 load (the wide variants' group bases and SA values).
__device__ __forceinline__ int64_t ldg64(const int64_t* p) {
  return (int64_t)__ldg(reinterpret_cast<const long long*>(p));
}

// w[i] for a runtime i in [0, N), as a select chain (no local-memory array).
template <int N>
__device__ __forceinline__ uint32_t pick(const uint32_t (&w)[N], uint32_t i) {
  uint32_t r = w[0];
#pragma unroll
  for (uint32_t j = 1; j < N; ++j) r = (i == j) ? w[j] : r;
  return r;
}

// A BWT row's place: its fused block row and the word and bit of the row
// inside the block's 256-bit fields.  pos is clamped into the table.
struct RowAt {
  const uint32_t* row;
  uint32_t blk;
  uint32_t word;
  uint32_t bit;
};

__device__ __forceinline__ RowAt row_at(const uint32_t* blocks, int64_t nbits, int row_words, int64_t pos) {
  pos = pos < 0 ? 0 : (pos >= nbits ? nbits - 1 : pos);
  const uint32_t local = (uint32_t)pos & 255u;
  return {blocks + (pos >> 8) * (int64_t)row_words, (uint32_t)(pos >> 8), local >> 5, local & 31u};
}

// What an LF step takes from its row's occurrence code: the safe symbol
// (the code's symbol, or ambiguity_idx in place of the sentinel), its code,
// C[safe] - 1, and whether the row holds the sentinel.
struct alignas(16) CodeStep {
  int64_t base;
  uint32_t scode;
  uint16_t safe;
  uint16_t sentinel;
};

// What a walk reads besides its rows: the fused rows, the LF step's tables
// and the SA values it ends on (the marked SA values for marked_walk, the
// row-sampled SA for the sampled walks).  The wide variants (kWide: texts
// of 2^32 symbols and more) read the rows' milestones and mark milestones
// relative to their group of 2^group_shift blocks, add the group's absolute
// counts from ms_base (int64 [groups, card]) and mark_base (int64
// [groups]), and read int64 SA values from sa64.
struct WalkTables {
  const uint32_t* blocks;
  int64_t nbits;
  int row_words;
  const int64_t* prefix_sums;
  const int32_t* codes;
  const int32_t* c2i;
  int ambiguity_idx;
  const uint32_t* sa;
  int64_t sa_len;
  int64_t bwt_len;
  const int64_t* sa64;
  const int64_t* ms_base;
  const int64_t* mark_base;
  int group_shift;
  int card;
};

// A BWT row, a step count and a mark rank: uint32 narrow, 64-bit wide.
template <bool kWide>
using WalkRow = std::conditional_t<kWide, uint64_t, uint32_t>;
template <bool kWide>
using MarkRank = std::conditional_t<kWide, int64_t, uint32_t>;

// The 2^V-entry code -> step table, in shared memory, filled by the block.
template <int V>
__device__ __forceinline__ void load_code_steps(CodeStep* tab, const int64_t* __restrict__ prefix_sums,
                                                const int32_t* __restrict__ codes,
                                                const int32_t* __restrict__ c2i, int ambiguity_idx) {
  for (int c = threadIdx.x; c < (1 << V); c += blockDim.x) {
    const int sym = c2i[c];
    const int safe = sym == 0 ? ambiguity_idx : sym;
    tab[c] = {prefix_sums[safe] - 1, (uint32_t)codes[safe], (uint16_t)safe, (uint16_t)(sym == 0)};
  }
  __syncthreads();
}

// A step's row in registers: the V planes and, for nucleotide, the
// milestone sector (words 24-31) that comes in the same 128 B.  An amino
// row's 22 milestones span sectors 5-7 (words 40-61): its step reads the
// one milestone word in a second round trip once the planes have named
// the symbol (0.1753 ms per 262,144-query amino batch, against 0.2137 with
// the three sectors loaded beside the planes; PERF.md).
template <int V>
struct RowWords {
  static constexpr bool kMiles = V == 3;
  uint32_t plane[V][8];
  uint32_t mile[kMiles ? 8 : 1];
};

// kUpperOnDemand: a plane's upper half (words 4-7) is read only when the
// row's word is among them (the rank masks out the words above the row's):
// 1 % faster for the sampled walks, 1.4 % slower for marked_walk, whose
// loads follow its mark word's.
template <int V, bool kUpperOnDemand = false>
__device__ __forceinline__ void load_row(const RowAt& r, RowWords<V>& x) {
  const uint4* p = reinterpret_cast<const uint4*>(r.row);
  const bool upper = !kUpperOnDemand || r.word >= 4;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const uint4 lo = __ldg(p + 2 * v);
    uint4 hi = {0u, 0u, 0u, 0u};
    if (upper) hi = __ldg(p + 2 * v + 1);
    x.plane[v][0] = lo.x;
    x.plane[v][1] = lo.y;
    x.plane[v][2] = lo.z;
    x.plane[v][3] = lo.w;
    x.plane[v][4] = hi.x;
    x.plane[v][5] = hi.y;
    x.plane[v][6] = hi.z;
    x.plane[v][7] = hi.w;
  }
  if constexpr (RowWords<V>::kMiles) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint4 m = __ldg(p + 2 * V + k);
      x.mile[4 * k] = m.x;
      x.mile[4 * k + 1] = m.y;
      x.mile[4 * k + 2] = m.z;
      x.mile[4 * k + 3] = m.w;
    }
  }
}

// LF(row) from its loaded words: C[safe] + Occ(row, safe) - 1, or 0 when
// the row's symbol is the sentinel.
template <int V, bool kWide = false>
__device__ __forceinline__ int64_t lf_of(const RowWords<V>& x, const RowAt& r, const CodeStep* tab,
                                         const WalkTables& t) {
  uint32_t code = 0;
#pragma unroll
  for (int v = 0; v < V; ++v) code |= ((pick(x.plane[v], r.word) >> r.bit) & 1u) << v;
  const CodeStep c = tab[code];
  uint32_t occ[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) occ[w] = kFull;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    // A zero code bit matches a zero plane bit: flip the plane first.
    const uint32_t pol = ((c.scode >> v) & 1u) ? 0u : kFull;
#pragma unroll
    for (int w = 0; w < 8; ++w) occ[w] &= x.plane[v][w] ^ pol;
  }
  const uint32_t in_word = kFull >> (31u - r.bit);
  uint32_t count = 0;
#pragma unroll
  for (uint32_t w = 0; w < 8; ++w) {
    const uint32_t m = w < r.word ? kFull : (w == r.word ? in_word : 0u);
    count += __popc(occ[w] & m);
  }
  uint32_t mile;
  if constexpr (RowWords<V>::kMiles) {
    mile = pick(x.mile, c.safe);
  } else {
    mile = __ldg(r.row + V * 8 + c.safe);
  }
  int64_t base = c.base;
  if constexpr (kWide) base += ldg64(t.ms_base + (int64_t)(r.blk >> t.group_shift) * t.card + c.safe);
  return c.sentinel ? 0 : base + (int64_t)mile + count;
}

// A row's 8 mark words, its mark milestone and (wide) its group's mark base.
struct MarkWords {
  uint32_t w[8];
  uint32_t mile;
  int64_t base;
};

template <bool kWide = false>
__device__ __forceinline__ void load_marks(const RowAt& r, int mark_offset, MarkWords& m, const WalkTables& t) {
  const uint2* mp = reinterpret_cast<const uint2*>(r.row + mark_offset);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint2 v = __ldg(mp + w);
    m.w[2 * w] = v.x;
    m.w[2 * w + 1] = v.y;
  }
  m.mile = __ldg(r.row + mark_offset + 8);
  m.base = 0;
  if constexpr (kWide) m.base = ldg64(t.mark_base + (r.blk >> t.group_shift));
}

// The marked rows strictly before the row: the mark milestone (plus the
// group's base) and the mark words' bits [0, row) of the block.
template <bool kWide = false>
__device__ __forceinline__ MarkRank<kWide> mark_rank_of(const MarkWords& m, const RowAt& r) {
  const uint32_t before = (1u << r.bit) - 1u;  // exclusive: bits [0, bit)
  MarkRank<kWide> mark_rank = m.mile;
  if constexpr (kWide) mark_rank += m.base;
#pragma unroll
  for (uint32_t w = 0; w < 8; ++w) {
    const uint32_t mask = w < r.word ? kFull : (w == r.word ? before : 0u);
    mark_rank += __popc(m.w[w] & mask);
  }
  return mark_rank;
}

__device__ __forceinline__ uint32_t mark_bit_of(const MarkWords& m, const RowAt& r) {
  return (pick(m.w, r.word) >> r.bit) & 1u;
}

// backstep's staged rows: a warp stages the 32 rows of a tile, one per
// lane, in shared memory, each at a stride of row_words | 4 words (an odd
// multiple of 4), so that 8 lanes' 16 B reads at one offset of 8 rows fall
// in 8 distinct groups of 4 banks (40-word rows: 44, 72-word rows: 76).
__host__ __device__ constexpr int staged_words(int row_words) { return row_words | 4; }

// LF(row) from its staged words: lf_of's arithmetic, the milestone (amino
// too) read from shared memory.
template <int V, bool kWide>
__device__ __forceinline__ int64_t staged_lf(const uint32_t* s, const RowAt& r, const CodeStep* tab,
                                             const WalkTables& t) {
  uint32_t code = 0;
#pragma unroll
  for (int v = 0; v < V; ++v) code |= ((s[8 * v + r.word] >> r.bit) & 1u) << v;
  const CodeStep c = tab[code];
  const uint32_t in_word = kFull >> (31u - r.bit);
  uint32_t occ[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) occ[w] = w < (int)r.word ? kFull : (w == (int)r.word ? in_word : 0u);
  const uint4* s4 = reinterpret_cast<const uint4*>(s);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const uint32_t pol = ((c.scode >> v) & 1u) ? 0u : kFull;
    const uint4 lo = s4[2 * v], hi = s4[2 * v + 1];
    occ[0] &= lo.x ^ pol;
    occ[1] &= lo.y ^ pol;
    occ[2] &= lo.z ^ pol;
    occ[3] &= lo.w ^ pol;
    occ[4] &= hi.x ^ pol;
    occ[5] &= hi.y ^ pol;
    occ[6] &= hi.z ^ pol;
    occ[7] &= hi.w ^ pol;
  }
  uint32_t count = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) count += __popc(occ[w]);
  int64_t base = c.base + s[V * 8 + c.safe];
  if constexpr (kWide) base += ldg64(t.ms_base + (int64_t)(r.blk >> t.group_shift) * t.card + c.safe);
  return c.sentinel ? 0 : base + count;
}

// A staged row's visit: stepped[i] = LF(row), mark[i] = (mark_rank << 1) |
// mark_bit (narrow: 31 bits of the rank, uint32; wide: int64).
template <int V, bool kWide>
__device__ __forceinline__ void staged_visit(const uint32_t* s, const RowAt& r, int mark_offset, const CodeStep* tab,
                                             const WalkTables& t, int64_t i, int64_t* __restrict__ stepped,
                                             MarkRank<kWide>* __restrict__ mark) {
  MarkWords m;
  const uint2* mp = reinterpret_cast<const uint2*>(s + mark_offset);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint2 v = mp[w];
    m.w[2 * w] = v.x;
    m.w[2 * w + 1] = v.y;
  }
  m.mile = s[mark_offset + 8];
  m.base = 0;
  if constexpr (kWide) m.base = ldg64(t.mark_base + (r.blk >> t.group_shift));
  stepped[i] = staged_lf<V, kWide>(s, r, tab, t);
  mark[i] = (mark_rank_of<kWide>(m, r) << 1) | mark_bit_of(m, r);
}

// The mbarrier and bulk-copy instructions backstep stages its rows with
// (PTX ISA: mbarrier, cp.async.bulk).
__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// Tile `tile`'s rows into `stage`, arriving on `bar`: lane 0 sets the bytes
// the barrier's phase waits for, each lane with a row copies it (one bulk
// copy of its row_words words); returns the lane's RowAt.
__device__ __forceinline__ RowAt issue_tile(const WalkTables& t, const int64_t* __restrict__ rows, int64_t n,
                                            int64_t tile, uint32_t* stage, uint32_t bar, unsigned lane) {
  const int64_t first = tile * 32;
  const int live = n - first < 32 ? (int)(n - first) : 32;
  const RowAt r = row_at(t.blocks, t.nbits, t.row_words, (int)lane < live ? rows[first + lane] : 0);
  const uint32_t bytes = (uint32_t)t.row_words * 4u;
  if (lane == 0) bar_expect(bar, bytes * (uint32_t)live);
  __syncwarp();
  if ((int)lane < live) bulk_copy(smem_u32(stage + lane * staged_words(t.row_words)), r.row, bytes, bar);
  return r;
}

// backstep (the head of this file's backstep note): a warp per tile of 32
// rows.  Each lane with a row copies it into the warp's tile by one bulk
// copy, completed on the warp's mbarrier; then each lane steps its own row
// from shared memory.
template <int V, bool kWide>
__global__ void __launch_bounds__(kThreads) backstep_kernel(const WalkTables t, int mark_offset,
                                                            const int64_t* __restrict__ rows, int64_t n,
                                                            int64_t* __restrict__ stepped,
                                                            MarkRank<kWide>* __restrict__ mark) {
  extern __shared__ uint4 staged[];
  __shared__ uint64_t bars[kWarps];
  __shared__ CodeStep tab[1 << V];
  const unsigned lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  if (lane == 0) {
    bar_init(smem_u32(&bars[warp]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_code_steps<V>(tab, t.prefix_sums, t.codes, t.c2i, t.ambiguity_idx);
  const int sw = staged_words(t.row_words);
  uint32_t* tile_words = reinterpret_cast<uint32_t*>(staged) + warp * 32 * sw;
  const int64_t tile = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (tile >= (n + 31) >> 5) return;
  const RowAt r = issue_tile(t, rows, n, tile, tile_words, smem_u32(&bars[warp]), lane);
  bar_wait(smem_u32(&bars[warp]), 0);
  const int64_t i = tile * 32 + lane;
  if (i < n) staged_visit<V, kWide>(tile_words + lane * sw, r, mark_offset, tab, t, i, stepped, mark);
}

// text_pos[i] of row rows[i] by the marked walk, one thread per row: a row
// is final when its mark bit is set (its mark word is read first, so a
// marked row skips its planes) or on the walk's last visit (steps ==
// mark_ratio - 1); the SA index is the final row's mark rank (narrow: 31
// bits of it, as backstep packs it), clamped into the marked SA; text_pos
// = sa + steps, less bwt_len when that reaches it.
template <int V, bool kWide>
__global__ void marked_walk_kernel(const WalkTables t, int mark_offset, int mark_ratio,
                                   const int64_t* __restrict__ rows, int64_t n, int64_t* __restrict__ text_pos) {
  __shared__ CodeStep tab[1 << V];
  load_code_steps<V>(tab, t.prefix_sums, t.codes, t.c2i, t.ambiguity_idx);
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int64_t pos = rows[i];
  for (int steps = 0;; ++steps) {
    const RowAt r = row_at(t.blocks, t.nbits, t.row_words, pos);
    const uint32_t word = __ldg(r.row + mark_offset + r.word);
    if (((word >> r.bit) & 1u) || steps + 1 >= mark_ratio) {
      MarkWords m;
      load_marks<kWide>(r, mark_offset, m, t);
      const MarkRank<kWide> mark_rank = mark_rank_of<kWide>(m, r);
      int64_t s;
      if constexpr (kWide) {
        const int64_t idx = mark_rank < 0 ? 0 : (mark_rank >= t.sa_len ? t.sa_len - 1 : mark_rank);
        s = ldg64(t.sa64 + idx) + steps;
      } else {
        const int64_t idx = (int64_t)(mark_rank & 0x7FFFFFFFu);
        s = (int64_t)__ldg(t.sa + (idx >= t.sa_len ? t.sa_len - 1 : idx)) + steps;
      }
      text_pos[i] = s >= t.bwt_len ? s - t.bwt_len : s;
      return;
    }
    RowWords<V> x;
    load_row(r, x);
    pos = lf_of<V, kWide>(x, r, tab, t);
  }
}

// The reference's row sampling: a row that is a multiple of sa_ratio has
// its SA value at sa[row / sa_ratio].  A power-of-two ratio takes a mask
// and a shift; any other the multiplier M = ceil(2^64 / sa_ratio), exact
// for every 32-bit row and ratio (Lemire, Kaser and Kurz, "Faster remainder
// by direct computation", 2019): row % sa_ratio == 0 iff row * M mod 2^64
// <= M - 1, and row / sa_ratio = (row * M) >> 64.
struct RowSampling {
  uint64_t magic;  // 0 for a power of two
  uint32_t mask;
  uint32_t shift;

  static RowSampling of(uint32_t ratio) {
    if (ratio & (ratio - 1)) return {UINT64_MAX / ratio + 1, 0, 0};
    uint32_t shift = 0;
    while ((1u << shift) < ratio) ++shift;
    return {0, ratio - 1, shift};
  }
  __device__ __forceinline__ bool sampled(uint32_t p) const {
    return magic ? (uint64_t)p * magic <= magic - 1 : (p & mask) == 0;
  }
  __device__ __forceinline__ uint32_t index(uint32_t p) const {
    return magic ? (uint32_t)__umul64hi(magic, (uint64_t)p) : p >> shift;
  }
};

// The same sampling of 64-bit rows (the wide walks): the multiplier above
// is exact only for 32-bit rows, so a ratio that is no power of two takes
// a 64-bit remainder and quotient; a power of two a mask and a shift.
struct RowSampling64 {
  uint64_t ratio;  // 0 for a power of two
  uint64_t mask;
  uint32_t shift;

  static RowSampling64 of(uint64_t ratio) {
    if (ratio & (ratio - 1)) return {ratio, 0, 0};
    uint32_t shift = 0;
    while ((1ull << shift) < ratio) ++shift;
    return {0, ratio - 1, shift};
  }
  __device__ __forceinline__ bool sampled(uint64_t p) const { return ratio ? p % ratio == 0 : (p & mask) == 0; }
  __device__ __forceinline__ uint64_t index(uint64_t p) const { return ratio ? p / ratio : p >> shift; }
};

template <bool kWide>
using Sampling = std::conditional_t<kWide, RowSampling64, RowSampling>;

// What feeds a sampled walk's lanes: query ranges into [nq, cap] slots
// (kRanges), flat rows (kRows), or the rows of one shard's walk, walked in
// place (kShard).
enum class Feed { kRanges, kRows, kShard };

// sampled_walk_shard's window, blocks [first_block, first_block +
// local_blocks) of the table, and the round's rows and steps it walks in
// place (int64 [nq] each).
struct ShardWalk {
  int64_t* rows;
  int64_t* steps;
  uint32_t first_block;
  uint32_t local_blocks;
};

// A walk's text position: its final row's SA value plus its steps, less
// bwt_len when that reaches it.
__device__ __forceinline__ int64_t text_pos_of(int64_t sa, int64_t steps, int64_t bwt_len) {
  const int64_t s = sa + steps;
  return s >= bwt_len ? s - bwt_len : s;
}

template <class Row = uint32_t>
__device__ __forceinline__ Row clamp_row(int64_t row, int64_t bwt_len) {
  return (Row)(row < 0 ? 0 : (row >= bwt_len ? bwt_len - 1 : row));
}

// The SA value at index i of the walk's sampled SA (uint32 or int64).
template <bool kWide>
__device__ __forceinline__ int64_t sa_at(const WalkTables& t, int64_t i) {
  if constexpr (kWide) {
    return ldg64(t.sa64 + i);
  } else {
    return __ldg(t.sa + i);
  }
}

// One lane's step of a sampled walk at row pos: one round trip, its SA
// word if the row is sampled (the walk ends: *out gets its text position),
// else its row (pos and steps advance).  A walk still going after bwt_len
// steps ends with -1 (no valid index allows it: row 0 is sampled and LF is
// one cycle over all rows).  Returns whether the walk ended.
template <int V, bool kWide = false>
__device__ __forceinline__ bool sampled_step(const WalkTables& t, const Sampling<kWide>& smp, const CodeStep* tab,
                                             WalkRow<kWide>& pos, WalkRow<kWide>& steps, int64_t* out) {
  const bool ends = smp.sampled(pos);
  const bool stepping = !ends && (int64_t)steps < t.bwt_len;
  int64_t sa = 0;
  RowAt r{};
  RowWords<V> x;
  if (ends) sa = sa_at<kWide>(t, (int64_t)smp.index(pos));
  if (stepping) {
    r = row_at(t.blocks, t.nbits, t.row_words, pos);
    load_row<V, true>(r, x);
  }
  if (stepping) {
    pos = clamp_row<WalkRow<kWide>>(lf_of<V, kWide>(x, r, tab, t), t.bwt_len);
    ++steps;
    return false;
  }
  *out = ends ? text_pos_of(sa, steps, t.bwt_len) : -1;
  return true;
}

// One LF step of a shard's walk (sampled_walk_shard) at an owned, unsampled
// row: one round trip, its row read from the window.  Returns whether the
// walk leaves the shard: the new row is sampled, lies outside the window,
// or the walk has taken bwt_len steps in all.
template <int V>
__device__ __forceinline__ bool shard_step(const WalkTables& t, const RowSampling& smp, const CodeStep* tab,
                                           const ShardWalk& w, uint32_t& pos, uint32_t& steps) {
  RowAt r = row_at(t.blocks, t.nbits, t.row_words, pos);
  r.row = t.blocks + (int64_t)(r.blk - w.first_block) * t.row_words;
  RowWords<V> x;
  load_row<V, true>(r, x);
  pos = clamp_row(lf_of<V>(x, r, tab, t), t.bwt_len);
  ++steps;
  return smp.sampled(pos) || (pos >> 8) - w.first_block >= w.local_blocks || (int64_t)steps >= t.bwt_len;
}

// The marked walks' stop rule: a marked row, or the walk's last visit
// (steps == mark_ratio - 1); eager: whether a visit reads its row's planes
// beside its mark word (one round trip per step, the planes wasted on the
// final visit) or after it (two, the marked walk's parent schedule).
struct MarkedWalk {
  int mark_offset;
  int mark_ratio;
  int eager;
};

// What a marked walk's lane reads on its next iteration: its row's mark
// word (kProbe; eager: with the planes and milestones), the planes and
// milestones of a row found unmarked (kPlanes, lazy only), the final row's
// mark words and mark milestone (kMarks), or its SA word (kRead: pos then
// holds the word's index).
enum MarkedPhase : uint32_t { kProbe, kPlanes, kMarks, kRead };

// A visit's loaded words: a row's planes and milestones, or its mark words
// (one lane reads one of them per iteration, so they share registers).
template <int V>
union VisitWords {
  RowWords<V> row;
  MarkWords marks;
};

// Row 0's walk in a range-fed launch: its text position and a flag, both in
// the launch's cursor buffer (words 2 and 3), set once by the lane that
// walked it and read by every warp before it writes idle slots.
__device__ __forceinline__ void publish_idle(unsigned long long* cursor, int64_t value) {
  atomicExch(cursor + 2, (unsigned long long)value);
  __threadfence();
  atomicExch(cursor + 3, 1ull);
}

__device__ __forceinline__ int64_t await_idle(unsigned long long* cursor) {
  while (atomicAdd(cursor + 3, 0ull) == 0) __nanosleep(200);
  __threadfence();
  return (int64_t)atomicAdd(cursor + 2, 0ull);
}

// One lane's iteration of a marked walk: one round trip, the loads of its
// phase.  A probe that finds the row marked, or on the walk's last visit,
// moves to kMarks; an eager probe of an unmarked row steps at once (LF, the
// sentinel row stepping to 0, clamped into the table as row_at does), a
// lazy one moves to kPlanes, which steps.  kMarks turns the final row's
// mark rank (31 bits of it narrow, as backstep packs it; clamped into the
// marked SA) into the SA word's index; kRead writes the text position (to
// out[slot], or published as the idle value) and ends the walk.
template <int V, bool kWide>
__device__ __forceinline__ void marked_step(const WalkTables& t, const MarkedWalk& mw, const CodeStep* tab,
                                            bool& walking, uint32_t& phase, WalkRow<kWide>& pos,
                                            WalkRow<kWide>& steps, int64_t slot, int64_t* __restrict__ out,
                                            unsigned long long* cursor) {
  const bool read = walking && phase == kRead;
  const bool probe = walking && phase == kProbe;
  const bool planes = walking && (phase == kPlanes || (probe && mw.eager));
  const bool marks = walking && phase == kMarks;
  const RowAt r = row_at(t.blocks, t.nbits, t.row_words, read ? 0 : (int64_t)pos);
  int64_t sa = 0;
  uint32_t word = 0;
  VisitWords<V> x;
  if (read) sa = sa_at<kWide>(t, (int64_t)pos);
  if (probe) word = __ldg(r.row + mw.mark_offset + r.word);
  if (planes) load_row<V, true>(r, x.row);  // upper halves on demand: < 1 % either way
  if (marks) load_marks<kWide>(r, mw.mark_offset, x.marks, t);
  if (read) {
    const int64_t v = text_pos_of(sa, steps, t.bwt_len);
    if (slot >= 0) {
      out[slot] = v;
    } else {
      publish_idle(cursor, v);
    }
    walking = false;
  } else if (marks) {
    const MarkRank<kWide> rank = mark_rank_of<kWide>(x.marks, r);
    int64_t idx;
    if constexpr (kWide) {
      idx = rank < 0 ? 0 : (rank >= t.sa_len ? t.sa_len - 1 : rank);
    } else {
      idx = (int64_t)(rank & 0x7FFFFFFFu);
      idx = idx >= t.sa_len ? t.sa_len - 1 : idx;
    }
    pos = (WalkRow<kWide>)idx;
    phase = kRead;
  } else if (probe && (((word >> r.bit) & 1u) || (int64_t)steps + 1 >= mw.mark_ratio)) {
    phase = kMarks;
  } else if (planes) {
    pos = clamp_row<WalkRow<kWide>>(lf_of<V, kWide>(x.row, r, tab, t), t.nbits);
    ++steps;
    phase = kProbe;
  } else if (probe) {
    phase = kPlanes;
  }
}

// A tile of 32 queries, one per lane: the lane's query start, its live
// slots, min(count, cap) (one row each for the flat-row entry; for a shard,
// one if the row is live in its window), and a shard row's steps so far.
struct TileQuery {
  int64_t start;
  uint32_t live;
  uint32_t steps;
};

template <Feed kFeed, class Smp>
__device__ __forceinline__ TileQuery tile_query(int64_t tile, const int64_t* __restrict__ starts,
                                                const int64_t* __restrict__ counts, int64_t nq, int cap,
                                                unsigned lane, const ShardWalk& w, const Smp& smp,
                                                int64_t bwt_len) {
  const int64_t q = tile * 32 + lane;
  if (q >= nq) return {0, 0, 0};
  if constexpr (kFeed == Feed::kRows) return {starts[q], 1, 0};
  if constexpr (kFeed == Feed::kShard) {
    const uint32_t row = clamp_row(w.rows[q], bwt_len);
    const int64_t steps = w.steps[q];
    const bool live = !smp.sampled(row) && (row >> 8) - w.first_block < w.local_blocks && steps < bwt_len;
    return {row, live ? 1u : 0u, (uint32_t)steps};
  }
  const int64_t c = counts[q];
  return {starts[q], (uint32_t)(c < 0 ? 0 : (c > cap ? cap : c)), 0};
}

// What ends a lane's walk: a sampled row (the row-sampled walks) or a
// marked row or the walk's last visit (the marked walks).
enum class Stop { kSampled, kMarked };

// The walks of nq queries' live slots into out[nq, cap] (flat rows: kRows,
// starts = rows, cap = 1; a shard's rows: kShard, the rows and steps of w
// walked in place, cap = 1), by persistent warps that refill lanes as walks
// end (the head of this file).  The marked stop rule (kMarked: mw) runs on
// the range feed only.  cursor: 64-bit counters, zero (one; four for a
// marked walk: the tile claims, the idle pass's claims, and row 0's walk
// and its flag).
template <int V, Stop kStop, Feed kFeed, bool kWide>
__global__ void __launch_bounds__(kThreads) walk_kernel(
    const WalkTables t, const Sampling<kWide> smp, const MarkedWalk mw, const int64_t* __restrict__ starts,
    const int64_t* __restrict__ counts, int64_t nq, int cap, unsigned long long* __restrict__ cursor,
    int64_t* __restrict__ out, const ShardWalk w) {
  constexpr bool kRanges = kFeed == Feed::kRanges;
  constexpr bool kMarked = kStop == Stop::kMarked;
  __shared__ CodeStep tab[1 << V];
  load_code_steps<V>(tab, t.prefix_sums, t.codes, t.c2i, t.ambiguity_idx);
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  const int64_t ntiles = (nq + 31) >> 5;
  // A sampled walk's idle slot holds the walk of row 0, which is sampled.
  const int64_t idle = kRanges && !kMarked ? text_pos_of(sa_at<kWide>(t, 0), 0, t.bwt_len) : 0;
  // A marked walk's rows clamp into the table (row_at); a sampled walk's
  // below bwt_len.
  const int64_t row_limit = kMarked ? t.nbits : t.bwt_len;

  // The next tile (claimed, its queries loading) and the claim of the one
  // after it run a tile ahead of the tile being handed out.
  unsigned long long claim = 0;
  if (lane == 0) claim = atomicAdd(cursor, 1ull);
  int64_t next_tile = (int64_t)__shfl_sync(kFull, claim, 0);
  TileQuery next_q = tile_query<kFeed>(next_tile, starts, counts, nq, cap, lane, w, smp, t.bwt_len);
  if (lane == 0) claim = atomicAdd(cursor, 1ull);

  int64_t tile = 0;
  TileQuery cur = {0, 0};
  uint32_t incl = 0;       // live slots of the tile's queries up to this lane's
  uint32_t tile_live = 0;  // live slots of the tile
  uint32_t handed = 0;     // of them, handed to lanes
  bool more = true;        // tiles left to claim
  bool walking = false;
  WalkRow<kWide> pos = 0, steps = 0;
  int64_t slot = 0;
  uint32_t phase = kProbe;
  // A range-fed marked walk: lane 0 of the warp that claimed tile 0 walks
  // row 0 first, once for the launch; its position fills the idle slots.
  if (kMarked && kRanges && next_tile == 0 && lane == 0) {
    walking = true;
    slot = -1;
  }
  for (;;) {
    unsigned free_lanes = __ballot_sync(kFull, !walking);
    // A marked walk's warp hands out slots only once all its lanes are free
    // (a tile walked in lockstep): faster than per free lane (PERF.md).
    if (kMarked && free_lanes != kFull) free_lanes = 0;
    while (free_lanes && more) {
      if (handed == tile_live) {
        if (next_tile >= ntiles) {
          more = false;
          break;
        }
        tile = next_tile;
        cur = next_q;
        incl = cur.live;
#pragma unroll
        for (unsigned d = 1; d < 32; d <<= 1) {
          const uint32_t v = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += v;
        }
        tile_live = __shfl_sync(kFull, incl, 31);
        handed = 0;
        if (kRanges && !kMarked) {
          // The tile's idle slots, in order: a coalesced pass of cap stores per lane.
          for (int s = lane; s < 32 * cap; s += 32) {
            const unsigned ql = (unsigned)(s / cap);
            const uint32_t live = __shfl_sync(kFull, cur.live, ql);
            if (tile * 32 + ql < nq && (uint32_t)(s - (int)ql * cap) >= live) out[tile * 32 * cap + s] = idle;
          }
        }
        next_tile = (int64_t)__shfl_sync(kFull, claim, 0);
        next_q = tile_query<kFeed>(next_tile, starts, counts, nq, cap, lane, w, smp, t.bwt_len);
        if (lane == 0) claim = atomicAdd(cursor, 1ull);
        continue;
      }
      // Free lanes take the tile's next live slots in lane order; slot
      // `want` belongs to the first query whose inclusive count exceeds it.
      const uint32_t want = handed + __popc(free_lanes & below);
      unsigned q = 0;
#pragma unroll
      for (unsigned s = 16; s; s >>= 1) {
        if (__shfl_sync(kFull, incl, q + s - 1) <= want) q += s;
      }
      const uint32_t before = __shfl_sync(kFull, incl - cur.live, q);
      const int64_t start = __shfl_sync(kFull, cur.start, q);
      uint32_t steps0 = 0;
      if constexpr (kFeed == Feed::kShard) steps0 = __shfl_sync(kFull, cur.steps, q);
      if (!walking && want < tile_live) {
        const uint32_t j = want - before;
        pos = clamp_row<WalkRow<kWide>>(start + j, row_limit);
        steps = steps0;
        slot = (tile * 32 + q) * cap + j;
        phase = kProbe;
        walking = true;
      }
      handed = min(tile_live, handed + __popc(free_lanes));
      free_lanes = __ballot_sync(kFull, !walking);
    }
    if constexpr (kMarked) {
      if (!__any_sync(kFull, walking)) break;
      marked_step<V, kWide>(t, mw, tab, walking, phase, pos, steps, slot, out, cursor);
    } else if constexpr (kFeed == Feed::kShard) {
      if (!__any_sync(kFull, walking)) break;
      if (walking && shard_step<V>(t, smp, tab, w, pos, steps)) {
        w.rows[slot] = pos;
        w.steps[slot] = steps;
        walking = false;
      }
    } else {
      if (!__any_sync(kFull, walking)) break;
      if (walking && sampled_step<V, kWide>(t, smp, tab, pos, steps, out + slot)) walking = false;
    }
  }
  if constexpr (kMarked && kRanges) {
    // The idle slots, tile by tile (claims on cursor[1]), once row 0's walk
    // has ended: a coalesced pass of cap stores per lane.
    unsigned long long value = 0;
    if (lane == 0) value = (unsigned long long)await_idle(cursor);
    const int64_t row0 = (int64_t)__shfl_sync(kFull, value, 0);
    for (;;) {
      unsigned long long c = 0;
      if (lane == 0) c = atomicAdd(cursor + 1, 1ull);
      const int64_t it = (int64_t)__shfl_sync(kFull, c, 0);
      if (it >= ntiles) break;
      const uint32_t live = tile_query<kFeed>(it, starts, counts, nq, cap, lane, w, smp, t.bwt_len).live;
      for (int s = lane; s < 32 * cap; s += 32) {
        const unsigned ql = (unsigned)(s / cap);
        const uint32_t ql_live = __shfl_sync(kFull, live, ql);
        if (it * 32 + ql < nq && (uint32_t)(s - (int)ql * cap) >= ql_live) out[it * 32 * cap + s] = row0;
      }
    }
  }
}

WalkTables walk_tables(const void* blocks, int64_t num_blocks, int row_words, const void* prefix_sums,
                       const void* codes, const void* c2i, int ambiguity_idx, const void* sa,
                       int64_t sa_len, int64_t bwt_len) {
  return {(const uint32_t*)blocks, num_blocks * 256, row_words, (const int64_t*)prefix_sums,
          (const int32_t*)codes, (const int32_t*)c2i, ambiguity_idx, (const uint32_t*)sa, sa_len,
          bwt_len};
}

unsigned blocks_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

constexpr int kMaxDevices = 64;

// The persistent grid: as many blocks as fit the card at once, no more
// than the tiles need.  `fit` caches the card's count per device, so the
// runtime is asked once per kernel and device, not on every launch.
template <class Kernel>
unsigned persistent_grid(Kernel kernel, int device, std::atomic<int> (&fit)[kMaxDevices], int64_t nq) {
  int resident = device < kMaxDevices ? fit[device].load(std::memory_order_relaxed) : 0;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
    if (device < kMaxDevices) fit[device].store(resident, std::memory_order_relaxed);
  }
  const int64_t need = ((nq + 31) / 32 + kWarps - 1) / kWarps;
  return (unsigned)(need < resident ? need : resident);
}

template <int V, Stop kStop, Feed kFeed, bool kWide>
void launch_walk_kernel(int device, const WalkTables& t, uint64_t sa_ratio, const MarkedWalk& mw, const void* starts,
                        const void* counts, int64_t nq, int cap, void* cursor, void* out, const ShardWalk& w,
                        cudaStream_t st) {
  static std::atomic<int> fit[kMaxDevices];
  auto kernel = walk_kernel<V, kStop, kFeed, kWide>;
  kernel<<<persistent_grid(kernel, device, fit, nq), kThreads, 0, st>>>(
      t, Sampling<kWide>::of(sa_ratio), mw, (const int64_t*)starts, (const int64_t*)counts, nq, cap,
      (unsigned long long*)cursor, (int64_t*)out, w);
}

void set_device(int device) {
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) cudaSetDevice(device);
}

// The wide tables of a WalkTables: the group bases and the int64 SA values.
WalkTables widen(WalkTables t, int card, const void* ms_base, const void* mark_base, int group_shift,
                 const void* sa64) {
  t.card = card;
  t.ms_base = (const int64_t*)ms_base;
  t.mark_base = (const int64_t*)mark_base;
  t.group_shift = group_shift;
  t.sa64 = (const int64_t*)sa64;
  return t;
}

// Shared memory a block of backstep stages its tiles in: below the 48 KB a
// block takes without opting in (the step table and barriers beside it).
constexpr int kStageBudget = 46 << 10;

template <bool kWide>
int launch_backstep(int device, const WalkTables& t, int nplanes, int mark_offset, const void* rows, int64_t n,
                    void* stepped, void* mark, void* stream) {
  set_device(device);
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0) {
    // As many warps per block as their tiles fit kStageBudget: 8
    // nucleotide, 4 amino.
    const int tile_bytes = 32 * staged_words(t.row_words) * (int)sizeof(uint32_t);
    const int fit = kStageBudget / tile_bytes;
    const int warps = fit < kWarps ? fit : kWarps;
    if (warps < 1) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((n + 32 * warps - 1) / (32 * warps));
    const size_t smem = (size_t)warps * tile_bytes;
    if (nplanes == 3) {
      backstep_kernel<3, kWide><<<grid, 32 * warps, smem, st>>>(t, mark_offset, (const int64_t*)rows, n,
                                                                (int64_t*)stepped, (MarkRank<kWide>*)mark);
    } else if (nplanes == 5) {
      backstep_kernel<5, kWide><<<grid, 32 * warps, smem, st>>>(t, mark_offset, (const int64_t*)rows, n,
                                                                (int64_t*)stepped, (MarkRank<kWide>*)mark);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// A walk of either stop rule: the flat-row walk (kRows; starts = rows,
// counts unused), the range-fed walk, or a shard's walk in place (kShard:
// w).  sa_ratio: the sampled walks' (1 for the marked walks); mw: the
// marked walks' stop rule.
template <Stop kStop, Feed kFeed, bool kWide>
int launch_walk(int device, const WalkTables& t, int nplanes, uint64_t sa_ratio, const MarkedWalk& mw,
                const void* starts, const void* counts, int64_t nq, int cap, void* cursor, void* out, void* stream,
                const ShardWalk& w = {}) {
  set_device(device);
  cudaStream_t st = (cudaStream_t)stream;
  if (nq > 0) {
    if (nplanes == 3) {
      launch_walk_kernel<3, kStop, kFeed, kWide>(device, t, sa_ratio, mw, starts, counts, nq, cap, cursor, out, w, st);
    } else if (nplanes == 5) {
      launch_walk_kernel<5, kStop, kFeed, kWide>(device, t, sa_ratio, mw, starts, counts, nq, cap, cursor, out, w, st);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

template <Feed kFeed, bool kWide>
int launch_sampled_walk(int device, const WalkTables& t, int nplanes, uint64_t sa_ratio, const void* starts,
                        const void* counts, int64_t nq, int cap, void* cursor, void* out, void* stream,
                        const ShardWalk& w = {}) {
  return launch_walk<Stop::kSampled, kFeed, kWide>(device, t, nplanes, sa_ratio, {}, starts, counts, nq, cap, cursor,
                                                   out, stream, w);
}

template <bool kWide>
int launch_marked_walk(int device, const WalkTables& t, int nplanes, int mark_offset, int mark_ratio,
                       const void* rows, int64_t n, void* text_pos, void* stream) {
  set_device(device);
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0) {
    if (nplanes == 3) {
      marked_walk_kernel<3, kWide><<<blocks_for(n), kThreads, 0, st>>>(t, mark_offset, mark_ratio,
                                                                       (const int64_t*)rows, n, (int64_t*)text_pos);
    } else if (nplanes == 5) {
      marked_walk_kernel<5, kWide><<<blocks_for(n), kThreads, 0, st>>>(t, mark_offset, mark_ratio,
                                                                       (const int64_t*)rows, n, (int64_t*)text_pos);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

template <bool kWide>
int launch_marked_walk_ranges(int device, const WalkTables& t, int nplanes, int mark_offset, int mark_ratio,
                              int eager, const void* starts, const void* counts, int64_t nq, int cap, void* cursor,
                              void* out, void* stream) {
  return launch_walk<Stop::kMarked, Feed::kRanges, kWide>(device, t, nplanes, 1, {mark_offset, mark_ratio, eager},
                                                          starts, counts, nq, cap, cursor, out, stream);
}

}  // namespace

// Each entry launches on `stream` (the caller's current PyTorch stream) and
// returns cudaGetLastError() so a refused launch is reported to the caller.
extern "C" int awry_backstep(int device, const void* blocks, int64_t num_blocks, int row_words,
                             int nplanes, const void* prefix_sums, const void* codes,
                             const void* c2i, int mark_offset, int ambiguity_idx,
                             const void* rows, int64_t n, void* stepped, void* mark,
                             void* stream) {
  const WalkTables t = walk_tables(blocks, num_blocks, row_words, prefix_sums, codes, c2i, ambiguity_idx,
                                   nullptr, 0, 0);
  return launch_backstep<false>(device, t, nplanes, mark_offset, rows, n, stepped, mark, stream);
}

extern "C" int awry_marked_walk(int device, const void* blocks, int64_t num_blocks, int row_words,
                                int nplanes, const void* prefix_sums, const void* codes,
                                const void* c2i, int mark_offset, int ambiguity_idx,
                                int mark_ratio, const void* sampled_sa, int64_t sa_len,
                                int64_t bwt_len, const void* rows, int64_t n, void* text_pos,
                                void* stream) {
  const WalkTables t = walk_tables(blocks, num_blocks, row_words, prefix_sums, codes, c2i,
                                   ambiguity_idx, sampled_sa, sa_len, bwt_len);
  return launch_marked_walk<false>(device, t, nplanes, mark_offset, mark_ratio, rows, n, text_pos, stream);
}

// The range-fed marked walk (starts, counts: int64[nq]; out int64[nq,
// cap]); eager: read a row's planes with its mark word (MarkedWalk);
// cursor: four zeroed 64-bit counters.
extern "C" int awry_marked_walk_ranges(int device, const void* blocks, int64_t num_blocks, int row_words,
                                       int nplanes, const void* prefix_sums, const void* codes,
                                       const void* c2i, int mark_offset, int ambiguity_idx,
                                       int mark_ratio, int eager, const void* sampled_sa, int64_t sa_len,
                                       int64_t bwt_len, const void* starts, const void* counts, int64_t nq, int cap,
                                       void* cursor, void* out, void* stream) {
  const WalkTables t = walk_tables(blocks, num_blocks, row_words, prefix_sums, codes, c2i,
                                   ambiguity_idx, sampled_sa, sa_len, bwt_len);
  return launch_marked_walk_ranges<false>(device, t, nplanes, mark_offset, mark_ratio, eager, starts, counts, nq,
                                          cap, cursor, out, stream);
}

// The flat-row walk (rows: int64[n]) and the range-fed walk (starts,
// counts: int64[nq]; out int64[nq, cap]); cursor: a zeroed 64-bit counter.
extern "C" int awry_sampled_walk(int device, const void* blocks, int64_t num_blocks, int row_words,
                                 int nplanes, const void* prefix_sums, const void* codes,
                                 const void* c2i, int ambiguity_idx, uint32_t sa_ratio,
                                 const void* sampled_sa, int64_t sa_len, int64_t bwt_len,
                                 const void* rows, int64_t n, void* cursor, void* text_pos, void* stream) {
  const WalkTables t = walk_tables(blocks, num_blocks, row_words, prefix_sums, codes, c2i,
                                   ambiguity_idx, sampled_sa, sa_len, bwt_len);
  return launch_sampled_walk<Feed::kRows, false>(device, t, nplanes, sa_ratio, rows, nullptr, n, 1, cursor, text_pos,
                                          stream);
}

extern "C" int awry_sampled_walk_ranges(int device, const void* blocks, int64_t num_blocks, int row_words,
                                        int nplanes, const void* prefix_sums, const void* codes,
                                        const void* c2i, int ambiguity_idx, uint32_t sa_ratio,
                                        const void* sampled_sa, int64_t sa_len, int64_t bwt_len,
                                        const void* starts, const void* counts, int64_t nq, int cap,
                                        void* cursor, void* out, void* stream) {
  const WalkTables t = walk_tables(blocks, num_blocks, row_words, prefix_sums, codes, c2i,
                                   ambiguity_idx, sampled_sa, sa_len, bwt_len);
  return launch_sampled_walk<Feed::kRanges, false>(device, t, nplanes, sa_ratio, starts, counts, nq, cap, cursor, out,
                                           stream);
}

// The shard walk: blocks holds the local_blocks rows of blocks [first_block,
// first_block + local_blocks) of a table of total_blocks; rows and steps
// (int64 [n]) are walked in place; cursor: a zeroed 64-bit counter.
extern "C" int awry_sampled_walk_shard(int device, const void* blocks, int64_t local_blocks, int64_t first_block,
                                       int64_t total_blocks, int row_words, int nplanes, const void* prefix_sums,
                                       const void* codes, const void* c2i, int ambiguity_idx, uint32_t sa_ratio,
                                       int64_t bwt_len, void* rows, void* steps, int64_t n, void* cursor,
                                       void* stream) {
  const WalkTables t = walk_tables(blocks, total_blocks, row_words, prefix_sums, codes, c2i, ambiguity_idx,
                                   nullptr, 0, bwt_len);
  const ShardWalk w{(int64_t*)rows, (int64_t*)steps, (uint32_t)first_block, (uint32_t)local_blocks};
  return launch_sampled_walk<Feed::kShard, false>(device, t, nplanes, sa_ratio, nullptr, nullptr, n, 1, cursor,
                                                  nullptr, stream, w);
}

// The wide variants: the same arguments as their narrow twins, with card,
// ms_base (int64 [groups, card]), mark_base (int64 [groups]; the walks
// without marks pass none) and group_shift after c2i; SA values int64;
// backstep's mark output int64; sa_ratio 64-bit.
extern "C" int awry_backstep_wide(int device, const void* blocks, int64_t num_blocks, int row_words,
                                  int nplanes, const void* prefix_sums, const void* codes,
                                  const void* c2i, int card, const void* ms_base, const void* mark_base,
                                  int group_shift, int mark_offset, int ambiguity_idx, const void* rows,
                                  int64_t n, void* stepped, void* mark, void* stream) {
  const WalkTables t = widen(walk_tables(blocks, num_blocks, row_words, prefix_sums, codes, c2i, ambiguity_idx,
                                         nullptr, 0, 0),
                             card, ms_base, mark_base, group_shift, nullptr);
  return launch_backstep<true>(device, t, nplanes, mark_offset, rows, n, stepped, mark, stream);
}

extern "C" int awry_marked_walk_wide(int device, const void* blocks, int64_t num_blocks, int row_words,
                                     int nplanes, const void* prefix_sums, const void* codes,
                                     const void* c2i, int card, const void* ms_base, const void* mark_base,
                                     int group_shift, int mark_offset, int ambiguity_idx, int mark_ratio,
                                     const void* sampled_sa, int64_t sa_len, int64_t bwt_len, const void* rows,
                                     int64_t n, void* text_pos, void* stream) {
  const WalkTables t = widen(walk_tables(blocks, num_blocks, row_words, prefix_sums, codes, c2i, ambiguity_idx,
                                         nullptr, sa_len, bwt_len),
                             card, ms_base, mark_base, group_shift, sampled_sa);
  return launch_marked_walk<true>(device, t, nplanes, mark_offset, mark_ratio, rows, n, text_pos, stream);
}

extern "C" int awry_marked_walk_ranges_wide(int device, const void* blocks, int64_t num_blocks, int row_words,
                                            int nplanes, const void* prefix_sums, const void* codes,
                                            const void* c2i, int card, const void* ms_base, const void* mark_base,
                                            int group_shift, int mark_offset, int ambiguity_idx, int mark_ratio,
                                            int eager, const void* sampled_sa, int64_t sa_len, int64_t bwt_len,
                                            const void* starts, const void* counts, int64_t nq, int cap,
                                            void* cursor, void* out, void* stream) {
  const WalkTables t = widen(walk_tables(blocks, num_blocks, row_words, prefix_sums, codes, c2i, ambiguity_idx,
                                         nullptr, sa_len, bwt_len),
                             card, ms_base, mark_base, group_shift, sampled_sa);
  return launch_marked_walk_ranges<true>(device, t, nplanes, mark_offset, mark_ratio, eager, starts, counts, nq, cap,
                                         cursor, out, stream);
}

extern "C" int awry_sampled_walk_wide(int device, const void* blocks, int64_t num_blocks, int row_words,
                                      int nplanes, const void* prefix_sums, const void* codes,
                                      const void* c2i, int card, const void* ms_base, int group_shift,
                                      int ambiguity_idx, uint64_t sa_ratio, const void* sampled_sa,
                                      int64_t sa_len, int64_t bwt_len, const void* rows, int64_t n,
                                      void* cursor, void* text_pos, void* stream) {
  const WalkTables t = widen(walk_tables(blocks, num_blocks, row_words, prefix_sums, codes, c2i, ambiguity_idx,
                                         nullptr, sa_len, bwt_len),
                             card, ms_base, nullptr, group_shift, sampled_sa);
  return launch_sampled_walk<Feed::kRows, true>(device, t, nplanes, sa_ratio, rows, nullptr, n, 1, cursor, text_pos,
                                         stream);
}

extern "C" int awry_sampled_walk_ranges_wide(int device, const void* blocks, int64_t num_blocks, int row_words,
                                             int nplanes, const void* prefix_sums, const void* codes,
                                             const void* c2i, int card, const void* ms_base, int group_shift,
                                             int ambiguity_idx, uint64_t sa_ratio, const void* sampled_sa,
                                             int64_t sa_len, int64_t bwt_len, const void* starts,
                                             const void* counts, int64_t nq, int cap, void* cursor, void* out,
                                             void* stream) {
  const WalkTables t = widen(walk_tables(blocks, num_blocks, row_words, prefix_sums, codes, c2i, ambiguity_idx,
                                         nullptr, sa_len, bwt_len),
                             card, ms_base, nullptr, group_shift, sampled_sa);
  return launch_sampled_walk<Feed::kRanges, true>(device, t, nplanes, sa_ratio, starts, counts, nq, cap, cursor, out,
                                          stream);
}
