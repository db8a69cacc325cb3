// occ_pair: (Occ(pos_a[i], sym[i]), Occ(pos_b[i], sym[i])) over fused block
// rows, where Occ(p, c) = count of symbol c in BWT[0..=p]; occ: Occ(pos[i],
// sym[i]) alone.
//
// occ_pair replaces awry_tpu/ops/sweep.py:_occ_pair_pay_kernel_anchored (the
// post-seed LF steps of seeded_pair_chain) and its twin
// _occ_pair_kernel_anchored (the same pair with the symbol as an operand:
// unseeded lanes and the classic full-depth re-dispatch).  occ replaces
// _occ_kernel_anchored and its blocked twin _occ_kernel (occurrence_sweep:
// one rank per request), which the device k-mer build runs: each level ranks
// the concatenation [starts - 1, ends] of its range updates in one batch.
//
// A fused row holds V 256-bit occurrence planes (V*8 words; V = 3 for
// nucleotide, 5 for amino) followed by the block's per-symbol milestones
// (40 words per nucleotide row, 72 per amino row).  Occ = milestone[sym] +
// popcount of the AND over planes of (plane ^ polarity(sym's code bit v)),
// masked to the bits [0..=p & 255] of the block (inclusive).  A row's rank
// part is 2V 16 B plane pieces (piece u: plane u >> 1, words 4(u & 1)..+3)
// and the milestone word.
//
// What bounds them on the H100 (NVIDIA H100 80GB HBM3 at 700 W; each build
// timed in turns with chip_smoke.py's time_ms, the L2 flushed by a 128 MB
// write before each launch; scripts/rank_kernel_study.py, PERF.md §6).  The
// first design ran one thread per request, loaded each plane sector as two
// 16 B halves (a warp instruction touched 32 rows) and read a row twice
// when both endpoints shared a block (94-99.5 % of serving requests).  Cut
// down to its request/result I/O and to I/O + row loads:
// - occ_pair at the chr1 and GRCh38 rank steps (524,288 requests):
//   0.077-0.104 ms, I/O + row loads 0.064-0.098, I/O alone 0.013-0.056:
//   the row loads hold it.
// - occ over the k-mer build's 21 full chunks (8,388,608 requests each):
//   2.216 ms summed, I/O alone 1.424 (134 MB per chunk).  At level 11 (the
//   chunk chip_smoke times) each half holds 4 symbol runs, each sorted over
//   the whole table, so the chunk sweeps the 40 MB of rows 8 times, and the
//   request and result streams push the rows out of L2 between sweeps:
//   0.199 ms against 0.078 of I/O.
//
// Design.  One rank core serves three callers: 16 B pieces ANDed per half
// under the symbol's polarity, and an inclusive masked popcount per half.
// - occ_pair: a pair of lanes serves one request (4 lanes measured no
//   better).  Lane 0 loads the request, clamps it
//   and broadcasts its rows, offsets, symbol and code; lane h loads the
//   pieces of half h, so each warp instruction reads whole 32 B sectors,
//   and the lanes add their halves' counts with __shfl_xor_sync.  When
//   both endpoints lie in one block the row is read and ANDed once and
//   only the two masks and popcounts differ.
// - occ: a CTA takes a tile of kOccTile consecutive requests and finds the
//   lowest and highest block they touch with one block reduction.  When that
//   span fits the stage (kStageRows: 320 nucleotide, 169 amino rows in 46 KB)
//   the rows' rank parts are copied in once with cp.async (16 B per thread),
//   and each thread ranks from shared memory; otherwise (random positions)
//   the CTA gathers each request's row with occ_pair's cooperative loads.
//   The choice is per CTA, inside the kernel; both branches are exact.
//   CTAs are dispatched interleaved over kOccSegments equal segments of the
//   batch, so the k-mer build's sorted runs (8 per level-11 chunk; the
//   [starts - 1] and [ends] halves of every chunk) sweep the table together
//   and each row comes from HBM about once.  Request and result streams
//   carry evict-first hints (__ldcs / __stcs) so that they do not push the
//   rows out of L2.  The mapping of CTAs to tiles changes no answer.
//   Summed over the 21 chunks: 2.138 ms; 2.203 without the interleave (it
//   buys level 11, 0.134 against 0.191, and ties levels 12-13); 2.693 with
//   neither staging nor interleave.
// Positions are clamped into the table (pos_a = start-1 is -1 only on lanes
// the caller masks) and symbols into the alphabet.
//
// ptxas (sm_90a, -Xptxas=-v): occ_pair 32 registers (V = 3) and 36 (V = 5);
// occ 56 and 61 registers, 46,144 and 46,032 bytes of shared memory.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kOccPerThread = 4;
constexpr int kOccTile = kThreads * kOccPerThread;
constexpr int kOccSegments = 8;     // segments of an occ batch whose CTAs interleave
constexpr int kStageBytes = 46080;  // under the 48 KB of static shared memory
constexpr unsigned kFull = 0xFFFFFFFFu;

// 16 B pieces of a row's rank part staged per row (planes and milestones:
// 30 words nucleotide, 62 amino), and the stage's row stride in pieces (one
// more, so that rows in one quarter-warp fall on different banks).
template <int V>
constexpr int kRankPieces = V == 3 ? 8 : 16;
template <int V>
constexpr int kStageStride = kRankPieces<V> + 1;
// Rows a CTA may stage: 320 nucleotide, 169 amino.
template <int V>
constexpr int kStageRows = kStageBytes / (16 * kStageStride<V>);

// Request and result streams are read and written once: with evict-first
// hints they do not push the rows out of L2 (the k-mer build ranks over the
// same rows chunk after chunk).
__device__ __forceinline__ int64_t load_once(const int64_t* p) {
  return (int64_t)__ldcs(reinterpret_cast<const long long*>(p));
}
__device__ __forceinline__ int32_t load_once(const int32_t* p) { return __ldcs(p); }
__device__ __forceinline__ void store_once(uint32_t* p, uint32_t v) { __stcs(p, v); }

__device__ __forceinline__ uint4 ones4() { return make_uint4(kFull, kFull, kFull, kFull); }

// All ones where sym's code bit for plane v is clear (a zero code bit
// matches a zero plane bit: the plane is flipped), else zero.
__device__ __forceinline__ uint32_t polarity(uint32_t code, uint32_t v) { return ((code >> v) & 1u) - 1u; }

__device__ __forceinline__ uint4 and_xor(uint4 acc, uint4 w, uint32_t pol) {
  acc.x &= w.x ^ pol;
  acc.y &= w.y ^ pol;
  acc.z &= w.z ^ pol;
  acc.w &= w.w ^ pol;
  return acc;
}

// Popcount of half h (words 4h..4h+3) of a block's ANDed planes, masked to
// the bits [0..=local] of the block.
__device__ __forceinline__ uint32_t half_count(uint4 a, uint32_t h, uint32_t local) {
  const uint32_t word = local >> 5;
  const uint32_t in_word = kFull >> (31u - (local & 31u));
  const uint32_t w0 = h * 4u;
  uint32_t m[4];
#pragma unroll
  for (uint32_t c = 0; c < 4; ++c) m[c] = w0 + c < word ? kFull : (w0 + c == word ? in_word : 0u);
  return __popc(a.x & m[0]) + __popc(a.y & m[1]) + __popc(a.z & m[2]) + __popc(a.w & m[3]);
}

// -- the cooperative gather: a pair of lanes per request ---------------------

// The AND over planes of half h of one row under sym's polarity: lane h of
// a pair loads pieces h, h + 2, ..., so the pair reads whole 32 B sectors.
template <int V>
__device__ __forceinline__ uint4 half_and(const uint32_t* __restrict__ row, uint32_t h, uint32_t code) {
  uint4 acc = ones4();
#pragma unroll
  for (int v = 0; v < V; ++v) acc = and_xor(acc, __ldg(reinterpret_cast<const uint4*>(row) + 2 * v + h), polarity(code, v));
  return acc;
}

// One request's clamped operands: block row, block-local position, symbol
// and its occurrence code.
struct Req {
  uint32_t blk, local, sym, code;
};

__device__ __forceinline__ Req make_req(int64_t pos, int s, int64_t nbits, int card,
                                        const int32_t* __restrict__ codes) {
  pos = pos < 0 ? 0 : (pos >= nbits ? nbits - 1 : pos);
  s = s < 0 ? 0 : (s >= card ? card - 1 : s);
  return {(uint32_t)(pos >> 8), (uint32_t)pos & 255u, (uint32_t)s, (uint32_t)__ldg(codes + s)};
}

__device__ __forceinline__ const uint32_t* row_of(const uint32_t* blocks, uint32_t blk, int row_words) {
  return blocks + (int64_t)blk * row_words;
}

// Occ of one request by its pair of lanes (both return it).  All 32 lanes
// of the warp call it together.
template <int V>
__device__ __forceinline__ uint32_t pair_occ(const uint32_t* __restrict__ blocks, int row_words, Req r,
                                             uint32_t h) {
  const uint32_t* row = row_of(blocks, r.blk, row_words);
  const uint32_t ms = __ldg(row + V * 8 + r.sym);
  uint32_t c = half_count(half_and<V>(row, h, r.code), h, r.local);
  c += __shfl_xor_sync(kFull, c, 1, 2);
  return ms + c;
}

template <int V>
__global__ void __launch_bounds__(kThreads) occ_pair_kernel(
    const uint32_t* __restrict__ blocks, int64_t nbits, int row_words, int card,
    const int32_t* __restrict__ codes, const int64_t* __restrict__ pos_a,
    const int64_t* __restrict__ pos_b, const int32_t* __restrict__ sym, int64_t n,
    uint32_t* __restrict__ occ_a, uint32_t* __restrict__ occ_b) {
  const int64_t q = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 1;
  const uint32_t h = threadIdx.x & 1u;
  // Lanes past the end serve the last request again and store nothing, so
  // every lane of the warp takes part in the shuffles.
  const int64_t i = q < n ? q : n - 1;
  // Lane 0 of the pair loads and clamps the request and broadcasts it.
  Req a{}, b{};
  if (h == 0) {
    const int s = load_once(sym + i);
    a = make_req(load_once(pos_a + i), s, nbits, card, codes);
    b = make_req(load_once(pos_b + i), s, nbits, card, codes);
  }
  const uint32_t packed = __shfl_sync(kFull, a.local | (b.local << 8) | (a.sym << 16) | (a.code << 24), 0, 2);
  a.blk = __shfl_sync(kFull, a.blk, 0, 2);
  b.blk = __shfl_sync(kFull, b.blk, 0, 2);
  a.local = packed & 255u;
  b.local = (packed >> 8) & 255u;
  const uint32_t s = (packed >> 16) & 255u, code = packed >> 24;

  // One row read when both endpoints share a block, else two.
  const bool two = a.blk != b.blk;
  const uint32_t* row_a = row_of(blocks, a.blk, row_words);
  const uint32_t* row_b = row_of(blocks, b.blk, row_words);
  const uint32_t ms_a = __ldg(row_a + V * 8 + s);
  const uint32_t ms_b = two ? __ldg(row_b + V * 8 + s) : ms_a;
  const uint4 acc_a = half_and<V>(row_a, h, code);
  const uint4 acc_b = two ? half_and<V>(row_b, h, code) : acc_a;
  uint32_t c = half_count(acc_a, h, a.local) | (half_count(acc_b, h, b.local) << 16);
  c += __shfl_xor_sync(kFull, c, 1, 2);
  if (h == 0 && q < n) {
    store_once(occ_a + q, ms_a + (c & 0xFFFFu));
    store_once(occ_b + q, ms_b + (c >> 16));
  }
}

// -- occ: a staged span or the cooperative gather --------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

template <int V>
__global__ void __launch_bounds__(kThreads) occ_kernel(
    const uint32_t* __restrict__ blocks, int64_t nbits, int row_words, int card,
    const int32_t* __restrict__ codes, const int64_t* __restrict__ pos,
    const int32_t* __restrict__ sym, int64_t n, uint32_t* __restrict__ occ) {
  constexpr int R = kOccPerThread, PR = kRankPieces<V>, SR = kStageStride<V>;
  // The stage (staged branch) and the tile's requests (direct branch) share
  // one buffer.
  constexpr int kStagePieces = kStageRows<V> * SR, kReqPieces = 2 * kOccTile / 4;
  __shared__ uint4 smem[kStagePieces > kReqPieces ? kStagePieces : kReqPieces];
  __shared__ uint32_t lo_w[kThreads / 32], hi_w[kThreads / 32];
  uint4* stage = smem;
  uint32_t* req_blk = reinterpret_cast<uint32_t*>(smem);
  uint32_t* req_rest = req_blk + kOccTile;

  const int t = threadIdx.x;
  // CTA b takes tile (b % S) * L + b / S of the batch's T tiles (L =
  // ceil(T / S)): CTAs that run together take the same stretch of each of
  // the S segments.
  const int64_t tiles = (n + kOccTile - 1) / kOccTile;
  const int64_t seg_len = (tiles + kOccSegments - 1) / kOccSegments;
  const int64_t tile = (blockIdx.x % kOccSegments) * seg_len + blockIdx.x / kOccSegments;
  if (tile >= tiles) return;  // CTA-uniform, before any barrier
  const int64_t base = tile * kOccTile;
  const int tile_n = (int)(n - base < kOccTile ? n - base : kOccTile);

  // The tile's positions and symbols (coalesced, all in flight at once),
  // and the span of blocks the positions touch.
  int64_t p[R];
  int s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = r * kThreads + t;
    p[r] = j < tile_n ? load_once(pos + base + j) : 0;
    s[r] = j < tile_n ? load_once(sym + base + j) : 0;
  }
  uint32_t lo = kFull, hi = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    p[r] = p[r] < 0 ? 0 : (p[r] >= nbits ? nbits - 1 : p[r]);
    if (r * kThreads + t < tile_n) {
      lo = min(lo, (uint32_t)(p[r] >> 8));
      hi = max(hi, (uint32_t)(p[r] >> 8));
    }
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if ((t & 31) == 0) {
    lo_w[t >> 5] = lo;
    hi_w[t >> 5] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    lo = min(lo, lo_w[w]);
    hi = max(hi, hi_w[w]);
  }
  const bool staged = hi - lo < (uint32_t)kStageRows<V>;  // CTA-uniform

  if (staged) {
    // Copy the span's rank parts in (16 B per thread), and look the codes
    // up while the copies fly.
    const int pieces = (int)(hi - lo + 1) * PR;
    for (int j = t; j < pieces; j += kThreads) {
      const int r = j / PR, u = j - r * PR;
      cp_async16(&stage[r * SR + u], reinterpret_cast<const uint4*>(row_of(blocks, lo + r, row_words)) + u);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  Req q[R];
#pragma unroll
  for (int r = 0; r < R; ++r) q[r] = make_req(p[r], s[r], nbits, card, codes);

  if (staged) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = r * kThreads + t;
      if (j >= tile_n) continue;
      const uint4* srow = stage + (q[r].blk - lo) * SR;
      uint4 acc0 = ones4(), acc1 = ones4();
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const uint32_t pol = polarity(q[r].code, v);
        acc0 = and_xor(acc0, srow[2 * v], pol);
        acc1 = and_xor(acc1, srow[2 * v + 1], pol);
      }
      const uint32_t ms = reinterpret_cast<const uint32_t*>(srow)[V * 8 + q[r].sym];
      store_once(occ + base + j, ms + half_count(acc0, 0, q[r].local) + half_count(acc1, 1, q[r].local));
    }
    return;
  }

  // Direct: the tile's requests through shared memory to pairs of lanes.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = r * kThreads + t;
    req_blk[j] = q[r].blk;
    req_rest[j] = q[r].local | (q[r].sym << 8) | (q[r].code << 16);
  }
  __syncthreads();
  const uint32_t h = t & 1;
  for (int j0 = 0; j0 < tile_n; j0 += kThreads / 2) {  // CTA-uniform trip count
    const int j = j0 + (t >> 1);
    const int jc = j < tile_n ? j : tile_n - 1;
    const uint32_t rest = req_rest[jc];
    const Req r{req_blk[jc], rest & 255u, (rest >> 8) & 255u, rest >> 16};
    const uint32_t o = pair_occ<V>(blocks, row_words, r, h);
    if (h == 0 && j < tile_n) store_once(occ + base + j, o);
  }
}

int set_device(int device) {
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) return (int)cudaSetDevice(device);
  return 0;
}

// The staged rank part (V*8 plane words and card milestones) must lie in
// kRankPieces<V> 16 B pieces of the row.
template <int V>
bool rank_part_fits(int row_words, int card) {
  return V * 8 + card <= 4 * kRankPieces<V> && row_words >= 4 * kRankPieces<V>;
}

}  // namespace

// Launches on `stream` (the caller's current PyTorch stream) and returns
// cudaGetLastError() so a refused launch is reported to the caller.
extern "C" int awry_occ_pair(int device, const void* blocks, int64_t num_blocks, int row_words,
                             int nplanes, int card, const void* codes, const void* pos_a,
                             const void* pos_b, const void* sym, int64_t n, void* occ_a,
                             void* occ_b, void* stream) {
  if (int rc = set_device(device)) return rc;
  if (n > 0) {
    const unsigned grid = (unsigned)((n * 2 + kThreads - 1) / kThreads);
    const int64_t nbits = num_blocks * 256;
    cudaStream_t st = (cudaStream_t)stream;
    if (nplanes == 3) {
      occ_pair_kernel<3><<<grid, kThreads, 0, st>>>(
          (const uint32_t*)blocks, nbits, row_words, card, (const int32_t*)codes,
          (const int64_t*)pos_a, (const int64_t*)pos_b, (const int32_t*)sym, n,
          (uint32_t*)occ_a, (uint32_t*)occ_b);
    } else if (nplanes == 5) {
      occ_pair_kernel<5><<<grid, kThreads, 0, st>>>(
          (const uint32_t*)blocks, nbits, row_words, card, (const int32_t*)codes,
          (const int64_t*)pos_a, (const int64_t*)pos_b, (const int32_t*)sym, n,
          (uint32_t*)occ_a, (uint32_t*)occ_b);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int awry_occ(int device, const void* blocks, int64_t num_blocks, int row_words,
                        int nplanes, int card, const void* codes, const void* pos,
                        const void* sym, int64_t n, void* occ, void* stream) {
  if (int rc = set_device(device)) return rc;
  if (n > 0) {
    const int64_t tiles = (n + kOccTile - 1) / kOccTile;
    const unsigned grid = (unsigned)((tiles + kOccSegments - 1) / kOccSegments * kOccSegments);
    const int64_t nbits = num_blocks * 256;
    cudaStream_t st = (cudaStream_t)stream;
    if (nplanes == 3 && rank_part_fits<3>(row_words, card)) {
      occ_kernel<3><<<grid, kThreads, 0, st>>>(
          (const uint32_t*)blocks, nbits, row_words, card, (const int32_t*)codes,
          (const int64_t*)pos, (const int32_t*)sym, n, (uint32_t*)occ);
    } else if (nplanes == 5 && rank_part_fits<5>(row_words, card)) {
      occ_kernel<5><<<grid, kThreads, 0, st>>>(
          (const uint32_t*)blocks, nbits, row_words, card, (const int32_t*)codes,
          (const int64_t*)pos, (const int32_t*)sym, n, (uint32_t*)occ);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
