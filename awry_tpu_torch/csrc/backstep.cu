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
// one thread per row (below).
//
// backstep replaces awry_tpu/ops/sweep.py:_backstep_kernel_anchored as
// backstep_mark_sweep runs it (one visit) and its blocked twin
// _backstep_kernel; marked_walk replaces the same kernel as
// marked_walk_sweep runs it (mark_ratio visits, the glue between them and
// the marked SA read), with the semantics of awry_tpu/ops/locate.py
// _marked_walk.
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
// Bound: device-memory traffic of scattered reads.  Each visit reads one
// random row of a table far larger than L2 (625 MB of nucleotide rows at
// 1 Gbp): the V plane sectors, the milestone's sector, the mark words'
// sectors up to the row's word and the mark milestone's (at most the whole
// 160 B nucleotide row), plus 20 B of request/result I/O; a few dozen
// integer operations.
//
// Design: one thread per row.  Each plane is loaded as two 16 B uint4 words
// and the mark words as four 8 B uint2 words (mark_offset is even), so the
// row arrives in sector-sized loads; the symbol bit, the rank and the mark
// rank all come from those registers, with hardware popcounts.  No sort, no
// anchors, no coverage fixup and no shared-memory window: those streamed
// HBM windows through the TPU's VMEM.  Rows are clamped into the table.
//
// The walk as backstep launches (the first port) cost mark_ratio launches
// per walk, each over every lane: a lane already marked re-read its frozen
// row on every visit (4 row reads per lane at mark 4, where the walk needs
// steps + 1, 2.5 on average), and between visits the elementwise glue
// (where, |=, +=, the unpacking of the packed mark) ran as separate
// launches over 655,360 int64 lanes, then one more launch read the marked
// SA.  marked_walk walks each row in a thread: per visit it reads the mark
// word of the row's bit first; a marked row (or the walk's last visit)
// reads the other mark words and the mark milestone, already its final
// row, and stops; an unmarked row reads its planes and milestone and steps.
// So a lane reads steps + 1 rows, the final one only in its mark sectors,
// then its SA word, and writes its text position: one launch, 16 B of I/O
// per lane.  Lanes of a warp that finish early idle until the warp's
// longest walk ends.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// w[i] for a runtime i in [0, 8), as a select chain (no local-memory array).
__device__ __forceinline__ uint32_t pick8(const uint32_t (&w)[8], uint32_t i) {
  uint32_t r = w[0];
#pragma unroll
  for (uint32_t j = 1; j < 8; ++j) r = (i == j) ? w[j] : r;
  return r;
}

// A BWT row's place: its fused block row and the word and bit of the row
// inside the block's 256-bit fields.  pos is clamped into the table.
struct RowAt {
  const uint32_t* row;
  uint32_t word;
  uint32_t bit;
};

__device__ __forceinline__ RowAt row_at(const uint32_t* blocks, int64_t nbits, int row_words, int64_t pos) {
  pos = pos < 0 ? 0 : (pos >= nbits ? nbits - 1 : pos);
  const uint32_t local = (uint32_t)pos & 255u;
  return {blocks + (pos >> 8) * (int64_t)row_words, local >> 5, local & 31u};
}

// LF(row): C[safe] + Occ(row, safe) - 1, or 0 when the row's symbol is the
// sentinel (safe = the symbol, or ambiguity_idx in place of the sentinel).
template <int V>
__device__ __forceinline__ int64_t lf_step(const RowAt& r, const int64_t* __restrict__ prefix_sums,
                                           const int32_t* __restrict__ codes,
                                           const int32_t* __restrict__ c2i, int ambiguity_idx) {
  uint32_t planes[V][8];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const uint4 lo = __ldg(reinterpret_cast<const uint4*>(r.row + v * 8));
    const uint4 hi = __ldg(reinterpret_cast<const uint4*>(r.row + v * 8 + 4));
    planes[v][0] = lo.x;
    planes[v][1] = lo.y;
    planes[v][2] = lo.z;
    planes[v][3] = lo.w;
    planes[v][4] = hi.x;
    planes[v][5] = hi.y;
    planes[v][6] = hi.z;
    planes[v][7] = hi.w;
  }
  uint32_t code = 0;
#pragma unroll
  for (int v = 0; v < V; ++v) code |= ((pick8(planes[v], r.word) >> r.bit) & 1u) << v;
  const int sym = __ldg(c2i + code);
  const bool sentinel = sym == 0;
  const int safe = sentinel ? ambiguity_idx : sym;
  const uint32_t scode = (uint32_t)__ldg(codes + safe);

  uint32_t occ[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) occ[w] = 0xFFFFFFFFu;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    // A zero code bit matches a zero plane bit: flip the plane first.
    const uint32_t pol = ((scode >> v) & 1u) ? 0u : 0xFFFFFFFFu;
#pragma unroll
    for (int w = 0; w < 8; ++w) occ[w] &= planes[v][w] ^ pol;
  }
  const uint32_t in_word = 0xFFFFFFFFu >> (31u - r.bit);
  uint32_t count = 0;
#pragma unroll
  for (uint32_t w = 0; w < 8; ++w) {
    const uint32_t m = w < r.word ? 0xFFFFFFFFu : (w == r.word ? in_word : 0u);
    count += __popc(occ[w] & m);
  }
  const int64_t rank = (int64_t)__ldg(r.row + V * 8 + safe) + count;
  return sentinel ? 0 : prefix_sums[safe] + rank - 1;
}

// The row's mark bit, and into mark_rank the marked rows strictly before
// it: the mark milestone plus the mark words' bits [0, row) of the block.
__device__ __forceinline__ uint32_t mark_of(const RowAt& r, int mark_offset, uint32_t& mark_rank) {
  uint32_t marks[8];
  const uint2* mp = reinterpret_cast<const uint2*>(r.row + mark_offset);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint2 m = __ldg(mp + w);
    marks[2 * w] = m.x;
    marks[2 * w + 1] = m.y;
  }
  const uint32_t before = (1u << r.bit) - 1u;  // exclusive: bits [0, bit)
  mark_rank = __ldg(r.row + mark_offset + 8);
#pragma unroll
  for (uint32_t w = 0; w < 8; ++w) {
    const uint32_t m = w < r.word ? 0xFFFFFFFFu : (w == r.word ? before : 0u);
    mark_rank += __popc(marks[w] & m);
  }
  return (pick8(marks, r.word) >> r.bit) & 1u;
}

template <int V>
__global__ void backstep_kernel(const uint32_t* __restrict__ blocks, int64_t nbits, int row_words,
                                const int64_t* __restrict__ prefix_sums,
                                const int32_t* __restrict__ codes,
                                const int32_t* __restrict__ c2i, int mark_offset,
                                int ambiguity_idx, const int64_t* __restrict__ rows, int64_t n,
                                int64_t* __restrict__ stepped, uint32_t* __restrict__ mark) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const RowAt r = row_at(blocks, nbits, row_words, rows[i]);
  stepped[i] = lf_step<V>(r, prefix_sums, codes, c2i, ambiguity_idx);
  uint32_t mark_rank;
  const uint32_t mark_bit = mark_of(r, mark_offset, mark_rank);
  mark[i] = (mark_rank << 1) | mark_bit;
}

// text_pos[i] of row rows[i]: up to mark_ratio - 1 LF steps, stopping at
// the first marked row; then sa = sampled_sa[clamp(mark_rank, 0, sa_len-1)]
// at the final row and text_pos = sa + steps, less bwt_len when that
// reaches bwt_len.  The mark rank keeps the 31 bits that backstep's packed
// (mark_rank << 1) | mark_bit carries.
template <int V>
__global__ void marked_walk_kernel(const uint32_t* __restrict__ blocks, int64_t nbits, int row_words,
                                   const int64_t* __restrict__ prefix_sums,
                                   const int32_t* __restrict__ codes,
                                   const int32_t* __restrict__ c2i, int mark_offset,
                                   int ambiguity_idx, int mark_ratio,
                                   const uint32_t* __restrict__ sampled_sa, int64_t sa_len,
                                   int64_t bwt_len, const int64_t* __restrict__ rows, int64_t n,
                                   int64_t* __restrict__ text_pos) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int64_t pos = rows[i];
  int64_t steps = 0;
  uint32_t mark_rank = 0;
  for (int visit = 1;; ++visit) {
    const RowAt r = row_at(blocks, nbits, row_words, pos);
    const uint32_t word = __ldg(r.row + mark_offset + r.word);
    if (((word >> r.bit) & 1u) || visit == mark_ratio) {
      mark_of(r, mark_offset, mark_rank);
      break;
    }
    pos = lf_step<V>(r, prefix_sums, codes, c2i, ambiguity_idx);
    ++steps;
  }
  int64_t idx = (int64_t)(mark_rank & 0x7FFFFFFFu);
  idx = idx >= sa_len ? sa_len - 1 : idx;
  const int64_t t = (int64_t)__ldg(sampled_sa + idx) + steps;
  text_pos[i] = t >= bwt_len ? t - bwt_len : t;
}

constexpr int kThreads = 256;

}  // namespace

// Launches on `stream` (the caller's current PyTorch stream) and returns
// cudaGetLastError() so a refused launch is reported to the caller.
extern "C" int awry_backstep(int device, const void* blocks, int64_t num_blocks, int row_words,
                             int nplanes, const void* prefix_sums, const void* codes,
                             const void* c2i, int mark_offset, int ambiguity_idx,
                             const void* rows, int64_t n, void* stepped, void* mark,
                             void* stream) {
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) cudaSetDevice(device);
  if (n > 0) {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    const int64_t nbits = num_blocks * 256;
    cudaStream_t st = (cudaStream_t)stream;
    if (nplanes == 3) {
      backstep_kernel<3><<<grid, kThreads, 0, st>>>(
          (const uint32_t*)blocks, nbits, row_words, (const int64_t*)prefix_sums,
          (const int32_t*)codes, (const int32_t*)c2i, mark_offset, ambiguity_idx,
          (const int64_t*)rows, n, (int64_t*)stepped, (uint32_t*)mark);
    } else if (nplanes == 5) {
      backstep_kernel<5><<<grid, kThreads, 0, st>>>(
          (const uint32_t*)blocks, nbits, row_words, (const int64_t*)prefix_sums,
          (const int32_t*)codes, (const int32_t*)c2i, mark_offset, ambiguity_idx,
          (const int64_t*)rows, n, (int64_t*)stepped, (uint32_t*)mark);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int awry_marked_walk(int device, const void* blocks, int64_t num_blocks, int row_words,
                                int nplanes, const void* prefix_sums, const void* codes,
                                const void* c2i, int mark_offset, int ambiguity_idx,
                                int mark_ratio, const void* sampled_sa, int64_t sa_len,
                                int64_t bwt_len, const void* rows, int64_t n, void* text_pos,
                                void* stream) {
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) cudaSetDevice(device);
  if (n > 0) {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    const int64_t nbits = num_blocks * 256;
    cudaStream_t st = (cudaStream_t)stream;
    if (nplanes == 3) {
      marked_walk_kernel<3><<<grid, kThreads, 0, st>>>(
          (const uint32_t*)blocks, nbits, row_words, (const int64_t*)prefix_sums,
          (const int32_t*)codes, (const int32_t*)c2i, mark_offset, ambiguity_idx, mark_ratio,
          (const uint32_t*)sampled_sa, sa_len, bwt_len, (const int64_t*)rows, n,
          (int64_t*)text_pos);
    } else if (nplanes == 5) {
      marked_walk_kernel<5><<<grid, kThreads, 0, st>>>(
          (const uint32_t*)blocks, nbits, row_words, (const int64_t*)prefix_sums,
          (const int32_t*)codes, (const int32_t*)c2i, mark_offset, ambiguity_idx, mark_ratio,
          (const uint32_t*)sampled_sa, sa_len, bwt_len, (const int64_t*)rows, n,
          (int64_t*)text_pos);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
