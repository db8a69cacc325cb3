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
// masked to the bits [0..=p & 255] of the block (inclusive).
//
// Bound: device-memory traffic of scattered reads.  On the serving path each
// request reads two random rows of a table far larger than L2 (156 MB of
// nucleotide rows at chr1 scale): per row V 32 B plane sectors and one 32 B
// milestone sector, plus 28 B of request/result I/O; the popcounts are a few
// dozen integer operations.  The k-mer build's occ runs on whatever index is
// being built: at chr20 scale (64 Mbp) its 40 MB of rows fit the 50 MB L2, so
// the 16 B of request/result I/O per rank stream from device memory while
// the row sectors mostly hit L2.
//
// Design: one thread per request.  Each plane is loaded as two 16 B uint4
// words, so a row's plane bytes arrive in V sector-sized loads, and the
// milestone is one 4 B load.  No sort, no anchors, no coverage fixup and no
// shared-memory window: those streamed HBM windows through the TPU's VMEM;
// on this card a direct gather with many independent requests in flight is
// the simple first kernel.  Positions are clamped into the table (pos_a =
// start-1 is -1 only on lanes the caller masks) and symbols into the
// alphabet.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <int V>
__device__ __forceinline__ uint32_t occ_one(const uint32_t* __restrict__ blocks, int64_t nbits,
                                            int row_words, int64_t pos, int sym, uint32_t code) {
  pos = pos < 0 ? 0 : (pos >= nbits ? nbits - 1 : pos);
  const uint32_t* row = blocks + (pos >> 8) * (int64_t)row_words;
  const uint32_t local = (uint32_t)pos & 255u;
  const uint32_t word = local >> 5;
  uint32_t occ[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) occ[w] = 0xFFFFFFFFu;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    // A zero code bit matches a zero plane bit: flip the plane first.
    const uint32_t pol = ((code >> v) & 1u) ? 0u : 0xFFFFFFFFu;
    const uint4 lo = __ldg(reinterpret_cast<const uint4*>(row + v * 8));
    const uint4 hi = __ldg(reinterpret_cast<const uint4*>(row + v * 8 + 4));
    occ[0] &= lo.x ^ pol;
    occ[1] &= lo.y ^ pol;
    occ[2] &= lo.z ^ pol;
    occ[3] &= lo.w ^ pol;
    occ[4] &= hi.x ^ pol;
    occ[5] &= hi.y ^ pol;
    occ[6] &= hi.z ^ pol;
    occ[7] &= hi.w ^ pol;
  }
  const uint32_t in_word = 0xFFFFFFFFu >> (31u - (local & 31u));
  uint32_t count = 0;
#pragma unroll
  for (uint32_t w = 0; w < 8; ++w) {
    const uint32_t m = w < word ? 0xFFFFFFFFu : (w == word ? in_word : 0u);
    count += __popc(occ[w] & m);
  }
  return __ldg(row + V * 8 + sym) + count;
}

template <int V>
__global__ void occ_pair_kernel(const uint32_t* __restrict__ blocks, int64_t nbits, int row_words,
                                int card, const int32_t* __restrict__ codes,
                                const int64_t* __restrict__ pos_a,
                                const int64_t* __restrict__ pos_b,
                                const int32_t* __restrict__ sym, int64_t n,
                                uint32_t* __restrict__ occ_a, uint32_t* __restrict__ occ_b) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int s = sym[i];
  s = s < 0 ? 0 : (s >= card ? card - 1 : s);
  const uint32_t code = (uint32_t)__ldg(codes + s);
  occ_a[i] = occ_one<V>(blocks, nbits, row_words, pos_a[i], s, code);
  occ_b[i] = occ_one<V>(blocks, nbits, row_words, pos_b[i], s, code);
}

template <int V>
__global__ void occ_kernel(const uint32_t* __restrict__ blocks, int64_t nbits, int row_words,
                           int card, const int32_t* __restrict__ codes,
                           const int64_t* __restrict__ pos, const int32_t* __restrict__ sym,
                           int64_t n, uint32_t* __restrict__ occ) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int s = sym[i];
  s = s < 0 ? 0 : (s >= card ? card - 1 : s);
  occ[i] = occ_one<V>(blocks, nbits, row_words, pos[i], s, (uint32_t)__ldg(codes + s));
}

}  // namespace

// Launches on `stream` (the caller's current PyTorch stream) and returns
// cudaGetLastError() so a refused launch is reported to the caller.
extern "C" int awry_occ_pair(int device, const void* blocks, int64_t num_blocks, int row_words,
                             int nplanes, int card, const void* codes, const void* pos_a,
                             const void* pos_b, const void* sym, int64_t n, void* occ_a,
                             void* occ_b, void* stream) {
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) cudaSetDevice(device);
  if (n > 0) {
    const int threads = 256;
    const unsigned grid = (unsigned)((n + threads - 1) / threads);
    const int64_t nbits = num_blocks * 256;
    cudaStream_t st = (cudaStream_t)stream;
    if (nplanes == 3) {
      occ_pair_kernel<3><<<grid, threads, 0, st>>>(
          (const uint32_t*)blocks, nbits, row_words, card, (const int32_t*)codes,
          (const int64_t*)pos_a, (const int64_t*)pos_b, (const int32_t*)sym, n,
          (uint32_t*)occ_a, (uint32_t*)occ_b);
    } else if (nplanes == 5) {
      occ_pair_kernel<5><<<grid, threads, 0, st>>>(
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
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) cudaSetDevice(device);
  if (n > 0) {
    const int threads = 256;
    const unsigned grid = (unsigned)((n + threads - 1) / threads);
    const int64_t nbits = num_blocks * 256;
    cudaStream_t st = (cudaStream_t)stream;
    if (nplanes == 3) {
      occ_kernel<3><<<grid, threads, 0, st>>>(
          (const uint32_t*)blocks, nbits, row_words, card, (const int32_t*)codes,
          (const int64_t*)pos, (const int32_t*)sym, n, (uint32_t*)occ);
    } else if (nplanes == 5) {
      occ_kernel<5><<<grid, threads, 0, st>>>(
          (const uint32_t*)blocks, nbits, row_words, card, (const int32_t*)codes,
          (const int64_t*)pos, (const int32_t*)sym, n, (uint32_t*)occ);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
