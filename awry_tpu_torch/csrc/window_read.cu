// window_read: words[i, j] = flat[clamp(wbase[i], k-1, len-1) - j], j < k.
//
// Replaces awry_tpu/ops/sweep.py:_anchored_text_kernel (reached through
// _window_sweep_core <- window_sweep / text_window_sweep) and its blocked
// twin _text_kernel.  On the main path it serves the k-mer seed pair (k = 2
// over the flat seed table), the mark=1 locate walk's SA word (k = 2 over
// the SA), the verify text window (k = 3 at 30 bp, k = 15 at 100 bp) and the
// slot regime's fat rows (k = 4 over the slim rows, 4 slots per lane).  The
// clamp is part of the function: out-of-range dump lanes read in-bounds
// words, as the JAX gathers do.
//
// Bound: device-memory traffic of scattered reads.  Every request touches
// one (rarely two) random 32 B sectors of a table far larger than the 50 MB
// L2 (0.1-1 GB on the chr1-scale index), plus its own 8 B index and 4k B of
// output; no arithmetic to speak of.  At chr1's sites the bound is
// 0.007-0.010 ms per launch (PERF.md §6).
//
// The first design ran one thread per (request, word): each request's
// wbase was loaded and clamped k times, each thread did a 64-bit t / k
// with a runtime k (a long software sequence on this card, for one 4 B
// load of useful work) and had one load in flight.  A second design gave
// each thread its requests' whole windows as k scalar loads: it removed the
// divide, but each warp load instruction then touched 32 random sectors, k
// times per request, and at k = 15 it lost to the first (PERF.md §6).
// A warp load is served a sector at a time: what counts is the sectors
// each instruction touches, not the loads.
//
// Design: one thread per request owns it, kPer<K> requests per thread,
// with k a template parameter for the main path's widths (1, 2, 3, 4, 15)
// and a generic kernel for any other k.  A thread loads its requests'
// wbase (coalesced) and clamps each once; there is no division, and
// offsets are 32-bit when the table and the output allow.
// - k = 1: each thread reads and writes its own words.
// - k = 2 and 4, a warp whose windows are all aligned (the seed table's
//   pairs and the fat rows always are): each thread reads its window as
//   one 8 B or 16 B load, one sector per lane.
// - Otherwise the warp gathers cooperatively: G = k rounded up to a power
//   of two lanes share a request, lane m of a group reading word m, so a
//   load instruction touches the sectors of 32 / G requests, about one
//   each; the window start comes from its owner by a shuffle.
// Every load of the tile issues before the first store.  The tile's rows
// land in shared memory (stride k: conflict-free for odd k) and leave in
// coalesced 16 B stores.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Requests per thread: several independent scattered loads in flight, few
// enough that the tile's words stay in registers.
template <int K>
constexpr int kPer = K <= 4 ? 4 : 2;

// Lanes that share a request in the cooperative gather.
template <int K>
constexpr int kGroup = K <= 1 ? 1 : K <= 2 ? 2 : K <= 4 ? 4 : K <= 8 ? 8 : K <= 16 ? 16 : 32;

__device__ __forceinline__ int64_t load_once(const int64_t* p) {
  return (int64_t)__ldcs(reinterpret_cast<const long long*>(p));
}

__device__ __forceinline__ uint32_t shfl(uint32_t x, int src) { return __shfl_sync(kFull, x, src); }
__device__ __forceinline__ int64_t shfl(int64_t x, int src) {
  return (int64_t)__shfl_sync(kFull, (long long)x, src);
}

template <int K, typename Idx>
__global__ void __launch_bounds__(kThreads)
    window_read_fixed(const uint32_t* __restrict__ flat, int64_t len,
                      const int64_t* __restrict__ wbase, Idx n, uint32_t* __restrict__ out) {
  constexpr int P = kPer<K>;
  constexpr int G = kGroup<K>;
  const Idx tile = (Idx)blockIdx.x * (Idx)(kThreads * P);
  // start[j] = clamp(wbase) - (k-1): the window's lowest word.
  Idx start[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const Idx i = tile + (Idx)(j * kThreads + threadIdx.x);
    int64_t wb = i < n ? load_once(wbase + i) : (int64_t)(K - 1);
    wb = wb < K - 1 ? K - 1 : (wb > len - 1 ? len - 1 : wb);
    start[j] = (Idx)(wb - (K - 1));
  }
  if constexpr (K == 1) {
    uint32_t w[P];
#pragma unroll
    for (int j = 0; j < P; ++j) w[j] = __ldg(flat + start[j]);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const Idx i = tile + (Idx)(j * kThreads + threadIdx.x);
      if (i < n) out[i] = w[j];
    }
  } else {
    constexpr int kWords = kThreads * P * K;
    __shared__ __align__(16) uint32_t stage[kWords];
    const int lane = threadIdx.x & 31;
    const int warp0 = threadIdx.x & ~31;  // the warp's first thread
    const int g = lane / G;                // a power of two: a shift
    const int m = lane % G;
    const int mk = m < K ? m : K - 1;      // idle lanes (k < G) repeat a word
    uint32_t v[P][G];
    bool vec[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      vec[j] = false;
      if constexpr (K == 2 || K == 4) {
        const bool aligned = (reinterpret_cast<uintptr_t>(flat + start[j]) & (4 * K - 1)) == 0;
        vec[j] = __all_sync(kFull, aligned);  // warp-uniform: no divergence
      }
      if (vec[j]) {
        if constexpr (K == 2) {
          const uint2 x = __ldg(reinterpret_cast<const uint2*>(flat + start[j]));
          v[j][0] = x.y;
          v[j][1] = x.x;
        } else if constexpr (K == 4) {
          const uint4 x = __ldg(reinterpret_cast<const uint4*>(flat + start[j]));
          v[j][0] = x.w;
          v[j][1] = x.z;
          v[j][2] = x.y;
          v[j][3] = x.x;
        }
      } else {
#pragma unroll
        for (int r = 0; r < G; ++r) {
          const Idx s = shfl(start[j], r * (32 / G) + g);
          v[j][r] = __ldg(flat + s + (Idx)(K - 1 - mk));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int row0 = j * kThreads + warp0;  // the warp's first row of slot j
      if (vec[j]) {
        if constexpr (K == 2) {
          reinterpret_cast<uint2*>(stage)[row0 + lane] = make_uint2(v[j][0], v[j][1]);
        } else if constexpr (K == 4) {
          reinterpret_cast<uint4*>(stage)[row0 + lane] = make_uint4(v[j][0], v[j][1], v[j][2], v[j][3]);
        }
      } else if (m < K) {
#pragma unroll
        for (int r = 0; r < G; ++r) stage[(row0 + r * (32 / G) + g) * K + m] = v[j][r];
      }
    }
    __syncthreads();
    // The tile's rows are contiguous in out; tile * K words is a multiple
    // of 4, so full tiles leave in 16 B pieces.
    uint32_t* dst = out + tile * (Idx)K;
    const Idx left = n - tile;
    if (left >= (Idx)(kThreads * P)) {
      const uint4* s4 = reinterpret_cast<const uint4*>(stage);
      uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
      for (int c = threadIdx.x; c < kWords / 4; c += kThreads) d4[c] = s4[c];
    } else {
      const int words = (int)left * K;
      for (int c = threadIdx.x; c < words; c += kThreads) dst[c] = stage[c];
    }
  }
}

// Any other k: one thread per request, two requests per thread.
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
    window_read_any(const uint32_t* __restrict__ flat, int64_t len,
                    const int64_t* __restrict__ wbase, Idx n, int k, uint32_t* __restrict__ out) {
  const Idx tile = (Idx)blockIdx.x * (Idx)(kThreads * 2);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const Idx i = tile + (Idx)(j * kThreads + threadIdx.x);
    if (i >= n) continue;
    int64_t wb = load_once(wbase + i);
    wb = wb < k - 1 ? k - 1 : (wb > len - 1 ? len - 1 : wb);
    const uint32_t* src = flat + (Idx)wb;
    uint32_t* dst = out + i * (Idx)k;
    for (int m = 0; m < k; ++m) dst[m] = __ldg(src - m);
  }
}

template <int K, typename Idx>
void launch_fixed(const uint32_t* flat, int64_t len, const int64_t* wbase, int64_t n,
                  uint32_t* out, cudaStream_t st) {
  const int64_t per_block = (int64_t)kThreads * kPer<K>;
  const unsigned grid = (unsigned)((n + per_block - 1) / per_block);
  window_read_fixed<K, Idx><<<grid, kThreads, 0, st>>>(flat, len, wbase, (Idx)n, out);
}

template <typename Idx>
void launch(const uint32_t* flat, int64_t len, const int64_t* wbase, int64_t n, int k,
            uint32_t* out, cudaStream_t st) {
  switch (k) {
    case 1: return launch_fixed<1, Idx>(flat, len, wbase, n, out, st);
    case 2: return launch_fixed<2, Idx>(flat, len, wbase, n, out, st);
    case 3: return launch_fixed<3, Idx>(flat, len, wbase, n, out, st);
    case 4: return launch_fixed<4, Idx>(flat, len, wbase, n, out, st);
    case 15: return launch_fixed<15, Idx>(flat, len, wbase, n, out, st);
    default: {
      const unsigned grid = (unsigned)((n + 2 * kThreads - 1) / (2 * kThreads));
      window_read_any<Idx><<<grid, kThreads, 0, st>>>(flat, len, wbase, (Idx)n, k, out);
    }
  }
}

}  // namespace

// Launches on `stream` (the caller's current PyTorch stream) and returns
// cudaGetLastError() so a refused launch is reported to the caller.  `out`
// is 16-byte aligned (the wrapper's fresh allocation).
extern "C" int awry_window_read(int device, const void* flat, int64_t len, const void* wbase,
                                int64_t n, int k, void* out, void* stream) {
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) cudaSetDevice(device);
  if (n > 0) {
    const uint32_t* f = (const uint32_t*)flat;
    const int64_t* wb = (const int64_t*)wbase;
    uint32_t* o = (uint32_t*)out;
    cudaStream_t st = (cudaStream_t)stream;
    // 32-bit offsets when every table index and every output index (the
    // last tile's too) fits in 32 bits.
    const bool narrow = len <= (int64_t)UINT32_MAX && (n + 4 * kThreads) * (int64_t)k <= (int64_t)UINT32_MAX;
    if (narrow) {
      launch<uint32_t>(f, len, wb, n, k, o, st);
    } else {
      launch<int64_t>(f, len, wb, n, k, o, st);
    }
  }
  return (int)cudaGetLastError();
}
