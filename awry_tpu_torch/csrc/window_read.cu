// window_read: words[i, j] = flat[clamp(wbase[i], k-1, len-1) - j], j < k.
//
// Replaces awry_tpu/ops/sweep.py:_anchored_text_kernel (reached through
// _window_sweep_core <- window_sweep / text_window_sweep).  On the main path
// it serves three reads per batch: the k-mer seed pair (k = 2 over the flat
// seed table), the mark=1 locate walk's SA word (k = 2 over the SA) and the
// verify text window (k = 3 over the packed text).
//
// Bound: device-memory traffic of scattered reads.  Every request touches
// one (rarely two) random 32 B sectors of a table far larger than the 50 MB
// L2 (0.1-1 GB on the chr1-scale index), plus its own 8 B index and 4k B of
// output; there is no arithmetic to speak of.
//
// Design: one thread per (request, word).  Neighbouring threads read the k
// consecutive words of one request, so a request's words coalesce into the
// same sector, and the output row is written contiguously.  The TPU kernel
// sorted requests and streamed anchored windows through VMEM because the
// TPU's gathers are issue-bound; here a direct gather with many requests in
// flight is the simple first design (whether sorting buys L2 locality is a
// later measurement).  The clamp is part of the function: out-of-range
// dump lanes read in-bounds words, as the JAX gathers do.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void window_read_kernel(const uint32_t* __restrict__ flat, int64_t len,
                                   const int64_t* __restrict__ wbase, int64_t n, int k,
                                   uint32_t* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * k) return;
  const int64_t i = t / k;
  const int64_t j = t - i * k;
  int64_t wb = wbase[i];
  wb = wb < k - 1 ? k - 1 : (wb > len - 1 ? len - 1 : wb);
  out[t] = __ldg(flat + (wb - j));
}

}  // namespace

// Launches on `stream` (the caller's current PyTorch stream) and returns
// cudaGetLastError() so a refused launch is reported to the caller.
extern "C" int awry_window_read(int device, const void* flat, int64_t len, const void* wbase,
                                int64_t n, int k, void* out, void* stream) {
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) cudaSetDevice(device);
  const int64_t total = n * (int64_t)k;
  if (total > 0) {
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    window_read_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)flat, len, (const int64_t*)wbase, n, k, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}
