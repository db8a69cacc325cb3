// SA-IS linear-time suffix array construction (Nong, Zhang & Chan 2009).
//
// The PyTorch port's copy of awry_tpu/native/sais.cpp, trimmed to the entry
// points the port's builder calls (SA-IS, the BWT byte gather and the k-mer
// table histogram/fill).  Suffix-array construction is sequential/irregular
// and runs once per index on the host, off the query hot path, so it lives
// in C++ behind a ctypes binding.
//
// Contract: the caller passes `text` of length `n` whose final character
// text[n-1] is a UNIQUE, SMALLEST terminator (the virtual sentinel '$' is
// appended as byte 0 by the Python caller).  Output `sa` receives the
// lexicographic suffix array of text; sa[0] == n-1 always.
//
// Because the suffixes of a sentinel-terminated text are pairwise distinct,
// the suffix array is unique, so any correct algorithm reproduces libsufr's
// result bit-for-bit downstream (SURVEY.md section 2, item 4).
//
// The index type is templated over int32 / uint32 / int64.  The uint32
// instantiation is the one that matters at genome scale: GRCh38's
// n = 3.1e9 exceeds int32 but fits uint32, and a 4-byte SA halves the
// memory traffic (and peak RSS) of the int64 path.  All loops are therefore
// written sentinel-based (EMPTY = max value) rather than sign-based.
//
// Performance design (the reference bar is libsufr's 1024-partition rayon
// build, src/fm_index.rs:156-169):
//
//  * FUSED symbol+type array: the induce scans are memory-latency bound on
//    the random reads of (s[j-1], t[j-1]).  Both are packed into one value
//    f[i] = s[i] << 1 | t[i] (uint8 when the alphabet allows, else wider),
//    halving the random-read streams; the LMS-substring naming comparison
//    also collapses to a single f compare.
//  * The symbol histogram is counted ONCE per level and cached; get_buckets
//    becomes a K-length prefix sum (the textbook form re-counted 5x/level).
//  * Type classification / fusing is chunk-parallel under OpenMP (each
//    chunk's seed type comes from scanning forward to the first unequal
//    adjacent pair); LMS naming compares adjacent pairs in parallel before
//    one cheap sequential prefix-sum; bulk fills are parallel.
//  * The two induce scans are loop-carried (a placement can feed a later
//    read in the same scan) and stay sequential, with software prefetch on
//    the random f reads.

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

#ifdef __linux__
#include <sys/mman.h>
#endif

namespace {

// Ask the kernel for transparent hugepages over a buffer: the induce scans
// random-access multi-GB arrays, where 4K-page TLB misses roughly double the
// effective memory latency (the host runs THP in madvise mode).
void advise_huge(void* p, size_t bytes) {
#ifdef __linux__
  uintptr_t a = (uintptr_t)p;
  uintptr_t lo = (a + 4095) & ~(uintptr_t)4095;
  uintptr_t hi = (a + bytes) & ~(uintptr_t)4095;
  if (hi > lo) madvise((void*)lo, hi - lo, MADV_HUGEPAGE);
#else
  (void)p;
  (void)bytes;
#endif
}

// Minimum problem size before OpenMP fan-out is worth the fork/join cost.
constexpr int64_t kParThreshold = 1 << 20;

template <typename T, typename I>
void parallel_fill(T* p, I n, T value) {
  if ((int64_t)n >= kParThreshold) {
#pragma omp parallel for schedule(static)
    for (I i = 0; i < n; ++i) p[i] = value;
  } else {
    std::fill(p, p + n, value);
  }
}

// Chunk-parallel classification + fuse: f[i] = s[i] << 1 | t[i] with
// t[i] = 1 (S-type) iff suffix i < suffix i+1, i.e. s[i] < s[i+1], or
// s[i] == s[i+1] and t[i+1].  Within a run of equal symbols the type is
// constant, so each chunk's boundary type is recovered by scanning forward
// to the first unequal adjacent pair.
template <typename C, typename F, typename I>
void fuse_types(const C* s, F* f, I n) {
  auto fill_chunk = [&](I lo, I hi) {
    // Seed: type of position hi-1.
    uint8_t ty;
    if (hi - 1 == n - 1) {
      ty = 1;
    } else {
      I j = hi - 1;
      while (j + 1 < n - 1 && s[j] == s[j + 1]) ++j;
      ty = (j + 1 == n - 1 && s[j] == s[j + 1]) ? 1 : (s[j] < s[j + 1]);
    }
    f[hi - 1] = (F)((F)s[hi - 1] << 1 | ty);
    for (I i = hi - 1; i-- > lo;) {
      ty = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && ty);
      f[i] = (F)((F)s[i] << 1 | ty);
    }
  };
  if ((int64_t)n < kParThreshold) {
    fill_chunk(0, n);
    return;
  }
#pragma omp parallel
  {
#ifdef _OPENMP
    int nt = omp_get_num_threads();
    int tid = omp_get_thread_num();
#else
    int nt = 1, tid = 0;
#endif
    I chunk = (n + nt - 1) / nt;
    I lo = (I)tid * chunk;
    I hi = lo + chunk < n ? lo + chunk : n;
    if (lo < hi) fill_chunk(lo, hi);
  }
}

// Per-level state over the fused string.  Bucket index of f is f >> 1;
// S-type flag is f & 1.
template <typename F, typename I>
struct Level {
  const F* f;
  I* sa;
  I n;
  I K;
  std::vector<I> cnt;  // cached histogram of s = f >> 1
  std::vector<I> bkt;  // working bucket pointers

  void count_symbols() {
    cnt.assign((size_t)K, 0);
#ifdef _OPENMP
    if ((int64_t)n >= kParThreshold && K <= (1 << 18)) {
      int nt = omp_get_max_threads();
      std::vector<std::vector<I>> part((size_t)nt);
#pragma omp parallel
      {
        int tid = omp_get_thread_num();
        auto& local = part[(size_t)tid];
        local.assign((size_t)K, 0);
#pragma omp for schedule(static)
        for (I i = 0; i < n; ++i) ++local[f[i] >> 1];
      }
      for (auto& local : part)
        for (I k = 0; k < K; ++k) cnt[(size_t)k] += local[(size_t)k];
      return;
    }
#endif
    for (I i = 0; i < n; ++i) ++cnt[f[i] >> 1];
  }

  void get_buckets(bool end) {
    bkt.resize((size_t)K);
    I sum = 0;
    for (I k = 0; k < K; ++k) {
      sum += cnt[(size_t)k];
      bkt[(size_t)k] = end ? sum : sum - cnt[(size_t)k];
    }
  }

  bool is_lms(I i) const { return i > 0 && (f[i] & 1) && !(f[i - 1] & 1); }

  void induce() {
    const I EMPTY = std::numeric_limits<I>::max();
    constexpr I PF = 24;  // prefetch distance for the random f reads
    // Induce L-type suffixes left-to-right from bucket heads.
    get_buckets(false);
    I* b = bkt.data();
    for (I i = 0; i < n; ++i) {
      if (i + PF < n) {
        I jp = sa[i + PF];
        if (jp != EMPTY && jp > 0) __builtin_prefetch(&f[jp - 1], 0, 0);
      }
      I j = sa[i];
      if (j != EMPTY && j > 0) {
        F fj = f[j - 1];
        if (!(fj & 1)) sa[b[fj >> 1]++] = j - 1;
      }
    }
    // Induce S-type suffixes right-to-left from bucket tails.
    get_buckets(true);
    b = bkt.data();
    for (I i = n; i-- > 0;) {
      if (i >= PF) {
        I jp = sa[i - PF];
        if (jp != EMPTY && jp > 0) __builtin_prefetch(&f[jp - 1], 0, 0);
      }
      I j = sa[i];
      if (j != EMPTY && j > 0) {
        F fj = f[j - 1];
        if (fj & 1) sa[--b[fj >> 1]] = j - 1;
      }
    }
  }
};

template <typename F, typename I>
void sais_core(const F* f, I* sa, I n, I K) {
  const I EMPTY = std::numeric_limits<I>::max();
  if (n == 1) {
    sa[0] = 0;
    return;
  }

  Level<F, I> lv{f, sa, n, K, {}, {}};
  lv.count_symbols();

  // Stage 1: approximately sort LMS suffixes by first placing them at their
  // bucket tails and inducing.
  parallel_fill(sa, n, EMPTY);
  lv.get_buckets(true);
  for (I i = 1; i < n; ++i)
    if (lv.is_lms(i)) sa[--lv.bkt[f[i] >> 1]] = i;
  lv.induce();

  // Compact the (now substring-sorted) LMS positions into sa[0..n1).
  I n1 = 0;
  for (I i = 0; i < n; ++i)
    if (sa[i] != EMPTY && sa[i] > 0 && lv.is_lms(sa[i])) sa[n1++] = sa[i];

  // Name LMS substrings; equal substrings share a name.  The adjacent-pair
  // comparisons are independent — run them parallel, then assign names with
  // one cheap sequential prefix-sum pass over n1 flags.  An f compare is a
  // (symbol, type) compare in one load.
  parallel_fill(sa + n1, n - n1, EMPTY);
  I name = 0;
  {
    std::vector<uint8_t> diff((size_t)n1, 0);
    if (n1 > 0) diff[0] = 1;
#pragma omp parallel for schedule(dynamic, 4096) if ((int64_t)n1 >= kParThreshold)
    for (I i = 1; i < n1; ++i) {
      I pos = sa[i], prev = sa[i - 1];
      uint8_t d = 0;
      for (I dd = 0;; ++dd) {
        if (f[pos + dd] != f[prev + dd]) {
          d = 1;
          break;
        }
        if (dd > 0 && (lv.is_lms(pos + dd) || lv.is_lms(prev + dd))) break;
      }
      diff[(size_t)i] = d;
    }
    for (I i = 0; i < n1; ++i) {
      name += diff[(size_t)i];
      sa[n1 + sa[i] / 2] = name - 1;
    }
    I j = n - 1;
    for (I i = n; i-- > n1;)
      if (sa[i] != EMPTY) sa[j--] = sa[i];
  }

  // Stage 2: sort the reduced problem (LMS-substring names in text order).
  I* s1 = sa + n - n1;
  I* sa1 = sa;
  if (name < n1) {
    // Fuse the reduced string (its own classification pass) so the
    // recursion reads one value per random access too.  s1's last symbol
    // (the sentinel's LMS name) is 0 and unique, preserving the contract.
    std::vector<I> f1((size_t)n1);
    advise_huge(f1.data(), (size_t)n1 * sizeof(I));
    fuse_types<I, I, I>(s1, f1.data(), n1);
    sais_core<I, I>(f1.data(), sa1, n1, name);
  } else {
    for (I i = 0; i < n1; ++i) sa1[s1[i]] = i;
  }

  // Stage 3: map reduced ranks back to LMS positions and induce the rest.
  {
    std::vector<I> lms;
    lms.reserve((size_t)n1);
    for (I i = 1; i < n; ++i)
      if (lv.is_lms(i)) lms.push_back(i);
    for (I i = 0; i < n1; ++i) sa1[i] = lms[(size_t)sa1[i]];
  }
  parallel_fill(sa + n1, n - n1, EMPTY);
  lv.get_buckets(true);
  for (I i = n1; i-- > 0;) {
    I p = sa[i];
    sa[i] = EMPTY;
    sa[--lv.bkt[f[p] >> 1]] = p;
  }
  lv.induce();
}

template <typename I>
void sais_entry(const uint8_t* s, I* sa, I n) {
  advise_huge(sa, (size_t)n * sizeof(I));
  // Fused representation: f = s << 1 | t.  ASCII genomic/protein text stays
  // in uint8 (max byte < 128); arbitrary bytes widen to uint16.
  uint8_t maxb = 0;
#pragma omp parallel for schedule(static) reduction(max : maxb) if ((int64_t)n >= kParThreshold)
  for (I i = 0; i < n; ++i)
    maxb = s[i] > maxb ? s[i] : maxb;
  if (maxb < 128) {
    std::vector<uint8_t> f((size_t)n);
    advise_huge(f.data(), (size_t)n);
    fuse_types<uint8_t, uint8_t, I>(s, f.data(), n);
    sais_core<uint8_t, I>(f.data(), sa, n, (I)(maxb + 1));
  } else {
    std::vector<uint16_t> f((size_t)n);
    advise_huge(f.data(), (size_t)n * 2);
    fuse_types<uint8_t, uint16_t, I>(s, f.data(), n);
    sais_core<uint16_t, I>(f.data(), sa, n, (I)256);
  }
}

}  // namespace

extern "C" {

// Parallel random gather dst[i] = src[idx[i]] — the BWT-from-SA pass is a
// multi-G-element random byte gather, memory-latency bound; OpenMP threads
// hide miss latency across cores.
int awry_gather_u8(const uint8_t* src, const int64_t* idx, uint8_t* dst, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) dst[i] = src[idx[i]];
  return 0;
}

// uint32-index variant (no 8-byte index temporary at genome scale).
int awry_gather_u8_u32(const uint8_t* src, const uint32_t* idx, uint8_t* dst, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) dst[i] = src[idx[i]];
  return 0;
}

// K-mer seed-table assembly from window addresses (build/kmer_count.py).
// addr: base-b addresses of the valid k-symbol windows (one per counted
// suffix); inserts: SORTED lexicographic insert points of the remaining
// suffixes (ambiguity/sentinel windows).  Fills table[a] = {start, end}
// where start(a) = #{addr < a} + #{inserts <= a} and end = start + cnt - 1,
// with the canonical empty range {1, 0} (reference: src/search.rs:51-56).
//
// NumPy's pipeline for the same job (bincount -> int64 cumsum -> fancy-mask
// fixups) allocates three 8 B/bin temporaries and first-touches ~10 GB at
// k=14 — minutes on this host's fault-bound pages; here one shared uint32
// histogram (atomic increments; collisions are ~nil over b^k bins) and one
// fused scan+fill pass touch 2x4 B/bin total.
// Histogram accumulation pass (callers chunk multi-GB address streams so
// the uint32 address temporaries never all exist at once).
int awry_kmer_hist_u32(const uint32_t* addr, int64_t n_addr, uint32_t* cnt,
                       int64_t total) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_addr; ++i) {
    uint32_t a = addr[i];
    if ((int64_t)a < total) {
#pragma omp atomic
      cnt[a]++;
    }
  }
  return 0;
}

// Scan + fill from a caller-owned histogram (see awry_kmer_assemble_u32).
int awry_kmer_fill_u32(const uint32_t* cnt, const uint32_t* inserts,
                       int64_t n_inserts, uint32_t* table, int64_t total) {
  // Per-thread ranges: base = suffixes strictly below the range (cnt sum +
  // inserts), then a sequential scan+fill inside each range.
  int nt = 1;
#ifdef _OPENMP
  nt = omp_get_max_threads();
#endif
  std::vector<uint64_t> base((size_t)nt + 1, 0);
  int64_t step = (total + nt - 1) / nt;
#pragma omp parallel num_threads(nt)
  {
#ifdef _OPENMP
    int t = omp_get_thread_num();
#else
    int t = 0;
#endif
    int64_t lo = t * step, hi = lo + step < total ? lo + step : total;
    uint64_t s = 0;
    for (int64_t a = lo; a < hi; ++a) s += cnt[a];
    base[t + 1] = s;
#pragma omp barrier
#pragma omp single
    {
      for (int i = 0; i < nt; ++i) base[i + 1] += base[i];
    }
    // #{inserts <= a} via a pointer walk from lower_bound(lo).
    int64_t ip = 0;
    {
      int64_t l = 0, r = n_inserts;
      while (l < r) {
        int64_t m = (l + r) / 2;
        if ((int64_t)inserts[m] < lo) l = m + 1; else r = m;
      }
      ip = l;
    }
    uint64_t run = base[t];
    for (int64_t a = lo; a < hi; ++a) {
      while (ip < n_inserts && (int64_t)inserts[ip] <= a) ++ip;
      uint32_t c = cnt[a];
      uint64_t start = run + (uint64_t)ip;
      if (c) {
        table[2 * a] = (uint32_t)start;
        table[2 * a + 1] = (uint32_t)(start + c - 1);
      } else {
        table[2 * a] = 1;
        table[2 * a + 1] = 0;
      }
      run += c;
    }
  }
  return 0;
}

// Returns 0 on success. text[n-1] must be the unique smallest byte.
int awry_sais_i32(const uint8_t* text, int32_t n, int32_t* sa) {
  if (n <= 0) return -1;
  sais_entry<int32_t>(text, sa, n);
  return 0;
}

// n may be up to 2^32 - 2 (EMPTY = 2^32 - 1 is reserved).
int awry_sais_u32(const uint8_t* text, uint32_t n, uint32_t* sa) {
  if (n == 0 || n >= std::numeric_limits<uint32_t>::max()) return -1;
  sais_entry<uint32_t>(text, sa, n);
  return 0;
}

int awry_sais_i64(const uint8_t* text, int64_t n, int64_t* sa) {
  if (n <= 0) return -1;
  sais_entry<int64_t>(text, sa, n);
  return 0;
}
}
