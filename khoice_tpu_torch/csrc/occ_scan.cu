// Occurrence histogram over ONE sorted array of (canonical key, gid) pairs:
// hist[b-1] = the number of distinct keys found with exactly b distinct
// gids, b = 1..n_bins.  The per-k fused path's scan (exp1 on groups of more
// than 64 members or on small k grids).
//
// Replaces the TPU kernels khoice_tpu/kernels/occ_scan_pallas.py::
//   occ_hist_packed_pallas (:205, pallas_call :222, body _kernel_packed
//     :130-201): words sorted by value = (key << 8) | gid  -> PACKED = true
//   occ_hist_pallas (:238, pallas_call :255, body _kernel :46-127): key
//     words sorted by (key, gid) with a separate gid        -> PACKED = false
// One kernel, the layout a template parameter.  It computes exactly what
// the JAX package's plain path computes (engine/occurrence.py:265-276 and
// the bin loop at :289-292): occ of a key run = its number of distinct
// gids (pair starts), capped at cs; the SENTINEL run (all words all-ones)
// counts 0; hist[b-1] = #runs with occ == b.  The Pallas kernels instead
// fold occ >= n_bins into the last bin and never cap
// (occ_scan_pallas.py:121-127); the two differ only when cs or cx is below
// the member count, which the defaults (cs 5000, cx 10000) never meet.
//
// Input: the sorted words as int64 [W, n] (each entry a 32-bit word, most
// significant first), and for PACKED = false an int64 [n] gid
// (0xFFFFFFFF on invalid windows, whose keys are the SENTINEL).
//
// What bounds it on an H100: bytes, by design: every element's words are
// read twice (passes 1 and 3), 8 B per word in the int64 layout, so
// 2 x 8 x W (+8 for the gid) bytes per element; ~97M elements of three
// words take ~1.4 ms at 3.35 TB/s.  What the design does about it:
//   * the TPU kernel carried the previous key, gid and the open run's rank
//     from one grid step to the next in SMEM; CUDA blocks run in no order,
//     so the carry becomes three passes, as in ksweep_scan.cu and with its
//     segmented-scan helpers (seg_scan.cuh): (1) per tile, the segmented
//     summary (a key run starts in the tile? pair starts of the tile's
//     last open run); (2) one block scans the tile summaries into each
//     tile's carry-in; (3) each tile rescans with its carry-in and bins
//     every run at its end into a shared-memory histogram, flushed with
//     global atomics;
//   * each element's three facts (key starts, pair starts, sentinel) are
//     bits of three registers, computed once per pass from the element and
//     its predecessor; the TPU's log2(65536)-step Hillis-Steele rank scan
//     and its per-bin compare-reductions over the whole tile are gone;
//   * consecutive run ends of a thread that share a bin (most keys occur
//     once) are added with one shared-memory atomic;
//   * the histogram holds up to the device's opt-in shared memory (~56K
//     bins on an H100; exp1's cx is 10000), opted in above 48 KB;
//   * any n: the ragged last tile is masked, no padding to 65536.
// A decoupled look-back single pass and uint32 words are left for later
// work.

#include <cuda_runtime.h>

#include "seg_scan.cuh"

namespace {

typedef unsigned long long u64;

constexpr int NT = 256;          // threads per block, passes 1 and 3
constexpr int EPT = 8;           // consecutive elements per thread
constexpr int TILE = NT * EPT;   // elements per block
constexpr int NT_CARRY = 1024;   // threads of pass 2
constexpr int GID_BITS = 8;      // packed: value = (key << 8) | gid
constexpr int SMEM_MARGIN = 1024;  // static shared memory of a block, rounded up

// Segmented count (seg_scan.cuh): f = a key run starts inside, c = pair
// starts since the last key start (or all of them when none does).
struct Seg {
  int f;
  unsigned c;
  static __device__ __forceinline__ Seg combine(Seg a, Seg b) {  // a precedes b
    return Seg{a.f | b.f, b.f ? b.c : a.c + b.c};
  }
  static __device__ __forceinline__ Seg shfl_up(Seg x, int d) {
    return Seg{__shfl_up_sync(0xffffffffu, x.f, d), __shfl_up_sync(0xffffffffu, x.c, d)};
  }
};

// Element i: its words and gid (packed: the last word's low 8 bits).
template <int W, bool PACKED>
__device__ __forceinline__ void load_elem(const long long* __restrict__ words,
                                          const long long* __restrict__ gid,
                                          long long n, long long i,
                                          unsigned (&w)[W], unsigned& g) {
#pragma unroll
  for (int j = 0; j < W; ++j) w[j] = (unsigned)__ldg(words + j * n + i);
  g = PACKED ? (w[W - 1] & ((1u << GID_BITS) - 1u)) : (unsigned)__ldg(gid + i);
}

// Bit e (0..EPT) of kn: element base+e starts a key run (true at the
// array's first element and past its end, so both open and close runs);
// bit e (0..EPT-1) of pn: it starts a (key, gid) pair; of sent: it is the
// SENTINEL.
template <int W, bool PACKED>
__device__ __forceinline__ void load_flags(const long long* __restrict__ words,
                                           const long long* __restrict__ gid,
                                           long long n, long long base,
                                           unsigned& kn, unsigned& pn, unsigned& sent) {
  unsigned pw[W], pg = 0u;
#pragma unroll
  for (int j = 0; j < W; ++j) pw[j] = 0u;
  if (base > 0 && base - 1 < n) load_elem<W, PACKED>(words, gid, n, base - 1, pw, pg);
  kn = pn = sent = 0u;
#pragma unroll
  for (int e = 0; e <= EPT; ++e) {
    const long long i = base + e;
    unsigned w[W], g = 0u;
    if (i >= n) {
      kn |= 1u << e;
      continue;
    }
    load_elem<W, PACKED>(words, gid, n, i, w, g);
    bool key_eq = i > 0, all_ones = true;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const unsigned a = (PACKED && j == W - 1) ? w[j] >> GID_BITS : w[j];
      const unsigned b = (PACKED && j == W - 1) ? pw[j] >> GID_BITS : pw[j];
      key_eq = key_eq && a == b;
      all_ones = all_ones && w[j] == 0xffffffffu;
    }
    const bool pair_eq = key_eq && g == pg;
    if (!key_eq) kn |= 1u << e;
    if (e < EPT) {
      if (!pair_eq) pn |= 1u << e;
      if (all_ones) sent |= 1u << e;
    }
#pragma unroll
    for (int j = 0; j < W; ++j) pw[j] = w[j];
    pg = g;
  }
}

__device__ __forceinline__ Seg thread_summary(unsigned kn, unsigned pn) {
  Seg s{};
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const unsigned p = (pn >> e) & 1u;
    if ((kn >> e) & 1u) {
      s.f = 1;
      s.c = p;
    } else {
      s.c += p;
    }
  }
  return s;  // elements past the end have no pair bits and add nothing
}

// Pass 1: each tile's segmented summary.
template <int W, bool PACKED>
__global__ void __launch_bounds__(NT)
    occ_tile_summaries(const long long* __restrict__ words, const long long* __restrict__ gid,
                       long long n, int* __restrict__ tile_f, unsigned* __restrict__ tile_c) {
  __shared__ Seg sh[NT / 32];
  const long long base = (long long)blockIdx.x * TILE + (long long)threadIdx.x * EPT;
  unsigned kn, pn, sent;
  load_flags<W, PACKED>(words, gid, n, base, kn, pn, sent);
  Seg tot;
  seg_scan::block_scan<NT>(thread_summary(kn, pn), &tot, sh);
  if (threadIdx.x == 0) {
    tile_f[blockIdx.x] = tot.f;
    tile_c[blockIdx.x] = tot.c;
  }
}

// Pass 2: one block turns the tile summaries into each tile's carry-in
// (the pair starts of the key run still open where the tile begins).
__global__ void __launch_bounds__(NT_CARRY)
    occ_tile_carries(const int* __restrict__ tile_f, const unsigned* __restrict__ tile_c,
                     unsigned* __restrict__ carry, int n_tiles) {
  __shared__ Seg sh[NT_CARRY / 32];
  seg_scan::carry_scan<NT_CARRY>(
      n_tiles, sh, [&](int t) { return Seg{tile_f[t], tile_c[t]}; },
      [&](int t, Seg c) { carry[t] = c.c; });
}

// Pass 3: rescan each tile with its carry-in and bin every non-SENTINEL
// key run at its last element: b = min(pair starts, cs), counted when
// 1 <= b <= n_bins, into the block's shared histogram.
template <int W, bool PACKED>
__global__ void __launch_bounds__(NT)
    occ_count_runs(const long long* __restrict__ words, const long long* __restrict__ gid,
                   long long n, const unsigned* __restrict__ carry, unsigned cs, int n_bins,
                   u64* __restrict__ hist) {
  __shared__ Seg sh[NT / 32];
  extern __shared__ unsigned h[];
  for (int j = threadIdx.x; j < n_bins; j += NT) h[j] = 0u;
  __syncthreads();
  const long long base = (long long)blockIdx.x * TILE + (long long)threadIdx.x * EPT;
  unsigned kn, pn, sent;
  load_flags<W, PACKED>(words, gid, n, base, kn, pn, sent);
  Seg tot;
  const Seg ex = seg_scan::block_scan<NT>(thread_summary(kn, pn), &tot, sh);
  unsigned acc = ex.f ? ex.c : carry[blockIdx.x] + ex.c;
  unsigned pend_b = 0u, pend_c = 0u;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    if (base + e < n) {
      acc = (((kn >> e) & 1u) ? 0u : acc) + ((pn >> e) & 1u);
      if (((kn >> (e + 1)) & 1u) && !((sent >> e) & 1u)) {  // a key run closes here
        const unsigned b = min(acc, cs);
        if (b >= 1u && b <= (unsigned)n_bins) {
          if (b != pend_b) {
            if (pend_c) atomicAdd(&h[pend_b - 1], pend_c);
            pend_b = b;
            pend_c = 0u;
          }
          ++pend_c;
        }
      }
    }
  }
  if (pend_c) atomicAdd(&h[pend_b - 1], pend_c);
  __syncthreads();
  for (int j = threadIdx.x; j < n_bins; j += NT) {
    const unsigned v = h[j];
    if (v) atomicAdd(&hist[j], (u64)v);
  }
}

template <int W, bool PACKED>
int launch_all(const long long* words, const long long* gid, long long n, unsigned cs,
               int n_bins, int* tile_f, unsigned* tile_c, unsigned* carry, u64* hist,
               cudaStream_t st) {
  const int n_tiles = (int)((n + TILE - 1) / TILE);
  occ_tile_summaries<W, PACKED><<<n_tiles, NT, 0, st>>>(words, gid, n, tile_f, tile_c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  occ_tile_carries<<<1, NT_CARRY, 0, st>>>(tile_f, tile_c, carry, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = n_bins * (int)sizeof(unsigned);
  if (smem + SMEM_MARGIN > 48 * 1024) {  // static + dynamic above the default 48 KB
    err = cudaFuncSetAttribute(occ_count_runs<W, PACKED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  occ_count_runs<W, PACKED><<<n_tiles, NT, smem, st>>>(words, gid, n, carry, cs, n_bins, hist);
  return (int)cudaGetLastError();
}

int hist_bins_max() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return (optin - SMEM_MARGIN) / (int)sizeof(unsigned);
}

}  // namespace

extern "C" int occ_scan_tile_elems() { return TILE; }

// Most bins a block's shared histogram holds on the current device.
extern "C" int occ_scan_bins_max() { return hist_bins_max(); }

// One launch of the three passes.  words: int64 [W, n] sorted; packed != 0:
// each value is (key << 8) | gid and gid is null; packed == 0: gid int64
// [n].  tile_f: int32 [n_tiles]; tile_c, carry: int32 [n_tiles]; hist:
// zeroed int64 [n_bins].  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int occ_scan_launch(const void* words, const void* gid, long long n, int W,
                               int packed, int cs, int n_bins, void* tile_f, void* tile_c,
                               void* carry, void* hist, void* stream) {
  if (n <= 0 || n >= (1LL << 32) || W < 1 || W > 4 || (!packed && gid == nullptr) ||
      cs < 1 || n_bins < 1 || n_bins > hist_bins_max())
    return (int)cudaErrorInvalidValue;
  const auto* w = static_cast<const long long*>(words);
  const auto* g = static_cast<const long long*>(gid);
  auto* tf = static_cast<int*>(tile_f);
  auto* tc = static_cast<unsigned*>(tile_c);
  auto* ca = static_cast<unsigned*>(carry);
  auto* hi = static_cast<u64*>(hist);
  auto st = static_cast<cudaStream_t>(stream);
#define OCC_CASE(K)                                                                    \
  case K:                                                                              \
    return packed ? launch_all<K, true>(w, g, n, (unsigned)cs, n_bins, tf, tc, ca, hi, st) \
                  : launch_all<K, false>(w, g, n, (unsigned)cs, n_bins, tf, tc, ca, hi, st);
  switch (W) {
    OCC_CASE(1)
    OCC_CASE(2)
    OCC_CASE(3)
    OCC_CASE(4)
  }
#undef OCC_CASE
  return (int)cudaErrorInvalidValue;
}
