// Multi-k occurrence scan over ONE shared-sorted doubled-text array.
//
// Replaces the TPU kernel khoice_tpu/kernels/ksweep_scan_pallas.py::_kernel
// ("occ" mode).  For each k of a list it computes what
// khoice_tpu/engine/ksweep.py::_scan_multi_k_xla(..., raw=True) computes:
// the elements sort by their forward kmax-mer, so every k <= kmax groups
// into runs of equal top-2k key bits; a segmented OR of one-hot member
// masks (element counted iff nio >= k) over each run, popcounted at the
// run's end and capped at cs, gives the run's member count b, and
//   hist[0][k][b-1] counts runs          (doubled histogram)
//   hist[1][k][b-1] counts palindromic runs, even k only.
//
// Input: the sorted key words as int64 [KW, n] (each entry a 32-bit word,
// MSB word first, key left-aligned), the gid/nio payload either in the
// last word's spare bits (packed: gid = (w >> 6) & 63, nio = w & 63) or in
// a separate int64 [n] (gid = (p >> 8) & 255, nio = p & 255).
//
// What bounds it on an H100: bytes, by design.  Each pass reads every
// element's words once (8 B per word in the int64 layout, 32 B per
// element at KW=4); the 30 ks of the reference grid run inside the block
// on registers, so the array is read twice in all (passes 1 and 3), not
// once per k: 2.15 GB, ~0.64 ms at 3.35 TB/s for the bench shape (33.6M
// elements).  This first version takes ~6.7 ms there (H100 80GB HBM3,
// 700 W): the per-k block scans (warp shuffles and two barriers per k and
// pass) dominate, not the reads.  What the design does about the bytes:
//   * the top-2k comparison of every k comes from ONE number per element,
//     the count of equal leading key bits against its predecessor (lcp):
//     element i starts a k-run iff lcp(i) < 2k;
//   * one 64-bit mask per k covers up to 64 members in a single channel
//     (the TPU kernel packed several ks into sub-words of a u32 and capped
//     members at 32);
//   * CUDA blocks run in no order, so the TPU kernel's sequential-grid
//     carry (previous key, open run's OR, pal bits in SMEM) becomes three
//     passes: (1) per tile and k, the segmented-OR summary (a run starts
//     in the tile? OR of the tile's last open segment); (2) per k, a
//     block scan over the tile summaries gives each tile's carry-in;
//     (3) each tile rescans with its carry-in and counts every run at its
//     end into a shared-memory histogram, flushed with global atomics;
//   * any n: the ragged last tile is masked, no padding or ks-per-call
//     chunking as VMEM forced on the TPU.
// A decoupled look-back single-pass scan, uint32 words and vector loads
// are left for later work.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int NT = 256;          // threads per block, passes 1 and 3
constexpr int EPT = 8;           // consecutive elements per thread
constexpr int TILE = NT * EPT;   // elements per block
constexpr int NT_CARRY = 1024;   // threads per block, pass 2
constexpr int MAX_KS = 32;       // ks per launch (shared histogram rows)
constexpr int MAX_MEMBERS = 64;  // one 64-bit member mask

struct KList {
  int k[MAX_KS];
  int n;
};

// Segmented-OR scan value: f = a run starts inside, v = OR since the last
// start (or of everything when none does).
struct Seg {
  int f;
  u64 v;
};

__device__ __forceinline__ Seg seg_combine(Seg a, Seg b) {  // a precedes b
  Seg r;
  r.f = a.f | b.f;
  r.v = b.f ? b.v : (a.v | b.v);
  return r;
}

// Exclusive segmented-OR scan across the block's threads; *total gets the
// whole block's value.  sh holds one Seg per warp.
template <int NTHREADS>
__device__ Seg block_seg_scan(Seg x, Seg* total, Seg* sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Seg inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    Seg o;
    o.f = __shfl_up_sync(0xffffffffu, inc.f, off);
    o.v = __shfl_up_sync(0xffffffffu, inc.v, off);
    if (lane >= off) inc = seg_combine(o, inc);
  }
  Seg exc;
  exc.f = __shfl_up_sync(0xffffffffu, inc.f, 1);
  exc.v = __shfl_up_sync(0xffffffffu, inc.v, 1);
  if (lane == 0) {
    exc.f = 0;
    exc.v = 0ull;
  }
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  Seg pre = {0, 0ull};
  Seg tot = {0, 0ull};
  for (int w = 0; w < NTHREADS / 32; ++w) {
    if (w < warp) pre = seg_combine(pre, sh[w]);
    tot = seg_combine(tot, sh[w]);
  }
  __syncthreads();  // sh is reused by the next call
  *total = tot;
  return seg_combine(pre, exc);
}

__device__ __forceinline__ int clz128(u64 hi, u64 lo) {
  return hi ? __clzll(hi) : 64 + __clzll(lo);
}

// Element i's key as a left-aligned 128-bit value (zeros below KW words).
template <int KW>
__device__ __forceinline__ void load_key(const long long* __restrict__ words,
                                         long long n, long long i, u64& hi,
                                         u64& lo, unsigned& last) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < KW; ++j) w[j] = (unsigned)__ldg(words + j * n + i);
  hi = ((u64)w[0] << 32) | w[1];
  lo = ((u64)w[2] << 32) | w[3];
  last = w[KW - 1];
}

// A thread's EPT elements: keys, (gid << 8 | nio), and lcp[e] = equal
// leading key bits of element base+e against its predecessor (0 at the
// array's first element and past its end, so both start/close runs).
template <int KW, bool PACKED>
__device__ __forceinline__ void load_thread(
    const long long* __restrict__ words, const long long* __restrict__ pay,
    long long n, long long base, u64 (&hi)[EPT], u64 (&lo)[EPT],
    int (&gn)[EPT], int (&lcp)[EPT + 1]) {
  u64 phi = 0ull, plo = 0ull;
  unsigned last = 0u;
  if (base > 0 && base - 1 < n) load_key<KW>(words, n, base - 1, phi, plo, last);
#pragma unroll
  for (int e = 0; e <= EPT; ++e) {
    const long long i = base + e;
    u64 h = 0ull, l = 0ull;
    int g = 0;
    int c = 0;
    if (i < n) {
      load_key<KW>(words, n, i, h, l, last);
      if (PACKED) {
        g = (int)(((last >> 6) & 63u) << 8 | (last & 63u));
      } else {
        const unsigned p = (unsigned)__ldg(pay + i);
        g = (int)(((p >> 8) & 255u) << 8 | (p & 255u));
      }
      c = (i == 0) ? 0 : clz128(h ^ phi, l ^ plo);
    }
    lcp[e] = c;
    if (e < EPT) {
      hi[e] = h;
      lo[e] = l;
      gn[e] = g;
    }
    phi = h;
    plo = l;
  }
}

__device__ __forceinline__ u64 member_mask(int gn, int k) {
  const int gid = gn >> 8;
  const int nio = gn & 255;
  return (nio >= k && gid < MAX_MEMBERS) ? (1ull << gid) : 0ull;
}

// Segmented-OR summary of a thread's elements for one k.
__device__ __forceinline__ Seg thread_summary(const int (&gn)[EPT],
                                              const int (&lcp)[EPT + 1],
                                              long long base, long long n,
                                              int k) {
  Seg s = {0, 0ull};
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    if (base + e < n) {
      const u64 m = member_mask(gn[e], k);
      if (lcp[e] < 2 * k) {
        s.f = 1;
        s.v = m;
      } else {
        s.v |= m;
      }
    }
  }
  return s;
}

// Reverse the 2-bit groups of a 64-bit word.
__device__ __forceinline__ u64 rev2(u64 x) {
  x = ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
  return __brevll(x);
}

// True when the top 2k bits (the k-mer) equal their reverse complement.
__device__ __forceinline__ bool is_pal(u64 hi, u64 lo, int k2) {
  // reverse complement of the whole 128-bit value: its low k2 bits are
  // the k-mer's reverse complement; move them to the top
  const u64 rhi = rev2(~lo);
  const u64 rlo = rev2(~hi);
  const int s = 128 - k2;  // 2 <= s <= 124
  u64 shi, slo;
  if (s >= 64) {
    shi = rlo << (s - 64);
    slo = 0ull;
  } else {
    shi = (rhi << s) | (rlo >> (64 - s));
    slo = rlo << s;
  }
  return clz128(hi ^ shi, lo ^ slo) >= k2;
}

// Pass 1: per tile and k, the tile's segmented-OR summary.
template <int KW, bool PACKED>
__global__ void __launch_bounds__(NT)
    tile_summaries(const long long* __restrict__ words,
                   const long long* __restrict__ pay, long long n, KList ks,
                   int* __restrict__ tile_f, u64* __restrict__ tile_v,
                   int n_tiles) {
  __shared__ Seg sh[NT / 32];
  const long long base = (long long)blockIdx.x * TILE + (long long)threadIdx.x * EPT;
  u64 hi[EPT], lo[EPT];
  int gn[EPT], lcp[EPT + 1];
  load_thread<KW, PACKED>(words, pay, n, base, hi, lo, gn, lcp);
#pragma unroll 1
  for (int q = 0; q < ks.n; ++q) {
    Seg tot;
    block_seg_scan<NT>(thread_summary(gn, lcp, base, n, ks.k[q]), &tot, sh);
    if (threadIdx.x == 0) {
      tile_f[(long long)q * n_tiles + blockIdx.x] = tot.f;
      tile_v[(long long)q * n_tiles + blockIdx.x] = tot.v;
    }
  }
}

// Pass 2: one block per k turns the tile summaries into each tile's
// carry-in (the OR of the run still open where the tile begins).
__global__ void __launch_bounds__(NT_CARRY)
    tile_carries(const int* __restrict__ tile_f, const u64* __restrict__ tile_v,
                 u64* __restrict__ carry, int n_tiles) {
  __shared__ Seg sh[NT_CARRY / 32];
  const long long off = (long long)blockIdx.x * n_tiles;
  const int per = (n_tiles + NT_CARRY - 1) / NT_CARRY;
  const int t0 = min((int)threadIdx.x * per, n_tiles);
  const int t1 = min(t0 + per, n_tiles);
  Seg s = {0, 0ull};
  for (int t = t0; t < t1; ++t) s = seg_combine(s, Seg{tile_f[off + t], tile_v[off + t]});
  Seg tot;
  Seg run = block_seg_scan<NT_CARRY>(s, &tot, sh);
  for (int t = t0; t < t1; ++t) {
    carry[off + t] = run.v;
    run = seg_combine(run, Seg{tile_f[off + t], tile_v[off + t]});
  }
}

// Pass 3: rescan each tile with its carry-in; count each run at its end.
template <int KW, bool PACKED>
__global__ void __launch_bounds__(NT)
    count_runs(const long long* __restrict__ words,
               const long long* __restrict__ pay, long long n, KList ks,
               const u64* __restrict__ carry, int n_tiles, int n_members,
               int cs, u64* __restrict__ hist) {
  __shared__ Seg sh[NT / 32];
  __shared__ unsigned h[2][MAX_KS][MAX_MEMBERS];
  for (int j = threadIdx.x; j < 2 * MAX_KS * MAX_MEMBERS; j += NT) (&h[0][0][0])[j] = 0u;
  __syncthreads();
  const long long base = (long long)blockIdx.x * TILE + (long long)threadIdx.x * EPT;
  u64 hi[EPT], lo[EPT];
  int gn[EPT], lcp[EPT + 1];
  load_thread<KW, PACKED>(words, pay, n, base, hi, lo, gn, lcp);
#pragma unroll 1
  for (int q = 0; q < ks.n; ++q) {
    const int k = ks.k[q];
    const int k2 = 2 * k;
    Seg tot;
    const Seg ex = block_seg_scan<NT>(thread_summary(gn, lcp, base, n, k), &tot, sh);
    u64 acc = ex.f ? ex.v : (carry[(long long)q * n_tiles + blockIdx.x] | ex.v);
    // consecutive run ends often share a bin: count them locally first
    int pend_b = 0;
    unsigned pend_c = 0u;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      if (base + e < n) {
        const u64 m = member_mask(gn[e], k);
        acc = (lcp[e] < k2) ? m : (acc | m);
        if (lcp[e + 1] < k2) {  // the run closes at this element
          const int b = min(__popcll(acc), cs);
          if (b >= 1 && b <= n_members) {
            if (b != pend_b) {
              if (pend_c) atomicAdd(&h[0][q][pend_b - 1], pend_c);
              pend_b = b;
              pend_c = 0u;
            }
            ++pend_c;
            if ((k & 1) == 0 && is_pal(hi[e], lo[e], k2)) atomicAdd(&h[1][q][b - 1], 1u);
          }
        }
      }
    }
    if (pend_c) atomicAdd(&h[0][q][pend_b - 1], pend_c);
  }
  __syncthreads();
  const int per_p = ks.n * n_members;
  for (int j = threadIdx.x; j < 2 * per_p; j += NT) {
    const int p = j / per_p;
    const int q = (j % per_p) / n_members;
    const int b = j % n_members;
    const unsigned v = h[p][q][b];
    if (v) atomicAdd(&hist[j], (u64)v);
  }
}

template <int KW, bool PACKED>
int launch_all(const long long* words, const long long* pay, long long n,
               const KList& ks, int n_members, int cs, int* tile_f,
               u64* tile_v, u64* carry, u64* hist, cudaStream_t st) {
  const int n_tiles = (int)((n + TILE - 1) / TILE);
  tile_summaries<KW, PACKED><<<n_tiles, NT, 0, st>>>(words, pay, n, ks, tile_f, tile_v, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_carries<<<ks.n, NT_CARRY, 0, st>>>(tile_f, tile_v, carry, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  count_runs<KW, PACKED><<<n_tiles, NT, 0, st>>>(words, pay, n, ks, carry, n_tiles,
                                                 n_members, cs, hist);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ksweep_scan_tile_elems() { return TILE; }

extern "C" int ksweep_scan_max_ks() { return MAX_KS; }

// words: int64 [KW, n]; payload: int64 [n] or null when packed; ks: host
// array of n_ks ints; tile_f: int32 [n_ks, n_tiles]; tile_v, carry: int64
// [n_ks, n_tiles]; hist: zeroed int64 [2, n_ks, n_members].  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ksweep_scan_launch(const void* words, const void* payload,
                                  long long n, int KW, int packed,
                                  const int* ks, int n_ks, int n_members,
                                  int cs, void* tile_f, void* tile_v,
                                  void* carry, void* hist, void* stream) {
  if (n <= 0 || KW < 1 || KW > 4 || n_ks < 1 || n_ks > MAX_KS ||
      n_members < 1 || n_members > MAX_MEMBERS || cs < 1 ||
      (!packed && payload == nullptr))
    return (int)cudaErrorInvalidValue;
  KList kl;
  for (int q = 0; q < n_ks; ++q) kl.k[q] = ks[q];
  kl.n = n_ks;
  const long long* w = static_cast<const long long*>(words);
  const long long* p = static_cast<const long long*>(payload);
  int* tf = static_cast<int*>(tile_f);
  u64* tv = static_cast<u64*>(tile_v);
  u64* c = static_cast<u64*>(carry);
  u64* hs = static_cast<u64*>(hist);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KSWEEP_CASE(K)                                                             \
  case K:                                                                          \
    return packed ? launch_all<K, true>(w, p, n, kl, n_members, cs, tf, tv, c, hs, st) \
                  : launch_all<K, false>(w, p, n, kl, n_members, cs, tf, tv, c, hs, st);
  switch (KW) {
    KSWEEP_CASE(1)
    KSWEEP_CASE(2)
    KSWEEP_CASE(3)
    KSWEEP_CASE(4)
  }
#undef KSWEEP_CASE
  return (int)cudaErrorInvalidValue;
}
