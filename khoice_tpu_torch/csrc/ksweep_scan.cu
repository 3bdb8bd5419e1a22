// Multi-k scan over ONE shared-sorted doubled-text array, in five modes:
// exp1's occurrence histograms ("occ") and the classification modes of
// exp2/3/4 (pivot_rest, multi_pivot, containment, buckets).
//
// Replaces the TPU kernel khoice_tpu/kernels/ksweep_scan_pallas.py::_kernel
// (:299-482; scan_multi_k_pallas :527 -> _scan_chunk :490, pallas_call
// :504) in every mode.  For each k of a list it computes what the XLA
// scans compute with raw=True:
//   occ          khoice_tpu/engine/ksweep.py::_scan_multi_k_xla
//   pivot_rest   khoice_tpu/engine/ksweep_classify.py::_sweep_class_pivot_rest
//   multi_pivot  ...::_sweep_class_multi_pivot
//   containment  ...::_sweep_class_containment
//   buckets      ...::_sweep_class_feature_buckets   (ksweep_classify.py:115-372)
// i.e. the per-mode binning of _mode_stats (ksweep_scan_pallas.py:221-282)
// and the buckets weight channel (_satadd16 :180, _seg_sum_2level :192,
// _kernel :347-374, :405-421, :444-453).
//
// The elements sort by their forward kmax-mer, so every k <= kmax groups
// them into runs of equal top-2k key bits.  A segmented OR of one-hot
// member masks (element counted iff nio >= k) over each run gives the
// run's member mask `acc` at its last element, where the run is binned:
//   occ          (p0 = n_members, p1 = cs): b = min(popc(acc), cs), bin b-1
//   pivot_rest   (p0 = n_rest): bit 0 set -> bin popc(rest bits 1..n_rest)
//   multi_pivot  (p0 = D): for each set pivot bit num < D, bin
//                num*D + popc(group bits D..2D-1 without group num's own)
//   containment  (p0 = nq, p1 = ng): for each set query bit q, bin
//                q*(ng+1), plus q*(ng+1)+1+g for each set group bit g
//   buckets      (p0 = D, p1 = cap): bit 0 set, m = popc(group bits 1..D):
//                bin d*D+m-1 for each set group d, or bin D*D when m = 0;
//                each hit weighs w = min(pal ? s>>1 : s, cap), s the run's
//                count of pivot elements (gid 0, nio >= k): a segmented SUM
//                riding the OR scan.  The TPU summed in saturating 16-bit
//                lanes (SUM_SAT 1023, cap <= 511); here s is an exact
//                32-bit count, and min(min(S,1023)>>1, cap) = min(S>>1, cap)
//                for every cap <= 511, so the results are equal and any cap
//                is taken.  Palindromic runs are halved before the cap.
//   hist[0][k][bin] counts (buckets: weighs) every run  (doubled stats)
//   hist[1][k][bin] only palindromic runs, even k       (palindromic stats)
// and the caller combines (d + p) // 2.
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
// elements).  The occ version takes ~6.7 ms there (H100 80GB HBM3,
// 700 W): the per-k block scans (warp shuffles and two barriers per k and
// pass) dominate, not the reads.  What the design does about the bytes:
//   * the top-2k comparison of every k comes from ONE number per element,
//     the count of equal leading key bits against its predecessor (lcp):
//     element i starts a k-run iff lcp(i) < 2k;
//   * one 64-bit mask per k covers up to 64 members in a single channel
//     (the TPU kernel packed several ks into sub-words of a u32 and capped
//     members at 32, the classification modes at 32 members and 128 bins);
//   * CUDA blocks run in no order, so the TPU kernel's sequential-grid
//     carry (previous key, open run's OR and pivot sum, pal bits in SMEM)
//     becomes three passes (the helpers of seg_scan.cuh): (1) per tile
//     and k, the segmented summary (a run starts in the tile? OR and
//     pivot count of the tile's last open segment); (2) per k, a block
//     scan over the tile summaries gives each tile's carry-in; (3) each
//     tile rescans with its carry-in and bins every run at its end into a
//     shared-memory histogram, flushed with global atomics;
//   * the classification modes add work only where a run closes (one bin
//     or a few per run), not per element; the buckets sum rides the same
//     shuffles as the OR;
//   * the shared histogram is [2][ks per launch][bins] 32-bit counters,
//     sized by the launcher (dynamic shared memory, opted in above 48 KB):
//     up to 3970 bins (buckets, D = 63) leave room for 7 ks per launch,
//     and every extra launch re-reads the array twice; the bench-shape
//     modes (<= 33 bins) take all 30 ks in one launch;
//   * any n: the ragged last tile is masked, no padding or ks-per-call
//     chunking as VMEM forced on the TPU.
// A decoupled look-back single-pass scan, uint32 words and vector loads
// are left for later work.

#include <cuda_runtime.h>

#include "seg_scan.cuh"

namespace {

typedef unsigned long long u64;

constexpr int NT = 256;          // threads per block, passes 1 and 3
constexpr int EPT = 8;           // consecutive elements per thread
constexpr int TILE = NT * EPT;   // elements per block
constexpr int NT_CARRY = 1024;   // threads per block, pass 2
constexpr int MAX_KS = 32;       // ks per launch
constexpr int MAX_MEMBERS = 64;  // one 64-bit member mask
constexpr int SMEM_MARGIN = 1024;  // static shared memory of a block, rounded up

enum Mode { OCC = 0, PIVOT_REST = 1, MULTI_PIVOT = 2, CONTAINMENT = 3, BUCKETS = 4 };

struct KList {
  int k[MAX_KS];
  int n;
};

// Mode parameters (see the table above) and the bins per k.
struct Params {
  int p0;
  int p1;
  int bins;
};

// Segmented scan value (seg_scan.cuh): f = a run starts inside, v = OR
// since the last start (or of everything when none does), s = the pivot
// elements over the same span (buckets mode, SUM, only; 0 elsewhere, so it
// costs nothing).  No padding: f and s share the 8 bytes before v.
template <bool SUM>
struct Seg {
  int f;
  unsigned s;
  u64 v;
  static __device__ __forceinline__ Seg combine(Seg a, Seg b) {  // a precedes b
    return Seg{a.f | b.f, SUM ? (b.f ? b.s : a.s + b.s) : 0u, b.f ? b.v : (a.v | b.v)};
  }
  static __device__ __forceinline__ Seg shfl_up(Seg x, int d) {
    return Seg{__shfl_up_sync(0xffffffffu, x.f, d),
               SUM ? __shfl_up_sync(0xffffffffu, x.s, d) : 0u,
               __shfl_up_sync(0xffffffffu, x.v, d)};
  }
};

__device__ __forceinline__ int clz128(u64 hi, u64 lo) {
  return hi ? __clzll(hi) : 64 + __clzll(lo);
}

__device__ __forceinline__ u64 low_mask(int bits) {  // 0 <= bits <= 64
  return bits >= 64 ? ~0ull : ((1ull << bits) - 1ull);
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

// 1 for an element of the pivot (member 0) counted at k.
__device__ __forceinline__ unsigned pivot_one(int gn, int k) {
  return ((gn >> 8) == 0 && (gn & 255) >= k) ? 1u : 0u;
}

// Segmented summary of a thread's elements for one k.
template <bool SUM>
__device__ __forceinline__ Seg<SUM> thread_summary(const int (&gn)[EPT],
                                              const int (&lcp)[EPT + 1],
                                              long long base, long long n,
                                              int k) {
  Seg<SUM> s{};
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    if (base + e < n) {
      const u64 m = member_mask(gn[e], k);
      const unsigned p = SUM ? pivot_one(gn[e], k) : 0u;
      if (lcp[e] < 2 * k) {
        s.f = 1;
        s.v = m;
        s.s = p;
      } else {
        s.v |= m;
        s.s += p;
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

__device__ __forceinline__ bool even_pal(u64 hi, u64 lo, int k) {
  return (k & 1) == 0 && is_pal(hi, lo, 2 * k);
}

__device__ __forceinline__ void hit(unsigned* hd, unsigned* hp, int b,
                                    unsigned w, bool pal) {
  atomicAdd(&hd[b], w);
  if (pal) atomicAdd(&hp[b], w);
}

// Bin one closed classification run (member mask acc, pivot count s) into
// the block's doubled (hd) and palindromic (hp) rows of this k.
template <int MODE>
__device__ __forceinline__ void close_run(u64 acc, unsigned s, int k, u64 hi,
                                          u64 lo, const Params& mp,
                                          unsigned* hd, unsigned* hp) {
  if (MODE == PIVOT_REST) {
    if (!(acc & 1ull)) return;
    hit(hd, hp, __popcll((acc >> 1) & low_mask(mp.p0)), 1u, even_pal(hi, lo, k));
  } else if (MODE == MULTI_PIVOT) {
    const int D = mp.p0;  // <= 32
    u64 piv = acc & low_mask(D);
    if (!piv) return;
    const u64 grp = (acc >> D) & low_mask(D);
    const bool pal = even_pal(hi, lo, k);
    while (piv) {
      const int num = __ffsll((long long)piv) - 1;
      piv &= piv - 1ull;
      hit(hd, hp, num * D + __popcll(grp & ~(1ull << num)), 1u, pal);
    }
  } else if (MODE == CONTAINMENT) {
    const int nq = mp.p0, ng = mp.p1;  // nq + ng <= 64
    u64 qm = acc & low_mask(nq);
    if (!qm) return;
    const u64 gm = nq < 64 ? ((acc >> nq) & low_mask(ng)) : 0ull;
    const bool pal = even_pal(hi, lo, k);
    while (qm) {
      const int row = (__ffsll((long long)qm) - 1) * (ng + 1);
      qm &= qm - 1ull;
      hit(hd, hp, row, 1u, pal);
      for (u64 g = gm; g; g &= g - 1ull) hit(hd, hp, row + __ffsll((long long)g), 1u, pal);
    }
  } else if (MODE == BUCKETS) {
    if (!(acc & 1ull)) return;
    const int D = mp.p0;  // <= 63
    const u64 gb = (acc >> 1) & low_mask(D);
    const bool pal = even_pal(hi, lo, k);
    const unsigned w = min(pal ? s >> 1 : s, (unsigned)mp.p1);
    if (w == 0u) return;
    const int m = __popcll(gb);
    if (m == 0) {
      hit(hd, hp, D * D, w, pal);
      return;
    }
    for (u64 g = gb; g; g &= g - 1ull) hit(hd, hp, (__ffsll((long long)g) - 1) * D + m - 1, w, pal);
  }
}

// Pass 1: per tile and k, the tile's segmented summary.
template <int KW, bool PACKED, bool SUM>
__global__ void __launch_bounds__(NT)
    tile_summaries(const long long* __restrict__ words,
                   const long long* __restrict__ pay, long long n, KList ks,
                   int* __restrict__ tile_f, u64* __restrict__ tile_v,
                   unsigned* __restrict__ tile_s, int n_tiles) {
  __shared__ Seg<SUM> sh[NT / 32];
  const long long base = (long long)blockIdx.x * TILE + (long long)threadIdx.x * EPT;
  u64 hi[EPT], lo[EPT];
  int gn[EPT], lcp[EPT + 1];
  load_thread<KW, PACKED>(words, pay, n, base, hi, lo, gn, lcp);
#pragma unroll 1
  for (int q = 0; q < ks.n; ++q) {
    Seg<SUM> tot;
    seg_scan::block_scan<NT>(thread_summary<SUM>(gn, lcp, base, n, ks.k[q]), &tot, sh);
    if (threadIdx.x == 0) {
      const long long t = (long long)q * n_tiles + blockIdx.x;
      tile_f[t] = tot.f;
      tile_v[t] = tot.v;
      if (SUM) tile_s[t] = tot.s;
    }
  }
}

// Pass 2: one block per k turns the tile summaries into each tile's
// carry-in (the OR and pivot count of the run still open where the tile
// begins).
template <bool SUM>
__global__ void __launch_bounds__(NT_CARRY)
    tile_carries(const int* __restrict__ tile_f, const u64* __restrict__ tile_v,
                 const unsigned* __restrict__ tile_s, u64* __restrict__ carry,
                 unsigned* __restrict__ carry_s, int n_tiles) {
  __shared__ Seg<SUM> sh[NT_CARRY / 32];
  const long long off = (long long)blockIdx.x * n_tiles;
  seg_scan::carry_scan<NT_CARRY>(
      n_tiles, sh,
      [&](int t) {
        return Seg<SUM>{tile_f[off + t], SUM ? tile_s[off + t] : 0u, tile_v[off + t]};
      },
      [&](int t, Seg<SUM> c) {
        carry[off + t] = c.v;
        if (SUM) carry_s[off + t] = c.s;
      });
}

// Pass 3: rescan each tile with its carry-in; bin each run at its end
// into the block's histogram h[2][ks.n][mp.bins] (dynamic shared memory).
// Two blocks per SM: without the bound the buckets pass at KW = 4 takes
// 138 registers, one block per SM and 1.54x the time (H100).
template <int KW, bool PACKED, int MODE>
__global__ void __launch_bounds__(NT, 2)
    count_runs(const long long* __restrict__ words,
               const long long* __restrict__ pay, long long n, KList ks,
               const u64* __restrict__ carry, const unsigned* __restrict__ carry_s,
               int n_tiles, Params mp, u64* __restrict__ hist) {
  constexpr bool SUM = MODE == BUCKETS;
  __shared__ Seg<SUM> sh[NT / 32];
  extern __shared__ unsigned h[];
  const int per_p = ks.n * mp.bins;
  for (int j = threadIdx.x; j < 2 * per_p; j += NT) h[j] = 0u;
  __syncthreads();
  const long long base = (long long)blockIdx.x * TILE + (long long)threadIdx.x * EPT;
  u64 hi[EPT], lo[EPT];
  int gn[EPT], lcp[EPT + 1];
  load_thread<KW, PACKED>(words, pay, n, base, hi, lo, gn, lcp);
#pragma unroll 1
  for (int q = 0; q < ks.n; ++q) {
    const int k = ks.k[q];
    const int k2 = 2 * k;
    unsigned* hd = h + q * mp.bins;
    unsigned* hp = h + per_p + q * mp.bins;
    Seg<SUM> tot;
    const Seg<SUM> ex = seg_scan::block_scan<NT>(thread_summary<SUM>(gn, lcp, base, n, k), &tot, sh);
    const long long ci = (long long)q * n_tiles + blockIdx.x;
    u64 acc = ex.f ? ex.v : (carry[ci] | ex.v);
    unsigned sacc = SUM ? (ex.f ? ex.s : carry_s[ci] + ex.s) : 0u;
    // occ: consecutive run ends often share a bin, so count them locally first
    int pend_b = 0;
    unsigned pend_c = 0u;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      if (base + e < n) {
        const u64 m = member_mask(gn[e], k);
        const bool start = lcp[e] < k2;
        acc = start ? m : (acc | m);
        if (SUM) {
          const unsigned p = pivot_one(gn[e], k);
          sacc = start ? p : sacc + p;
        }
        if (lcp[e + 1] < k2) {  // the run closes at this element
          if (MODE == OCC) {
            const int b = min(__popcll(acc), mp.p1);
            if (b >= 1 && b <= mp.p0) {
              if (b != pend_b) {
                if (pend_c) atomicAdd(&hd[pend_b - 1], pend_c);
                pend_b = b;
                pend_c = 0u;
              }
              ++pend_c;
              if (even_pal(hi[e], lo[e], k)) atomicAdd(&hp[b - 1], 1u);
            }
          } else {
            close_run<MODE>(acc, sacc, k, hi[e], lo[e], mp, hd, hp);
          }
        }
      }
    }
    if (MODE == OCC && pend_c) atomicAdd(&hd[pend_b - 1], pend_c);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * per_p; j += NT) {
    const unsigned v = h[j];
    if (v) atomicAdd(&hist[j], (u64)v);
  }
}

struct Launch {
  const long long* words;
  const long long* pay;
  long long n;
  KList ks;
  Params mp;
  int* tile_f;
  u64* tile_v;
  unsigned* tile_s;
  u64* carry;
  unsigned* carry_s;
  u64* hist;
  cudaStream_t st;
};

template <int KW, bool PACKED, int MODE>
int launch_all(const Launch& a) {
  constexpr bool SUM = MODE == BUCKETS;
  const int n_tiles = (int)((a.n + TILE - 1) / TILE);
  tile_summaries<KW, PACKED, SUM><<<n_tiles, NT, 0, a.st>>>(
      a.words, a.pay, a.n, a.ks, a.tile_f, a.tile_v, a.tile_s, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_carries<SUM><<<a.ks.n, NT_CARRY, 0, a.st>>>(a.tile_f, a.tile_v, a.tile_s, a.carry,
                                                   a.carry_s, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = 2 * a.ks.n * a.mp.bins * (int)sizeof(unsigned);
  if (smem + SMEM_MARGIN > 48 * 1024) {  // static + dynamic above the default 48 KB
    err = cudaFuncSetAttribute(count_runs<KW, PACKED, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  count_runs<KW, PACKED, MODE><<<n_tiles, NT, smem, a.st>>>(
      a.words, a.pay, a.n, a.ks, a.carry, a.carry_s, n_tiles, a.mp, a.hist);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_mode(int KW, int packed, const Launch& a) {
#define KSWEEP_CASE(K) \
  case K:              \
    return packed ? launch_all<K, true, MODE>(a) : launch_all<K, false, MODE>(a);
  switch (KW) {
    KSWEEP_CASE(1)
    KSWEEP_CASE(2)
    KSWEEP_CASE(3)
    KSWEEP_CASE(4)
  }
#undef KSWEEP_CASE
  return (int)cudaErrorInvalidValue;
}

int hist_bytes_max() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return optin - SMEM_MARGIN;
}

// Bins per k of a mode's parameters, or -1 when they are out of range.
int mode_bins(int mode, int p0, int p1) {
  switch (mode) {
    case OCC:
      return (p0 >= 1 && p0 <= MAX_MEMBERS && p1 >= 1) ? p0 : -1;
    case PIVOT_REST:
      return (p0 >= 0 && p0 < MAX_MEMBERS) ? p0 + 1 : -1;
    case MULTI_PIVOT:
      return (p0 >= 1 && 2 * p0 <= MAX_MEMBERS) ? p0 * p0 : -1;
    case CONTAINMENT:
      return (p0 >= 1 && p1 >= 0 && p0 + p1 <= MAX_MEMBERS) ? p0 * (p1 + 1) : -1;
    case BUCKETS:
      return (p0 >= 1 && p0 < MAX_MEMBERS && p1 >= 0) ? p0 * p0 + 1 : -1;
  }
  return -1;
}

}  // namespace

extern "C" int ksweep_scan_tile_elems() { return TILE; }

extern "C" int ksweep_scan_max_ks() { return MAX_KS; }

// Largest shared histogram, in bytes, that a block of the count pass can
// hold on the current device (2 x ks per launch x bins x 4 B must fit).
extern "C" int ksweep_scan_hist_bytes_max() { return hist_bytes_max(); }

// One launch of the three passes in mode 0 occ, 1 pivot_rest,
// 2 multi_pivot, 3 containment or 4 buckets, with (p0, p1) as in the
// table at the top and bins their bin count per k.  words: int64 [KW, n];
// payload: int64 [n] or null when packed; ks: host array of n_ks ints;
// tile_f: int32 [n_ks, n_tiles]; tile_v, carry: int64 [n_ks, n_tiles];
// tile_s, carry_s: int32 [n_ks, n_tiles] (buckets only, else null);
// hist: zeroed int64 [2, n_ks, bins].  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int ksweep_scan_launch(const void* words, const void* payload, long long n,
                                  int KW, int packed, const int* ks, int n_ks, int mode,
                                  int p0, int p1, int bins, void* tile_f, void* tile_v,
                                  void* tile_s, void* carry, void* carry_s, void* hist,
                                  void* stream) {
  if (n <= 0 || n >= (1LL << 32) || KW < 1 || KW > 4 || n_ks < 1 || n_ks > MAX_KS ||
      (!packed && payload == nullptr) || bins < 1 || mode_bins(mode, p0, p1) != bins ||
      2LL * n_ks * bins * (long long)sizeof(unsigned) > hist_bytes_max() ||
      (mode == BUCKETS && (tile_s == nullptr || carry_s == nullptr)))
    return (int)cudaErrorInvalidValue;
  Launch a;
  for (int q = 0; q < n_ks; ++q) a.ks.k[q] = ks[q];
  a.ks.n = n_ks;
  a.words = static_cast<const long long*>(words);
  a.pay = static_cast<const long long*>(payload);
  a.n = n;
  a.mp = Params{p0, p1, bins};
  a.tile_f = static_cast<int*>(tile_f);
  a.tile_v = static_cast<u64*>(tile_v);
  a.tile_s = static_cast<unsigned*>(tile_s);
  a.carry = static_cast<u64*>(carry);
  a.carry_s = static_cast<unsigned*>(carry_s);
  a.hist = static_cast<u64*>(hist);
  a.st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case OCC:
      return launch_mode<OCC>(KW, packed, a);
    case PIVOT_REST:
      return launch_mode<PIVOT_REST>(KW, packed, a);
    case MULTI_PIVOT:
      return launch_mode<MULTI_PIVOT>(KW, packed, a);
    case CONTAINMENT:
      return launch_mode<CONTAINMENT>(KW, packed, a);
    case BUCKETS:
      return launch_mode<BUCKETS>(KW, packed, a);
  }
  return (int)cudaErrorInvalidValue;
}
