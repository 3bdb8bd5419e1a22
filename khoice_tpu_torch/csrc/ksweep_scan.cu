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
// One pass, one read.  CUDA blocks run in no order, so the TPU kernel's
// sequential-grid carry (previous key, open run's OR and pivot sum) is a
// single-pass scan with decoupled look-back (Merrill & Garland, 2016), the
// pattern of radix_sort.cu: persistent blocks take tiles of TILE elements
// from an atomic counter (every earlier tile's block is running, so a
// look-back never waits on a block that has not started), and each tile
// publishes per k a status word (aggregate or inclusive) after its value.
// Everything else rests on ONE number per element, the count of equal
// leading key bits against its predecessor (lcp): element i starts a
// k-run iff lcp(i) < 2k, and
//   * a k-run crosses from one thread into the next only when the next
//     thread's first lcp is >= 2k.  A thread whose first lcp is below 2k
//     needs nothing from the threads before it; a warp where no thread's
//     first lcp reaches 2k runs no shuffle at all for that k (one ballot);
//   * where runs do cross threads, the warp's segmented OR is a ballot of
//     the threads that start a run, then shuffle rounds only as far as the
//     longest crossing run reaches (one when each crosses one boundary);
//   * cross-warp and cross-tile work is needed only for the ks with 2k <=
//     the largest lcp at the tile's warp boundaries, its first element and
//     the element after it ("block ks").  For those, each warp's summary
//     (a ballot and two __reduce_or_sync) goes to shared memory during the
//     same pass over the ks that bins the runs; the one run per warp and k
//     that began before the warp has its close deferred (its OR so far in
//     shared memory).  After that pass: one lane per block k publishes the
//     tile's status (only where the next tile's first lcp >= 2k), looks
//     back (only where the tile's own first lcp >= 2k, so a chain of
//     aggregates always reaches an inclusive status) and gives each warp
//     its carry-in; the deferred closes are then binned, one thread each.
//     Two barriers per tile, not two per k;
//   * palindromes (even k): each element's mask of palindromic prefixes
//     is taken once at load (pal_mask: four bit-parallel compares leave
//     ~1 candidate k in 256, checked in full), so the keys are not kept.
// Uniform keys (the bench shape) have block ks up to k ~ 14 of the
// 30-point grid; genomes with repeats and a doubled text have long runs at
// every k, and the same code takes them (phase 3 has a 100 kb poly-A tract
// and a 3000x repeated block).
// Bins: each run is binned at its end into a shared-memory histogram
// [2][ks per launch][bins] (dynamic shared memory, opted in above 48 KB),
// flushed with global atomics once per block.  occ first counts
// consecutive run ends of one bin in a register.  Summing a warp's hits of
// one bin before the atomic (__match_any_sync) was 1.3-6.3x slower.
//
// What bounds it on an H100: the in-block work per (element, k), not the
// bytes (one read: 32 B per element at KW=4, 0.32 ms at 3.35 TB/s for the
// bench shape's 33.6M elements); 64 registers keep four blocks an SM
// without spills; PERF.md has the times and the variants measured.  Up to
// 3970 bins (buckets, D = 63) leave room for 6 ks per launch; any n <
// 2^32, the ragged last tile masked.  uint32 words and vector loads are
// later work.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int NT = 256;          // threads per block
constexpr int NWARPS = NT / 32;
constexpr int EPT = 8;           // consecutive elements per thread
constexpr int TILE = NT * EPT;   // elements per tile
constexpr int MIN_BLOCKS = 4;    // blocks per SM the register budget keeps (64 registers)
constexpr int MAX_KS = 32;       // ks per launch: one lane each in the look-back
constexpr int MAX_MEMBERS = 64;  // one 64-bit member mask
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ST_AGG = 1u;  // status: the tile's own value (no run starts in it)
constexpr unsigned ST_INC = 2u;  // status: the value of the run open at the tile's end

enum Mode { OCC = 0, PIVOT_REST = 1, MULTI_PIVOT = 2, CONTAINMENT = 3, BUCKETS = 4 };

// The ks of a launch; for the even ks (the only ones with palindromes),
// the bit of each k's last base in a 128-bit key (bit 128 - 2k, as
// (hi, lo) words: `pal_at` for k >= 8, `pal_small` below) and the rows q
// of each k (`rows[k]`, a bit per q).
struct KList {
  int k[MAX_KS];
  int n;
  u64 pal_at[2];
  u64 pal_small[2];
  unsigned rows[64];
};

// Mode parameters (see the table above) and the bins per k.
struct Params {
  int p0;
  int p1;
  int bins;
};

// Segmented scan value: f = a run starts inside, v = OR since the last
// start (or of everything when none does), s = the pivot elements over the
// same span (buckets mode, SUM, only; 0 elsewhere).  No padding: f and s
// share the 8 bytes before v.
template <bool SUM>
struct Seg {
  int f;
  unsigned s;
  u64 v;
  static __device__ __forceinline__ Seg combine(Seg a, Seg b) {  // a precedes b
    return Seg{a.f | b.f, SUM ? (b.f ? b.s : a.s + b.s) : 0u, b.f ? b.v : (a.v | b.v)};
  }
};

// Static shared memory of a block (warp totals, carries, deferred closes, the rest),
// rounded up; the histogram takes the dynamic part.
constexpr int SMEM_STATIC = 3 * MAX_KS * NWARPS * 16 + 1024;

// The look-back's arrays: per k and tile a status word (zeroed per
// launch) and, per status kind, the value and the pivot count, written
// before the status and never changed after it.
struct Carries {
  unsigned* status;   // [n_ks][n_tiles], then the tile counter
  u64* val;           // [2][n_ks][n_tiles]: aggregate, inclusive
  unsigned* sum;      // [2][n_ks][n_tiles] (buckets only)
};

__device__ __forceinline__ unsigned load_status(const unsigned* p) {
  return *(const volatile unsigned*)p;
}

__device__ __forceinline__ int clz128(u64 hi, u64 lo) {
  return hi ? __clzll(hi) : 64 + __clzll(lo);
}

__device__ __forceinline__ u64 low_mask(int bits) {  // 0 <= bits <= 64
  return bits >= 64 ? ~0ull : ((1ull << bits) - 1ull);
}

// Reverse the 2-bit groups of a 64-bit word.
__device__ __forceinline__ u64 rev2(u64 x) {
  x = ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
  return __brevll(x);
}

// Bit q set for each even k = ks.k[q] whose k-mer (the key's top 2k bits)
// equals its reverse complement.  Such a k-mer's bases i < 4 are the
// complements of its bases k-1-i, so four compares of every base of the
// key with a complement of one of its first four, shifted into line, leave
// the ks whose last base can end one (about 1 in 256 for each k >= 8);
// only those, and the ks below 8, are checked in full: the low 2k bits of
// rev2(~key) (128 bits: rlo = rev2(~hi) below rhi = rev2(~lo)) are the
// k-mer's reverse complement.
__device__ __forceinline__ unsigned pal_mask(u64 hi, u64 lo, const KList& ks) {
  constexpr u64 PAIRS = 0x5555555555555555ull;
  u64 th = ks.pal_at[0], tl = ks.pal_at[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const u64 c = (u64)(3u - (unsigned)((hi >> (62 - 2 * i)) & 3u)) * PAIRS;
    u64 eh = ~(hi ^ c), el = ~(lo ^ c);
    eh &= (eh >> 1) & PAIRS;  // the low bit of each pair: base == c
    el &= (el >> 1) & PAIRS;
    if (i) {
      el = (el >> (2 * i)) | (eh << (64 - 2 * i));
      eh >>= 2 * i;
    }
    th &= eh;
    tl &= el;
  }
  th |= ks.pal_small[0];
  tl |= ks.pal_small[1];
  if (!(th | tl)) return 0u;
  const u64 rlo = rev2(~hi), rhi = rev2(~lo);
  unsigned pm = 0u;
  while (th | tl) {
    int t;  // bit 128 - 2k
    if (tl) {
      t = __ffsll((long long)tl) - 1;
      tl &= tl - 1ull;
    } else {
      t = 63 + __ffsll((long long)th);
      th &= th - 1ull;
    }
    const int k2 = 128 - t;
    bool pal;
    if (k2 <= 64) {
      pal = (hi >> (64 - k2)) == (rlo & low_mask(k2));
    } else {
      const int s = 128 - k2;  // 2 <= s < 64
      pal = (hi >> s) == (rhi & low_mask(k2 - 64)) && ((hi << (64 - s)) | (lo >> s)) == rlo;
    }
    if (pal) pm |= ks.rows[k2 >> 1];
  }
  return pm;
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

// A thread's EPT elements: (gid << 8 | nio), their palindrome masks
// (pal_mask) and lcp[e] = equal leading key bits of element base+e against
// its predecessor (0 at the array's first element and past its end, so
// both start/close runs).  The keys themselves are not kept.
template <int KW, bool PACKED>
__device__ __forceinline__ void load_thread(
    const long long* __restrict__ words, const long long* __restrict__ pay,
    long long n, long long base, const KList& ks, int (&gn)[EPT],
    unsigned (&pm)[EPT], int (&lcp)[EPT + 1]) {
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
      gn[e] = g;
      pm[e] = i < n ? pal_mask(h, l, ks) : 0u;
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

// Segmented summary of a thread's elements for one k: whether a run
// starts among them, and the OR (pivot count) from the last start on.
template <bool SUM>
__device__ __forceinline__ Seg<SUM> thread_tail(const int (&gn)[EPT],
                                           const int (&lcp)[EPT + 1],
                                           long long base, long long n, int k) {
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

// The warp's combined summary: the last thread that starts a run found by
// a ballot, the OR and the sum of the tails from it on by reductions.
template <bool SUM>
__device__ __forceinline__ Seg<SUM> warp_total(Seg<SUM> x, int lane) {
  const unsigned starts = __ballot_sync(FULL, x.f);
  const bool take = lane >= (starts ? 31 - __clz(starts) : 0);
  const unsigned vlo = __reduce_or_sync(FULL, take ? (unsigned)x.v : 0u);
  const unsigned vhi = __reduce_or_sync(FULL, take ? (unsigned)(x.v >> 32) : 0u);
  const unsigned s = SUM ? __reduce_add_sync(FULL, take ? x.s : 0u) : 0u;
  return Seg<SUM>{starts != 0u, s, ((u64)vhi << 32) | vlo};
}

// Each thread's carry-in from the threads before it in its warp: the OR
// (and pivot count) of the run still open where the thread begins, as far
// as the warp holds it.  A thread's segment reaches back to the last
// thread at or before it that starts a run; the shuffle rounds stop as
// soon as every segment is covered.  A segment that reaches back past the
// warp's first thread lacks the warp's carry-in (the caller defers that
// run's close).
template <bool SUM>
__device__ __forceinline__ Seg<SUM> warp_exclusive(Seg<SUM> x, int lane) {
  const unsigned starts = __ballot_sync(FULL, x.f) & (FULL >> (31 - lane));
  const int first = starts ? 31 - __clz(starts) : 0;
  const int reach = __reduce_max_sync(FULL, (unsigned)(lane - first + 1));
  u64 v = x.v;
  unsigned s = x.s;
  for (int d = 1; d < reach; d <<= 1) {
    const u64 ov = __shfl_up_sync(FULL, v, d);
    const unsigned os = SUM ? __shfl_up_sync(FULL, s, d) : 0u;
    if (lane - d >= first) {
      v |= ov;
      s += os;
    }
  }
  Seg<SUM> exc{0, SUM ? __shfl_up_sync(FULL, s, 1) : 0u, __shfl_up_sync(FULL, v, 1)};
  if (lane == 0) exc = Seg<SUM>{};
  return exc;
}

__device__ __forceinline__ void hit(unsigned* hd, unsigned* hp, int b,
                                    unsigned w, bool pal) {
  atomicAdd(&hd[b], w);
  if (pal) atomicAdd(&hp[b], w);
}

// Bin one closed classification run (member mask acc, pivot count s,
// palindromic or not) into the block's doubled (hd) and palindromic (hp)
// rows of this k.
template <int MODE>
__device__ __forceinline__ void close_run(u64 acc, unsigned s, bool pal, const Params& mp,
                                          unsigned* hd, unsigned* hp) {
  if (MODE == PIVOT_REST) {
    if (!(acc & 1ull)) return;
    hit(hd, hp, __popcll((acc >> 1) & low_mask(mp.p0)), 1u, pal);
  } else if (MODE == MULTI_PIVOT) {
    const int D = mp.p0;  // <= 32
    u64 piv = acc & low_mask(D);
    if (!piv) return;
    const u64 grp = (acc >> D) & low_mask(D);
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

// Publish a tile's value of one k under a status kind (ST_AGG, ST_INC).
template <bool SUM>
__device__ __forceinline__ void publish(const Carries& c, long long at, long long kind_stride,
                                        unsigned kind, Seg<SUM> x) {
  const long long j = (kind == ST_INC ? kind_stride : 0) + at;
  c.val[j] = x.v;
  if (SUM) c.sum[j] = x.s;
  __threadfence();
  *(volatile unsigned*)(c.status + at) = kind;
}

// The run open where tile t begins, for the k at row q: the values of the
// tiles before it back to the first inclusive status (a tile publishes an
// aggregate only when no run starts in it, so the chain ends there).
template <bool SUM>
__device__ __forceinline__ Seg<SUM> look_back(const Carries& c, int q, int t, int n_tiles,
                                              long long kind_stride) {
  Seg<SUM> carry{};
  for (int tt = t - 1;; --tt) {
    const long long at = (long long)q * n_tiles + tt;
    unsigned st;
    do {
      st = load_status(c.status + at);
    } while (st == 0u);
    __threadfence();
    const long long j = (st == ST_INC ? kind_stride : 0) + at;
    carry.v |= *(const volatile u64*)(c.val + j);
    if (SUM) carry.s += *(const volatile unsigned*)(c.sum + j);
    if (st == ST_INC) return carry;
  }
}

// A closed occ run (member mask acc) into the block's doubled (hd) and
// palindromic (hp) rows of its k.
__device__ __forceinline__ void close_occ(u64 acc, bool pal, const Params& mp, unsigned* hd,
                                          unsigned* hp) {
  const int b = min(__popcll(acc), mp.p1);
  if (b < 1 || b > mp.p0) return;
  atomicAdd(&hd[b - 1], 1u);
  if (pal) atomicAdd(&hp[b - 1], 1u);
}

// Bin the runs that close among a thread's elements for the k at row q,
// the run open where the thread begins entering with (acc, sacc).  A
// `carried` run (begun before the warp) is not binned where it closes: its
// value so far goes to *defer, to be completed with the warp's carry-in;
// returns whether it went there.  (A second copy of the loop without this
// tracking, for the warps that carry no run, was faster on uniform keys
// and slower on related genomes: PERF.md.)
template <int MODE>
__device__ __forceinline__ bool bin_runs(const int (&gn)[EPT], const int (&lcp)[EPT + 1],
                                         const unsigned (&pm)[EPT], long long base, long long n,
                                         int q, int k, u64 acc, unsigned sacc, bool carried,
                                         const Params& mp, unsigned* hd, unsigned* hp,
                                         Seg<MODE == BUCKETS>* defer) {
  constexpr bool SUM = MODE == BUCKETS;
  const int k2 = 2 * k;
  bool deferred = false;
  // occ: consecutive run ends often share a bin, so count them locally first
  int pend_b = 0;
  unsigned pend_c = 0u;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    if (base + e < n) {
      const u64 m = member_mask(gn[e], k);
      const bool start = lcp[e] < k2;
      carried &= !start;
      acc = start ? m : (acc | m);
      if (SUM) {
        const unsigned p = pivot_one(gn[e], k);
        sacc = start ? p : sacc + p;
      }
      if (lcp[e + 1] < k2) {  // the run closes at this element
        const bool pal = (pm[e] >> q) & 1u;
        if (carried) {
          *defer = Seg<SUM>{1 + (int)pal, sacc, acc};
          deferred = true;
          carried = false;
        } else if (MODE == OCC) {
          const int b = min(__popcll(acc), mp.p1);
          if (b >= 1 && b <= mp.p0) {
            if (b != pend_b) {
              if (pend_c) atomicAdd(&hd[pend_b - 1], pend_c);
              pend_b = b;
              pend_c = 0u;
            }
            ++pend_c;
            if (pal) atomicAdd(&hp[b - 1], 1u);
          }
        } else {
          close_run<MODE>(acc, sacc, pal, mp, hd, hp);
        }
      }
    }
  }
  if (MODE == OCC && pend_c) atomicAdd(&hd[pend_b - 1], pend_c);
  return deferred;
}

// The scan: persistent blocks, one tile at a time; every run is binned at
// its end into the block's histogram h[2][ks.n][mp.bins] (dynamic shared
// memory), flushed once per block.  Per tile: the loads, one pass over the
// ks that bins every run whose OR the warp knows, then, for the block ks,
// the tile's status and look-back and the run each warp continues from
// before it (at most one per warp and k, its close deferred until then).
template <int KW, bool PACKED, int MODE>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    scan_tiles(const long long* __restrict__ words, const long long* __restrict__ pay,
               long long n, KList ks, Params mp, int n_tiles, Carries c,
               u64* __restrict__ hist) {
  constexpr bool SUM = MODE == BUCKETS;
  __shared__ Seg<SUM> s_tot[MAX_KS][NWARPS];    // each warp's summary per block k
  __shared__ Seg<SUM> s_carry[MAX_KS][NWARPS];  // the run open where each warp begins
  __shared__ Seg<SUM> s_defer[MAX_KS][NWARPS];  // the close of that run in the warp: f = 0
                                                // none, 1 one, 2 a palindromic one
  __shared__ int s_bound[NWARPS + 1];           // lcp at each warp's first element, then after the tile
  __shared__ int s_tile;
  extern __shared__ unsigned h[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per_p = ks.n * mp.bins;
  const long long kind_stride = (long long)ks.n * n_tiles;
  for (int j = tid; j < 2 * per_p; j += NT) h[j] = 0u;

  for (;;) {
    if (tid == 0) s_tile = (int)atomicAdd(c.status + kind_stride, 1u);
    __syncthreads();
    const int t = s_tile;
    if (t >= n_tiles) break;
    const long long base = (long long)t * TILE + (long long)tid * EPT;
    int gn[EPT], lcp[EPT + 1];
    unsigned pm[EPT];
    load_thread<KW, PACKED>(words, pay, n, base, ks, gn, pm, lcp);
    if (lane == 0) s_bound[warp] = lcp[0];
    if (tid == NT - 1) s_bound[NWARPS] = lcp[EPT];
    __syncthreads();
    int bmax = 0;
#pragma unroll
    for (int w = 0; w <= NWARPS; ++w) bmax = max(bmax, s_bound[w]);
    unsigned block_ks = 0u;
    for (int q = 0; q < ks.n; ++q)
      if (2 * ks.k[q] <= bmax) block_ks |= 1u << q;

#pragma unroll 1
    for (int q = 0; q < ks.n; ++q) {
      const int k = ks.k[q];
      const int k2 = 2 * k;
      const bool block = (block_ks >> q) & 1u;
      unsigned* hd = h + q * mp.bins;
      unsigned* hp = h + per_p + q * mp.bins;
      const bool head = lcp[0] >= k2;  // the thread's first element continues a run
      // the run open where the thread begins, from the threads before it
      // in the warp; `carried`: it began before the warp (its close waits
      // for the warp's carry-in)
      u64 acc = 0ull;
      unsigned sacc = 0u;
      bool carried = false;
      const bool any_head = __any_sync(FULL, head);
      if (block || any_head) {
        const Seg<SUM> tail = thread_tail<SUM>(gn, lcp, base, n, k);
        if (any_head) {
          const Seg<SUM> exc = warp_exclusive(tail, lane);
          const unsigned starts = __ballot_sync(FULL, tail.f);
          carried = head && !(starts & ((1u << lane) - 1u));
          if (head) {
            acc = exc.v;
            sacc = exc.s;
          }
        }
        if (block) {
          const Seg<SUM> tot = warp_total(tail, lane);
          if (lane == 0) s_tot[q][warp] = tot;
        }
      }
      const bool deferred = bin_runs<MODE>(gn, lcp, pm, base, n, q, k, acc, sacc, carried, mp,
                                           hd, hp, &s_defer[q][warp]);
      if (block) {
        const bool any_deferred = __any_sync(FULL, deferred);
        if (lane == 0 && !any_deferred) s_defer[q][warp].f = 0;
      }
    }

    if (block_ks) {
      // (warp 0, one lane per block k) the tile's status, its look-back
      // and each warp's carry-in; then each deferred close
      __syncthreads();
      if (warp == 0 && lane < ks.n && ((block_ks >> lane) & 1u)) {
        const int q = lane, k2 = 2 * ks.k[q];
        const long long at = (long long)q * n_tiles + t;
        Seg<SUM> agg{};
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) agg = Seg<SUM>::combine(agg, s_tot[q][w]);
        const bool out = s_bound[NWARPS] >= k2;  // the next tile continues a run
        if (out) publish(c, at, kind_stride, agg.f ? ST_INC : ST_AGG, agg);
        Seg<SUM> run{};
        if (s_bound[0] >= k2) {  // this tile continues a run
          run = look_back<SUM>(c, q, t, n_tiles, kind_stride);
          if (out && !agg.f) publish(c, at, kind_stride, ST_INC, Seg<SUM>::combine(run, agg));
        }
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) {
          s_carry[q][w] = run;
          run = Seg<SUM>::combine(run, s_tot[q][w]);
        }
      }
      __syncthreads();
      for (int j = tid; j < ks.n * NWARPS; j += NT) {
        const int q = j / NWARPS, w = j % NWARPS;
        if (!((block_ks >> q) & 1u) || !s_defer[q][w].f) continue;
        const Seg<SUM> d = s_defer[q][w], in = s_carry[q][w];
        unsigned* hd = h + q * mp.bins;
        unsigned* hp = h + per_p + q * mp.bins;
        if (MODE == OCC) {
          close_occ(in.v | d.v, d.f == 2, mp, hd, hp);
        } else {
          close_run<MODE>(in.v | d.v, in.s + d.s, d.f == 2, mp, hd, hp);
        }
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < 2 * per_p; j += NT) {
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
  Carries c;
  u64* hist;
  cudaStream_t st;
};

template <int KW, bool PACKED, int MODE>
int launch_scan(const Launch& a) {
  const int n_tiles = (int)((a.n + TILE - 1) / TILE);
  const int smem = 2 * a.ks.n * a.mp.bins * (int)sizeof(unsigned);
  auto kernel = scan_tiles<KW, PACKED, MODE>;
  cudaError_t err;
  if (smem + SMEM_STATIC > 48 * 1024) {  // static + dynamic above the default 48 KB
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = (int)min((long long)n_tiles, (long long)sms * per_sm);
  kernel<<<grid, NT, smem, a.st>>>(a.words, a.pay, a.n, a.ks, a.mp, n_tiles, a.c, a.hist);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_mode(int KW, int packed, const Launch& a) {
#define KSWEEP_CASE(K) \
  case K:              \
    return packed ? launch_scan<K, true, MODE>(a) : launch_scan<K, false, MODE>(a);
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
  return optin - SMEM_STATIC;
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

// Largest shared histogram, in bytes, that a block can hold on the
// current device (2 x ks per launch x bins x 4 B must fit).
extern "C" int ksweep_scan_hist_bytes_max() { return hist_bytes_max(); }

// One launch of the scan in mode 0 occ, 1 pivot_rest, 2 multi_pivot,
// 3 containment or 4 buckets, with (p0, p1) as in the table at the top and
// bins their bin count per k.  words: int64 [KW, n]; payload: int64 [n] or
// null when packed; ks: host array of n_ks ints; status: zeroed int32
// [n_ks * n_tiles + 1] (n_tiles by ksweep_scan_tile_elems; the tile
// counter last); vals: int64 [2, n_ks, n_tiles]; sums: int32 [2, n_ks,
// n_tiles] (buckets only, else null); hist: zeroed int64 [2, n_ks, bins].
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ksweep_scan_launch(const void* words, const void* payload, long long n,
                                  int KW, int packed, const int* ks, int n_ks, int mode,
                                  int p0, int p1, int bins, void* status, void* vals,
                                  void* sums, void* hist, void* stream) {
  if (n <= 0 || n >= (1LL << 32) || KW < 1 || KW > 4 || n_ks < 1 || n_ks > MAX_KS ||
      (!packed && payload == nullptr) || bins < 1 || mode_bins(mode, p0, p1) != bins ||
      2LL * n_ks * bins * (long long)sizeof(unsigned) > hist_bytes_max() ||
      status == nullptr || vals == nullptr || (mode == BUCKETS && sums == nullptr))
    return (int)cudaErrorInvalidValue;
  Launch a = {};
  for (int q = 0; q < n_ks; ++q) {
    const int k = ks[q];
    if (k < 2 || k > 63) return (int)cudaErrorInvalidValue;
    a.ks.k[q] = k;
    if (k & 1) continue;
    const int t = 128 - 2 * k;
    u64* at = k >= 8 ? a.ks.pal_at : a.ks.pal_small;
    at[t >= 64 ? 0 : 1] |= 1ull << (t & 63);
    a.ks.rows[k] |= 1u << q;
  }
  a.ks.n = n_ks;
  a.words = static_cast<const long long*>(words);
  a.pay = static_cast<const long long*>(payload);
  a.n = n;
  a.mp = Params{p0, p1, bins};
  a.c = Carries{static_cast<unsigned*>(status), static_cast<u64*>(vals),
                static_cast<unsigned*>(sums)};
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
