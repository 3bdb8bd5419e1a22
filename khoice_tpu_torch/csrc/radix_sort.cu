// Stable LSD radix sort of multi-word keys: the port's multi-word sort,
// which every sort of the engine goes through (the shared-sort sweeps,
// the streaming sweep, the per-k path, the table ops and the annotation).
//
// Replaces the TPU kernel khoice_tpu/kernels/merge_pallas.py::merge_sort
// (:340; merge levels _merge_level :245, pallas_call :261, body
// _merge_kernel :147) in its role, and the flat lax.sort it was built to
// replace in khoice_tpu/engine/ksweep.py::_sweep_doubled (:384, :386).
// The TPU sorted with row sorts and merge-path merges because it has no
// cheap scatter; a GPU has one, so the port sorts by scattering 8-bit
// digits, least significant first.
//
// What it computes (kernels/sort.py::sort_words_reference is the plain
// version): int64 [W, n] rows of 32-bit values (W = 1..5, most significant
// word first) sorted as unsigned W*32-bit keys; an optional int64 [n]
// payload follows its element.  The sort is STABLE: equal keys keep their
// input order (the table merge, engine/ops.py::_merge_two, and the
// annotation depend on it), so the result, payload included, is fully
// determined and equals the plain version's bit for bit.
//
// Records.  Between passes every element is one record of R = W (+2 with
// a payload) uint32 words, its key words then its payload's low and high
// halves, records back to back (element-major), so a tile moves whole
// records with 16-byte loads and a bucket's run in a tile is one
// contiguous stretch of R * 4 bytes per element.
//
// Kernels (one launch each):
//   first pass  - reads the int64 rows once, writes the records, and takes
//                 every byte digit's global histogram over the elements
//                 that are not all ones (the SENTINEL windows, the largest
//                 key), their count, and 1 + the index of the last element
//                 that is not all ones;
//   digit pass  - per digit of the wrapper's plan, least significant
//                 first, a one-sweep pass with decoupled look-back
//                 (Adinets & Merrill, "Onesweep", 2022): a block takes its
//                 tile from an atomic counter (so every earlier tile has
//                 started and the look-back cannot wait on a block that is
//                 not running), copies the tile's records into shared
//                 memory, ranks its elements stably by digit (warps own
//                 contiguous slices taken 32 at a time; lanes with equal
//                 digits found with nine ballots), publishes each bucket's
//                 count (flag, pass number, count in one 64-bit word), looks
//                 back over the earlier tiles for the elements of its
//                 bucket before it, and writes the records in sorted order
//                 from shared memory: consecutive lanes store consecutive
//                 words of a bucket's run.  All-ones elements go to a 257th
//                 bucket after bucket 255 in every pass, so they stay at the
//                 tail in input order, where the stable plain sort puts
//                 them; their tile prefix needs no look-back (the earlier
//                 tiles' elements less their other buckets' prefixes);
//   last pass   - the same pass over the plan's last digit, writing the
//                 int64 rows and the payload directly.
// The wrapper reads the first pass's statistics back (one synchronisation
// per sort) and plans the digits: those on which the elements that are not
// all ones fall into more than one bucket (kernels/sort.py::plan_passes).
// A stable pass over any other digit is the identity on them, so the skip
// is exact.  The per-k words (SENTINEL windows, all ones) run 9 passes at
// k = 31 and 14 at k = 49 instead of 12 and 16; packed master keys skip
// their 18 spare bits' constant byte.
//
// What bounds it on an H100: bytes.  A digit pass reads and writes each
// record once (2 R * 4 B per element, 32 B at the bench shape: 33.6M
// elements, W 4, 15 passes) and the first and last pass move the int64
// rows once each; ~18 GB at the bench shape, ~5.5 ms at 3.35 TB/s, against
// the bound of one int64 read and write (0.64 ms).  A digit pass runs at
// ~60% of that rate (PERF.md): the limit is the memory system's rate for a
// tile's 256 scattered bucket runs, with the in-block work hidden behind
// the two or three tiles an SM holds.  Smaller tiles (shorter runs),
// larger ones (fewer tiles per SM) and 512-thread blocks (less in-block
// time, same total) were no faster.  Keeping the words uint32 between the
// extraction, the sort and the scan is later work.
//
// Limits: n < 2^31 (element indices are 32-bit; a tile-local index fits
// 16 bits); the status counts have 40 bits.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int NT = 256;                // threads of every block
constexpr int NWARPS = NT / 32;
constexpr int RADIX = 256;             // 8-bit digits
constexpr int NB = RADIX + 1;          // buckets: the digit's values, then the all-ones elements
constexpr unsigned SENT_BUCKET = RADIX;
constexpr unsigned NO_BUCKET = 511u;   // past the end of the tile (9 bits, like every bucket)
constexpr int BUCKET_BITS = 9;
constexpr int MAX_W = 5;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ONES = 0xffffffffu;
constexpr unsigned NO_RANK = 0xffffffffu;

// A status word: flag (2 bits: aggregate, inclusive prefix) | pass number
// (22 bits) | count (40 bits).  A word of another pass reads as not ready,
// so one zeroed array serves every pass of a sort.
constexpr int COUNT_BITS = 40;
constexpr u64 COUNT_MASK = (1ull << COUNT_BITS) - 1;
constexpr u64 EPOCH_MASK = (1ull << 22) - 1;
constexpr u64 FLAG_AGG = 1ull << 62;
constexpr u64 FLAG_INC = 2ull << 62;

static_assert(NT == RADIX, "one thread per digit bucket");

// Elements per thread of a digit pass: tiles of 8192, 4096 or 2048
// elements, so a tile's records take at most 64 KB of shared memory and
// two or three blocks fit an SM.
template <int R>
struct Tile {
  static constexpr int ITEMS = R <= 2 ? 32 : (R <= 4 ? 16 : 8);
  static constexpr int ELEMS = NT * ITEMS;
  // dynamic shared memory: the records, then one word per sorted position
  static constexpr int SMEM = ELEMS * R * 4 + ELEMS * 4;
  static_assert(ELEMS <= (1 << 16), "a tile-local index fits 16 bits");
  static_assert(ITEMS * 32 < (1 << (32 - BUCKET_BITS)), "a rank in the warp fits its field");
  static_assert(ELEMS * R % 4 == 0, "a full tile is whole 16-byte vectors");
};

__device__ __forceinline__ u64 load_status(const u64* p) {
  return *(const volatile u64*)p;
}

__device__ __forceinline__ void store_status(u64* p, u64 v) {
  *(volatile u64*)p = v;
}

// h[d] += 1 for each counted lane; a warp whose counted lanes share one
// digit (constant bytes, runs of equal keys) adds with one atomic.
__device__ __forceinline__ void add_digit(unsigned* h, unsigned d, bool counted) {
  const unsigned ball = __ballot_sync(FULL, counted);
  if (ball == 0u) return;
  const int first = __ffs(ball) - 1;
  const unsigned d0 = __shfl_sync(FULL, d, first);
  if (__all_sync(FULL, !counted || d == d0)) {
    if ((int)(threadIdx.x & 31) == first) atomicAdd(&h[d0], (unsigned)__popc(ball));
  } else if (counted) {
    atomicAdd(&h[d], 1u);
  }
}

// Exclusive prefix of x over the block's threads; `total` gets the block's
// sum.  ws holds NWARPS values.
__device__ __forceinline__ u64 block_exclusive_scan(u64 x, u64& total, u64* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  u64 inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const u64 y = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc += y;
  }
  __syncthreads();  // ws is free: every thread has read the previous call's
  if (lane == 31) ws[warp] = inc;
  __syncthreads();
  u64 below = 0, all = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    const u64 s = ws[w];
    if (w < warp) below += s;
    all += s;
  }
  total = all;
  return below + inc - x;
}

// The first pass: int64 rows (and payload) -> records, and into stats:
// [0, W * 4 * 256) every digit's histogram (word * 4 + byte) * 256 +
// bucket over the elements that are not all ones, then their count of
// all-ones elements, then 1 + the last index of an element that is not.
template <int W, bool PAY>
__global__ void __launch_bounds__(NT) first_pass_kernel(const long long* __restrict__ words,
                                                        const long long* __restrict__ pay,
                                                        unsigned* __restrict__ rec, unsigned n,
                                                        u64* __restrict__ stats) {
  constexpr int R = W + (PAY ? 2 : 0);
  __shared__ unsigned h[W * 4 * RADIX];
  __shared__ unsigned stage[NT * R];
  for (int j = threadIdx.x; j < W * 4 * RADIX; j += NT) h[j] = 0u;
  unsigned n_ones = 0, end = 0;
  __syncthreads();
  for (unsigned base = blockIdx.x * NT; base < n; base += gridDim.x * NT) {
    const unsigned i = base + threadIdx.x;
    const bool valid = i < n;
    unsigned v[W];
    bool ones = true;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      v[j] = valid ? (unsigned)words[(u64)j * n + i] : 0u;
      ones &= v[j] == ONES;
      stage[threadIdx.x * R + j] = v[j];
    }
    if (PAY && valid) {
      const u64 p = (u64)pay[i];
      stage[threadIdx.x * R + W] = (unsigned)p;
      stage[threadIdx.x * R + W + 1] = (unsigned)(p >> 32);
    }
    const bool counted = valid && !ones;
    n_ones += valid && ones;
    if (counted) end = i + 1;
#pragma unroll
    for (int j = 0; j < W; ++j)
#pragma unroll
      for (int b = 0; b < 4; ++b) add_digit(h + (j * 4 + b) * RADIX, (v[j] >> (8 * b)) & 255u, counted);
    __syncthreads();
    const int m = (int)(n - base < NT ? n - base : NT) * R;
    unsigned* o = rec + (u64)base * R;
    for (int f = threadIdx.x; f < m; f += NT) o[f] = stage[f];
    __syncthreads();
  }
  for (int j = threadIdx.x; j < W * 4 * RADIX; j += NT)
    if (h[j]) atomicAdd(stats + j, (u64)h[j]);
  n_ones = __reduce_add_sync(FULL, n_ones);
  end = __reduce_max_sync(FULL, end);
  if ((threadIdx.x & 31) == 0) {
    if (n_ones) atomicAdd(stats + W * 4 * RADIX, (u64)n_ones);
    if (end) atomicMax(stats + W * 4 * RADIX + 1, (u64)end);
  }
}

// One digit pass over tile `tile counter` (see the header).  Reads records
// from src; writes records to dst or, in the last pass, the int64 rows to
// out and the payload to pout.  hist: the digit's 256 global counts over
// the elements that are not all ones; ones: whether all-ones elements
// take the 257th bucket (the sort has some).
template <int W, bool PAY, bool LAST>
__device__ __forceinline__ void digit_pass(const unsigned* __restrict__ src,
                                           unsigned* __restrict__ dst, long long* __restrict__ out,
                                           long long* __restrict__ pout, unsigned n, int word,
                                           int shift, bool ones, const u64* __restrict__ hist,
                                           u64* status, unsigned* tile_counter, unsigned epoch) {
  constexpr int R = W + (PAY ? 2 : 0);
  constexpr int ITEMS = Tile<R>::ITEMS, ELEMS = Tile<R>::ELEMS;
  __shared__ unsigned whist[NWARPS][NB];  // per warp: its elements per bucket, then those of the warps before it
  __shared__ unsigned bstart[NB];         // each bucket's first sorted position in the tile
  __shared__ unsigned slot[NB];           // each bucket's first global position for this tile
  __shared__ u64 ws[NWARPS];
  __shared__ unsigned tile_id;
  extern __shared__ uint4 dyn[];
  unsigned* buf = (unsigned*)dyn;  // the tile's records, in input order
  unsigned* info = buf + ELEMS * R;  // per sorted position: (bucket << 16) | input index
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) tile_id = atomicAdd(tile_counter, 1u);
  for (int j = tid; j < NWARPS * NB; j += NT) (&whist[0][0])[j] = 0u;
  __syncthreads();
  const unsigned t = tile_id;
  const unsigned tile_base = t * (unsigned)ELEMS;
  const int valid = (int)(n - tile_base < (unsigned)ELEMS ? n - tile_base : (unsigned)ELEMS);

  // 1. the tile's records into shared memory, 16 bytes per copy
  {
    const unsigned* s = src + (u64)tile_base * R;
    const int nw = valid * R, n4 = nw >> 2;
    const unsigned sbase = (unsigned)__cvta_generic_to_shared(buf);
    for (int v = tid; v < n4; v += NT)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sbase + 16u * v),
                   "l"(s + 4 * v));
    asm volatile("cp.async.commit_group;\n" ::);
    for (int v = 4 * n4 + tid; v < nw; v += NT) buf[v] = s[v];
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();

  // 2. rank: warp w owns the tile's elements [w * ITEMS * 32, (w + 1) *
  // ITEMS * 32), taken 32 at a time in order, so ranking by (warp, round,
  // lane) is ranking in input order: a stable pass.  Every round's equal
  // lanes first (independent ballots), then the rounds' counts in order.
  const unsigned below_lane = (1u << lane) - 1u;
  unsigned rank_bucket[ITEMS];  // bucket, then (rank in the warp << 9) | bucket; NO_RANK past the end
  unsigned peer_of[ITEMS];      // the round's lanes with the same bucket
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int e = (warp * ITEMS + r) * 32 + lane;
    unsigned d = NO_BUCKET;
    if (e < valid) {
      const unsigned* x = buf + e * R;
      d = (x[word] >> shift) & 255u;
      if (ones && d == 255u) {  // an all-ones element has 255 in every digit
        bool all = true;
#pragma unroll
        for (int j = 0; j < W; ++j) all &= x[j] == ONES;
        if (all) d = SENT_BUCKET;
      }
    }
    unsigned peers = FULL;
#pragma unroll
    for (int b = 0; b < BUCKET_BITS; ++b) {
      const unsigned bit = __ballot_sync(FULL, (d >> b) & 1u);
      peers &= ((d >> b) & 1u) ? bit : ~bit;
    }
    rank_bucket[r] = d;
    peer_of[r] = peers;
  }
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const unsigned d = rank_bucket[r], peers = peer_of[r];
    const unsigned before = d != NO_BUCKET ? whist[warp][d] : 0u;
    __syncwarp();
    if (d != NO_BUCKET && (peers & below_lane) == 0u) whist[warp][d] = before + __popc(peers);
    __syncwarp();
    rank_bucket[r] = d == NO_BUCKET ? NO_RANK
                                    : ((before + __popc(peers & below_lane)) << BUCKET_BITS) | d;
  }
  __syncthreads();

  // 3. per bucket b (thread b; thread 0 also the all-ones bucket): the
  // warps' offsets and the tile's count, published at once; then one scan
  // gives the buckets' starts in the tile and their global bases
  const int b = tid;
  unsigned c = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    const unsigned x = whist[w][b];
    whist[w][b] = c;
    c += x;
  }
  if (tid == 0) {
    unsigned s = 0;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const unsigned x = whist[w][SENT_BUCKET];
      whist[w][SENT_BUCKET] = s;
      s += x;
    }
  }
  u64* my_status = status + (u64)t * RADIX + b;
  const u64 tag = (u64)epoch << COUNT_BITS;
  store_status(my_status, (t == 0 ? FLAG_INC : FLAG_AGG) | tag | c);
  // (global count << 16) | tile count: the tile's counts sum to <= ELEMS
  // < 2^16, so the two scans do not mix
  u64 totals;
  const u64 pre = block_exclusive_scan((hist[b] << 16) | c, totals, ws);
  bstart[b] = (unsigned)(pre & 0xffffu);
  if (tid == 0) bstart[SENT_BUCKET] = (unsigned)(totals & 0xffffu);
  __syncthreads();

  // 4. each element's sorted position in the tile
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    if (rank_bucket[r] == NO_RANK) continue;
    const unsigned d = rank_bucket[r] & ((1u << BUCKET_BITS) - 1u);
    const unsigned q = bstart[d] + whist[warp][d] + (rank_bucket[r] >> BUCKET_BITS);
    info[q] = (d << 16) | (unsigned)((warp * ITEMS + r) * 32 + lane);
  }

  // 5. look back: bucket b's elements in the tiles before this one
  u64 before = 0;
  if (t > 0) {
    for (unsigned tt = t - 1;; --tt) {
      u64 s;
      do {
        s = load_status(status + (u64)tt * RADIX + b);
      } while (((s >> COUNT_BITS) & EPOCH_MASK) != epoch);
      before += s & COUNT_MASK;
      if (s & FLAG_INC) break;
    }
    store_status(my_status, FLAG_INC | tag | (before + c));
  }
  slot[b] = (unsigned)((pre >> 16) + before);
  if (ones) {
    // the all-ones elements of the earlier tiles: their elements (all
    // full tiles) less those of the other buckets; after all the others
    u64 others;
    block_exclusive_scan(before, others, ws);
    if (tid == 0) slot[SENT_BUCKET] = (unsigned)((totals >> 16) + (u64)tile_base - others);
  }
  __syncthreads();

  // 6. out in sorted order
  if constexpr (LAST) {
    for (int q = tid; q < valid; q += NT) {
      const unsigned x = info[q], d = x >> 16;
      const unsigned* y = buf + (x & 0xffffu) * R;
      const unsigned g = slot[d] + (unsigned)q - bstart[d];
#pragma unroll
      for (int j = 0; j < W; ++j) out[(u64)j * n + g] = (long long)y[j];
      if constexpr (PAY) pout[g] = (long long)(((u64)y[W + 1] << 32) | y[W]);
    }
  } else {
    // 32 sorted records per warp step; lane l stores words l, l + 32, ...
    // of their R * 32 words, so a step's stores are runs of consecutive
    // words
    for (int c0 = warp * 32; c0 < valid; c0 += NT) {
      const int q = c0 + lane;
      unsigned e = 0, g = 0;
      if (q < valid) {
        const unsigned x = info[q], d = x >> 16;
        e = x & 0xffffu;
        g = slot[d] + (unsigned)q - bstart[d];
      }
      const int live = valid - c0 < 32 ? valid - c0 : 32;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int f = k * 32 + lane, from = f / R, j = f - from * R;
        const unsigned es = __shfl_sync(FULL, e, from), gs = __shfl_sync(FULL, g, from);
        if (from < live) dst[(u64)gs * R + j] = buf[es * R + j];
      }
    }
  }
}

template <int W, bool PAY>
__global__ void __launch_bounds__(NT) middle_pass_kernel(const unsigned* __restrict__ src,
                                                         unsigned* __restrict__ dst, unsigned n,
                                                         int word, int shift, bool ones,
                                                         const u64* __restrict__ hist,
                                                         u64* status, unsigned* tile_counter,
                                                         unsigned epoch) {
  digit_pass<W, PAY, false>(src, dst, nullptr, nullptr, n, word, shift, ones, hist, status,
                            tile_counter, epoch);
}

template <int W, bool PAY>
__global__ void __launch_bounds__(NT) last_pass_kernel(const unsigned* __restrict__ src,
                                                       long long* __restrict__ out,
                                                       long long* __restrict__ pout, unsigned n,
                                                       int word, int shift, bool ones,
                                                       const u64* __restrict__ hist,
                                                       u64* status, unsigned* tile_counter,
                                                       unsigned epoch) {
  digit_pass<W, PAY, true>(src, nullptr, out, pout, n, word, shift, ones, hist, status,
                           tile_counter, epoch);
}

int sm_count() {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <int W, bool PAY>
int first_pass(const long long* words, const long long* pay, unsigned* rec, unsigned n,
               u64* stats, cudaStream_t stream) {
  const long long blocks = ((long long)n + NT - 1) / NT, cap = (long long)sm_count() * 4;
  first_pass_kernel<W, PAY><<<(int)(blocks < cap ? blocks : cap), NT, 0, stream>>>(words, pay, rec,
                                                                                  n, stats);
  return (int)cudaGetLastError();
}

// Passes [begin, end) of the plan; pass p reads a (p even) or b (p odd)
// and writes the other, the plan's last pass (p == n_digits - 1) the rows
// out and pout.  counters: one zeroed tile counter per pass.
template <int W, bool PAY>
int passes(const unsigned* a, unsigned* b, long long* out, long long* pout, unsigned n,
           const int* digits, int n_digits, int begin, int end, bool ones, const u64* stats,
           u64* status, unsigned* counters, cudaStream_t stream) {
  constexpr int R = W + (PAY ? 2 : 0);
  const unsigned n_tiles = (n + Tile<R>::ELEMS - 1) / Tile<R>::ELEMS;
  cudaError_t err = cudaFuncSetAttribute(middle_pass_kernel<W, PAY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<R>::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(last_pass_kernel<W, PAY>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<R>::SMEM);
  if (err != cudaSuccess) return (int)err;
  for (int p = begin; p < end; ++p) {
    const int digit = digits[p];
    if (digit < 0 || digit >= W * 4) return (int)cudaErrorInvalidValue;
    const int word = digit / 4, shift = 8 * (digit % 4);
    const unsigned* src = p % 2 ? b : a;
    const u64* hist = stats + (u64)digit * RADIX;
    if (p == n_digits - 1) {
      last_pass_kernel<W, PAY><<<n_tiles, NT, Tile<R>::SMEM, stream>>>(
          src, out, pout, n, word, shift, ones, hist, status, counters + p, (unsigned)p + 1);
    } else {
      middle_pass_kernel<W, PAY><<<n_tiles, NT, Tile<R>::SMEM, stream>>>(
          src, p % 2 ? (unsigned*)a : b, n, word, shift, ones, hist, status, counters + p,
          (unsigned)p + 1);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

template <int W>
int tile_elems(bool pay) {
  return pay ? Tile<W + 2>::ELEMS : Tile<W>::ELEMS;
}

}  // namespace

extern "C" {

// Elements per tile of a digit pass of W key words (+ payload).
int radix_sort_tile_elems(int W, int pay) {
  switch (W) {
    case 1: return tile_elems<1>(pay);
    case 2: return tile_elems<2>(pay);
    case 3: return tile_elems<3>(pay);
    case 4: return tile_elems<4>(pay);
    case 5: return tile_elems<5>(pay);
    default: return 0;
  }
}

// The first pass: words int64 [W, n] (and pay int64 [n], or null) ->
// records rec uint32 [n, W (+2)]; stats u64 [W * 4 * 256 + 2], zeroed by
// the caller, gets the histograms, the all-ones count and the end of the
// other elements.
int radix_sort_first_pass(const long long* words, const long long* pay, long long n, int W,
                          unsigned* rec, u64* stats, cudaStream_t stream) {
  if (W < 1 || W > MAX_W || n < 1 || n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const unsigned m = (unsigned)n;
#define KHOICE_FIRST(w)                                                            \
  case w:                                                                          \
    return pay ? first_pass<w, true>(words, pay, rec, m, stats, stream)            \
               : first_pass<w, false>(words, nullptr, rec, m, stats, stream);
  switch (W) {
    KHOICE_FIRST(1)
    KHOICE_FIRST(2)
    KHOICE_FIRST(3)
    KHOICE_FIRST(4)
    KHOICE_FIRST(5)
  }
#undef KHOICE_FIRST
  return (int)cudaErrorInvalidValue;
}

// Passes [begin, end) of a plan of n_digits digits (digit = word * 4 +
// byte, byte 0 the least significant, least significant digit first).
// a: the first pass's records; b: a second record buffer (null when no
// pass in [begin, end) writes it); out int64 [W, n], pout int64 [n] (null
// without a payload): the last pass's output, null when end < n_digits.
// ones: the sort has all-ones elements.  stats: the first pass's;
// status: zeroed u64 [n_tiles * 256 + n_digits] (n_tiles by
// radix_sort_tile_elems), the per-pass tile counters at its end.
int radix_sort_passes(const unsigned* a, unsigned* b, long long* out, long long* pout,
                      long long n, int W, int pay, const int* digits, int n_digits, int begin,
                      int end, int ones, const u64* stats, u64* status, cudaStream_t stream) {
  if (W < 1 || W > MAX_W || n < 1 || n >= (1LL << 31) || begin < 0 || end > n_digits ||
      begin > end)
    return (int)cudaErrorInvalidValue;
  const unsigned m = (unsigned)n;
  const unsigned n_tiles = (m + radix_sort_tile_elems(W, pay) - 1) / radix_sort_tile_elems(W, pay);
  unsigned* counters = (unsigned*)(status + (u64)n_tiles * RADIX);
#define KHOICE_PASSES(w)                                                                       \
  case w:                                                                                      \
    return pay ? passes<w, true>(a, b, out, pout, m, digits, n_digits, begin, end, ones != 0,  \
                                 stats, status, counters, stream)                              \
               : passes<w, false>(a, b, out, nullptr, m, digits, n_digits, begin, end,         \
                                  ones != 0, stats, status, counters, stream);
  switch (W) {
    KHOICE_PASSES(1)
    KHOICE_PASSES(2)
    KHOICE_PASSES(3)
    KHOICE_PASSES(4)
    KHOICE_PASSES(5)
  }
#undef KHOICE_PASSES
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
