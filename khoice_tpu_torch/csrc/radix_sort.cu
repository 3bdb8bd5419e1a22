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
// Passes:
//   (a) prepare: one read of the int64 rows, written back as uint32
//       scratch (half the bytes for every later pass), and every digit's
//       global histogram (W words x 4 bytes x 256 buckets).
//   (b) per digit that varies, least significant first:
//       count   - each tile's 256 bucket counts (tile = TILE elements);
//       scan    - an exclusive scan of the counts in digit-major order
//                 (bucket b, then tile t), one block per bucket, its base
//                 the global histogram's sum of the buckets below b;
//       scatter - each tile ranks its elements by digit in input order
//                 (warps in order, rounds in order, lanes ranked with
//                 __match_any_sync and a per-warp bucket counter), then
//                 moves all W words and the payload to
//                 scan[b][t] + rank: a stable pass.
//   (c) finish: the last buffer written back as int64 rows.
// A digit whose histogram has one non-empty bucket is skipped: a stable
// pass over it is the identity, so the skip is exact.  Packed master keys
// (kmax 49, KW 4) keep 18 spare bits of word 3 zero between the key and
// the 12 payload bits, so one of their 16 byte-digits never runs; table
// keys skip their constant high bytes the same way (the per-k packed
// words do not: their SENTINEL windows are all ones there).  The wrapper
// reads the histogram back to choose the digits (one synchronisation per
// sort).
//
// What bounds it on an H100: bytes.  Each varying digit reads the digit's
// word twice (count, scatter) and each element's W uint32 words (+ 8 B of
// payload) once, and writes them once: ~(8 + 8W (+16)) B per element per
// pass, plus the int64 read and write of (a) and (c); at the bench shape
// (33.6M elements, W 4, 15 varying digits) ~23 GB, ~7 ms at 3.35 TB/s,
// against the bound of one int64 read and write (0.64 ms).  Fewer passes
// (11-bit digits), one-sweep decoupled look-back and keeping the words
// uint32 between sorts are left for later work.
//
// All element offsets are 64-bit (W * n passes 2^31 at the in-core sizes).

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int NT = 256;               // threads of the count and scatter blocks
constexpr int NWARPS = NT / 32;
constexpr int ITEMS = 16;             // elements per thread in a tile
constexpr int TILE = NT * ITEMS;      // elements per tile
constexpr int RADIX = 256;            // 8-bit digits
constexpr int MAX_W = 5;              // key words
constexpr int SCAN_NT = 256;          // threads of a scan block
constexpr int SCAN_ITEMS = 4;         // counts per thread per scan step
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_DIGIT = 0xffffffffu;

static_assert(NT == RADIX && NT == SCAN_NT, "one thread per bucket in the count and scatter blocks");
static_assert(TILE <= (1 << 24), "a tile-local position fits 24 bits");
static_assert(ITEMS * 32 <= (1 << 24), "a rank in the warp fits 24 bits");

// h[d] += 1 for each valid lane; a warp whose valid lanes share one digit
// (constant bytes, runs of equal keys) adds with one atomic.
__device__ __forceinline__ void add_digit(unsigned* h, unsigned d, bool valid) {
  const unsigned ball = __ballot_sync(FULL, valid);
  if (ball == 0u) return;
  const int first = __ffs(ball) - 1;
  const unsigned d0 = __shfl_sync(FULL, d, first);
  if (__all_sync(FULL, !valid || d == d0)) {
    if ((int)(threadIdx.x & 31) == first) atomicAdd(&h[d0], (unsigned)__popc(ball));
  } else if (valid) {
    atomicAdd(&h[d], 1u);
  }
}

// (a) int64 rows -> uint32 rows, and every digit's histogram into
// hist[(word * 4 + byte) * 256 + bucket].
__global__ void __launch_bounds__(NT) prepare_kernel(const long long* __restrict__ in,
                                                     unsigned* __restrict__ keys, long long n,
                                                     int W, u64* __restrict__ hist) {
  __shared__ unsigned h[MAX_W * 4 * RADIX];
  const int nh = W * 4 * RADIX;
  for (int j = threadIdx.x; j < nh; j += NT) h[j] = 0u;
  __syncthreads();
  const long long stride = (long long)gridDim.x * NT;
  for (long long base = (long long)blockIdx.x * NT; base < n; base += stride) {
    const long long i = base + threadIdx.x;
    const bool valid = i < n;
    for (int j = 0; j < W; ++j) {
      unsigned v = 0u;
      if (valid) {
        v = (unsigned)in[(long long)j * n + i];
        keys[(long long)j * n + i] = v;
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) add_digit(h + (j * 4 + b) * RADIX, (v >> (8 * b)) & 255u, valid);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nh; j += NT)
    if (h[j]) atomicAdd(hist + j, (u64)h[j]);
}

// (b1) counts[b * n_tiles + t] = elements of tile t whose digit is b.
__global__ void __launch_bounds__(NT) count_kernel(const unsigned* __restrict__ word, long long n,
                                                   int shift, u64* __restrict__ counts,
                                                   int n_tiles) {
  __shared__ unsigned h[RADIX];
  h[threadIdx.x] = 0u;
  __syncthreads();
  const long long base = (long long)blockIdx.x * TILE;
#pragma unroll 4
  for (int r = 0; r < ITEMS; ++r) {
    const long long i = base + (long long)r * NT + threadIdx.x;
    const bool valid = i < n;
    const unsigned d = valid ? (__ldg(word + i) >> shift) & 255u : 0u;
    add_digit(h, d, valid);
  }
  __syncthreads();
  counts[(long long)threadIdx.x * n_tiles + blockIdx.x] = h[threadIdx.x];
}

// Exclusive prefix of x over the block's threads; `total` gets the block's
// sum.  ws holds SCAN_NT / 32 values.
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
  for (int w = 0; w < SCAN_NT / 32; ++w) {
    const u64 s = ws[w];
    if (w < warp) below += s;
    all += s;
  }
  total = all;
  return below + inc - x;
}

// (b2) Block b: row b of the counts (one count per tile) becomes each
// tile's first output slot for bucket b, in place.
__global__ void __launch_bounds__(SCAN_NT) scan_kernel(u64* __restrict__ counts,
                                                       const u64* __restrict__ digit_hist,
                                                       int n_tiles) {
  __shared__ u64 ws[SCAN_NT / 32];
  const int b = blockIdx.x;
  u64 below = 0;
  for (int v = threadIdx.x; v < b; v += SCAN_NT) below += digit_hist[v];
  u64 carry;
  block_exclusive_scan(below, carry, ws);
  u64* row = counts + (long long)b * n_tiles;
  for (long long t0 = 0; t0 < n_tiles; t0 += SCAN_NT * SCAN_ITEMS) {
    const long long t = t0 + (long long)threadIdx.x * SCAN_ITEMS;
    u64 v[SCAN_ITEMS], sum = 0;
#pragma unroll
    for (int e = 0; e < SCAN_ITEMS; ++e) {
      v[e] = t + e < n_tiles ? row[t + e] : 0;
      sum += v[e];
    }
    u64 step;
    u64 at = carry + block_exclusive_scan(sum, step, ws);
#pragma unroll
    for (int e = 0; e < SCAN_ITEMS; ++e) {
      if (t + e < n_tiles) row[t + e] = at;
      at += v[e];
    }
    carry += step;
  }
}

// Moves one 32-bit value per element of the tile to its sorted place:
// each element writes its value to its tile-local sorted position in
// shared memory, then consecutive threads write consecutive sorted
// positions out, so a warp's stores fall in one or two bucket runs
// (coalesced) instead of 32 scattered buckets.
template <typename Load, typename Store>
__device__ __forceinline__ void stage_out(const unsigned (&local_digit)[ITEMS], long long wbase,
                                          int lane, int valid_n, unsigned* stage,
                                          const unsigned char* stage_digit,
                                          const unsigned* bucket_start, const u64* tile_slot,
                                          Load load, Store store) {
#pragma unroll
  for (int r = 0; r < ITEMS; ++r)
    if (local_digit[r] != NO_DIGIT) stage[local_digit[r] >> 8] = load(wbase + r * 32 + lane);
  __syncthreads();
  for (int q = threadIdx.x; q < valid_n; q += NT) {
    const unsigned d = stage_digit[q];
    store((long long)(tile_slot[d] + (q - bucket_start[d])), stage[q]);
  }
  __syncthreads();
}

// (b3) The stable scatter of tile blockIdx.x.  Warp w owns the tile's
// elements [w * ITEMS * 32, (w + 1) * ITEMS * 32), taken 32 at a time in
// order, so ranking by (warp, round, lane) is ranking in input order.
// An element's tile-local sorted position is its bucket's start in the
// tile + the bucket's elements in earlier warps + its rank in its warp;
// its global position is the bucket's slot for this tile + the same
// offset past the bucket's start.
template <int W, bool PAY>
__global__ void __launch_bounds__(NT) scatter_kernel(const unsigned* __restrict__ src,
                                                     unsigned* __restrict__ dst,
                                                     const u64* __restrict__ psrc,
                                                     u64* __restrict__ pdst, long long n,
                                                     int word, int shift,
                                                     const u64* __restrict__ slots, int n_tiles) {
  __shared__ unsigned whist[NWARPS][RADIX];  // per warp: its elements per bucket so far
  __shared__ u64 tile_slot[RADIX];
  __shared__ unsigned bucket_start[RADIX];
  __shared__ u64 ws[NWARPS];
  __shared__ unsigned stage[TILE];
  __shared__ unsigned char stage_digit[TILE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below_lane = (1u << lane) - 1u;
  const long long tile_base = (long long)blockIdx.x * TILE;
  const long long wbase = tile_base + (long long)warp * (ITEMS * 32);
  const int valid_n = (int)(n - tile_base < TILE ? n - tile_base : TILE);
  const unsigned* digit_word = src + (long long)word * n;
  for (int v = lane; v < RADIX; v += 32) whist[warp][v] = 0u;
  __syncwarp();
  unsigned rank_digit[ITEMS];  // (rank in the warp << 8) | digit, NO_DIGIT past the end
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const long long i = wbase + r * 32 + lane;
    const bool valid = i < n;
    const unsigned d = valid ? (__ldg(digit_word + i) >> shift) & 255u : RADIX;
    const unsigned peers = __match_any_sync(FULL, d);
    const unsigned before = valid ? whist[warp][d] : 0u;
    __syncwarp();
    if (valid && (peers & below_lane) == 0u) whist[warp][d] = before + __popc(peers);
    __syncwarp();
    rank_digit[r] = valid ? ((before + __popc(peers & below_lane)) << 8) | d : NO_DIGIT;
  }
  __syncthreads();
  {  // per bucket: the elements of the warps before each warp, the bucket's
     // start in the tile, and the tile's global slot
    const int v = threadIdx.x;
    unsigned s = 0u;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const unsigned c = whist[w][v];
      whist[w][v] = s;
      s += c;
    }
    u64 tile_total;
    bucket_start[v] = (unsigned)block_exclusive_scan(s, tile_total, ws);
    tile_slot[v] = slots[(long long)v * n_tiles + blockIdx.x];
  }
  __syncthreads();
  unsigned local_digit[ITEMS];  // (tile-local sorted position << 8) | digit
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    local_digit[r] = NO_DIGIT;
    if (rank_digit[r] == NO_DIGIT) continue;
    const unsigned d = rank_digit[r] & 255u;
    const unsigned local = bucket_start[d] + whist[warp][d] + (rank_digit[r] >> 8);
    stage_digit[local] = (unsigned char)d;
    local_digit[r] = (local << 8) | d;
  }
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const unsigned* s_row = src + (long long)j * n;
    unsigned* d_row = dst + (long long)j * n;
    stage_out(local_digit, wbase, lane, valid_n, stage, stage_digit, bucket_start, tile_slot,
              [&](long long i) { return s_row[i]; },
              [&](long long pos, unsigned v) { d_row[pos] = v; });
  }
  if (PAY) {  // the 64-bit payload as its two 32-bit halves
    const unsigned* p32 = (const unsigned*)psrc;
    unsigned* q32 = (unsigned*)pdst;
#pragma unroll
    for (int half = 0; half < 2; ++half)
      stage_out(local_digit, wbase, lane, valid_n, stage, stage_digit, bucket_start, tile_slot,
                [&](long long i) { return p32[2 * i + half]; },
                [&](long long pos, unsigned v) { q32[2 * pos + half] = v; });
  }
}

// (c) uint32 rows -> int64 rows; the payload copied.
__global__ void finish_kernel(const unsigned* __restrict__ keys, const u64* __restrict__ psrc,
                              long long* __restrict__ out, long long* __restrict__ pout,
                              long long n, int W) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    for (int j = 0; j < W; ++j) out[(long long)j * n + i] = (long long)keys[(long long)j * n + i];
    if (pout) pout[i] = (long long)psrc[i];
  }
}

int grid_for(long long n, int per_sm) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = (n + NT - 1) / NT;
  return (int)(blocks < (long long)sms * per_sm ? blocks : (long long)sms * per_sm);
}

template <int W, bool PAY>
void launch_scatter(const unsigned* src, unsigned* dst, const u64* psrc, u64* pdst, long long n,
                    int word, int shift, const u64* slots, int n_tiles, cudaStream_t stream) {
  scatter_kernel<W, PAY><<<n_tiles, NT, 0, stream>>>(src, dst, psrc, pdst, n, word, shift, slots,
                                                     n_tiles);
}

template <bool PAY>
void scatter_w(int W, const unsigned* src, unsigned* dst, const u64* psrc, u64* pdst, long long n,
               int word, int shift, const u64* slots, int n_tiles, cudaStream_t stream) {
  switch (W) {
    case 1: launch_scatter<1, PAY>(src, dst, psrc, pdst, n, word, shift, slots, n_tiles, stream); break;
    case 2: launch_scatter<2, PAY>(src, dst, psrc, pdst, n, word, shift, slots, n_tiles, stream); break;
    case 3: launch_scatter<3, PAY>(src, dst, psrc, pdst, n, word, shift, slots, n_tiles, stream); break;
    case 4: launch_scatter<4, PAY>(src, dst, psrc, pdst, n, word, shift, slots, n_tiles, stream); break;
    default: launch_scatter<5, PAY>(src, dst, psrc, pdst, n, word, shift, slots, n_tiles, stream); break;
  }
}

}  // namespace

extern "C" {

int radix_sort_tile_elems() { return TILE; }

// (a): words int64 [W, n] -> keys uint32 [W, n]; hist u64 [W * 4 * 256],
// zeroed by the caller, gets every digit's histogram.
int radix_sort_prepare(const long long* words, long long n, int W, unsigned* keys, u64* hist,
                       cudaStream_t stream) {
  if (W < 1 || W > MAX_W || n < 1) return (int)cudaErrorInvalidValue;
  prepare_kernel<<<grid_for(n, 4), NT, 0, stream>>>(words, keys, n, W, hist);
  return (int)cudaGetLastError();
}

// (b): one stable pass per digit of digits[0..n_digits) (least significant
// first; digit = word * 4 + byte, byte 0 the least significant).  Pass p
// reads keys_a (p even) or keys_b (p odd) and writes the other; the
// payload (pay_in null: none) is read from pay_in by pass 0 and written
// to pay_a (p even) or pay_b (p odd).  slots: u64 [256 * n_tiles].
int radix_sort_passes(unsigned* keys_a, unsigned* keys_b, const long long* pay_in,
                      long long* pay_a, long long* pay_b, long long n, int W, const int* digits,
                      int n_digits, const u64* hist, u64* slots, cudaStream_t stream) {
  if (W < 1 || W > MAX_W || n < 1) return (int)cudaErrorInvalidValue;
  const long long n_tiles = (n + TILE - 1) / TILE;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  for (int p = 0; p < n_digits; ++p) {
    const int digit = digits[p];
    if (digit < 0 || digit >= W * 4) return (int)cudaErrorInvalidValue;
    const int word = digit / 4, shift = 8 * (digit % 4);
    const unsigned* src = p % 2 ? keys_b : keys_a;
    unsigned* dst = p % 2 ? keys_a : keys_b;
    count_kernel<<<(int)n_tiles, NT, 0, stream>>>(src + (long long)word * n, n, shift, slots,
                                                  (int)n_tiles);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    scan_kernel<<<RADIX, SCAN_NT, 0, stream>>>(slots, hist + (long long)digit * RADIX,
                                               (int)n_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (pay_in) {
      const u64* psrc = (const u64*)(p == 0 ? pay_in : (p % 2 ? pay_a : pay_b));
      u64* pdst = (u64*)(p % 2 ? pay_b : pay_a);
      scatter_w<true>(W, src, dst, psrc, pdst, n, word, shift, slots, (int)n_tiles, stream);
    } else {
      scatter_w<false>(W, src, dst, nullptr, nullptr, n, word, shift, slots, (int)n_tiles, stream);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// (c): keys uint32 [W, n] -> out int64 [W, n]; pay (null: none) -> pout.
int radix_sort_finish(const unsigned* keys, const long long* pay, long long* out, long long* pout,
                      long long n, int W, cudaStream_t stream) {
  if (W < 1 || W > MAX_W || n < 1) return (int)cudaErrorInvalidValue;
  finish_kernel<<<grid_for(n, 8), NT, 0, stream>>>(keys, (const u64*)pay, out, pout, n, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
