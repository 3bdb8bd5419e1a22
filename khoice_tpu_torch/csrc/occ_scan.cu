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
// What bounds it on an H100: bytes.  One read of the W int64 rows (and of
// the gid row for the unpacked layout), 8 B per word: 24 B per element of
// a 3-word packed array, ~97M elements in 0.72 ms at 3.35 TB/s.  The
// TPU kernel carried the previous key, gid and the open run's count from
// one grid step to the next in SMEM; CUDA blocks run in no order, so:
//   * one launch, one read: persistent blocks (a few an SM) take tiles of
//     TILE elements from an atomic counter after the status words, so
//     every earlier tile's block is running.  A tile publishes its
//     segmented value Seg{f = a key run starts in it, c = pair starts of
//     the run open at its end (of the whole tile when f = 0)} as an
//     inclusive status when f (or for tile 0), else as an aggregate and,
//     after its look-back, as an inclusive one; value and kind share one
//     64-bit word.  Each tile takes its carry-in by decoupled look-back
//     (Merrill & Garland, 2016; radix_sort.cu and ksweep_scan.cu do the
//     same), so no element is read twice;
//   * coalesced loads: each warp owns a contiguous span of SPAN elements
//     of the tile and walks it in 64-element windows, the next window's
//     loads in flight while one is counted.  Lane l reads window
//     elements l and l + 32 of each row with two 8-B loads, 256
//     contiguous bytes per warp instruction, at any n and any 8-B
//     aligned row (one 16-B load of two neighbouring words, whose ballots
//     need a bit interleave, was 0-6% slower).  Each word keeps its low
//     32 bits.  A lane takes its elements' predecessors by shuffles, lane
//     0 the previous window's last element; the element before a span is
//     loaded once.
//     Warp-striped windows were chosen over a transpose through shared
//     memory: every count below needs only the window's bit masks, so no
//     element has to move between threads;
//   * counting with ballots: one compare of each element with its
//     predecessor gives three bits: key start, pair start, predecessor is
//     the SENTINEL.  Ballots make 64-bit masks K and P of the window, and
//     each key start closes the run that ends just before it, with
//     __popcll(P) over the run's span of the window (plus the count
//     carried in when the run began in an earlier window).  Past the
//     array's end every element is a key start with no pair start, so
//     element n closes the last run; a tile count of n / TILE + 1 keeps
//     element n inside a tile;
//   * the one run per warp that began before the warp's span is closed at
//     the span's first key start by one thread, after the tile's warp
//     summaries and the look-back have given its count carried in;
//   * one histogram per block: min(members, cx) bins of shared memory (up
//     to occ_scan_bins_max(), opted in above 48 KB) that live across all
//     the block's tiles and are flushed once per block; a lane counts
//     consecutive closes of one bin in a register before its atomic;
//   * any n below 2^32, the ragged tile masked.
// PERF.md has the times, the bound and the variants measured
// (tools/sort_variants.py --kernel occ).

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int NT = 256;                  // threads per block
constexpr int NWARPS = NT / 32;
constexpr int WINDOWS = 8;               // 64-element windows per warp and tile
constexpr int SPAN = 64 * WINDOWS;       // elements per warp and tile
constexpr int TILE = NWARPS * SPAN;      // elements per tile
constexpr int MIN_BLOCKS = 4;            // blocks per SM the register budget keeps
constexpr int GID_BITS = 8;              // packed: value = (key << 8) | gid
constexpr int SMEM_MARGIN = 1024;        // static shared memory of a block, rounded up
constexpr unsigned FULL = 0xffffffffu;
constexpr u64 ST_AGG = 1ull << 32;       // status: the tile's own count (no run starts in it)
constexpr u64 ST_INC = 2ull << 32;       // status: the count of the run open at the tile's end

// A warp's scan of its span: the open run's pair starts so far (`open`;
// all of the span's when no key run starts in it), whether one does
// (`seen`), and the close of the run open where the span begins, at the
// span's first key start: its pair starts in the span (`d_cnt`) and
// whether it is the SENTINEL run (`d_sent`).
struct SpanState {
  unsigned open;
  unsigned d_cnt;
  int seen;
  int d_sent;
};

// A lane's closes not yet added: `c` runs of bin `b`.
struct Pending {
  unsigned b;
  unsigned c;
};

// A lane's two elements of a window: the low 32 bits of their words and
// their gids (0 in the packed layout, whose gid is in the last word).
template <int W>
struct Win {
  unsigned a[W];
  unsigned b[W];
  unsigned ga;
  unsigned gb;
};

// The window's 64-bit mask of a flag the lanes hold for their two
// elements (lane l's at bits l and l + 32).
__device__ __forceinline__ u64 window_mask(bool a, bool b) {
  return (u64)__ballot_sync(FULL, a) | ((u64)__ballot_sync(FULL, b) << 32);
}

// A lane's two elements, lane and lane + 32, of one row of the window at
// `base` (all ones past the end).
__device__ __forceinline__ void load_row(const long long* __restrict__ row, long long n,
                                         long long base, int lane, unsigned& va, unsigned& vb) {
  const long long ia = base + lane;
  const long long ib = ia + 32;
  va = ia < n ? (unsigned)__ldg(row + ia) : FULL;
  vb = ib < n ? (unsigned)__ldg(row + ib) : FULL;
}

template <int W, bool PACKED>
__device__ __forceinline__ void load_window(const long long* __restrict__ words,
                                            const long long* __restrict__ gid, long long n,
                                            long long base, int lane, Win<W>& x) {
#pragma unroll
  for (int j = 0; j < W; ++j) load_row(words + (long long)j * n, n, base, lane, x.a[j], x.b[j]);
  if (PACKED)
    x.ga = x.gb = 0u;
  else
    load_row(gid, n, base, lane, x.ga, x.gb);
}

// Element i (words w, gid g) against its predecessor (p, pg): does it
// start a key run, a (key, gid) pair, and is its predecessor the SENTINEL.
// Element 0 starts both; past the end each element starts a key run and
// no pair.
template <int W, bool PACKED>
__device__ __forceinline__ void facts(const unsigned (&w)[W], unsigned g, const unsigned (&p)[W],
                                      unsigned pg, long long i, long long n, bool& kstart,
                                      bool& pstart, bool& psent) {
  bool keq = i > 0, ones = true;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const unsigned a = (PACKED && j == W - 1) ? w[j] >> GID_BITS : w[j];
    const unsigned b = (PACKED && j == W - 1) ? p[j] >> GID_BITS : p[j];
    keq = keq && a == b;
    ones = ones && p[j] == FULL;
  }
  const bool peq = keq && (PACKED ? w[W - 1] == p[W - 1] : g == pg);
  kstart = i >= n || !keq;
  pstart = i < n && !peq;
  psent = ones;
}

__device__ __forceinline__ void bin_run(unsigned cnt, unsigned cs, int n_bins, unsigned* h,
                                        Pending& pend) {
  const unsigned b = min(cnt, cs);
  if (b < 1u || b > (unsigned)n_bins) return;
  if (b != pend.b) {
    if (pend.c) atomicAdd(&h[pend.b - 1], pend.c);
    pend.b = b;
    pend.c = 0u;
  }
  ++pend.c;
}

// A lane's element at window position j closes, when it starts a key run
// and its predecessor is not the SENTINEL, the run that ends just before
// it: its pair starts are P's bits from the run's start (the last key
// start below j) to j - 1, plus the open count when the run began before
// the window.  The span's first key start is left to the tile (deferred).
__device__ __forceinline__ void close_before(int j, bool kstart, bool psent, u64 K, u64 P,
                                             const SpanState& s, unsigned cs, int n_bins,
                                             unsigned* h, Pending& pend) {
  if (!kstart) return;
  const u64 lo = (1ull << j) - 1ull;
  const u64 below = K & lo;
  unsigned cnt;
  if (below) {
    cnt = __popcll((P & lo) >> (63 - __clzll((long long)below)));
  } else if (s.seen) {
    cnt = s.open + __popcll(P & lo);
  } else {
    return;
  }
  if (!psent) bin_run(cnt, cs, n_bins, h, pend);
}

// Count one window (x, at `base`) into the warp's state; prev/pg hold the
// previous element's words and gid (lane 0's predecessor) and get this
// window's last.
template <int W, bool PACKED>
__device__ __forceinline__ void scan_window(const Win<W>& x, long long base, long long n,
                                            int lane, unsigned (&prev)[W], unsigned& pg,
                                            SpanState& s, unsigned cs, int n_bins, unsigned* h,
                                            Pending& pend) {
  // lane l's predecessors: lane l - 1's elements; lane 0's are the
  // previous window's last and lane 31's first
  const int src = (lane + 31) & 31;
  unsigned pa[W], pb[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const unsigned xa = __shfl_sync(FULL, x.a[j], src);
    const unsigned xb = __shfl_sync(FULL, x.b[j], src);
    pa[j] = lane ? xa : prev[j];
    pb[j] = lane ? xb : xa;
    prev[j] = __shfl_sync(FULL, x.b[j], 31);
  }
  unsigned pga = 0u, pgb = 0u;
  if (!PACKED) {
    const unsigned xa = __shfl_sync(FULL, x.ga, src);
    const unsigned xb = __shfl_sync(FULL, x.gb, src);
    pga = lane ? xa : pg;
    pgb = lane ? xb : xa;
    pg = __shfl_sync(FULL, x.gb, 31);
  }
  const int ja = lane, jb = lane + 32;
  bool ka, qa, ra, kb, qb, rb;
  facts<W, PACKED>(x.a, x.ga, pa, pga, base + ja, n, ka, qa, ra);
  facts<W, PACKED>(x.b, x.gb, pb, pgb, base + jb, n, kb, qb, rb);
  const u64 K = window_mask(ka, kb);
  const u64 P = window_mask(qa, qb);
  close_before(ja, ka, ra, K, P, s, cs, n_bins, h, pend);
  close_before(jb, kb, rb, K, P, s, cs, n_bins, h, pend);
  if (K) {
    if (!s.seen) {  // the span's first key start: its close waits for the carry-in
      const int j0 = __ffsll((long long)K) - 1;
      const u64 R = window_mask(ra, rb);
      s.d_cnt = s.open + __popcll(P & ((1ull << j0) - 1ull));
      s.d_sent = (int)((R >> j0) & 1ull);
      s.seen = 1;
    }
    s.open = __popcll(P >> (63 - __clzll((long long)K)));
  } else {
    s.open += __popcll(P);
  }
}

// A warp's span of SPAN elements from `span`, window by window.
template <int W, bool PACKED>
__device__ __forceinline__ SpanState scan_span(const long long* __restrict__ words,
                                               const long long* __restrict__ gid, long long n,
                                               long long span, int lane, unsigned cs,
                                               int n_bins, unsigned* h, Pending& pend) {
  unsigned prev[W], pg = 0u;
#pragma unroll
  for (int j = 0; j < W; ++j) prev[j] = 0u;
  if (span > 0) {  // the element before the span (all ones past the end)
#pragma unroll
    for (int j = 0; j < W; ++j)
      prev[j] = span - 1 < n ? (unsigned)__ldg(words + (long long)j * n + span - 1) : FULL;
    if (!PACKED) pg = span - 1 < n ? (unsigned)__ldg(gid + span - 1) : FULL;
  }
  SpanState s{0u, 0u, 0, 0};
  Win<W> cur, nxt;
  load_window<W, PACKED>(words, gid, n, span, lane, cur);
#pragma unroll
  for (int w = 0; w < WINDOWS; ++w) {
    if (w + 1 < WINDOWS) load_window<W, PACKED>(words, gid, n, span + 64 * (w + 1), lane, nxt);
    scan_window<W, PACKED>(cur, span + 64 * w, n, lane, prev, pg, s, cs, n_bins, h, pend);
    if (w + 1 < WINDOWS) cur = nxt;
  }
  return s;
}

__device__ __forceinline__ void publish(u64* at, u64 kind, unsigned c) {
  *(volatile u64*)at = kind | c;
}

// The count of the run open where tile t begins: the counts of the tiles
// before it back to the first inclusive status (tile 0 publishes one).
__device__ __forceinline__ unsigned look_back(const u64* status, int t) {
  unsigned in = 0u;
  for (int tt = t - 1;; --tt) {
    u64 st;
    do {
      st = *(const volatile u64*)(status + tt);
    } while (!(st >> 32));
    in += (unsigned)st;
    if ((st & ~(u64)FULL) == ST_INC) return in;
  }
}

// (one thread) The tile's status and look-back, then each warp's deferred
// close with the count carried into its span.
__device__ __forceinline__ void close_tile(u64* status, int t, const SpanState* sp, unsigned cs,
                                           int n_bins, unsigned* h) {
  int f = 0;
  unsigned c = 0u;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    c = sp[w].seen ? sp[w].open : c + sp[w].open;
    f |= sp[w].seen;
  }
  publish(status + t, (f || t == 0) ? ST_INC : ST_AGG, c);
  unsigned in = 0u;
  if (t > 0) {
    in = look_back(status, t);
    if (!f) publish(status + t, ST_INC, in + c);
  }
  for (int w = 0; w < NWARPS; ++w) {
    if (sp[w].seen) {
      const unsigned b = min(in + sp[w].d_cnt, cs);
      if (!sp[w].d_sent && b >= 1u && b <= (unsigned)n_bins) atomicAdd(&h[b - 1], 1u);
      in = sp[w].open;
    } else {
      in += sp[w].open;
    }
  }
}

// The histogram: persistent blocks, one tile at a time (the next tile's
// id taken while this one is counted); every run is binned into the
// block's shared histogram h[n_bins], flushed once per block.
template <int W, bool PACKED>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    occ_tiles(const long long* __restrict__ words, const long long* __restrict__ gid, long long n,
              unsigned cs, int n_bins, int n_tiles, u64* __restrict__ status,
              u64* __restrict__ hist) {
  __shared__ SpanState s_span[NWARPS];
  __shared__ int s_tile[2];
  extern __shared__ unsigned h[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < n_bins; j += NT) h[j] = 0u;
  if (tid == 0) s_tile[0] = (int)atomicAdd(status + n_tiles, 1ull);
  __syncthreads();
  Pending pend{0u, 0u};
  for (int it = 0;; ++it) {
    const int t = s_tile[it & 1];
    if (t >= n_tiles) break;
    if (tid == 0) s_tile[(it + 1) & 1] = (int)atomicAdd(status + n_tiles, 1ull);
    const SpanState s = scan_span<W, PACKED>(
        words, gid, n, (long long)t * TILE + (long long)warp * SPAN, lane, cs, n_bins, h, pend);
    if (lane == 0) s_span[warp] = s;
    __syncthreads();
    if (tid == 0) close_tile(status, t, s_span, cs, n_bins, h);
    __syncthreads();
  }
  if (pend.c) atomicAdd(&h[pend.b - 1], pend.c);
  __syncthreads();
  for (int j = tid; j < n_bins; j += NT) {
    const unsigned v = h[j];
    if (v) atomicAdd(&hist[j], (u64)v);
  }
}

template <int W, bool PACKED>
int launch(const long long* words, const long long* gid, long long n, unsigned cs, int n_bins,
           u64* status, u64* hist, cudaStream_t st) {
  const int n_tiles = (int)(n / TILE + 1);  // element n (closing the last run) in a tile
  const int smem = n_bins * (int)sizeof(unsigned);
  auto kernel = occ_tiles<W, PACKED>;
  cudaError_t err;
  if (smem + SMEM_MARGIN > 48 * 1024) {  // static + dynamic above the default 48 KB
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
  kernel<<<grid, NT, smem, st>>>(words, gid, n, cs, n_bins, n_tiles, status, hist);
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

// One launch of the histogram.  words: int64 [W, n] sorted; packed != 0:
// each value is (key << 8) | gid and gid is null; packed == 0: gid int64
// [n].  status: zeroed int64 [n / occ_scan_tile_elems() + 2] (a status
// word per tile, the tile counter last); hist: zeroed int64 [n_bins].
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int occ_scan_launch(const void* words, const void* gid, long long n, int W,
                               int packed, int cs, int n_bins, void* status, void* hist,
                               void* stream) {
  if (n <= 0 || n >= (1LL << 32) || W < 1 || W > 4 || (!packed && gid == nullptr) ||
      status == nullptr || cs < 1 || n_bins < 1 || n_bins > hist_bins_max())
    return (int)cudaErrorInvalidValue;
  const auto* w = static_cast<const long long*>(words);
  const auto* g = static_cast<const long long*>(gid);
  auto* sta = static_cast<u64*>(status);
  auto* hi = static_cast<u64*>(hist);
  auto st = static_cast<cudaStream_t>(stream);
#define OCC_CASE(K)                                                                       \
  case K:                                                                                 \
    return packed ? launch<K, true>(w, g, n, (unsigned)cs, n_bins, sta, hi, st)            \
                  : launch<K, false>(w, g, n, (unsigned)cs, n_bins, sta, hi, st);
  switch (W) {
    OCC_CASE(1)
    OCC_CASE(2)
    OCC_CASE(3)
    OCC_CASE(4)
  }
#undef OCC_CASE
  return (int)cudaErrorInvalidValue;
}
