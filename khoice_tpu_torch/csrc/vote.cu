// exp6's read-level voting: two kernels over the merge-join of the group
// texts and the reads (khoice_tpu_torch/classify/annotate.py::
// read_votes_bulk_multi).
//
// They replace XLA code of the JAX package, not a Pallas kernel:
//   vote_mask   khoice_tpu/classify/annotate.py:250-266 (_read_votes_merge:
//               the forward and backward segmented OR scans, the SENTINEL
//               mask and the second sort by payload that puts the masks
//               back in read order)
//   read_votes  khoice_tpu/classify/annotate.py:497-510 (_votes_from_masks)
//
// vote_mask.  Input: the concatenation [text elements, query elements]
// sorted stably by key, as int64 [W, n] words (each a 32-bit word, most
// significant first) and an int64 payload: a text element's is its
// dataset gid (< D), a query element's D + its flat read position.  For
// every query e, out[pay_e - D] = the OR of 1 << gid over the text
// elements of e's key run, 0 for the SENTINEL run (all words all ones).
// The sort is stable and the texts come first, so within a run every text
// element precedes every query, and the FORWARD inclusive segmented OR at
// a query already is its run's total: no backward scan, and no second
// sort (each query's value goes to its read position).  Bound by bytes:
// one read of 8 (W + 1) B an element and one 8-B write a query position.
// Scattered 8-B stores into `out` (a part of a 32-B sector each, most of
// them to sectors L2 no longer holds) cost several times their bytes, so
// the values reach `out` in two launches:
//   vote_mask_tiles  the scan below; each matched query appends (its
//                    position in its bucket of BUCKET read positions, its
//                    value) to that bucket's list (an atomic slot count
//                    per bucket; a list's slots fill in order, so its
//                    sectors are whole when L2 writes them back);
//   vote_mask_fill   a block per bucket: the bucket's values laid out in
//                    shared memory, 0 where no query matched, then
//                    written to `out` in whole sectors.
// vote_mask_tiles:
//   * one read: persistent blocks take tiles of TILE elements
//     from an atomic counter after the status words; a tile publishes
//     Seg{f = a key run starts in it, v = the OR since its last run start
//     (of the whole tile when f = 0)} and takes its carry-in by decoupled
//     look-back (Merrill & Garland, 2016), value and kind in one 64-bit
//     word;
//   * each warp owns a span of SPAN elements of the tile and walks it in
//     64-element windows, lane l holding elements 2l and 2l + 1 (one 16-B
//     load a row where the row is 16-B aligned, two 8-B loads where it is
//     not), DEPTH windows in flight; the span's first windows of the next
//     tile are loaded before the block waits on anything;
//   * a window without a query only updates the run open at its end: the
//     last key start from a ballot and one __reduce_or_sync of the gid
//     bits from there on.  A window with a query takes the per-lane
//     segmented OR (five shuffles) and appends each query's value at once;
//   * only the queries of the span's first run, when it began before the
//     span, need the OR carried into the span; the span keeps where that
//     run ends, where its first query is and its texts' OR (no per-thread
//     buffers), and after the look-back re-reads the payloads of those
//     queries and appends carry | that OR for each (every text of a run
//     precedes its queries);
//   * the look-back is warp-parallel (a predecessor status per lane, a
//     ballot for the nearest inclusive one, a __reduce_or_sync), and a
//     tile's look-back and the appends of its spans' heads wait until the
//     block has read its next tile, so the tiles before it have published.
// Any n below 2^32, the ragged tile masked.
//
// read_votes.  For each read row r (positions row_starts[r] to
// row_starts[r + 1] of the flat query masks): a window with mask m != 0
// (its low D bits, 0 where not valid) votes lcm / popcount(m) for each
// dataset in m; votes[r, d] sums them in int64, unmatched[r] counts the
// valid windows with m == 0 and n_kmers[r] the valid windows.  Bound by
// bytes (9 B a window) once the per-window work is a few instructions:
//   * a lane per window: a warp takes T consecutive rows (T from R and
//     the card's resident warps) and walks their windows back to back in
//     chunks of 32, CHUNKS chunks in flight; each lane finds its window's
//     weight lcm / c in a 33-entry table in shared memory and adds it to
//     its accumulators for the datasets in the mask (predicated 64-bit
//     adds; DB = 4, 8, 16 or 32 accumulators by the bucket of D);
//   * where a row ends inside a chunk the lanes of the next row add after
//     the row is closed: one reduce-scatter of the DB accumulators over
//     the warp (log2 DB halving steps after 5 - log2 DB butterfly sums:
//     lane d ends with dataset d's sum) and two __reduce_add_sync of the
//     counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int NT = 256;                  // threads per block
constexpr int NWARPS = NT / 32;
constexpr int WINDOWS = 8;               // 64-element windows per warp and tile
constexpr int DEPTH = 2;                 // windows in flight per warp
constexpr int SPAN = 64 * WINDOWS;       // elements per warp and tile
constexpr int TILE = NWARPS * SPAN;      // elements per tile
constexpr int MIN_BLOCKS = 4;            // blocks per SM the registers allow at W <= 2
constexpr int MIN_BLOCKS_WIDE = 3;       // ... at W 3 and 4 (80 registers)
constexpr unsigned FULL = 0xffffffffu;
constexpr u64 ST_AGG = 1ull << 32;       // status: the tile's own OR (no run starts in it)
constexpr u64 ST_INC = 2ull << 32;       // status: the OR of the run open at the tile's end
constexpr int BUCKET_BITS = 12;
constexpr int BUCKET = 1 << BUCKET_BITS;  // read positions per bucket of vote_mask_fill
constexpr int COUNT_STRIDE = 32;         // a bucket's slot count to a 128-B line: atomics on
                                         // one line serialise in L2


// A warp's span: the OR since its last key start (of the whole span when
// none starts in it), whether one does, its head (the elements before its
// first key start: one run's) by its length, the position of its first
// query of a non-SENTINEL key (hq0 >= hlen: none) and the OR of its texts,
// which all precede that query.
struct SpanSum {
  unsigned open;
  int seen;
  int hlen;
  int hq0;
  unsigned hor;
};

// A lane's two elements of a window: the low 32 bits of their words and
// their payloads.
template <int W>
struct Win {
  unsigned a[W];
  unsigned b[W];
  long long pa;
  long long pb;
};

// Elements i and i + 1 (i even) of every row; `al` bit j: row j (bit W:
// the payload) is 16-B aligned.  Past n: all-ones words, payload -1
// (neither text nor query).
template <int W>
__device__ __forceinline__ void load_window(const long long* __restrict__ words,
                                            const long long* __restrict__ pay, long long n,
                                            long long i, unsigned al, Win<W>& x) {
  if (i + 1 < n) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const long long* p = words + (long long)j * n + i;
      if ((al >> j) & 1u) {
        // read once: evict-first, so L2 keeps the lists' open sectors
        const longlong2 v = __ldcs(reinterpret_cast<const longlong2*>(p));
        x.a[j] = (unsigned)v.x;
        x.b[j] = (unsigned)v.y;
      } else {
        x.a[j] = (unsigned)__ldg(p);
        x.b[j] = (unsigned)__ldg(p + 1);
      }
    }
    if ((al >> W) & 1u) {
      const longlong2 v = __ldcs(reinterpret_cast<const longlong2*>(pay + i));
      x.pa = v.x;
      x.pb = v.y;
    } else {
      x.pa = __ldg(pay + i);
      x.pb = __ldg(pay + i + 1);
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      x.a[j] = i < n ? (unsigned)__ldg(words + (long long)j * n + i) : FULL;
      x.b[j] = FULL;
    }
    x.pa = i < n ? __ldg(pay + i) : -1;
    x.pb = -1;
  }
}

// The first DEPTH windows of the span at `span`, and in lane 31 the
// words of the element before it.
template <int W>
__device__ __forceinline__ void load_span_head(const long long* __restrict__ words,
                                               const long long* __restrict__ pay, long long n,
                                               long long span, int lane, unsigned al,
                                               Win<W> (&buf)[DEPTH], unsigned (&last)[W]) {
#pragma unroll
  for (int d = 0; d < DEPTH; ++d)
    load_window<W>(words, pay, n, span + 64 * d + 2 * lane, al, buf[d]);
#pragma unroll
  for (int j = 0; j < W; ++j)
    last[j] = (lane == 31 && span > 0 && span - 1 < n)
                  ? (unsigned)__ldg(words + (long long)j * n + span - 1)
                  : FULL;
}

// Append query `pos`'s value v (!= 0) to its bucket's list (bucket b's
// slot count at count[b * COUNT_STRIDE]).
__device__ __forceinline__ void stage(unsigned* __restrict__ count, u64* __restrict__ staged,
                                      long long pos, unsigned v) {
  const long long b = pos >> BUCKET_BITS;
  const unsigned slot = atomicAdd(count + b * COUNT_STRIDE, 1u);
  staged[(b << BUCKET_BITS) + slot] = ((u64)(pos & (BUCKET - 1)) << 32) | v;
}

// A warp's span of SPAN elements from `span`: appends every matched query
// but the head's, and returns the span's summary.  buf holds its first windows,
// lane 31's `last` the words of the element before it.
template <int W>
__device__ __forceinline__ SpanSum scan_span(const long long* __restrict__ words,
                                             const long long* __restrict__ pay, long long n,
                                             long long span, int lane, int D, long long n_query,
                                             unsigned al, Win<W> (&buf)[DEPTH],
                                             unsigned (&last)[W], unsigned* __restrict__ count,
                                             u64* __restrict__ staged) {
  const unsigned below = (1u << lane) - 1u;  // lanes before this one
  const unsigned upto = below | (1u << lane);
  unsigned open = 0u, hor = 0u;
  bool seen = false;
  int hlen = SPAN, hq0 = SPAN;
#pragma unroll
  for (int w = 0; w < WINDOWS; ++w) {
    const Win<W> x = buf[w % DEPTH];
    if (w + DEPTH < WINDOWS)
      load_window<W>(words, pay, n, span + 64 * (w + DEPTH) + 2 * lane, al, buf[w % DEPTH]);
    // key starts: element 2l against lane l - 1's second (lane 0: the
    // previous window's last, which lane 31 passes), 2l + 1 against 2l
    bool s0 = span + 64 * w + 2 * lane == 0, s1 = false, sent0 = true, sent1 = true;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const unsigned before = __shfl_sync(FULL, lane == 31 ? last[j] : x.b[j], (lane + 31) & 31);
      last[j] = x.b[j];
      s0 = s0 || x.a[j] != before;
      s1 = s1 || x.b[j] != x.a[j];
      sent0 = sent0 && x.a[j] == FULL;
      sent1 = sent1 && x.b[j] == FULL;
    }
    const unsigned m0 = (x.pa >= 0 && x.pa < D) ? 1u << (unsigned)x.pa : 0u;
    const unsigned m1 = (x.pb >= 0 && x.pb < D) ? 1u << (unsigned)x.pb : 0u;
    // a query of a SENTINEL key is left to vote_mask_fill's 0
    const bool q0 = x.pa >= D && x.pa - D < n_query && !sent0;
    const bool q1 = x.pb >= D && x.pb - D < n_query && !sent1;
    const unsigned K0 = __ballot_sync(FULL, s0);
    const unsigned K = K0 | __ballot_sync(FULL, s1);
    const unsigned open_before = open;
    if (!__any_sync(FULL, q0 || q1)) {
      // no query: the run open at the window's end only
      if (K == 0u) {
        open |= __reduce_or_sync(FULL, m0 | m1);
      } else {
        const int L = 31 - __clz(K);
        const unsigned tail = s1 ? m1 : (m0 | m1);
        open = __reduce_or_sync(FULL, lane > L ? (m0 | m1) : (lane == L ? tail : 0u));
      }
    } else {
      // the inclusive segmented OR over the lanes' runs open at their end
      const unsigned ks = K & upto;
      const int st = ks ? 31 - __clz(ks) : -1;
      unsigned v = s1 ? m1 : (m0 | m1);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned t = __shfl_up_sync(FULL, v, o);
        if (lane - o >= st) v |= t;
      }
      const unsigned ex = __shfl_up_sync(FULL, v, 1);
      // c0: element 2l continues the run open where the window begins
      const bool c0 = !s0 && !(K & below);
      const unsigned v0 = m0 | (s0 || lane == 0 ? 0u : ex) | (c0 ? open : 0u);
      const unsigned v1 = s1 ? m1 : (v0 | m1);
      // the head's queries wait for the carry into the span: where the
      // first one is
      const bool h0 = !seen && c0, h1 = h0 && !s1;
      if (q0 && !h0 && v0) stage(count, staged, x.pa - D, v0);
      if (q1 && !h1 && v1) stage(count, staged, x.pb - D, v1);
      if (!seen) {
        const unsigned H0 = __ballot_sync(FULL, q0 && h0);
        const unsigned H = H0 | __ballot_sync(FULL, q1 && h1);
        if (H && hq0 == SPAN) {
          const int f = __ffs(H) - 1;
          hq0 = 64 * w + 2 * f + (((H0 >> f) & 1u) ? 0 : 1);
        }
      }
      open = __shfl_sync(FULL, v1, 31);
    }
    if (!seen) {
      if (K == 0u) {
        hor = open;  // the whole window is head
      } else {
        // the head ends before the first key start, in lane f; a head
        // that ends in a text holds no query, so lane f's elements do not
        // count in its texts' OR
        const int f = __ffs(K) - 1;
        hor = open_before | __reduce_or_sync(FULL, lane < f ? (m0 | m1) : 0u);
        hlen = 64 * w + 2 * f + (((K0 >> f) & 1u) ? 0 : 1);
        seen = true;
      }
    }
  }
  return SpanSum{open, (int)seen, hlen, hq0, hor};
}

// The head's queries of a span whose carry-in is known: every text of a
// run precedes its queries, so each gets carry | the OR of the head's
// texts; re-read the payloads from its first query to the head's end,
// 4 loads in flight a lane.
__device__ __forceinline__ void store_head(const long long* __restrict__ pay, long long n,
                                           long long span, int lane, int D, long long n_query,
                                           SpanSum s, unsigned carry, unsigned* __restrict__ count,
                                           u64* __restrict__ staged) {
  const unsigned v = carry | s.hor;
  if (s.hq0 >= s.hlen || v == 0u) return;  // no query, or 0: vote_mask_fill writes it
  const long long end = min(span + (long long)s.hlen, n);
  for (long long i0 = span + s.hq0; i0 < end; i0 += 128) {
    long long p[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long i = i0 + 32 * u + lane;
      p[u] = i < end ? __ldg(pay + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (p[u] >= D && p[u] - D < n_query) stage(count, staged, p[u] - D, v);
  }
}

__device__ __forceinline__ void publish(u64* at, u64 kind, unsigned v) {
  *(volatile u64*)at = kind | v;
}

// (one warp) The OR of the run open where tile t > 0 begins: the values
// of the tiles before it back to the nearest inclusive status (tile 0
// publishes one), 32 statuses a step.
__device__ __forceinline__ unsigned look_back(const u64* status, int t, int lane) {
  unsigned in = 0u;
  for (int base = t - 1;; base -= 32) {
    const int tt = base - lane;
    u64 st = tt >= 0 ? *(const volatile u64*)(status + tt) : ST_INC;
    while (!__all_sync(FULL, (st >> 32) != 0u)) {
      if (!(st >> 32)) st = *(const volatile u64*)(status + tt);
    }
    const unsigned inc = __ballot_sync(FULL, (st & ~(u64)FULL) == ST_INC);
    if (inc) {
      const int j = __ffs(inc) - 1;
      return in | __reduce_or_sync(FULL, lane <= j ? (unsigned)st : 0u);
    }
    in |= __reduce_or_sync(FULL, (unsigned)st);
  }
}

// (warp 0) Publish tile t's status (t < 0: none), then take tile tp's
// carry-in (tp < 0: none) and the OR carried into each of its spans; a
// tile in which no run starts publishes its inclusive value then.
__device__ __forceinline__ void close_tiles(u64* status, int t, const SpanSum* cur, int tp,
                                            const SpanSum* prev, unsigned* carry, int lane) {
  if (t >= 0 && lane == 0) {
    unsigned c = 0u;
    int f = 0;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      c = cur[w].seen ? cur[w].open : (c | cur[w].open);
      f |= cur[w].seen;
    }
    publish(status + t, (f || t == 0) ? ST_INC : ST_AGG, c);
  }
  if (tp < 0) return;
  const unsigned in = tp > 0 ? look_back(status, tp, lane) : 0u;
  if (lane == 0) {
    unsigned c = in;
    int f = 0;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      carry[w] = c;
      c = prev[w].seen ? prev[w].open : (c | prev[w].open);
      f |= prev[w].seen;
    }
    if (tp > 0 && !f) publish(status + tp, ST_INC, c);
  }
}

template <int W>
__global__ void __launch_bounds__(NT, W <= 2 ? MIN_BLOCKS : MIN_BLOCKS_WIDE)
    vote_mask_tiles(const long long* __restrict__ words, const long long* __restrict__ pay,
                    long long n, int D, long long n_query, int n_tiles, u64* __restrict__ status,
                    u64* __restrict__ staged) {
  __shared__ SpanSum s_sum[2][NWARPS];
  __shared__ unsigned s_carry[NWARPS];
  __shared__ int s_tile[2];
  // the buckets' slot counts follow the tile statuses and the tile counter
  unsigned* count = reinterpret_cast<unsigned*>(status + n_tiles + 1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned al = (reinterpret_cast<uintptr_t>(pay) & 15u) ? 0u : 1u << W;
#pragma unroll
  for (int j = 0; j < W; ++j)
    al |= (reinterpret_cast<uintptr_t>(words + (long long)j * n) & 15u) ? 0u : 1u << j;
  if (tid == 0) s_tile[0] = (int)atomicAdd(status + n_tiles, 1ull);
  __syncthreads();
  Win<W> buf[DEPTH];
  unsigned last[W];
  int t = s_tile[0], tp = -1;
  if (t < n_tiles)
    load_span_head<W>(words, pay, n, (long long)t * TILE + (long long)warp * SPAN, lane, al, buf,
                      last);
  for (int it = 0;; ++it) {
    const int cur = it & 1;
    if (t < n_tiles) {
      int next = 0;
      if (tid == 0) next = (int)atomicAdd(status + n_tiles, 1ull);
      const SpanSum s = scan_span<W>(words, pay, n, (long long)t * TILE + (long long)warp * SPAN,
                                     lane, D, n_query, al, buf, last, count, staged);
      if (lane == 0) s_sum[cur][warp] = s;
      if (tid == 0) s_tile[cur ^ 1] = next;
    } else if (tid == 0) {
      s_tile[cur ^ 1] = n_tiles;
    }
    __syncthreads();
    const int tn = s_tile[cur ^ 1];
    if (tn < n_tiles)
      load_span_head<W>(words, pay, n, (long long)tn * TILE + (long long)warp * SPAN, lane, al,
                        buf, last);
    if (warp == 0)
      close_tiles(status, t < n_tiles ? t : -1, s_sum[cur], tp, s_sum[cur ^ 1], s_carry, lane);
    __syncthreads();
    if (tp >= 0)
      store_head(pay, n, (long long)tp * TILE + (long long)warp * SPAN, lane, D, n_query,
                 s_sum[cur ^ 1][warp], s_carry[warp], count, staged);
    if (t >= n_tiles) break;
    tp = t;
    t = tn;
  }
}

// A block per bucket of BUCKET read positions: its values in shared
// memory (0 where no query matched), then `out` in whole sectors.
__global__ void __launch_bounds__(NT)
    vote_mask_fill(const u64* __restrict__ status, int n_tiles, const u64* __restrict__ staged,
                   long long n_query, long long* __restrict__ out) {
  __shared__ unsigned image[BUCKET];
  const long long b = blockIdx.x, base = b << BUCKET_BITS;
  for (int i = threadIdx.x; i < BUCKET; i += NT) image[i] = 0u;
  __syncthreads();
  const unsigned c = reinterpret_cast<const unsigned*>(status + n_tiles + 1)[b * COUNT_STRIDE];
  for (unsigned i = threadIdx.x; i < c; i += NT) {
    const u64 e = staged[base + i];
    image[e >> 32] = (unsigned)e;
  }
  __syncthreads();
  const int m = (int)min((long long)BUCKET, n_query - base);
  for (int i = threadIdx.x; i < m; i += NT) out[base + i] = image[i];
}

template <int W>
int launch_mask(const long long* words, const long long* pay, long long n, int D,
                long long n_query, u64* status, u64* staged, long long* out, cudaStream_t st) {
  const int n_tiles = (int)((n + TILE - 1) / TILE);
  auto kernel = vote_mask_tiles<W>;
  cudaError_t err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, 0)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // every block resident at once: a look-back waits only on tiles that
  // running blocks took before
  const int grid = (int)min((long long)n_tiles, (long long)sms * per_sm);
  kernel<<<grid, NT, 0, st>>>(words, pay, n, D, n_query, n_tiles, status, staged);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long buckets = (n_query + BUCKET - 1) / BUCKET;
  vote_mask_fill<<<(unsigned)buckets, NT, 0, st>>>(status, n_tiles, staged, n_query, out);
  return (int)cudaGetLastError();
}

constexpr int CHUNKS = 4;  // chunks of 32 windows in flight per warp
constexpr int MAX_T = 31;  // rows per warp task (their T + 1 starts fit a lane each)

// Accumulators indexed only by template arguments, so they stay in
// registers at every DB; each add is a predicated 64-bit add (a bit test
// and two adds, where a select of w or 0 took five).
template <int DB, int d = 0>
__device__ __forceinline__ void add_votes(long long (&acc)[DB], unsigned m, long long w) {
  if constexpr (d < DB) {
    asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t@p add.s64 %0, %0, %1;\n\t}"
        : "+l"(acc[d])
        : "l"(w), "r"(m & (1u << d)));
    add_votes<DB, d + 1>(acc, m, w);
  }
}

template <int DB, int d = 0>
__device__ __forceinline__ void zero_votes(long long (&acc)[DB]) {
  if constexpr (d < DB) {
    acc[d] = 0;
    zero_votes<DB, d + 1>(acc);
  }
}

// Butterfly sums of accumulators d..DB - 1 over lane bit o.
template <int DB, int d = 0>
__device__ __forceinline__ void xor_sums(long long (&acc)[DB], int o) {
  if constexpr (d < DB) {
    acc[d] += __shfl_xor_sync(FULL, acc[d], o);
    xor_sums<DB, d + 1>(acc, o);
  }
}

// A halving step over lane bit O: of accumulators d and d + O (d < O) a
// lane keeps the one its bit picks, plus its partner's copy of it, in d.
template <int DB, int O, int d = 0>
__device__ __forceinline__ void halve(long long (&acc)[DB], bool up) {
  if constexpr (d < O) {
    const long long send = up ? acc[d] : acc[d + O];
    const long long keep = up ? acc[d + O] : acc[d];
    acc[d] = keep + __shfl_xor_sync(FULL, send, O);
    halve<DB, O, d + 1>(acc, up);
  }
}

template <int DB, int O>
__device__ __forceinline__ void halvings(long long (&acc)[DB], int lane) {
  if constexpr (O >= 1) {
    halve<DB, O>(acc, (lane & O) != 0);
    halvings<DB, O / 2>(acc, lane);
  }
}

// The sum over the warp of accumulator d, for d = lane % DB, in every
// lane (acc is left undefined): butterfly sums over the lane bits at and
// above DB, then halving steps in which a lane keeps the half its bit
// picks and adds its partner's copy of it.
template <int DB>
__device__ __forceinline__ long long reduce_scatter(long long (&acc)[DB], int lane) {
  for (int o = 16; o >= DB; o >>= 1) xor_sums<DB>(acc, o);
  halvings<DB, DB / 2>(acc, lane);
  return acc[0];
}

// Close row r: its votes, unmatched and n_kmers; zero the accumulators.
template <int DB>
__device__ __forceinline__ void close_row(long long r, int D, int lane, long long (&acc)[DB],
                                          unsigned& um, unsigned& nk, long long* __restrict__ votes,
                                          long long* __restrict__ unmatched,
                                          long long* __restrict__ n_kmers) {
  const long long s = reduce_scatter<DB>(acc, lane);
  const unsigned u = __reduce_add_sync(FULL, um), k = __reduce_add_sync(FULL, nk);
  if (lane < D) votes[r * D + lane] = s;
  if (lane == 0) {
    unmatched[r] = u;
    n_kmers[r] = k;
  }
  zero_votes<DB>(acc);
  um = nk = 0u;
}

// Lane j <= the task's rows: the start of its row j (the end of the last).
__device__ __forceinline__ long long load_starts(const long long* __restrict__ row_starts,
                                                 long long R, int T, long long task,
                                                 long long n_tasks, int lane) {
  if (task >= n_tasks) return 0;
  const long long r0 = task * T;
  return lane <= min((long long)T, R - r0) ? __ldg(row_starts + r0 + lane) : 0;
}

template <int DB>
__global__ void __launch_bounds__(NT)
    read_votes_rows(const long long* __restrict__ qmask, const unsigned char* __restrict__ valid,
                    const long long* __restrict__ row_starts, long long R, int T, int D,
                    long long lcm, long long* __restrict__ votes,
                    long long* __restrict__ unmatched, long long* __restrict__ n_kmers) {
  __shared__ long long weight[33];  // lcm / c for a window matched by c datasets
  for (int c = threadIdx.x; c <= 32; c += NT) weight[c] = c ? lcm / c : 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned dmask = D >= 32 ? FULL : (1u << D) - 1u;
  const long long n_tasks = (R + T - 1) / T;
  const long long stride = (long long)gridDim.x * NWARPS;
  long long task = (long long)blockIdx.x * NWARPS + (threadIdx.x >> 5);
  long long rs_next = load_starts(row_starts, R, T, task, n_tasks, lane);
  for (; task < n_tasks; task += stride) {
    const long long r0 = task * T;
    const int nr = (int)min((long long)T, R - r0);
    const long long rs = rs_next;  // lane j: row_starts[r0 + j], j <= nr
    rs_next = load_starts(row_starts, R, T, task + stride, n_tasks, lane);
    const long long b = __shfl_sync(FULL, rs, 0), end = __shfl_sync(FULL, rs, nr);
    long long e = __shfl_sync(FULL, rs, 1);  // the end of row r0 + r
    int r = 0;
    long long acc[DB];
    zero_votes<DB>(acc);
    unsigned um = 0u, nk = 0u;
    long long qm[CHUNKS];
    unsigned vd[CHUNKS];
#pragma unroll
    for (int u = 0; u < CHUNKS; ++u) {
      const long long i = b + 32 * u + lane;
      qm[u] = i < end ? __ldg(qmask + i) : 0;
      vd[u] = i < end ? __ldg(valid + i) : 0u;
    }
    for (long long c0 = b; c0 < end; c0 += 32 * CHUNKS) {
#pragma unroll
      for (int u = 0; u < CHUNKS; ++u) {
        const long long cc = c0 + 32 * u, i = cc + lane;
        const bool v = vd[u] != 0u;
        const unsigned m = v ? (unsigned)qm[u] & dmask : 0u;
        const long long nx = i + 32 * CHUNKS;
        qm[u] = nx < end ? __ldg(qmask + nx) : 0;
        vd[u] = nx < end ? __ldg(valid + nx) : 0u;
        if (cc >= end) continue;
        const long long wt = weight[__popc(m)];
        // the lanes of row r0 + r in this chunk from `lo` on; rows that
        // end in it are closed
        for (long long lo = cc;;) {
          const bool in = i >= lo && i < e;
          add_votes<DB>(acc, in ? m : 0u, wt);
          um += in && v && m == 0u;
          nk += in && v;
          if (e > cc + 32) break;
          close_row<DB>(r0 + r, D, lane, acc, um, nk, votes, unmatched, n_kmers);
          if (++r == nr) break;
          lo = e;
          e = __shfl_sync(FULL, rs, r + 1);
        }
      }
    }
    // rows with no window (a task of empty rows)
    for (; r < nr; ++r) close_row<DB>(r0 + r, D, lane, acc, um, nk, votes, unmatched, n_kmers);
  }
}

template <int DB>
int launch_votes(const long long* qmask, const unsigned char* valid, const long long* row_starts,
                 long long R, int D, long long lcm, long long* votes, long long* unmatched,
                 long long* n_kmers, cudaStream_t st) {
  auto kernel = read_votes_rows<DB>;
  cudaError_t err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, 0)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // rows per warp task: the rows spread evenly over the resident warps in
  // as few rounds of tasks as MAX_T allows, each warp streaming its rows
  // back to back
  const long long warps = (long long)sms * per_sm * NWARPS;
  const long long rounds = (R + MAX_T * warps - 1) / (MAX_T * warps);
  const int T = (int)((R + rounds * warps - 1) / (rounds * warps));
  const long long blocks = ((R + T - 1) / T + NWARPS - 1) / NWARPS;
  const int grid = (int)min(blocks, (long long)sms * per_sm);
  kernel<<<grid, NT, 0, st>>>(qmask, valid, row_starts, R, T, D, lcm, votes, unmatched, n_kmers);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vote_mask_tile_elems() { return TILE; }

// int64 words of vote_mask_launch's zeroed scratch: a status word per
// tile, the tile counter, then a 32-bit slot count per bucket, one a
// 128-B line.
extern "C" long long vote_mask_status_words(long long n, long long n_query) {
  return (n + TILE - 1) / TILE + 1 + ((n_query + BUCKET - 1) / BUCKET * COUNT_STRIDE + 1) / 2;
}

// int64 words of vote_mask_launch's other scratch (not zeroed): each
// bucket's list.
extern "C" long long vote_mask_staged_words(long long n_query) {
  return (n_query + BUCKET - 1) / BUCKET * BUCKET;
}

// The run masks, two launches.  words: int64 [W, n] sorted stably, text
// elements (payload < D) before query elements (payload D + read
// position, each position below n_query at most once); status: zeroed
// int64 [vote_mask_status_words(n, n_query)]; staged: int64
// [vote_mask_staged_words(n_query)]; out: int64 [n_query] (n_query > 0),
// every position written, 0 where no query matched.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int vote_mask_launch(const void* words, const void* payload, long long n, int W,
                                int D, long long n_query, void* status, void* staged, void* out,
                                void* stream) {
  if (n <= 0 || n >= (1LL << 32) || W < 1 || W > 4 || D < 1 || D > 32 || n_query <= 0 ||
      n_query >= (long long)FULL || status == nullptr || staged == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const auto* w = static_cast<const long long*>(words);
  const auto* p = static_cast<const long long*>(payload);
  auto* sta = static_cast<u64*>(status);
  auto* stg = static_cast<u64*>(staged);
  auto* o = static_cast<long long*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return launch_mask<1>(w, p, n, D, n_query, sta, stg, o, st);
    case 2: return launch_mask<2>(w, p, n, D, n_query, sta, stg, o, st);
    case 3: return launch_mask<3>(w, p, n, D, n_query, sta, stg, o, st);
    case 4: return launch_mask<4>(w, p, n, D, n_query, sta, stg, o, st);
  }
  return (int)cudaErrorInvalidValue;
}

// One launch of the per-read votes.  qmask int64 [N], valid bool [N],
// row_starts int64 [R + 1] (row r is positions row_starts[r] to
// row_starts[r + 1] - 1); votes int64 [R, D], unmatched and n_kmers int64
// [R], each written once.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int read_votes_launch(const void* qmask, const void* valid, const void* row_starts,
                                 long long R, int D, long long lcm, void* votes, void* unmatched,
                                 void* n_kmers, void* stream) {
  if (R <= 0 || D < 1 || D > 32 || lcm < 1) return (int)cudaErrorInvalidValue;
  const auto* q = static_cast<const long long*>(qmask);
  const auto* v = static_cast<const unsigned char*>(valid);
  const auto* rs = static_cast<const long long*>(row_starts);
  auto* vo = static_cast<long long*>(votes);
  auto* um = static_cast<long long*>(unmatched);
  auto* nk = static_cast<long long*>(n_kmers);
  auto st = static_cast<cudaStream_t>(stream);
  if (D <= 4) return launch_votes<4>(q, v, rs, R, D, lcm, vo, um, nk, st);
  if (D <= 8) return launch_votes<8>(q, v, rs, R, D, lcm, vo, um, nk, st);
  if (D <= 16) return launch_votes<16>(q, v, rs, R, D, lcm, vo, um, nk, st);
  return launch_votes<32>(q, v, rs, R, D, lcm, vo, um, nk, st);
}
