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
// sort (each query stores its value at its read position).
//   * one launch, one read: persistent blocks take tiles of TILE elements
//     from an atomic counter after the status words; a tile publishes
//     Seg{f = a key run starts in it, v = the OR since its last run start
//     (of the whole tile when f = 0)} and takes its carry-in by decoupled
//     look-back (Merrill & Garland, 2016), as csrc/occ_scan.cu does; value
//     and kind share one 64-bit word;
//   * coalesced loads: each warp owns a contiguous span of SPAN elements
//     and walks it in 64-element windows, lane l holding elements l and
//     l + 32 (two 8-B loads a row, 256 contiguous bytes per warp
//     instruction), the next window's loads in flight;
//   * the segmented OR within a window: a ballot of the key starts gives
//     each lane its run's first lane, and five shuffles of the value make
//     the inclusive scan (a lane takes lane - o's value while lane - o is
//     in its run);
//   * a span's values wait in registers until the look-back has given
//     the OR carried into the span; then each query stores one 8-B value.
// Any n below 2^32, the ragged tile masked.
//
// read_votes.  For each read row r (positions row_starts[r] to
// row_starts[r + 1] of the flat query masks): a window with mask m != 0
// (its low D bits, 0 where not valid) votes lcm / popcount(m) for each
// dataset in m; votes[r, d] sums them in int64, unmatched[r] counts the
// valid windows with m == 0 and n_kmers[r] the valid windows.  A warp per
// row: lane j loads window j of each 32 (coalesced), the warp walks the
// windows that matched (a ballot), and lane d adds the weight where bit d
// is set; the weights lcm / c (c = 1..32) sit in shared memory.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int NT = 256;                  // threads per block
constexpr int NWARPS = NT / 32;
constexpr int WINDOWS = 8;               // 64-element windows per warp and tile
constexpr int SPAN = 64 * WINDOWS;       // elements per warp and tile
constexpr int TILE = NWARPS * SPAN;      // elements per tile
constexpr int MIN_BLOCKS = 2;            // blocks per SM the register budget keeps
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NOT_QUERY = 0xffffffffu;
constexpr u64 ST_AGG = 1ull << 32;       // status: the tile's own OR (no run starts in it)
constexpr u64 ST_INC = 2ull << 32;       // status: the OR of the run open at the tile's end

// A warp's span: the OR since its last key start (of the whole span when
// none starts in it) and whether one does.
struct SpanState {
  unsigned open;
  int seen;
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

template <int W>
__device__ __forceinline__ void load_window(const long long* __restrict__ words,
                                            const long long* __restrict__ pay, long long n,
                                            long long base, int lane, Win<W>& x) {
  const long long ia = base + lane, ib = ia + 32;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const long long* row = words + (long long)j * n;
    x.a[j] = ia < n ? (unsigned)__ldg(row + ia) : FULL;
    x.b[j] = ib < n ? (unsigned)__ldg(row + ib) : FULL;
  }
  x.pa = ia < n ? __ldg(pay + ia) : -1;  // -1: neither text nor query
  x.pb = ib < n ? __ldg(pay + ib) : -1;
}

// One element's bit (a text's 1 << gid, else 0) and its output index
// (NOT_QUERY unless a query of a non-SENTINEL key; `zero` marks a
// SENTINEL query, whose value is 0).
__device__ __forceinline__ void classify(long long p, bool sent, int D, long long n_query,
                                         unsigned& m, unsigned& idx, bool& zero) {
  m = (p >= 0 && p < D) ? 1u << (unsigned)p : 0u;
  idx = NOT_QUERY;
  zero = false;
  if (p >= D && p - D < n_query) {
    idx = (unsigned)(p - D);
    zero = sent;
  }
}

// The inclusive OR over lanes s..lane of v (s <= lane; s = -1 for a run
// that begins before the window's half).
__device__ __forceinline__ unsigned seg_or(unsigned v, int s, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    // below lane o the shuffle returns the lane's own value: no change
    const unsigned t = __shfl_up_sync(FULL, v, o);
    if (lane - o >= s) v |= t;
  }
  return v;
}

// A warp's span of SPAN elements from `span`: each element's value
// without the OR carried into the span (val), its output index, and
// whether its run began before the span (bit of `needs`).
template <int W>
__device__ __forceinline__ SpanState scan_span(const long long* __restrict__ words,
                                               const long long* __restrict__ pay, long long n,
                                               long long span, int lane, int D,
                                               long long n_query, unsigned (&val)[2 * WINDOWS],
                                               unsigned (&idx)[2 * WINDOWS], unsigned& needs) {
  unsigned prev[W];
#pragma unroll
  for (int j = 0; j < W; ++j)
    prev[j] = (span > 0 && span - 1 < n) ? (unsigned)__ldg(words + (long long)j * n + span - 1)
                                         : FULL;
  const unsigned upto = lane == 31 ? FULL : (2u << lane) - 1u;  // lanes 0..lane
  const int src = (lane + 31) & 31;
  SpanState s{0u, 0};
  needs = 0u;
  Win<W> cur, nxt;
  load_window<W>(words, pay, n, span, lane, cur);
#pragma unroll
  for (int w = 0; w < WINDOWS; ++w) {
    if (w + 1 < WINDOWS) load_window<W>(words, pay, n, span + 64 * (w + 1), lane, nxt);
    const long long ia = span + 64 * w + lane;
    // key starts against the predecessors: lane l - 1's elements; lane
    // 0's are the previous window's last and lane 31's first
    bool eqa = true, eqb = true, sa = true, sb = true;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const unsigned xa = __shfl_sync(FULL, cur.a[j], src);
      const unsigned xb = __shfl_sync(FULL, cur.b[j], src);
      const unsigned pa = lane ? xa : prev[j];
      const unsigned pb = lane ? xb : xa;
      prev[j] = __shfl_sync(FULL, cur.b[j], 31);
      eqa = eqa && cur.a[j] == pa;
      eqb = eqb && cur.b[j] == pb;
      sa = sa && cur.a[j] == FULL;
      sb = sb && cur.b[j] == FULL;
    }
    const unsigned Ka = __ballot_sync(FULL, !eqa || ia == 0);
    const unsigned Kb = __ballot_sync(FULL, !eqb);
    unsigned ma, mb, qa, qb;
    bool za, zb;
    classify(cur.pa, sa, D, n_query, ma, qa, za);
    classify(cur.pb, sb, D, n_query, mb, qb, zb);
    const unsigned ka = Ka & upto, kb = Kb & upto;
    unsigned va = seg_or(ma, ka ? 31 - __clz(ka) : -1, lane);
    if (!ka) va |= s.open;  // the run began before the window
    const unsigned a31 = __shfl_sync(FULL, va, 31);
    unsigned vb = seg_or(mb, kb ? 31 - __clz(kb) : -1, lane);
    if (!kb) vb |= a31;  // ... before the window's second half
    const bool na = !s.seen && !ka;
    const bool nb = !s.seen && !Ka && !kb;
    val[2 * w] = za ? 0u : va;
    val[2 * w + 1] = zb ? 0u : vb;
    idx[2 * w] = qa;
    idx[2 * w + 1] = qb;
    needs |= (unsigned)(na && !za) << (2 * w);
    needs |= (unsigned)(nb && !zb) << (2 * w + 1);
    s.open = __shfl_sync(FULL, vb, 31);
    s.seen |= (Ka | Kb) != 0u;
    if (w + 1 < WINDOWS) cur = nxt;
  }
  return s;
}

__device__ __forceinline__ void publish(u64* at, u64 kind, unsigned v) {
  *(volatile u64*)at = kind | v;
}

// The OR of the run open where tile t begins: the values of the tiles
// before it back to the first inclusive status (tile 0 publishes one).
__device__ __forceinline__ unsigned look_back(const u64* status, int t) {
  unsigned in = 0u;
  for (int tt = t - 1;; --tt) {
    u64 st;
    do {
      st = *(const volatile u64*)(status + tt);
    } while (!(st >> 32));
    in |= (unsigned)st;
    if ((st & ~(u64)FULL) == ST_INC) return in;
  }
}

// (one thread) The tile's status and look-back, then the OR carried into
// each warp's span.
__device__ __forceinline__ void close_tile(u64* status, int t, const SpanState* sp,
                                           unsigned* carry) {
  int f = 0;
  unsigned c = 0u;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    c = sp[w].seen ? sp[w].open : (c | sp[w].open);
    f |= sp[w].seen;
  }
  publish(status + t, (f || t == 0) ? ST_INC : ST_AGG, c);
  unsigned in = 0u;
  if (t > 0) {
    in = look_back(status, t);
    if (!f) publish(status + t, ST_INC, in | c);
  }
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    carry[w] = in;
    in = sp[w].seen ? sp[w].open : (in | sp[w].open);
  }
}

template <int W>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    vote_mask_tiles(const long long* __restrict__ words, const long long* __restrict__ pay,
                    long long n, int D, long long n_query, int n_tiles, u64* __restrict__ status,
                    long long* __restrict__ out) {
  __shared__ SpanState s_span[NWARPS];
  __shared__ unsigned s_carry[NWARPS];
  __shared__ int s_tile[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile[0] = (int)atomicAdd(status + n_tiles, 1ull);
  __syncthreads();
  for (int it = 0;; ++it) {
    const int t = s_tile[it & 1];
    if (t >= n_tiles) break;
    if (tid == 0) s_tile[(it + 1) & 1] = (int)atomicAdd(status + n_tiles, 1ull);
    unsigned val[2 * WINDOWS], idx[2 * WINDOWS], needs;
    const SpanState s = scan_span<W>(words, pay, n, (long long)t * TILE + (long long)warp * SPAN,
                                     lane, D, n_query, val, idx, needs);
    if (lane == 0) s_span[warp] = s;
    __syncthreads();
    if (tid == 0) close_tile(status, t, s_span, s_carry);
    __syncthreads();
    const unsigned cin = s_carry[warp];
#pragma unroll
    for (int e = 0; e < 2 * WINDOWS; ++e) {
      if (idx[e] != NOT_QUERY) out[idx[e]] = (long long)(((needs >> e) & 1u) ? (val[e] | cin) : val[e]);
    }
  }
}

template <int W>
int launch_mask(const long long* words, const long long* pay, long long n, int D,
                long long n_query, u64* status, long long* out, cudaStream_t st) {
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
  const int grid = (int)min((long long)n_tiles, (long long)sms * per_sm);
  kernel<<<grid, NT, 0, st>>>(words, pay, n, D, n_query, n_tiles, status, out);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(NT)
    read_votes_rows(const long long* __restrict__ qmask, const bool* __restrict__ valid,
                    const long long* __restrict__ row_starts, long long R, int D, long long lcm,
                    long long* __restrict__ votes, long long* __restrict__ unmatched,
                    long long* __restrict__ n_kmers) {
  __shared__ long long weight[33];  // lcm / c for a window matched by c datasets
  for (int c = threadIdx.x; c <= 32; c += NT) weight[c] = c ? lcm / c : 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned dmask = D >= 32 ? FULL : (1u << D) - 1u;
  const long long stride = (long long)gridDim.x * NWARPS;
  for (long long r = (long long)blockIdx.x * NWARPS + (threadIdx.x >> 5); r < R; r += stride) {
    const long long b = row_starts[r], e = row_starts[r + 1];
    long long acc = 0;
    unsigned um = 0u, nk = 0u;
    for (long long i0 = b; i0 < e; i0 += 32) {
      const long long i = i0 + lane;
      const bool v = i < e && valid[i];
      const unsigned m = v ? (unsigned)qmask[i] & dmask : 0u;
      um += v && m == 0u;
      nk += v;
      for (unsigned hits = __ballot_sync(FULL, m != 0u); hits; hits &= hits - 1u) {
        const unsigned mj = __shfl_sync(FULL, m, __ffs(hits) - 1);
        if ((mj >> lane) & 1u) acc += weight[__popc(mj)];
      }
    }
    um = __reduce_add_sync(FULL, um);
    nk = __reduce_add_sync(FULL, nk);
    if (lane < D) votes[r * D + lane] = acc;
    if (lane == 0) {
      unmatched[r] = um;
      n_kmers[r] = nk;
    }
  }
}

}  // namespace

extern "C" int vote_mask_tile_elems() { return TILE; }

// One launch of the run masks.  words: int64 [W, n] sorted stably, text
// elements (payload < D) before query elements (payload D + read
// position); status: zeroed int64 [ceil(n / vote_mask_tile_elems()) + 1]
// (a status word per tile, the tile counter last); out: int64 [n_query],
// each written once.  Launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int vote_mask_launch(const void* words, const void* payload, long long n, int W,
                                int D, long long n_query, void* status, void* out,
                                void* stream) {
  if (n <= 0 || n >= (1LL << 32) || W < 1 || W > 4 || D < 1 || D > 32 || n_query < 0 ||
      n_query >= (long long)NOT_QUERY || status == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const auto* w = static_cast<const long long*>(words);
  const auto* p = static_cast<const long long*>(payload);
  auto* sta = static_cast<u64*>(status);
  auto* o = static_cast<long long*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return launch_mask<1>(w, p, n, D, n_query, sta, o, st);
    case 2: return launch_mask<2>(w, p, n, D, n_query, sta, o, st);
    case 3: return launch_mask<3>(w, p, n, D, n_query, sta, o, st);
    case 4: return launch_mask<4>(w, p, n, D, n_query, sta, o, st);
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
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const long long blocks = (R + NWARPS - 1) / NWARPS;
  const int grid = (int)min(blocks, (long long)sms * 16);
  read_votes_rows<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(qmask), static_cast<const bool*>(valid),
      static_cast<const long long*>(row_starts), R, D, lcm, static_cast<long long*>(votes),
      static_cast<long long*>(unmatched), static_cast<long long*>(n_kmers));
  return (int)cudaGetLastError();
}
