// The shared-sort sweep's extraction: every position i of a text yields KW
// forward 16-base words (word w packs bases [i + 16w, i + 16w + 16), most
// significant first; a base >= 4, or past the text, packs as 0), the last
// word's low KW * 32 - 2 * kmax bits cleared, and a payload of the
// position's gid and nio, the consecutive valid bases from i capped at
// kmax: (gid << 6) | nio ORed into the last word (packed), or an int64 row
// (gid << 8) | nio.  Outputs are int64 [KW, n2] rows of 32-bit words, the
// layout the radix sort (radix_sort.cu) reads.
//
// Replaces XLA code of the JAX package: khoice_tpu/engine/ksweep.py::
// _extract_fwd_sweep (:142), and the doubling of the text and the gids in
// _sweep_doubled (:366).  Two modes:
//   direct  (doubled == 0): the text is codes[0, n), gids[0, n); n2 = n;
//   doubled (doubled == 1): the text is codes ++ revcomp(codes) with gids ++
//           flip(gids); n2 = 2n.  Position j >= n reads codes[2n - 1 - j]
//           complemented (where < 4) and gids[2n - 1 - j]: no reversed or
//           concatenated copy is made.
// Positions past n2 read as 4, even where the array behind `codes` holds
// more codes (a chunk of the streaming sweep is a slice).
//
// What bounds it on an H100: bytes.  Each code (1 B) and gid (8 B) is
// read once, and a position writes 8 bytes per word, plus 8 for the
// payload row: the bench class (16.8M codes, 33.6M doubled positions of 4
// packed words) needs ~0.37 ms at 3.35 TB/s.  What the design does about
// it:
//   * a block stages 16 * NT positions (its tile of TILE positions and a
//     64-position halo, enough for the fourth word and for nio up to 63)
//     with one 16-B load per thread; the doubled half reads a contiguous
//     range of codes backwards (one 16-B load, bytes reversed), and a
//     range that is not 16-B aligned takes two aligned loads and a funnel
//     shift, so every load is a vector load but at the ends of the text;
//   * each thread packs its 16 codes into one 32-bit word of 2-bit bases
//     and a 16-bit mask of invalid positions in shared memory: word w of
//     any position is then one funnel shift of two shared words, and nio
//     the first set bit of 64 mask bits from the position (k-independent,
//     no scan over the text and no host synchronisation);
//   * results go straight from registers: consecutive threads take
//     consecutive positions, so each warp stores 256 contiguous bytes of a
//     row per instruction and reads the gids coalesced (descending in the
//     doubled half), four positions' at a time per thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int NT = 256;            // threads per block, one 16-position chunk each
constexpr int SPAN = 16 * NT;      // positions staged per block
constexpr int HALO = 64;           // staged positions past the tile
constexpr int TILE = SPAN - HALO;  // positions extracted per block (a multiple of 16)
constexpr int ITER = (TILE + NT - 1) / NT;  // positions per thread
constexpr int BATCH = 4;                     // gid loads in flight per thread

// Bytes src[i, i + 16) of an array of n bytes (0 <= i, i + 16 <= n): one
// 16-B load where src + i is aligned; else two aligned loads and a funnel
// shift where both lie within the array; else 16 byte loads.
__device__ __forceinline__ uint4 load16(const unsigned char* __restrict__ src, long long i,
                                        long long n) {
  const unsigned off = (unsigned)((uintptr_t)(src + i) & 15u);
  if (off == 0) return __ldg(reinterpret_cast<const uint4*>(src + i));
  if (i >= off && i - off + 32 <= n) {
    const uint4* g = reinterpret_cast<const uint4*>(src + i - off);
    const uint4 a = __ldg(g), b = __ldg(g + 1);
    unsigned w0 = a.x, w1 = a.y, w2 = a.z, w3 = a.w, w4 = b.x, w5 = b.y, w6 = b.z, w7 = b.w;
    if (off & 8) { w0 = w2; w1 = w3; w2 = w4; w3 = w5; w4 = w6; w5 = w7; }
    if (off & 4) { w0 = w1; w1 = w2; w2 = w3; w3 = w4; w4 = w5; }
    const unsigned sh = (off & 3) * 8;
    return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                      __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
  }
  unsigned w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[q] = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) w[q] |= (unsigned)src[i + 4 * q + b] << (8 * b);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ unsigned bswap(unsigned v) { return __byte_perm(v, 0, 0x0123); }

// 16 codes in reverse order, complemented where < 4: a chunk of revcomp.
__device__ __forceinline__ uint4 revcomp16(uint4 v) {
  uint4 r = make_uint4(bswap(v.w), bswap(v.z), bswap(v.y), bswap(v.x));
  r.x ^= __vcmpltu4(r.x, 0x04040404u) & 0x03030303u;
  r.y ^= __vcmpltu4(r.y, 0x04040404u) & 0x03030303u;
  r.z ^= __vcmpltu4(r.z, 0x04040404u) & 0x03030303u;
  r.w ^= __vcmpltu4(r.w, 0x04040404u) & 0x03030303u;
  return r;
}

// 4 codes (first in the low byte) -> 8 bits of 2-bit bases, the first most
// significant, invalid codes as 0; *inv gets bit b set where code b >= 4.
__device__ __forceinline__ unsigned pack4(unsigned v, unsigned* inv) {
  const unsigned ok = __vcmpltu4(v, 0x04040404u);
  const unsigned iv = ~ok & 0x01010101u;
  *inv = (iv | (iv >> 7) | (iv >> 14) | (iv >> 21)) & 0xFu;
  const unsigned r = bswap(v & ok & 0x03030303u);
  const unsigned s = (r | (r >> 6)) & 0x000F000Fu;
  return (s | (s >> 12)) & 0xFFu;
}

// 16 codes -> one word of 16 bases (the first most significant) and the
// 16-bit mask of invalid positions (bit b for code b).
__device__ __forceinline__ unsigned pack16(uint4 v, unsigned* inv16) {
  unsigned i0, i1, i2, i3;
  const unsigned word = pack4(v.x, &i0) << 24 | pack4(v.y, &i1) << 16 |
                        pack4(v.z, &i2) << 8 | pack4(v.w, &i3);
  *inv16 = i0 | i1 << 4 | i2 << 8 | i3 << 12;
  return word;
}

// Code of text position p (4 past the text).
__device__ __forceinline__ unsigned code_at(const unsigned char* __restrict__ codes,
                                            long long n, bool doubled, long long p) {
  if (p < n) return codes[p];
  if (doubled && p < 2 * n) {
    const unsigned c = codes[2 * n - 1 - p];
    return c < 4u ? c ^ 3u : c;
  }
  return 4u;
}

template <int KW, bool PACK>
__global__ void __launch_bounds__(NT)
    sweep_tiles(const unsigned char* __restrict__ codes, const long long* __restrict__ gids,
                long long n, bool doubled, int kmax, unsigned keep,
                long long* __restrict__ out, long long* __restrict__ payload) {
  __shared__ unsigned S[NT];      // 16 bases per word, position order
  __shared__ unsigned M[NT / 2];  // bit p % 32 of word p / 32: position p invalid
  const long long n2 = doubled ? 2 * n : n;
  const long long t0 = (long long)blockIdx.x * TILE;
  // the gids of BATCH positions per thread are loaded together, the first
  // batch's before the staging, so that several loads are in flight
  auto load_gids = [&](int r0, u64* g) {
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int j = threadIdx.x + (r0 + u) * NT;
      const long long i = t0 + j;
      g[u] = j < TILE && i < n2 ? (u64)__ldg(gids + (i < n ? i : 2 * n - 1 - i)) : 0ull;
    }
  };
  u64 g[BATCH];
  load_gids(0, g);
  {
    const long long p0 = t0 + 16 * threadIdx.x;
    uint4 v;
    if (p0 + 16 <= n) {
      v = load16(codes, p0, n);
    } else if (doubled && p0 >= n && p0 + 16 <= n2) {
      v = revcomp16(load16(codes, 2 * n - 16 - p0, n));
    } else {
      unsigned w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w[q] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) w[q] |= code_at(codes, n, doubled, p0 + 4 * q + b) << (8 * b);
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    unsigned inv;
    S[threadIdx.x] = pack16(v, &inv);
    const unsigned next = __shfl_down_sync(0xffffffffu, inv, 1);
    if (!(threadIdx.x & 1)) M[threadIdx.x >> 1] = inv | next << 16;
  }
  __syncthreads();

  for (int r0 = 0; r0 < ITER; r0 += BATCH) {
    if (r0) load_gids(r0, g);
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int j = threadIdx.x + (r0 + u) * NT;
      const long long i = t0 + j;
      if (j >= TILE || i >= n2) break;
      const int q = j >> 4, s = (j & 15) * 2;
      long long words[KW];
#pragma unroll
      for (int w = 0; w < KW; ++w)
        words[w] = (long long)__funnelshift_l(S[q + w + 1], S[q + w], s);
      words[KW - 1] &= (long long)keep;
      // the 64 mask bits from i: nio is the distance to the first set one
      const int qm = j >> 5, sm = j & 31;
      const u64 bits = (u64)__funnelshift_r(M[qm + 1], M[qm + 2], sm) << 32 |
                       __funnelshift_r(M[qm], M[qm + 1], sm);
      const int nio = min(bits ? __ffsll((long long)bits) - 1 : 64, kmax);
      if (PACK) words[KW - 1] |= (long long)(g[u] << 6 | (u64)nio);
      else payload[i] = (long long)(g[u] << 8 | (u64)nio);
#pragma unroll
      for (int w = 0; w < KW; ++w) out[(long long)w * n2 + i] = words[w];
    }
  }
}

template <int KW>
int launch(const unsigned char* codes, const long long* gids, long long n, bool doubled,
           int kmax, unsigned keep, long long* out, long long* payload, cudaStream_t st) {
  const long long n2 = doubled ? 2 * n : n;
  const unsigned blocks = (unsigned)((n2 + TILE - 1) / TILE);
  if (payload == nullptr)
    sweep_tiles<KW, true><<<blocks, NT, 0, st>>>(codes, gids, n, doubled, kmax, keep, out, payload);
  else
    sweep_tiles<KW, false><<<blocks, NT, 0, st>>>(codes, gids, n, doubled, kmax, keep, out, payload);
  return (int)cudaGetLastError();
}

}  // namespace

// Positions per block.
extern "C" int extract_sweep_tile_elems() { return TILE; }

// codes uint8 [n], gids int64 [n]; out int64 [KW, n2] and, unpacked,
// payload int64 [n2] (null: the payload is packed into the last word, which
// needs KW * 32 - 2 * kmax >= 14), n2 = 2n when doubled, else n.  Launches
// on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int extract_sweep_launch(const void* codes, const void* gids, long long n,
                                    int doubled, int kmax, int kw, void* out, void* payload,
                                    void* stream) {
  const int spare = 32 * kw - 2 * kmax;
  if (n <= 0 || codes == nullptr || gids == nullptr || out == nullptr || kmax < 2 ||
      kmax > 63 || kw < 1 || kw > 4 || spare < 0 || (payload == nullptr && spare < 14))
    return (int)cudaErrorInvalidValue;
  const unsigned keep = spare >= 32 ? 0u : (0xFFFFFFFFu >> spare) << spare;
  const auto* c = static_cast<const unsigned char*>(codes);
  const auto* g = static_cast<const long long*>(gids);
  auto* o = static_cast<long long*>(out);
  auto* p = static_cast<long long*>(payload);
  auto st = static_cast<cudaStream_t>(stream);
  const bool d = doubled != 0;
  switch (kw) {
    case 1: return launch<1>(c, g, n, d, kmax, keep, o, p, st);
    case 2: return launch<2>(c, g, n, d, kmax, keep, o, p, st);
    case 3: return launch<3>(c, g, n, d, kmax, keep, o, p, st);
    default: return launch<4>(c, g, n, d, kmax, keep, o, p, st);
  }
}
