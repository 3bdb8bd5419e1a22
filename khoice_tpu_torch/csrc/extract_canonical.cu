// Canonical k-mer extraction: for every window of k codes, the lexicographic
// min of the forward k-mer and its reverse complement, or the all-ones
// SENTINEL where the window holds a code >= 4 (an N, a separator, or the
// end of the array).
//
// Replaces the TPU kernel khoice_tpu/kernels/extract_pallas.py::
// extract_canonical_pallas (:86, pallas_call :104, body _kernel :36-82),
// and computes what khoice_tpu/engine/extract.py::extract_canonical
// computes.  Two outputs:
//   keys mode  (gids == null): int64 [key_words(k), n] key words (32-bit
//              values, most significant first, the 2k-bit key right-aligned)
//              and uint8/bool [n] valid;
//   packed mode (gids given): int64 [ow, n] words of (key << 8) | gid over
//              ow = occ_words_static(k) = ceil((2k + 8) / 32) words, all-ones
//              where the window is invalid: the JAX package's
//              engine/occurrence.py::pack_gid_static of the canonical keys,
//              fused into the same pass (gids must be < 256, k <= 60).
//
// What bounds it on an H100: bytes.  A window reads 1 code byte (8 more for
// its gid in packed mode) and writes 8 bytes per output word plus 1 valid
// byte; at n = 2^24 and four words that is ~0.17 ms at 3.35 TB/s.  What the
// design does about it:
//   * a block stages 16 * NT codes (its tile of TILE windows and a
//     64-code halo >= k - 1) with one 16-B load per thread (two aligned
//     loads and a funnel shift where the codes are not 16-B aligned), and
//     packs them into 32-bit words of 16 bases and a bit mask of invalid
//     codes in shared memory;
//   * per window the work does not depend on k: the forward k-mer is a
//     funnel shift of at most five shared words, its reverse complement
//     the complemented, 2-bit-reversed bits of the same value (__brevll),
//     and its validity one test of k mask bits (no k - 1 pushes per
//     thread, no run counter);
//   * results go straight from registers: consecutive threads take
//     consecutive windows, so each warp stores 256 contiguous bytes of a
//     row (32 of `valid`) per instruction, with no staging buffer and no
//     barrier after the packing; gids are read coalesced, four windows'
//     at a time per thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int NT = 256;            // threads per block, one 16-code chunk each
constexpr int SPAN = 16 * NT;      // codes staged per block
constexpr int HALO = 64;           // codes past the tile, >= k - 1
constexpr int TILE = SPAN - HALO;  // windows per block (a multiple of 16)
constexpr int ITER = (TILE + NT - 1) / NT;  // windows per thread
constexpr int BATCH = 4;                     // gid loads in flight per thread
constexpr int MAX_K = 63;

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

// 4 codes (first in the low byte) -> 8 bits of 2-bit bases, the first most
// significant; *inv gets bit b set where code b >= 4.
__device__ __forceinline__ unsigned pack4(unsigned v, unsigned* inv) {
  const unsigned ok = __vcmpltu4(v, 0x04040404u);
  const unsigned iv = ~ok & 0x01010101u;
  *inv = (iv | (iv >> 7) | (iv >> 14) | (iv >> 21)) & 0xFu;
  const unsigned r = __byte_perm(v & 0x03030303u, 0, 0x0123);
  const unsigned s = (r | (r >> 6)) & 0x000F000Fu;
  return (s | (s >> 12)) & 0xFFu;
}

// 16 codes -> one word of 16 bases (the first most significant) and the
// 16-bit mask of invalid codes (bit b for code b).
__device__ __forceinline__ unsigned pack16(uint4 v, unsigned* inv16) {
  unsigned i0, i1, i2, i3;
  const unsigned word = pack4(v.x, &i0) << 24 | pack4(v.y, &i1) << 16 |
                        pack4(v.z, &i2) << 8 | pack4(v.w, &i3);
  *inv16 = i0 | i1 << 4 | i2 << 8 | i3 << 12;
  return word;
}

// Reverse the 2-bit groups of x.
__device__ __forceinline__ u64 rev2(u64 x) {
  x = __brevll(x);
  return ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
}

__device__ __forceinline__ u64 low_mask(int bits) {  // 0 <= bits <= 64
  return bits >= 64 ? ~0ull : ((1ull << bits) - 1ull);
}

// Word w (most significant first) of the nw-word value (hi, lo).
__device__ __forceinline__ long long word_of(u64 hi, u64 lo, int nw, int w) {
  const int bit = (nw - 1 - w) * 32;
  return (long long)((bit >= 64 ? hi >> (bit - 64) : lo >> bit) & 0xffffffffull);
}

// CW: 32-bit words the forward k-mer spans left-aligned (1: k <= 16,
// 2: k <= 32, 4: k <= 63).
template <int CW, bool PACK>
__global__ void __launch_bounds__(NT)
    extract_kernel(const unsigned char* __restrict__ codes, long long n, int k,
                   const long long* __restrict__ gids, long long* __restrict__ out,
                   int nw, unsigned char* __restrict__ valid) {
  __shared__ unsigned S[NT];      // 16 bases per word, position order
  __shared__ unsigned M[NT / 2];  // bit p % 32 of word p / 32: code p invalid
  const long long t0 = (long long)blockIdx.x * TILE;
  // packed, the gids of BATCH windows per thread are loaded together, the
  // first batch's before the staging, so that several loads are in flight
  auto load_gids = [&](int r0, u64* g) {
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int j = threadIdx.x + (r0 + u) * NT;
      const long long i = t0 + j;
      g[u] = PACK && j < TILE && i < n ? (u64)__ldg(gids + i) & 255ull : 0ull;
    }
  };
  u64 g[BATCH];
  load_gids(0, g);
  {
    const long long p0 = t0 + 16 * threadIdx.x;
    uint4 v;
    if (p0 + 16 <= n) {
      v = load16(codes, p0, n);
    } else {  // the end of the array: codes past it read as 4
      unsigned w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w[q] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const long long p = p0 + 4 * q + b;
          w[q] |= (p < n ? (unsigned)codes[p] : 4u) << (8 * b);
        }
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    unsigned inv;
    S[threadIdx.x] = pack16(v, &inv);
    const unsigned next = __shfl_down_sync(0xffffffffu, inv, 1);
    if (!(threadIdx.x & 1)) M[threadIdx.x >> 1] = inv | next << 16;
  }
  __syncthreads();

  const int k2 = 2 * k;
  for (int r0 = 0; r0 < ITER; r0 += BATCH) {
    if (PACK && r0) load_gids(r0, g);
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int j = threadIdx.x + (r0 + u) * NT;
      const long long i = t0 + j;
      if (j >= TILE || i >= n) break;
      // the window's forward bases, left-aligned in CW * 32 bits
      const int q = j >> 4, s = (j & 15) * 2;
      u64 hi = 0, lo;
      if (CW == 1) {
        const u64 f = __funnelshift_l(S[q + 1], S[q], s);
        const u64 fwd = f >> (32 - k2);
        const u64 rc = (rev2(~f) >> 32) & low_mask(k2);
        lo = fwd < rc ? fwd : rc;
      } else if (CW == 2) {
        const u64 f = (u64)__funnelshift_l(S[q + 1], S[q], s) << 32 |
                      __funnelshift_l(S[q + 2], S[q + 1], s);
        const u64 fwd = f >> (64 - k2);
        const u64 rc = rev2(~f) & low_mask(k2);
        lo = fwd < rc ? fwd : rc;
      } else {
        const u64 fh = (u64)__funnelshift_l(S[q + 1], S[q], s) << 32 |
                       __funnelshift_l(S[q + 2], S[q + 1], s);
        const u64 fl = (u64)__funnelshift_l(S[q + 3], S[q + 2], s) << 32 |
                       __funnelshift_l(S[q + 4], S[q + 3], s);
        const int rs = 128 - k2;  // 2..62
        const u64 fwd_hi = fh >> rs, fwd_lo = fl >> rs | fh << (64 - rs);
        const u64 rc_hi = rev2(~fl) & low_mask(k2 - 64), rc_lo = rev2(~fh);
        const bool fwd_lt = fwd_hi < rc_hi || (fwd_hi == rc_hi && fwd_lo < rc_lo);
        hi = fwd_lt ? fwd_hi : rc_hi;
        lo = fwd_lt ? fwd_lo : rc_lo;
      }
      // valid: none of the k mask bits from j set
      const int qm = j >> 5, sm = j & 31;
      const u64 bits = (u64)__funnelshift_r(M[qm + 1], M[qm + 2], sm) << 32 |
                       __funnelshift_r(M[qm], M[qm + 1], sm);
      const bool ok = (bits & low_mask(k)) == 0;
      if (PACK) {
        const u64 gid = ok ? g[u] : 0ull;
        hi = hi << 8 | lo >> 56;
        lo = lo << 8 | gid;
      } else {
        valid[i] = (unsigned char)ok;
      }
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (w < nw) out[(long long)w * n + i] = ok ? word_of(hi, lo, nw, w) : 0xffffffffll;
    }
  }
}

template <int CW, bool PACK>
int launch(const unsigned char* codes, long long n, int k, const long long* gids,
           long long* out, int nw, unsigned char* valid, cudaStream_t st) {
  const unsigned blocks = (unsigned)((n + TILE - 1) / TILE);
  extract_kernel<CW, PACK><<<blocks, NT, 0, st>>>(codes, n, k, gids, out, nw, valid);
  return (int)cudaGetLastError();
}

template <bool PACK>
int launch_k(const unsigned char* codes, long long n, int k, const long long* gids,
             long long* out, int nw, unsigned char* valid, cudaStream_t st) {
  if (k <= 16) return launch<1, PACK>(codes, n, k, gids, out, nw, valid, st);
  if (k <= 32) return launch<2, PACK>(codes, n, k, gids, out, nw, valid, st);
  return launch<4, PACK>(codes, n, k, gids, out, nw, valid, st);
}

}  // namespace

// Windows per block.
extern "C" int extract_canonical_tile_elems() { return TILE; }

// Keys mode (gids null): out int64 [key_words(k), n], valid uint8 [n].
// Packed mode (gids int64 [n], each < 256): out int64 [ow, n] with
// ow = ceil((2k + 8) / 32), valid may be null.  n_words is the row count
// of out.  Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int extract_canonical_launch(const void* codes, long long n, int k,
                                        const void* gids, void* out, int n_words,
                                        void* valid, void* stream) {
  const int key_w = k <= 15 ? 1 : (k <= 31 ? 2 : 4);
  const int pack_w = (2 * k + 8 + 31) / 32;
  if (n <= 0 || k < 2 || k > MAX_K || k - 1 > HALO || out == nullptr ||
      (gids == nullptr && (n_words != key_w || valid == nullptr)) ||
      (gids != nullptr && (k > 60 || n_words != pack_w)))
    return (int)cudaErrorInvalidValue;
  const auto* c = static_cast<const unsigned char*>(codes);
  const auto* g = static_cast<const long long*>(gids);
  auto* o = static_cast<long long*>(out);
  auto* v = static_cast<unsigned char*>(valid);
  auto st = static_cast<cudaStream_t>(stream);
  return gids == nullptr ? launch_k<false>(c, n, k, g, o, n_words, v, st)
                         : launch_k<true>(c, n, k, g, o, n_words, v, st);
}
