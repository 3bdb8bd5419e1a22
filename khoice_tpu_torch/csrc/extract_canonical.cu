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
// What bounds it on an H100: bytes.  A position reads 1 code byte (8 more
// for its gid in packed mode) and writes 8 bytes per output word plus 1
// valid byte; at n = 2^24 and four words that is ~0.17 ms at 3.35 TB/s.
// The shift registers cost about (k + EPT) / EPT steps per position.
// What the design does about it:
//   * each block stages its tile of codes plus a 64-code halo (>= k - 1) in
//     shared memory, so every code is read from device memory once per
//     block (the TPU kernel DMA'd a tile plus a 1024-code halo into VMEM);
//     codes past the end of the array read as 4, so windows that cross it
//     are invalid, as extract_canonical's padding makes them;
//   * each thread keeps the forward and reverse-complement registers of
//     EPT consecutive windows and rolls them one base per window (two
//     uint64 hold 126 bits; k <= 31 uses one), instead of k pushes per
//     window as the TPU kernel's unrolled register did;
//   * results go out word by word through a shared staging buffer (skewed
//     against bank conflicts), so consecutive threads write consecutive
//     int64 words: the writes are coalesced.
// Wider loads of the codes and 32-bit output words are left for later
// work.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int NT = 256;          // threads per block
constexpr int EPT = 8;           // consecutive windows per thread
constexpr int TILE = NT * EPT;   // windows per block
constexpr int HALO = 64;         // codes past the tile, >= k - 1
constexpr int MAX_K = 63;

__device__ __forceinline__ int skew(int p) { return p + (p >> 5); }

__device__ __forceinline__ u64 low_mask(int bits) {  // 0 <= bits <= 64
  return bits >= 64 ? ~0ull : ((1ull << bits) - 1ull);
}

// Word w (most significant first) of the nw-word value (hi, lo).
__device__ __forceinline__ unsigned word_of(u64 hi, u64 lo, int nw, int w) {
  const int bit = (nw - 1 - w) * 32;
  return (unsigned)((bit >= 64 ? hi >> (bit - 64) : lo >> bit) & 0xffffffffull);
}

template <bool WIDE, bool PACK>
__global__ void __launch_bounds__(NT)
    extract_kernel(const unsigned char* __restrict__ codes, long long n, int k,
                   const long long* __restrict__ gids, long long* __restrict__ out,
                   int nw, unsigned char* __restrict__ valid) {
  __shared__ unsigned char s[TILE + HALO];
  __shared__ unsigned buf[TILE + TILE / 32];
  const long long t0 = (long long)blockIdx.x * TILE;
  for (int j = threadIdx.x; j < TILE + HALO; j += NT) {
    const long long i = t0 + j;
    s[j] = i < n ? codes[i] : (unsigned char)4;
  }
  __syncthreads();

  const int k2 = 2 * k;
  const int base = threadIdx.x * EPT;
  // forward register: the last k bases, masked to 2k bits; reverse
  // complement register: complemented bases pushed in at bit 2k - 2
  u64 fhi = 0ull, flo = 0ull, rhi = 0ull, rlo = 0ull;
  int run = 0;  // consecutive valid codes ending at the last one pushed
  auto push = [&](unsigned c) {
    run = c < 4u ? run + 1 : 0;
    const u64 d = c & 3u;
    const u64 comp = d ^ 3ull;
    if (WIDE) {
      fhi = ((fhi << 2) | (flo >> 62)) & low_mask(k2 - 64);
      flo = (flo << 2) | d;
      rlo = (rlo >> 2) | (rhi << 62);
      rhi >>= 2;
      if (k2 - 2 >= 64) rhi |= comp << (k2 - 2 - 64);
      else rlo |= comp << (k2 - 2);
    } else {
      flo = ((flo << 2) | d) & low_mask(k2);
      rlo = (rlo >> 2) | (comp << (k2 - 2));
    }
  };
  for (int q = 0; q < k - 1; ++q) push(s[base + q]);

  u64 khi[EPT], klo[EPT];
  bool ok[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    push(s[base + k - 1 + e]);
    const bool fwd_lt = WIDE ? (fhi < rhi || (fhi == rhi && flo < rlo)) : flo < rlo;
    u64 hi = fwd_lt ? fhi : rhi;
    u64 lo = fwd_lt ? flo : rlo;
    ok[e] = run >= k;
    if (PACK) {
      const long long i = t0 + base + e;
      const u64 gid = (ok[e] && i < n) ? (u64)gids[i] & 255ull : 0ull;
      hi = (hi << 8) | (lo >> 56);
      lo = (lo << 8) | gid;
    }
    khi[e] = ok[e] ? hi : ~0ull;
    klo[e] = ok[e] ? lo : ~0ull;
  }

  // word by word through shared memory, so that the writes coalesce
  for (int w = 0; w <= nw; ++w) {
    if (w == nw && valid == nullptr) break;
    __syncthreads();
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      buf[skew(base + e)] = w < nw ? word_of(khi[e], klo[e], nw, w) : (unsigned)ok[e];
    __syncthreads();
    for (int j = threadIdx.x; j < TILE; j += NT) {
      const long long i = t0 + j;
      if (i < n) {
        if (w < nw) out[(long long)w * n + i] = (long long)buf[skew(j)];
        else valid[i] = (unsigned char)buf[skew(j)];
      }
    }
  }
}

template <bool WIDE, bool PACK>
int launch(const unsigned char* codes, long long n, int k, const long long* gids,
           long long* out, int nw, unsigned char* valid, cudaStream_t st) {
  const long long n_tiles = (n + TILE - 1) / TILE;
  extract_kernel<WIDE, PACK><<<(unsigned)n_tiles, NT, 0, st>>>(codes, n, k, gids, out, nw, valid);
  return (int)cudaGetLastError();
}

}  // namespace

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
  const bool wide = k > 31;
  if (gids == nullptr)
    return wide ? launch<true, false>(c, n, k, g, o, n_words, v, st)
                : launch<false, false>(c, n, k, g, o, n_words, v, st);
  return wide ? launch<true, true>(c, n, k, g, o, n_words, v, st)
              : launch<false, true>(c, n, k, g, o, n_words, v, st);
}
