// Segmented scans across one CUDA block, shared by the three-pass scan
// kernels (ksweep_scan.cu, occ_scan.cu).
//
// A segment value S is a struct with an `int f` field (a segment starts
// inside the span) and the fields the kernel carries over a segment, laid
// out without padding: padding bytes ride every copy of S as live values
// (4-9% on every mode of ksweep_scan.cu, H100).  S{} is the identity, and
// S provides
//   static S combine(S a, S b)    a precedes b: b's fields when b.f, else
//                                 the two combined (OR, sum, ...)
//   static S shfl_up(S x, int d)  __shfl_up_sync of every field by d lanes
// The kernels run three passes because CUDA blocks run in no order:
// (1) each tile's summary (block_scan's total), (2) one block turns the
// tile summaries into carry-ins (carry_scan), (3) each tile rescans with
// its carry-in (block_scan's exclusive value).

#pragma once

#include <cuda_runtime.h>

namespace seg_scan {

// Exclusive segmented scan across the block's NTHREADS threads; *total
// gets the whole block's value.  sh holds one S per warp.
template <int NTHREADS, class S>
__device__ S block_scan(S x, S* total, S* sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  S inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const S o = S::shfl_up(inc, off);
    if (lane >= off) inc = S::combine(o, inc);
  }
  S exc = S::shfl_up(inc, 1);
  if (lane == 0) exc = S{};
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  S pre{};
  S tot{};
  for (int w = 0; w < NTHREADS / 32; ++w) {
    if (w < warp) pre = S::combine(pre, sh[w]);
    tot = S::combine(tot, sh[w]);
  }
  __syncthreads();  // sh is reused by the next call
  *total = tot;
  return S::combine(pre, exc);
}

// Pass 2, run by one block of NTHREADS threads: the summaries load(t) of
// tiles 0..n_tiles-1 become each tile's carry-in, store(t, c) with c the
// combined summaries of the tiles before t (what is still open where tile
// t begins).  Each thread takes a contiguous range of tiles.
template <int NTHREADS, class S, class Load, class Store>
__device__ void carry_scan(int n_tiles, S* sh, Load load, Store store) {
  const int per = (n_tiles + NTHREADS - 1) / NTHREADS;
  const int t0 = min((int)threadIdx.x * per, n_tiles);
  const int t1 = min(t0 + per, n_tiles);
  S s{};
  for (int t = t0; t < t1; ++t) s = S::combine(s, load(t));
  S tot;
  S run = block_scan<NTHREADS>(s, &tot, sh);
  for (int t = t0; t < t1; ++t) {
    store(t, run);
    run = S::combine(run, load(t));
  }
}

}  // namespace seg_scan
