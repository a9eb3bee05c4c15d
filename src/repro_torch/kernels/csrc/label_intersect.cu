// Stage 1 of every query (paper Equation 1): mu[q] = min over ancestor
// ids shared by the two label rows of d_s + d_t, +inf when none.
//
// Replaces the Pallas kernel repro/kernels/label_intersect/kernel.py:
// label_intersect_kernel (_intersect_kernel -> _equality_join). The TPU
// kernel compares every id pair of a [bq, L] tile (an L^2 equality join
// on the vector unit); here one warp takes one query, each lane walks a
// strided part of ids_s and binary-searches each id in the sorted ids_t
// row (the same hit set as the searchsorted reference), and a warp
// shuffle takes the min. O(L log L) per query instead of O(L^2).
//
// Bound on Hopper: bytes. Each query reads its four [L] rows once
// (16 L bytes) and does L log L comparisons; the rows of one query sit
// in a few cache lines, so the binary search runs from L1.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void label_intersect_warp(const int* __restrict__ ids_s,
                                     const float* __restrict__ d_s,
                                     const int* __restrict__ ids_t,
                                     const float* __restrict__ d_t,
                                     float* __restrict__ mu, int q, int l,
                                     int n_sentinel) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= q) return;  // the whole warp leaves together
  const size_t base = static_cast<size_t>(row) * l;
  const int* rs = ids_s + base;
  const float* ds = d_s + base;
  const int* rt = ids_t + base;
  const float* dt = d_t + base;
  float best = INFINITY;
  for (int j = lane; j < l; j += 32) {
    const int id = rs[j];
    if (id >= n_sentinel) continue;  // padding never matches
    int lo = 0, hi = l;              // lower_bound of id in rt[0, l)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (rt[mid] < id) lo = mid + 1; else hi = mid;
    }
    if (lo < l && rt[lo] == id) best = fminf(best, ds[j] + dt[lo]);
  }
  for (int off = 16; off > 0; off >>= 1)
    best = fminf(best, __shfl_xor_sync(0xffffffffu, best, off));
  if (lane == 0) mu[row] = best;
}

}  // namespace

extern "C" int islabel_label_intersect(const int* ids_s, const float* d_s,
                                       const int* ids_t, const float* d_t,
                                       float* mu, int q, int l,
                                       int n_sentinel, cudaStream_t stream) {
  if (q == 0) return 0;
  const int blocks = (q + kWarps - 1) / kWarps;
  label_intersect_warp<<<blocks, kThreads, 0, stream>>>(
      ids_s, d_s, ids_t, d_t, mu, q, l, n_sentinel);
  return static_cast<int>(cudaGetLastError());
}
