// Tropical (min-plus) product C[i, j] = min_k A[i, k] + B[k, j]: one
// synchronous relaxation round of the dense-core route (stacked s/t
// frontiers times the 0-diagonal dense core adjacency).
//
// Replaces the Pallas kernel repro/kernels/minplus_matmul/kernel.py:
// minplus_matmul_kernel (_minplus_kernel). Tensor cores only multiply
// and add, so min-plus runs on the CUDA cores, tiled like an SGEMM:
// a block owns a 64 x 64 tile of C, stages 64 x 16 slices of A and
// 16 x 64 slices of B in shared memory, and each of its 256 threads
// keeps a 4 x 4 register tile of running minima. Out-of-range elements
// load as +inf, the min-plus zero, so ragged edges need no padding.
//
// Bound on Hopper: operations. Each (i, j, k) is one add and one min on
// the fp32 pipes (2 M N K operations against 67 TFLOP/s); the tiles
// reuse each loaded element 64 times, far above the byte bound.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

__global__ void minplus_tiles(const float* __restrict__ a,
                              const float* __restrict__ b,
                              float* __restrict__ c, int m, int n, int k) {
  __shared__ float as[kBK][kBM];  // A slice, k-major
  __shared__ float bs[kBK][kBN];
  const int tx = threadIdx.x % (kBN / kTN);
  const int ty = threadIdx.x / (kBN / kTN);
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = INFINITY;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK;
      const int gr = row0 + r, gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k) ? a[static_cast<size_t>(gr) * k + gk]
                                     : INFINITY;
    }
    for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
      const int kk = e / kBN, cc = e % kBN;
      const int gk = k0 + kk, gc = col0 + cc;
      bs[kk][cc] = (gk < k && gc < n) ? b[static_cast<size_t>(gk) * n + gc]
                                      : INFINITY;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = as[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = bs[kk][tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          acc[i][j] = fminf(acc[i][j], av[i] + bv[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gr = row0 + ty * kTM + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gc = col0 + tx * kTN + j;
      if (gc < n) c[static_cast<size_t>(gr) * n + gc] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int islabel_minplus_matmul(const float* a, const float* b,
                                      float* c, int m, int n, int k,
                                      cudaStream_t stream) {
  if (m == 0 || n == 0) return 0;
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  minplus_tiles<<<grid, kThreads, 0, stream>>>(a, b, c, m, n, k);
  return static_cast<int>(cudaGetLastError());
}
