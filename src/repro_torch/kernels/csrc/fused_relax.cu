// Stage 2 of a query on small cores: all synchronous (Jacobi) min-plus
// relaxation rounds of the stacked s/t frontiers over the core graph in
// ELL layout, in one launch,
//   out[r, v] = min(dist[r, v], min_j dist[r, nbr[v, j]] + w[v, j]).
//
// fused_relax replaces repro/kernels/spmv_relax/kernel.py:
// fused_relax_kernel (_fused_kernel): one block per bq = 8 stacked rows,
// each block running to its own fixed point or max_rounds, with the
// block's round count as a second output.
//
// Bound on Hopper: bytes, mostly random 4-byte gathers of dist[r, id]
// through L2. Each thread takes one vertex v for the block's 8 rows:
// the ELL slots of v are loaded once and serve the 8 gathers; slots
// with w = +inf (the ELL padding) add nothing to a min and are skipped
// before their gather. The block ping-pongs between the output and a
// scratch buffer in global memory (Jacobi semantics) and ORs the
// per-thread "improved" flags with __syncthreads_or between rounds;
// keeping the block's rows in shared memory is later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 8;  // rows per fused block
constexpr int kThreads = 256;

// candidate mins of the kRows rows at vertex col, reading the [kRows, v]
// block src. src is not marked __restrict__: the kernel reads it while
// other threads of the block write the other buffer of the pair.
__device__ __forceinline__ void gather_min(const float* src, int v, int col,
                                           const int* __restrict__ nbr,
                                           const float* __restrict__ w,
                                           int d, float (&cand)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) cand[r] = INFINITY;
  const int* ni = nbr + static_cast<size_t>(col) * d;
  const float* wi = w + static_cast<size_t>(col) * d;
  for (int j = 0; j < d; ++j) {
    const float wj = wi[j];
    if (wj == INFINITY) continue;  // padding slot: dist + inf never wins
    const int id = ni[j];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      cand[r] = fminf(cand[r], src[static_cast<size_t>(r) * v + id] + wj);
  }
}

__global__ void fused_relax_block(const float* __restrict__ dist,
                                  const int* __restrict__ nbr,
                                  const float* __restrict__ w, float* out,
                                  float* scratch, int* __restrict__ rounds,
                                  int v, int d, int max_rounds) {
  const size_t off = static_cast<size_t>(blockIdx.x) * kRows * v;
  float* cur = out + off;
  float* nxt = scratch + off;
  for (int col = threadIdx.x; col < v; col += blockDim.x)
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      cur[static_cast<size_t>(r) * v + col] =
          dist[off + static_cast<size_t>(r) * v + col];
  __syncthreads();
  int it = 0;
  int improved = 1;
  while (improved && it < max_rounds) {
    int mine = 0;
    for (int col = threadIdx.x; col < v; col += blockDim.x) {
      float cand[kRows];
      gather_min(cur, v, col, nbr, w, d, cand);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const size_t o = static_cast<size_t>(r) * v + col;
        const float old = cur[o];
        const float nw = fminf(old, cand[r]);
        nxt[o] = nw;
        mine |= nw < old;
      }
    }
    // barrier + block-wide OR: every write of this round is visible
    // before the next round reads
    improved = __syncthreads_or(mine);
    float* t = cur;
    cur = nxt;
    nxt = t;
    ++it;
  }
  if (cur != out + off) {  // odd round count: the result sits in scratch
    for (int col = threadIdx.x; col < v; col += blockDim.x)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        out[off + static_cast<size_t>(r) * v + col] =
            cur[static_cast<size_t>(r) * v + col];
  }
  if (threadIdx.x == 0) rounds[blockIdx.x] = it;
}

}  // namespace

// q must be a multiple of 8 (the wrapper checks); one block per 8 rows.
extern "C" int islabel_fused_relax(const float* dist, const int* nbr,
                                   const float* w, float* out, float* scratch,
                                   int* rounds, int q, int v, int d,
                                   int max_rounds, cudaStream_t stream) {
  if (q == 0) return 0;
  fused_relax_block<<<q / kRows, kThreads, 0, stream>>>(
      dist, nbr, w, out, scratch, rounds, v, d, max_rounds);
  return static_cast<int>(cudaGetLastError());
}
