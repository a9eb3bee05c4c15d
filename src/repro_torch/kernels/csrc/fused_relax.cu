// Stage 2 of a query on small cores: all synchronous (Jacobi) min-plus
// relaxation rounds of the stacked s/t frontiers over the core graph, in
// one launch,
//   out[r, v] = min(dist[r, v], min over in-edges (u -> v, w): dist[r, u] + w).
//
// fused_relax replaces repro/kernels/spmv_relax/kernel.py:
// fused_relax_kernel (_fused_kernel): one block per bq = 8 stacked rows,
// each block running to its own fixed point or max_rounds, with the
// block's round count as a second output.
//
// Bound on Hopper: the gathers and the edge list. A round reads, for
// every real in-edge, the source's 8 values and adds and mins them in,
// and each block walks the edge list every round. The design:
//  - Vertex-major rows: the block's [8, V] rows are transposed on load
//    into [V][8] (32 bytes a vertex), so a gather is two float4 loads.
//  - Rows in shared memory where they fit (the "shared" variant): the
//    block's rounds touch device memory only for the edge list, between
//    the first load and the last store. Cores too large for that (the
//    "global" variant) keep the same layout in a per-block slice of
//    device scratch, which stays in L2 while the block runs.
//  - Real in-edges, sliced: destinations in order of in-degree, 32 to a
//    slice (one warp), and a slice's in-edges stored slot-interleaved
//    (edge j of lane i at slice_ptr[s] + 32 j + i, padded to the slice's
//    largest in-degree with w = +inf). A warp's edge loads are one
//    128-byte line, and lanes of similar in-degree waste few slots. A
//    CSR walked one destination a lane made each load touch 32 lines,
//    and that, not the gathers, set the first version's time (PERF.md).
//  - Changed sources only: a per-vertex flag says whether any of the
//    block's rows improved at the vertex last round (first round: any
//    row finite). A source that did not change cannot lower a
//    destination below what it gave it last round, so its gather is
//    skipped and the round stays bitwise the same.
//  - Latency: the loads of a lane's edge list form a chain (edge, flag,
//    gather), so the kernel hides latency by width: 1024 threads a
//    block, two groups of 2 edges in flight a lane, and warps that take
//    the slices in snake order so the deepest slices (the highest
//    in-degrees) spread over the warps; the warp with the deepest slices
//    sets a round's time.
//  - Jacobi rounds with one barrier-or a round: the next rows and flags
//    go to second buffers, and the pairs swap each round. (One buffer
//    with the next rows held in registers needs half the shared memory,
//    so two blocks fit on an SM, but ran slower on the card: PERF.md.)
// A destination's new value is min(old, every in-edge's candidate): min
// is exact and order-free, so the result and each block's round count
// are bitwise those of the plain version.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 8;     // rows per fused block
constexpr int kUnroll = 2;   // in-edges a lane loads at once (x2 in flight)

// A vertex's 8 row values.
struct Rows8 {
  float4 lo, hi;
};

__device__ __forceinline__ void min_in(Rows8& acc, const Rows8& x, float w) {
  acc.lo.x = fminf(acc.lo.x, x.lo.x + w);
  acc.lo.y = fminf(acc.lo.y, x.lo.y + w);
  acc.lo.z = fminf(acc.lo.z, x.lo.z + w);
  acc.lo.w = fminf(acc.lo.w, x.lo.w + w);
  acc.hi.x = fminf(acc.hi.x, x.hi.x + w);
  acc.hi.y = fminf(acc.hi.y, x.hi.y + w);
  acc.hi.z = fminf(acc.hi.z, x.hi.z + w);
  acc.hi.w = fminf(acc.hi.w, x.hi.w + w);
}

__device__ __forceinline__ bool lower(const Rows8& a, const Rows8& b) {
  return a.lo.x < b.lo.x || a.lo.y < b.lo.y || a.lo.z < b.lo.z ||
         a.lo.w < b.lo.w || a.hi.x < b.hi.x || a.hi.y < b.hi.y ||
         a.hi.z < b.hi.z || a.hi.w < b.hi.w;
}

// Slot k's destination (lane k % 32 of slice k / 32): min(old, the
// candidate of each in-edge whose source changed last round). cur and chg
// are the block's rows and flags (shared or global; read after a
// barrier, so plain loads). The next group of kUnroll edges is loaded
// before this group's gathers, so two groups of loads are in flight.
__device__ __forceinline__ Rows8 relax_slot(const Rows8* cur,
                                            const unsigned char* chg,
                                            const Rows8& old, int k,
                                            const int* __restrict__ slice_ptr,
                                            const int* __restrict__ src,
                                            const float* __restrict__ w) {
  constexpr int U = kUnroll;
  Rows8 acc = old;
  const int s = k / 32;
  const int hi = __ldg(slice_ptr + s + 1);
  int e = __ldg(slice_ptr + s) + k % 32;
  int un[U];
  float wn[U];
  auto fetch = [&](int at) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      un[i] = __ldg(src + at + 32 * i);
      wn[i] = __ldg(w + at + 32 * i);
    }
  };
  if (e + 32 * (U - 1) < hi) fetch(e);
  while (e + 32 * (U - 1) < hi) {  // warp-uniform: a slice is one depth
    int u[U];
    float wu[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      u[i] = un[i];
      wu[i] = wn[i];
    }
    e += 32 * U;
    if (e + 32 * (U - 1) < hi) fetch(e);
    bool live[U];
#pragma unroll
    for (int i = 0; i < U; ++i)  // +inf: a padding slot
      live[i] = wu[i] != INFINITY && chg[u[i]] != 0;
    Rows8 g[U];
#pragma unroll
    for (int i = 0; i < U; ++i)
      if (live[i]) g[i] = cur[u[i]];
#pragma unroll
    for (int i = 0; i < U; ++i)
      if (live[i]) min_in(acc, g[i], wu[i]);
  }
  for (; e < hi; e += 32) {
    const int u = __ldg(src + e);
    const float wu = __ldg(w + e);
    if (wu != INFINITY && chg[u] != 0) min_in(acc, cur[u], wu);
  }
  return acc;
}

// The slot lane `lane` of warp `warp` relaxes in its i-th pass: warps
// take slices in snake order (w, then 2W - 1 - w, ...), so the deep
// slices of the high in-degree destinations spread over the warps; the
// deepest slice a warp walks sets the round's time.
__device__ __forceinline__ int snake_slot(int i, int warp, int lane,
                                          int n_warps) {
  return (i * n_warps + ((i & 1) ? n_warps - 1 - warp : warp)) * 32 + lane;
}

// [8, V] rows of the block (row-major, device memory) -> [V] Rows8, and
// the first round's flags: whether any row is finite at the vertex.
__device__ __forceinline__ void load_block(const float* __restrict__ blk,
                                           Rows8* buf, unsigned char* chg,
                                           int v) {
  for (int j = threadIdx.x; j < v; j += blockDim.x) {
    float x[kRows];
    bool finite = false;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      x[r] = blk[static_cast<size_t>(r) * v + j];
      finite |= x[r] != INFINITY;
    }
    buf[j] = Rows8{make_float4(x[0], x[1], x[2], x[3]),
                   make_float4(x[4], x[5], x[6], x[7])};
    chg[j] = finite;
  }
}

__device__ __forceinline__ void store_block(const Rows8* buf,
                                            float* __restrict__ blk, int v) {
  for (int j = threadIdx.x; j < v; j += blockDim.x) {
    const Rows8 y = buf[j];
    const float x[kRows] = {y.lo.x, y.lo.y, y.lo.z, y.lo.w,
                            y.hi.x, y.hi.y, y.hi.z, y.hi.w};
#pragma unroll
    for (int r = 0; r < kRows; ++r) blk[static_cast<size_t>(r) * v + j] = x[r];
  }
}

// All rounds of one block: two buffers of rows and of flags, in shared
// memory (kShared) or in the block's slices of device scratch (rows
// [blocks][2][V], flags [blocks][2][V]).
template <int kThreads, bool kShared>
__global__ void __launch_bounds__(kThreads)
    fused_rounds(const float* __restrict__ dist,
                      const int* __restrict__ order,
                      const int* __restrict__ slice_ptr,
                      const int* __restrict__ src,
                      const float* __restrict__ w, float* __restrict__ out,
                      Rows8* scratch, unsigned char* scratch_chg,
                      int* __restrict__ rounds, int v, int max_rounds) {
  extern __shared__ float4 smem4[];
  constexpr int kWarps = kThreads / 32;
  const size_t blk = blockIdx.x;
  Rows8* rows = kShared ? reinterpret_cast<Rows8*>(smem4)
                        : scratch + blk * 2 * v;
  unsigned char* chg =
      kShared ? reinterpret_cast<unsigned char*>(smem4 + 4 * v)
              : scratch_chg + blk * 2 * v;
  const size_t off = blk * kRows * v;
  load_block(dist + off, rows, chg, v);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int passes = (v + kThreads - 1) / kThreads;
  int it = 0, cur = 0;
  int improved = 1;
  while (improved && it < max_rounds) {
    const Rows8* c = rows + cur * v;
    const unsigned char* cc = chg + cur * v;
    Rows8* nx = rows + (cur ^ 1) * v;
    unsigned char* nc = chg + (cur ^ 1) * v;
    int mine = 0;
    for (int i = 0; i < passes; ++i) {
      const int k = snake_slot(i, warp, lane, kWarps);
      if (k >= v) continue;
      const int x = __ldg(order + k);
      const Rows8 old = c[x];
      const Rows8 nw = relax_slot(c, cc, old, k, slice_ptr, src, w);
      const bool imp = lower(nw, old);
      nx[x] = nw;
      nc[x] = imp;
      mine |= imp;
    }
    // barrier + block-wide OR: every write of this round is visible
    // before the next round reads
    improved = __syncthreads_or(mine);
    cur ^= 1;
    ++it;
  }
  store_block(rows + cur * v, out + off, v);
  if (threadIdx.x == 0) rounds[blockIdx.x] = it;
}

// Opt a kernel in to `bytes` of dynamic shared memory (above 48 KB it
// must be asked for); each instantiation remembers what it was granted.
template <auto kKernel>
int set_smem(size_t bytes) {
  static size_t granted = 48 * 1024;
  if (bytes <= granted) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) granted = bytes;
  return static_cast<int>(err);
}

constexpr int kThreads = 1024;

}  // namespace

// One block per 8 rows (q % 8 == 0, the wrapper checks); the in-edges
// in slices of 32 destinations (order: slot -> destination, slice_ptr:
// [ceil(v / 32) + 1] slot offsets, src / w: slots). variant:
//   0 "shared": both buffers in shared memory, v * 66 bytes;
//   1 "global": both buffers in scratch (rows [q / 8, 2, v, 8] floats,
//     flags [q / 8, 2, v] bytes).
// The wrapper picks the variant by v; a variant that does not fit is
// refused here (an error code), never launched short.
extern "C" int islabel_fused_relax(const float* dist, const int* order,
                                   const int* slice_ptr, const int* src,
                                   const float* w, float* out,
                                   float* scratch, unsigned char* scratch_chg,
                                   int* rounds, int q, int v, int max_rounds,
                                   int variant, cudaStream_t stream) {
  if (q == 0) return 0;
  const int blocks = q / kRows;
  const size_t vertex_bytes = sizeof(Rows8) + 1;  // rows and flag
  int err = 0;
  switch (variant) {
    case 0: {
      constexpr auto kern = fused_rounds<kThreads, true>;
      const size_t bytes = 2 * v * vertex_bytes;
      err = set_smem<kern>(bytes);
      if (err) return err;
      kern<<<blocks, kThreads, bytes, stream>>>(
          dist, order, slice_ptr, src, w, out, nullptr, nullptr, rounds, v,
          max_rounds);
      break;
    }
    case 1: {
      fused_rounds<kThreads, false>
          <<<blocks, kThreads, 0, stream>>>(
              dist, order, slice_ptr, src, w, out,
              reinterpret_cast<Rows8*>(scratch), scratch_chg, rounds, v,
              max_rounds);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
