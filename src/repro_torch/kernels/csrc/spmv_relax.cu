// Stage 2 of a query on large cores: one synchronous (Jacobi) min-plus
// relaxation round of the stacked s/t frontiers over the core graph,
//   out[v, r] = min(dist[v, r], min over in-edges (u -> v, w) whose
//                   source u changed last round: dist[u, r] + w),
// with the frontier vertex-major ([Vp, R], R = both frontiers' rows).
//
// spmv_relax replaces repro/kernels/spmv_relax/kernel.py:
// spmv_relax_kernel (_relax_kernel), one round per launch.
//
// Bound on Hopper: bytes. A round must read and write the [Vp, R]
// frontier once (1.54 GB each way on the 10^6-vertex graph's core) and
// read each real in-edge once; the gathers dist[u, :] come on top. The
// design makes each gather one wide coalesced load and skips what
// cannot change the result:
//  - Vertex-major frontier: the R rows of a source u are one contiguous
//    segment, so a warp gathers a tile of u's rows with one coalesced
//    load (4 floats a lane) instead of one 32-byte sector a row.
//  - Row tiles: work items walk the grid tile-major, so the blocks in
//    flight share one [Vp, 128] slice of the frontier. A tile is 128
//    rows, 4 a lane, so a gather is 512 bytes. A sweep of 32, 64, 128
//    and 256 rows on the card picked 128 (PERF.md): a narrow tile keeps
//    its slice in L2 (24 MB at 32 rows on the 10^6 core) but walks the
//    in-edges once per tile and moves fewer bytes per gather.
//  - Real in-edges: a CSR by destination (indptr, src, w), not ELL
//    planes padded to the largest in-degree (99% padding on R-MAT
//    cores). A warp loads 32 edges at once, one per lane.
//  - Changed sources only: changed_in[tile, u] says whether u's rows of
//    the tile improved last round. A Jacobi round gathering from a
//    source that did not change cannot lower any destination below what
//    that source already gave it, so skipping those edges leaves the
//    result bitwise the same. The kernel writes changed_out for the
//    next round and ORs "some entry improved" into flag_out.
//  - Quiet rounds: a launch whose flag_in is 0 (the previous round
//    improved nothing) returns at once. Its input and output buffers
//    already hold equal values, so the loop may run past the fixed point
//    between host reads of the flag at the cost of a launch a round.
//  - Hubs: destinations come in order of in-degree, heaviest first.
//    A hub (one of the wrapper's n_heavy, more than 256 in-edges) takes
//    a whole block, whose 8 warps split its edge range and combine with a
//    min in shared memory; the rest take one warp each, 8 of similar
//    degree to a block.
//  - Persistent blocks: the grid is sized to fill the card once and
//    each block strides over the work items, so a quiet launch costs one
//    flag read per block.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kIlp = 4;  // gathers a warp keeps in flight
constexpr int kV = 4;    // consecutive rows a lane
constexpr int kTile = 32 * kV;  // rows a work item
constexpr unsigned kFull = 0xffffffffu;

// The kV consecutive floats at p (16-byte aligned) as one vector load
__device__ __forceinline__ void load_rows(const float* p, float (&x)[kV]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = t.x;
  x[1] = t.y;
  x[2] = t.z;
  x[3] = t.w;
}

__device__ __forceinline__ void store_rows(float* p, const float (&x)[kV]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// Min of dist[u, col..col+kV) + w over the in-edges lo, lo + stride, ...
// (in batches of 32, one edge a lane) whose source changed in this
// tile. lo and hi are warp-uniform; lanes past the last row (!valid)
// load nothing.
__device__ __forceinline__ void gather_changed(
    const float* __restrict__ cur, const int* __restrict__ src,
    const float* __restrict__ w, const uint8_t* __restrict__ changed_tile,
    int lo, int hi, int stride, size_t rows, int col, bool valid, int lane,
    float (&acc)[kV]) {
  for (int base = lo; base < hi; base += stride) {
    const int e = base + lane;
    int u = 0;
    float wu = INFINITY;
    bool live = false;
    if (e < hi) {
      u = __ldg(src + e);
      wu = __ldg(w + e);
      live = __ldg(changed_tile + u) != 0;
    }
    unsigned bits = __ballot_sync(kFull, live);
    while (bits) {  // warp-uniform
      float x[kIlp][kV];
      float wk[kIlp];
#pragma unroll
      for (int k = 0; k < kIlp; ++k) {
        const bool have = bits != 0;
        const int j = have ? __ffs(bits) - 1 : 0;
        bits &= bits - 1;
        const int uj = __shfl_sync(kFull, u, j);
        const float wj = __shfl_sync(kFull, wu, j);
        wk[k] = have ? wj : INFINITY;
        if (have && valid) {
          load_rows(cur + static_cast<size_t>(uj) * rows + col, x[k]);
        } else {
#pragma unroll
          for (int i = 0; i < kV; ++i) x[k][i] = INFINITY;
        }
      }
#pragma unroll
      for (int k = 0; k < kIlp; ++k)
#pragma unroll
        for (int i = 0; i < kV; ++i) acc[i] = fminf(acc[i], x[k][i] + wk[k]);
    }
  }
}

// out[v, col..) = min(cur, acc) from the lanes inside the rows,
// changed_out[tile, v] = any improved; returns whether any lane
// improved. v is warp-uniform and < vp.
__device__ __forceinline__ bool finish_vertex(
    const float* __restrict__ cur, float* __restrict__ out,
    uint8_t* __restrict__ changed_out_tile, int v, size_t rows, int col,
    bool valid, int lane, const float (&acc)[kV]) {
  bool imp = false;
  if (valid) {
    float old[kV], nw[kV];
    load_rows(cur + static_cast<size_t>(v) * rows + col, old);
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      nw[i] = fminf(old[i], acc[i]);
      imp |= nw[i] < old[i];
    }
    store_rows(out + static_cast<size_t>(v) * rows + col, nw);
  }
  imp = __any_sync(kFull, imp);
  if (lane == 0) changed_out_tile[v] = imp;
  return imp;
}

__global__ void __launch_bounds__(kThreads)
    spmv_relax_csr(const float* __restrict__ cur,
                   const int* __restrict__ indptr,
                   const int* __restrict__ src, const float* __restrict__ w,
                   const int* __restrict__ order, int n_heavy,
                   const uint8_t* __restrict__ changed_in,
                   const int* __restrict__ flag_in, float* __restrict__ out,
                   uint8_t* __restrict__ changed_out,
                   int* __restrict__ flag_out, int rows, int vp,
                   int n_items, long long total) {
  if (*flag_in == 0) return;  // the previous round improved nothing
  __shared__ float red[kWarps][kTile];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int any = 0;
  for (long long it = blockIdx.x; it < total; it += gridDim.x) {
    const int tile = static_cast<int>(it / n_items);
    const int item = static_cast<int>(it % n_items);
    const int col = (tile * 32 + lane) * kV;
    const bool valid = col < rows;
    const uint8_t* chg_in = changed_in + static_cast<size_t>(tile) * vp;
    uint8_t* chg_out = changed_out + static_cast<size_t>(tile) * vp;
    float acc[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) acc[i] = INFINITY;
    if (item < n_heavy) {  // one hub, the whole block (block-uniform)
      const int v = order[item];
      gather_changed(cur, src, w, chg_in, indptr[v] + warp * 32,
                     indptr[v + 1], kWarps * 32, rows, col, valid, lane, acc);
#pragma unroll
      for (int i = 0; i < kV; ++i) red[warp][lane * kV + i] = acc[i];
      __syncthreads();
      if (warp == 0) {
        for (int k = 1; k < kWarps; ++k)
#pragma unroll
          for (int i = 0; i < kV; ++i)
            acc[i] = fminf(acc[i], red[k][lane * kV + i]);
        any |= finish_vertex(cur, out, chg_out, v, rows, col, valid, lane,
                             acc);
      }
      __syncthreads();  // red is free for the next item
    } else {  // kWarps light vertices, one a warp
      const int slot = n_heavy + (item - n_heavy) * kWarps + warp;
      if (slot < vp) {
        const int v = order[slot];
        gather_changed(cur, src, w, chg_in, indptr[v], indptr[v + 1], 32,
                       rows, col, valid, lane, acc);
        any |= finish_vertex(cur, out, chg_out, v, rows, col, valid, lane,
                             acc);
      }
    }
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) atomicOr(flag_out, 1);
}

}  // namespace

// order lists every destination, the n_heavy hubs first (the wrapper
// picks them); rows % 8 == 0 (the wrapper checks); flag_out must hold
// 0 or 1 before the launch (the kernel only sets it).
extern "C" int islabel_spmv_relax(const float* cur, const int* indptr,
                                  const int* src, const float* w,
                                  const int* order, int n_heavy,
                                  const uint8_t* changed_in,
                                  const int* flag_in, float* out,
                                  uint8_t* changed_out, int* flag_out,
                                  int rows, int vp, cudaStream_t stream) {
  if (rows == 0 || vp == 0) return 0;
  static int grid_cap = 0;  // resident blocks on the whole card
  if (grid_cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, spmv_relax_csr, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    grid_cap = sms * std::max(per_sm, 1);
  }
  const int n_tiles = (rows + kTile - 1) / kTile;
  const int n_items = n_heavy + (vp - n_heavy + kWarps - 1) / kWarps;
  const long long total = static_cast<long long>(n_tiles) * n_items;
  const int grid = static_cast<int>(std::min<long long>(total, grid_cap));
  spmv_relax_csr<<<grid, kThreads, 0, stream>>>(
      cur, indptr, src, w, order, n_heavy, changed_in, flag_in, out,
      changed_out, flag_out, rows, vp, n_items, total);
  return static_cast<int>(cudaGetLastError());
}
