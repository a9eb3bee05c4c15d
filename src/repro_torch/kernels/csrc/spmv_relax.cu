// Stage 2 of a query on large cores: one synchronous (Jacobi) min-plus
// relaxation round of the stacked s/t frontiers over the core graph,
//   out[v, r] = min(dist[v, r], min over in-edges (u -> v, w) whose
//                   source u changed last round: dist[u, r] + w),
// with the frontier vertex-major ([Vp, R], R = both frontiers' rows).
//
// spmv_relax replaces repro/kernels/spmv_relax/kernel.py:
// spmv_relax_kernel (_relax_kernel), one round per launch.
//
// Bound on Hopper: bytes. A round must read the frontier values that
// changed last round, write those that improve, and read each in-edge
// whose source changed once (portbench/work.py); the gathers
// dist[u, :] come on top. The design makes each gather one wide
// coalesced load and skips what cannot change the result:
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
//  - Changed sectors only: changed_in[tile, u] is a 16-bit mask, bit j
//    set if some row of sector j (rows 8j..8j+7 of the tile, one
//    32-byte sector of u's tile row) improved at u last round. A Jacobi
//    round gathering from rows of a source that did not change cannot
//    lower any destination below what that source already gave it, so
//    a warp walks only the in-edges whose source has a bit set, and a
//    lane loads its 16 bytes only where its sector's bit is set (lanes
//    2j and 2j+1 share sector j): the result is bitwise the same, and
//    the sectors not loaded send no request to L2 or HBM.
//  - Moved sectors only: out is the buffer of two rounds back, so where
//    v's changed_in bit is 0 it already holds cur's values. A lane loads
//    cur[v] only where a gather reached it (some acc finite) or its bit
//    is set, and stores only where a row improved or its bit is set. A
//    call's first round (full = 1) loads and stores everything, since
//    its out holds nothing yet. So out equals the plain version's out
//    when full is 1, or when out held dist at every sector whose
//    changed_in bit is 0. changed_out is written for every (tile,
//    vertex): a ballot of "improved", folded to 16 bits; the kernel ORs
//    "some entry improved" into flag_out.
//  - Counts: with a counts buffer (program spans on), the warp that
//    finishes a (tile, vertex) adds whether its changed_in word is set
//    and the word's set bits to two warp totals, added to counts[0] and
//    counts[1] once a warp at the end: no launch of its own. Without
//    one (nullptr) nothing is counted.
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
constexpr int kSector = 8;      // rows a mask bit (32 bytes, two lanes)
static_assert(kTile / kSector == 16, "a (tile, vertex) mask is 16 bits");
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

// Whether the lane's sector (lane / 2) is set in the 16-bit mask m
__device__ __forceinline__ bool sector_set(unsigned m, int lane) {
  return (m >> (lane >> 1)) & 1u;
}

// A warp's ballot folded to a sector mask: bit j = lane 2j or 2j + 1
__device__ __forceinline__ uint16_t fold_sectors(unsigned b) {
  b = (b | (b >> 1)) & 0x55555555u;
  b = (b | (b >> 1)) & 0x33333333u;
  b = (b | (b >> 2)) & 0x0f0f0f0fu;
  b = (b | (b >> 4)) & 0x00ff00ffu;
  b = (b | (b >> 8)) & 0x0000ffffu;
  return static_cast<uint16_t>(b);
}

// Min of dist[u, col..col+kV) + w over the in-edges lo, lo + stride, ...
// (in batches of 32, one edge a lane) whose source changed in this
// lane's sector of the tile. lo and hi are warp-uniform; lanes past the
// last row (!valid) load nothing.
__device__ __forceinline__ void gather_changed(
    const float* __restrict__ cur, const int* __restrict__ src,
    const float* __restrict__ w, const uint16_t* __restrict__ changed_tile,
    int lo, int hi, int stride, size_t rows, int col, bool valid, int lane,
    float (&acc)[kV]) {
  for (int base = lo; base < hi; base += stride) {
    const int e = base + lane;
    int u = 0;
    float wu = INFINITY;
    unsigned m = 0;
    if (e < hi) {
      u = __ldg(src + e);
      wu = __ldg(w + e);
      m = __ldg(changed_tile + u);
    }
    unsigned bits = __ballot_sync(kFull, m != 0);
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
        const unsigned mj = __shfl_sync(kFull, m, j);
        wk[k] = have ? wj : INFINITY;
        if (have && valid && sector_set(mj, lane)) {
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

// out[v, col..) = min(cur, acc) where the lane's sector can differ
// from out (full, changed_in bit set, or some row improved);
// changed_out[tile, v] = the sectors that improved; with count, lane 0
// adds changed_in[tile, v]'s "any set" and set bits to n_live, n_bits.
// Returns whether any lane improved. v is warp-uniform and < vp.
__device__ __forceinline__ bool finish_vertex(
    const float* __restrict__ cur, float* __restrict__ out,
    const uint16_t* __restrict__ changed_in_tile,
    uint16_t* __restrict__ changed_out_tile, int v, size_t rows, int col,
    bool valid, bool full, bool count, int lane, const float (&acc)[kV],
    unsigned& n_live, unsigned& n_bits) {
  const unsigned m = (count || !full) ? __ldg(changed_in_tile + v) : 0u;
  if (count && lane == 0) {
    n_live += m != 0;
    n_bits += __popc(m);
  }
  const bool moved = full || sector_set(m, lane);
  bool reached = false;
#pragma unroll
  for (int i = 0; i < kV; ++i) reached |= acc[i] < INFINITY;
  bool imp = false;
  if (valid && (moved || reached)) {
    float old[kV], nw[kV];
    load_rows(cur + static_cast<size_t>(v) * rows + col, old);
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      nw[i] = fminf(old[i], acc[i]);
      imp |= nw[i] < old[i];
    }
    if (moved || imp) store_rows(out + static_cast<size_t>(v) * rows + col, nw);
  }
  const unsigned b = __ballot_sync(kFull, imp);
  if (lane == 0) changed_out_tile[v] = fold_sectors(b);
  return b != 0;
}

__global__ void __launch_bounds__(kThreads)
    spmv_relax_csr(const float* __restrict__ cur,
                   const int* __restrict__ indptr,
                   const int* __restrict__ src, const float* __restrict__ w,
                   const int* __restrict__ order, int n_heavy,
                   const uint16_t* __restrict__ changed_in,
                   const int* __restrict__ flag_in, float* __restrict__ out,
                   uint16_t* __restrict__ changed_out,
                   int* __restrict__ flag_out,
                   unsigned long long* __restrict__ counts, int full,
                   int rows, int vp, int n_items, long long total) {
  if (*flag_in == 0) return;  // the previous round improved nothing
  const bool count = counts != nullptr;
  unsigned n_live = 0, n_bits = 0;  // lane 0's counts (count only)
  __shared__ float red[kWarps][kTile];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int any = 0;
  for (long long it = blockIdx.x; it < total; it += gridDim.x) {
    const int tile = static_cast<int>(it / n_items);
    const int item = static_cast<int>(it % n_items);
    const int col = (tile * 32 + lane) * kV;
    const bool valid = col < rows;
    const uint16_t* chg_in = changed_in + static_cast<size_t>(tile) * vp;
    uint16_t* chg_out = changed_out + static_cast<size_t>(tile) * vp;
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
        any |= finish_vertex(cur, out, chg_in, chg_out, v, rows, col, valid,
                             full, count, lane, acc, n_live, n_bits);
      }
      __syncthreads();  // red is free for the next item
    } else {  // kWarps light vertices, one a warp
      const int slot = n_heavy + (item - n_heavy) * kWarps + warp;
      if (slot < vp) {
        const int v = order[slot];
        gather_changed(cur, src, w, chg_in, indptr[v], indptr[v + 1], 32,
                       rows, col, valid, lane, acc);
        any |= finish_vertex(cur, out, chg_in, chg_out, v, rows, col, valid,
                             full, count, lane, acc, n_live, n_bits);
      }
    }
  }
  if (count && lane == 0 && n_live != 0) {
    atomicAdd(counts, static_cast<unsigned long long>(n_live));
    atomicAdd(counts + 1, static_cast<unsigned long long>(n_bits));
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) atomicOr(flag_out, 1);
}

}  // namespace

// order lists every destination, the n_heavy hubs first (the wrapper
// picks them); rows % 8 == 0 (the wrapper checks), so a sector is all
// rows or none; flag_out must hold 0 or 1 before the launch (the kernel
// only sets it); counts is nullptr or two uint64 the launch adds its
// counts to (a quiet launch adds nothing); full = 1 when out holds
// nothing to keep (a call's first round), else out must hold the round
// before's input.
extern "C" int islabel_spmv_relax(const float* cur, const int* indptr,
                                  const int* src, const float* w,
                                  const int* order, int n_heavy,
                                  const uint16_t* changed_in,
                                  const int* flag_in, float* out,
                                  uint16_t* changed_out, int* flag_out,
                                  unsigned long long* counts, int full,
                                  int rows, int vp,
                                  cudaStream_t stream) {
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
      changed_out, flag_out, counts, full != 0, rows, vp, n_items, total);
  return static_cast<int>(cudaGetLastError());
}
