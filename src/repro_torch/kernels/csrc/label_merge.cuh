// The merge core of both label-intersect kernels (stage 1 of every
// query, paper Equation 1): mu[q] = min over ancestor ids shared by the
// label rows of s[q] and t[q] of d_s + d_t, +inf when none.
// label_intersect.cu instantiates it for int32 id rows (codec "none"),
// label_intersect_packed.cu for delta16 rows; the row decoder is the
// only part that differs.
//
// One warp takes one query and reads each row in place from its label
// planes: the row of side s is planes_s[idx_s[q]] (idx_s a vector of
// endpoint ids), or planes_s[q] when idx_s is null (rows gathered
// before the call). Row offsets are size_t. A row id maps as the JAX
// package gathers rows (plane_row): a negative id counts from the end,
// then the id is clamped into the planes, so any id reads a real row.
//
//   - a row is read 32 slots at a time, one coalesced load a chunk; the
//     decoder turns it into 32 sorted ids, pads (ids >= n_sentinel) at
//     the end, and a mask of the real lanes (a prefix);
//   - each real s id finds its lower bound in the t chunk by a 5-step
//     binary search over lanes (__shfl_sync with a per-lane source). A
//     match counts only where it is the first of its id in the t row
//     (at lane 0 the previous t chunk's last id must be smaller): the
//     slot the searchsorted reference finds, duplicates included;
//   - the t chunk advances while its largest id is below the largest
//     real id of the s chunk, otherwise the s chunk advances, so every
//     s id meets the t chunk that holds its first match. The loop ends
//     at the first chunk of either row that starts with a pad: no later
//     slot can match, so the hit set, and mu, are the full rows'.
//
// Bound on Hopper: at the serving batches (Q <= 1024) the latency of
// dependent loads, not bytes: endpoint id -> first chunk (and base) ->
// distances of the hits. The design keeps that chain short:
//   - both rows' first chunks (and bases) are issued before any
//     dependent work;
//   - a chunk with no pad prefetches the next chunk of its row while
//     the current chunks are searched; a chunk with a pad is the row's
//     last, and nothing after it is read;
//   - distances are read only at hits, as raw plane values, and folded
//     into the minimum one step later, so their latency overlaps the
//     next step instead of adding to it;
//   - the final minimum is one __reduce_min_sync on order-preserving
//     int keys, not five dependent shuffles;
//   - 4 queries a block of 128 threads: Q = 1024 gives 256 blocks on
//     132 SMs. No shared memory, so any L.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace islabel {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMergeWarps = 4;                  // queries a block
constexpr int kMergeThreads = 32 * kMergeWarps;

// A distance as its plane stores it -> fp32: int32 planes hold -1 for
// +inf and exact integers below 2**24; float32 planes hold the value.
__device__ __forceinline__ float dist_value(int v) {
  return v < 0 ? INFINITY : static_cast<float>(v);
}
__device__ __forceinline__ float dist_value(float v) { return v; }
template <typename D> __device__ __forceinline__ D dist_pad();
template <> __device__ __forceinline__ int dist_pad<int>() { return -1; }
template <> __device__ __forceinline__ float dist_pad<float>() {
  return INFINITY;
}

// The state a decoder keeps for one row: ``id`` is this lane's id of
// the current chunk (pads >= n_sentinel), ``real`` the lanes whose slot
// is real, ``start`` the chunk's first slot, ``prev_last`` the last id
// of the chunk before it, ``done`` whether the chunk holds a pad (then
// it is the row's last), ``next`` the raw slot of the next chunk.
struct RowState {
  int start = 0;
  int prev_last = INT_MIN;
  int id = INT_MAX;
  int next = 0;
  unsigned real = 0u;
  bool done = false;
};

// Codec "none": int32 ids, pad = n_sentinel.
struct IdRow : RowState {
  struct Plane {
    const int* ids;
  };
  const int* ids = nullptr;
  int l = 0;
  int n_sentinel = 0;

  __device__ __forceinline__ int fetch(int j) const {
    return j < l ? ids[j] : n_sentinel;
  }
  // issue the row's first chunk
  __device__ __forceinline__ void open(Plane p, size_t off, int, int l_,
                                       int n_sentinel_, int lane) {
    ids = p.ids + off;
    l = l_;
    n_sentinel = n_sentinel_;
    next = fetch(lane);
  }
  // make ``next`` the current chunk; prefetch the one after it
  __device__ __forceinline__ void decode(int lane) {
    id = next;
    real = __ballot_sync(kFull, id < n_sentinel);
    done = real != kFull;
    if (!done) next = fetch(start + 32 + lane);
  }
};

// Codec "delta16": int16 forward deltas onto an int32 base, -1 marks the
// first pad slot (every slot from the first negative delta on is a pad,
// as in decode_ids). A chunk decodes with a ballot of its pad flags and
// a warp inclusive scan of the deltas (__shfl_up_sync) plus the carry of
// the chunks before it; pads decode to INT_MAX, so a chunk stays sorted.
struct DeltaRow : RowState {
  struct Plane {
    const short* delta;
    const int* base;
  };
  const short* delta = nullptr;
  int l = 0;
  int base = 0;
  unsigned carry = 0u;

  __device__ __forceinline__ int fetch(int j) const {
    return j < l ? static_cast<int>(delta[j]) : -1;
  }
  __device__ __forceinline__ void open(Plane p, size_t off, int row, int l_,
                                       int, int lane) {
    delta = p.delta + off;
    l = l_;
    base = p.base[row];
    next = fetch(lane);
  }
  __device__ __forceinline__ void decode(int lane) {
    const unsigned pads = __ballot_sync(kFull, next < 0);
    // a pad at this lane or at any lane below it
    const bool padded = (pads & (kFull >> (31 - lane))) != 0u;
    unsigned sum = padded ? 0u : static_cast<unsigned>(next);
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned v = __shfl_up_sync(kFull, sum, off);
      if (lane >= off) sum += v;
    }
    id = padded ? INT_MAX
                : static_cast<int>(static_cast<unsigned>(base) + carry + sum);
    carry += __shfl_sync(kFull, sum, 31);
    real = pads ? (1u << (__ffs(pads) - 1)) - 1u : kFull;
    done = pads != 0u;
    if (!done) next = fetch(start + 32 + lane);
  }
};

// Move a row to its next chunk; after a chunk with a pad every slot is a
// pad, and nothing is read.
template <class Row>
__device__ __forceinline__ void advance(Row& r, int lane) {
  r.prev_last = __shfl_sync(kFull, r.id, 31);
  r.start += 32;
  if (r.done) {
    r.id = INT_MAX;
    r.real = 0u;
    return;
  }
  r.decode(lane);
}

// jnp's gather rule for a row id of [rows, L] planes: id < 0 counts
// from the end, then the id is clamped to [0, rows - 1]
// (core/labels.py:row_index is the same rule in torch)
__device__ __forceinline__ int plane_row(int id, int rows) {
  if (id < 0) id += rows;
  return min(max(id, 0), rows - 1);
}

template <class Row, typename D>
__global__ void __launch_bounds__(kMergeThreads)
label_merge(typename Row::Plane plane_s, const D* __restrict__ d_s,
            const int* __restrict__ idx_s, int rows_s,
            typename Row::Plane plane_t, const D* __restrict__ d_t,
            const int* __restrict__ idx_t, int rows_t,
            float* __restrict__ mu, int q, int l, int n_sentinel) {
  const int query = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (query >= q) return;  // the whole warp leaves together
  const int row_s = idx_s ? plane_row(idx_s[query], rows_s) : query;
  const int row_t = idx_t ? plane_row(idx_t[query], rows_t) : query;
  const size_t off_s = static_cast<size_t>(row_s) * l;
  const size_t off_t = static_cast<size_t>(row_t) * l;
  Row s, t;
  s.open(plane_s, off_s, row_s, l, n_sentinel, lane);
  t.open(plane_t, off_t, row_t, l, n_sentinel, lane);
  s.decode(lane);
  t.decode(lane);
  d_s += off_s;
  d_t += off_t;
  float best = INFINITY;
  // the distances of the last step's hit, folded in one step later
  D hit_s = dist_pad<D>(), hit_t = dist_pad<D>();
  while (s.real != 0u && t.real != 0u) {
    // lower bound of this lane's s id among the t chunk's 32 sorted ids
    int pos = 0;
    for (int k = 16; k > 0; k >>= 1)
      if (__shfl_sync(kFull, t.id, pos + k - 1) < s.id) pos += k;
    const int cand = __shfl_sync(kFull, t.id, pos);
    const bool hit = ((s.real >> lane) & 1u) && s.id < n_sentinel &&
                     cand == s.id && (pos > 0 || t.prev_last < s.id);
    best = fminf(best, dist_value(hit_s) + dist_value(hit_t));
    hit_s = dist_pad<D>();
    hit_t = dist_pad<D>();
    if (hit) {
      hit_s = d_s[s.start + lane];
      hit_t = d_t[t.start + pos];
    }
    const int s_max = __shfl_sync(kFull, s.id, 31 - __clz(s.real));
    const int t_max = __shfl_sync(kFull, t.id, 31);
    if (t_max < s_max) {
      advance(t, lane);
    } else {
      advance(s, lane);
    }
  }
  best = fminf(best, dist_value(hit_s) + dist_value(hit_t));
  // the warp's minimum in one redux: a float's bits, with the magnitude
  // bits of negative values flipped, order as int32 as the floats do
  int key = __float_as_int(best);
  key ^= (key >> 31) & 0x7fffffff;
  key = __reduce_min_sync(kFull, key);
  key ^= (key >> 31) & 0x7fffffff;
  if (lane == 0) mu[query] = __int_as_float(key);
}

inline int merge_blocks(int q) { return (q + kMergeWarps - 1) / kMergeWarps; }

}  // namespace islabel
