// Stage 1 over compressed label rows (paper Equation 1 on the delta16
// codec): mu[q] = min over ancestor ids shared by the two rows of
// d_s + d_t, +inf when none, with the decode fused before the join.
//
// Replaces the Pallas kernel repro/kernels/label_intersect/kernel.py:
// label_intersect_packed_kernel (_intersect_packed_kernel). The TPU
// kernel decodes a whole [bq, L] tile with a cumsum and then runs the
// L^2 equality join of the fp32 kernel on the vector unit. Here one
// warp takes one query and merges the two rows 32 slots at a time:
//
//   - decode: a chunk of 32 int16 deltas is one coalesced 64-byte load.
//     Its pad flags are ORed forward with a ballot (every slot from the
//     first negative delta on is a pad, as in decode_ids), and the
//     remaining deltas are added up with a warp inclusive scan
//     (__shfl_up_sync) plus the carry of the earlier chunks. Pads
//     decode to INT_MAX inside the kernel, which sorts after every real
//     id, so each decoded chunk is sorted.
//   - join: each real s id searches the current t chunk with a
//     5-step binary search over lanes (__shfl_sync with a per-lane
//     source). A match counts only where it is the first of its id in
//     the t row (at lane 0, the previous chunk's last id must be
//     smaller), which is the slot the searchsorted reference finds,
//     duplicates included. On a hit the lane reads its two distances
//     (int32 -> fp32 exactly, -1 -> +inf, or fp32 as stored).
//   - merge: the t chunk advances while its largest id is below the
//     largest real id of the s chunk, otherwise the s chunk advances.
//     Every s id thus meets the t chunk that holds its first match.
//     The loop ends at the first chunk of either row that starts with a
//     pad: every later slot decodes to the sentinel and can never
//     match, so the hit set, and mu, are those of the full rows.
//
// Decoded planes never leave registers; no shared memory, so any L.
//
// Bound on Hopper: bytes. A row is read up to its first pad marker (2
// bytes a slot) plus the distances of its hits; rows that are mostly
// padding cost one or two chunk loads instead of L slots.
#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_d(const int* d, size_t i) {
  const int v = d[i];
  return v < 0 ? INFINITY : static_cast<float>(v);
}

__device__ __forceinline__ float load_d(const float* d, size_t i) {
  return d[i];
}

// One decoded chunk of a row. ``id`` is this lane's id (INT_MAX for a
// pad); ``real`` has a bit per lane whose slot is real (a prefix of the
// lanes); ``carry``, ``pad_seen`` and ``prev_last`` (the last id of the
// previous chunk) run across the chunks of the row.
struct Chunk {
  int start = 0;
  int prev_last = INT_MIN;
  int id = INT_MAX;
  unsigned real = 0u;
  unsigned carry = 0u;
  bool pad_seen = false;

  __device__ __forceinline__ void load(const short* __restrict__ delta,
                                       int base, int l, int lane) {
    const int j = start + lane;
    const int dlt = (!pad_seen && j < l) ? static_cast<int>(delta[j]) : -1;
    const unsigned pads = __ballot_sync(kFull, dlt < 0);
    // a pad at this lane or at any lane below it
    const bool padded = (pads & (kFull >> (31 - lane))) != 0u;
    unsigned sum = padded ? 0u : static_cast<unsigned>(dlt);
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned v = __shfl_up_sync(kFull, sum, off);
      if (lane >= off) sum += v;
    }
    id = padded ? INT_MAX
                : static_cast<int>(static_cast<unsigned>(base) + carry + sum);
    carry += __shfl_sync(kFull, sum, 31);
    real = ~__ballot_sync(kFull, padded);
    pad_seen = pad_seen || pads != 0u;
  }
};

template <typename D>
__global__ void label_intersect_packed_warp(
    const short* __restrict__ delta_s, const int* __restrict__ base_s,
    const D* __restrict__ d_s, const short* __restrict__ delta_t,
    const int* __restrict__ base_t, const D* __restrict__ d_t,
    float* __restrict__ mu, int q, int l, int n_sentinel) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= q) return;  // the whole warp leaves together
  const size_t off = static_cast<size_t>(row) * l;
  const short* rs = delta_s + off;
  const short* rt = delta_t + off;
  const int bs = base_s[row];
  const int bt = base_t[row];
  Chunk s, t;
  s.load(rs, bs, l, lane);
  t.load(rt, bt, l, lane);
  float best = INFINITY;
  while (s.real != 0u && t.real != 0u) {
    // lower bound of this lane's s id among the t chunk's 32 sorted ids
    int pos = 0;
    for (int k = 16; k > 0; k >>= 1)
      if (__shfl_sync(kFull, t.id, pos + k - 1) < s.id) pos += k;
    const int cand = __shfl_sync(kFull, t.id, pos);
    if (((s.real >> lane) & 1u) && s.id < n_sentinel && cand == s.id &&
        (pos > 0 || t.prev_last < s.id))
      best = fminf(best, load_d(d_s, off + s.start + lane) +
                             load_d(d_t, off + t.start + pos));
    const int s_max = __shfl_sync(kFull, s.id, 31 - __clz(s.real));
    const int t_max = __shfl_sync(kFull, t.id, 31);
    if (t_max < s_max) {
      t.prev_last = t_max;
      t.start += 32;
      t.load(rt, bt, l, lane);
    } else {
      s.start += 32;
      s.load(rs, bs, l, lane);
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    best = fminf(best, __shfl_xor_sync(kFull, best, o));
  if (lane == 0) mu[row] = best;
}

}  // namespace

extern "C" int islabel_label_intersect_packed(
    const short* delta_s, const int* base_s, const void* d_s,
    const short* delta_t, const int* base_t, const void* d_t, float* mu,
    int q, int l, int n_sentinel, int d_is_int, cudaStream_t stream) {
  if (q == 0) return 0;
  const int blocks = (q + kWarps - 1) / kWarps;
  if (d_is_int) {
    label_intersect_packed_warp<int><<<blocks, kThreads, 0, stream>>>(
        delta_s, base_s, static_cast<const int*>(d_s), delta_t, base_t,
        static_cast<const int*>(d_t), mu, q, l, n_sentinel);
  } else {
    label_intersect_packed_warp<float><<<blocks, kThreads, 0, stream>>>(
        delta_s, base_s, static_cast<const float*>(d_s), delta_t, base_t,
        static_cast<const float*>(d_t), mu, q, l, n_sentinel);
  }
  return static_cast<int>(cudaGetLastError());
}
