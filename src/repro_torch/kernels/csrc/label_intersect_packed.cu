// Stage 1 over compressed label rows (paper Equation 1 on the delta16
// codec): mu[q] = min over ancestor ids shared by the label rows of s[q]
// and t[q] of d_s + d_t, +inf when none, with the decode fused before
// the join.
//
// Replaces the Pallas kernel repro/kernels/label_intersect/kernel.py:
// label_intersect_packed_kernel (_intersect_packed_kernel). The TPU
// kernel decodes a whole [bq, L] tile of gathered rows with a cumsum and
// then runs the L^2 equality join of the fp32 kernel on the vector unit.
// Here one warp merges the two rows 32 slots at a time, decoding each
// chunk in registers (a ballot of the pad flags and a warp scan of the
// deltas, label_merge.cuh), and reads the rows in place from the
// encoded [n+1, L] planes by endpoint id. Distance planes are int32 (-1
// = +inf, exact int -> fp32) or float32.
//
// Bound on Hopper: dependent-load latency at the serving batches (Q <=
// 1024): endpoint id -> first chunk and base -> distances of the hits.
// A row is read up to the chunk that holds its first pad marker (2
// bytes a slot); on the R-MAT rows of l_cap = 1024 that is one 64-byte
// load. Reading the rows in place saves the [Q, L] copies of each plane
// and side that a gather before the call would write and read (about
// 25 MB at Q = 1024, L = 1024).
#include "label_merge.cuh"

namespace {

template <typename D>
void launch(const short* delta_s, const int* base_s, const void* d_s,
            const int* idx_s, int rows_s, const short* delta_t,
            const int* base_t, const void* d_t, const int* idx_t, int rows_t,
            float* mu, int q, int l, int n_sentinel, cudaStream_t stream) {
  using islabel::DeltaRow;
  islabel::label_merge<DeltaRow, D>
      <<<islabel::merge_blocks(q), islabel::kMergeThreads, 0, stream>>>(
          DeltaRow::Plane{delta_s, base_s}, static_cast<const D*>(d_s), idx_s,
          rows_s, DeltaRow::Plane{delta_t, base_t},
          static_cast<const D*>(d_t), idx_t, rows_t, mu, q, l, n_sentinel);
}

}  // namespace

extern "C" int islabel_label_intersect_packed(
    const short* delta_s, const int* base_s, const void* d_s,
    const int* idx_s, int rows_s, const short* delta_t, const int* base_t,
    const void* d_t, const int* idx_t, int rows_t, float* mu, int q, int l,
    int n_sentinel, int d_is_int, cudaStream_t stream) {
  if (q == 0) return 0;
  if (d_is_int) {
    launch<int>(delta_s, base_s, d_s, idx_s, rows_s, delta_t, base_t, d_t,
                idx_t, rows_t, mu, q, l, n_sentinel, stream);
  } else {
    launch<float>(delta_s, base_s, d_s, idx_s, rows_s, delta_t, base_t, d_t,
                  idx_t, rows_t, mu, q, l, n_sentinel, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
