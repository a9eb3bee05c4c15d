// Stage 1 of every query (paper Equation 1) over int32 id rows (codec
// "none"): mu[q] = min over ancestor ids shared by the label rows of
// s[q] and t[q] of d_s + d_t, +inf when none.
//
// Replaces the Pallas kernel repro/kernels/label_intersect/kernel.py:
// label_intersect_kernel (_intersect_kernel -> _equality_join). The TPU
// kernel compares every id pair of a [bq, L] tile (an L^2 equality join
// on the vector unit) over rows gathered before the call. Here one warp
// merges the two rows 32 slots at a time (label_merge.cuh), reading
// them in place from the [n+1, L] planes by endpoint id.
//
// Bound on Hopper: dependent-load latency at the serving batches (Q <=
// 1024), then bytes: each row is read up to the chunk that holds its
// first pad, distances only at hits. A per-slot binary search of the
// t row in device memory (log2 L dependent loads for each s slot, pads
// included) over rows gathered outside the kernel would be bound by
// those chains and by the gather; label_merge.cuh says what the merge
// does instead.
#include "label_merge.cuh"

extern "C" int islabel_label_intersect(
    const int* ids_s, const float* d_s, const int* idx_s, int rows_s,
    const int* ids_t, const float* d_t, const int* idx_t, int rows_t,
    float* mu, int q, int l, int n_sentinel, cudaStream_t stream) {
  if (q == 0) return 0;
  using islabel::IdRow;
  islabel::label_merge<IdRow, float>
      <<<islabel::merge_blocks(q), islabel::kMergeThreads, 0, stream>>>(
          IdRow::Plane{ids_s}, d_s, idx_s, rows_s, IdRow::Plane{ids_t}, d_t,
          idx_t, rows_t, mu, q, l, n_sentinel);
  return static_cast<int>(cudaGetLastError());
}
