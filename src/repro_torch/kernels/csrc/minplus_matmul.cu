// Tropical (min-plus) product C[i, j] = min_k A[i, k] + B[k, j]: one
// synchronous relaxation round of the dense-core route (stacked s/t
// frontiers times the 0-diagonal dense core adjacency).
//
// Replaces the Pallas kernel repro/kernels/minplus_matmul/kernel.py:
// minplus_matmul_kernel (_minplus_kernel).
//
// Bound on Hopper: instruction issue. Tensor cores only multiply and
// add, so every (i, j, k) is one FADD and one FMNMX on the CUDA cores:
// 2 M N K operations against the 67 TFLOP/s fp32 peak, or, counted in
// issue slots, two warp instructions per 32 terms with one issue slot
// per SM sub-partition and clock (FMNMX also runs at half the FADD rate,
// 64 a clock per SM), i.e. 64 terms per SM and clock. The design is an
// SGEMM-style CUDA-core kernel that keeps everything else off that path:
//  - Block tile BM x BN, thread tile TM x TN: the wrapper's 32 x 64
//    tile gives each thread 4 x 8 running minima, fed per k by one
//    float4 load of A and two of B from shared memory (3 loads for 64
//    terms). A thread's rows (columns) come in runs of 4, so a warp's
//    shared loads are contiguous and conflict-free.
//  - A is staged k-major (As[k][m], rows padded by 4 floats) and B
//    row-major, BK = 16 deep, in a ring of kStages slices: slice kt + 2
//    loads while slice kt computes, with one __syncthreads a slice. B
//    copies with 16-byte cp.async; A loads as float4 (4 k's of a row)
//    into registers during the compute and is stored transposed after
//    it. Each thread's share of a slice is fixed, so a slice costs a few
//    pointer adds and no bounds checks inside M and N.
//  - Out-of-range elements are stored as +inf (the min-plus zero), not
//    copied, so ragged M, N and K need no padding by the caller (edge
//    blocks, the last K slice and unaligned rows take a checked path of
//    4-byte copies).
//  - The tiling is the fastest of four timed on the card at the dense
//    route's [2048, 1280] x [1280, 1280] (PERF.md): small tiles balance
//    the 132 SMs (1,280 tiles of 32 x 64, against 160 of 128 x 128,
//    where 28 SMs run a second tile), and 8 x 8 thread tiles, which need
//    more than 128 registers, ran slower.
// No FMA can form (there is no product), and the build has no fast-math
// flag, so each term is the plain fp32 sum and the min is exact: any
// tiling is bitwise equal to the plain version.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPadA = 4;  // As rows: BM + 4 floats (16-byte aligned rows)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Block tile BM x BN, thread tile TM x TN, slices BK deep in a ring of
// STAGES, and the blocks an SM must hold (caps the registers a thread).
template <int BM_, int BN_, int TM_, int TN_, int BK_, int STAGES_,
          int MIN_BLOCKS_>
struct Tiling {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr int kBK = BK_, kStages = STAGES_;
  static constexpr int kMinBlocks = MIN_BLOCKS_;
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int kLdA = BM + kPadA;
  static constexpr int kStageFloats = kBK * (kLdA + BN);
  static constexpr int kSmemBytes = kStages * kStageFloats * 4;
  // a thread's rows (columns) come in TM/4 (TN/4) runs of 4, this far apart
  static constexpr int kRunA = BM * 4 / TM;
  static constexpr int kRunB = BN * 4 / TN;
  // a thread's share of a slice: kNA float4 of A (4 k's of one row,
  // rows kStepA apart) and kNB float4 of B (rows kStepB apart)
  static constexpr int kQuadsA = kBK / 4;
  static constexpr int kQuadsB = BN / 4;
  static constexpr int kStepA = kThreads / kQuadsA;
  static constexpr int kStepB = kThreads / kQuadsB;
  static constexpr int kNA = BM / kStepA;
  static constexpr int kNB = kBK / kStepB;
  static_assert(TM % 4 == 0 && TN % 4 == 0, "thread tiles are float4 runs");
  static_assert(kThreads % kQuadsA == 0 && BM % kStepA == 0,
                "A slice splits evenly");
  static_assert(kThreads % kQuadsB == 0 && kBK % kStepB == 0,
                "B slice splits evenly");
};

__device__ __forceinline__ float& lane4(float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
    minplus_tiles(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int m, int n, int k, bool vec_a,
                  bool vec_b) {
  constexpr int BM = T::BM, BN = T::BN, TM = T::TM, TN = T::TN;
  constexpr int kBK = T::kBK, kStages = T::kStages;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int n_slices = (k + kBK - 1) / kBK;
  // A block inside M and N with 16-byte aligned rows copies whole float4s
  // and checks nothing but the last, ragged K slice.
  const bool interior = row0 + BM <= m && col0 + BN <= n && vec_a && vec_b;
  const int a_q = threadIdx.x % T::kQuadsA * 4;  // the thread's 4 k's of A
  const int a_r = threadIdx.x / T::kQuadsA;      // its first A row
  const int b_c = threadIdx.x % T::kQuadsB * 4;  // its 4 columns of B
  const int b_r = threadIdx.x / T::kQuadsB;      // its first B row
  const float* pa = a + static_cast<size_t>(row0 + a_r) * k + a_q;
  const float* pb = b + static_cast<size_t>(b_r) * n + col0 + b_c;
  float4 ra[T::kNA];  // A in flight, from device memory to shared

  // A goes through registers so it can be stored k-major; out of range
  // loads as +inf.
  auto fetch_a = [&](int k0) {
    if (interior && k0 + kBK <= k) {
#pragma unroll
      for (int j = 0; j < T::kNA; ++j)
        ra[j] = __ldg(reinterpret_cast<const float4*>(
            pa + static_cast<size_t>(j) * T::kStepA * k + k0));
    } else {
#pragma unroll
      for (int j = 0; j < T::kNA; ++j) {
        const int r = row0 + a_r + j * T::kStepA;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kk = k0 + a_q + i;
          lane4(ra[j], i) = r < m && kk < k
                                ? __ldg(a + static_cast<size_t>(r) * k + kk)
                                : INFINITY;
        }
      }
    }
  };
  auto store_a = [&](float* as) {
#pragma unroll
    for (int j = 0; j < T::kNA; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        as[(a_q + i) * T::kLdA + a_r + j * T::kStepA] = lane4(ra[j], i);
  };
  // B goes straight to shared memory with cp.async
  auto copy_b = [&](float* bs, int k0) {
    if (interior && k0 + kBK <= k) {
#pragma unroll
      for (int j = 0; j < T::kNB; ++j)
        cp_async16(bs + (b_r + j * T::kStepB) * BN + b_c,
                   pb + static_cast<size_t>(k0 + j * T::kStepB) * n);
    } else {
#pragma unroll
      for (int j = 0; j < T::kNB; ++j) {
        const int kk = k0 + b_r + j * T::kStepB, gc = col0 + b_c;
        float* dst = bs + (b_r + j * T::kStepB) * BN + b_c;
        const float* srcp = b + static_cast<size_t>(kk) * n + gc;
        if (vec_b && kk < k && gc < n) {  // n % 4 == 0: the float4 fits
          cp_async16(dst, srcp);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (kk < k && gc + i < n)
              cp_async4(dst + i, srcp + i);
            else
              dst[i] = INFINITY;
          }
        }
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = INFINITY;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_slices) {
      float* as = smem + s * T::kStageFloats;
      copy_b(as + kBK * T::kLdA, s * kBK);
      fetch_a(s * kBK);
      store_a(as);
    }
    cp_async_commit();  // one group a slot, empty or not
  }

  for (int kt = 0; kt < n_slices; ++kt) {
    cp_async_wait<kStages - 2>();  // slice kt has landed (this thread's)
    __syncthreads();               // ... everyone's; slot kt-1 is free
    const int pre = kt + kStages - 1;
    float* as_pre = smem + (pre % kStages) * T::kStageFloats;
    if (pre < n_slices) {
      copy_b(as_pre + kBK * T::kLdA, pre * kBK);
      fetch_a(pre * kBK);  // lands in registers while this slice computes
    }
    cp_async_commit();
    const float* as = smem + (kt % kStages) * T::kStageFloats;
    const float* bs = as + kBK * T::kLdA;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(
            as + kk * T::kLdA + g * T::kRunA + ty * 4);
        av[g * 4 + 0] = x.x;
        av[g * 4 + 1] = x.y;
        av[g * 4 + 2] = x.z;
        av[g * 4 + 3] = x.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 y = *reinterpret_cast<const float4*>(
            bs + kk * BN + g * T::kRunB + tx * 4);
        bv[g * 4 + 0] = y.x;
        bv[g * 4 + 1] = y.y;
        bv[g * 4 + 2] = y.z;
        bv[g * 4 + 3] = y.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fminf(acc[i][j], av[i] + bv[j]);
    }
    if (pre < n_slices) store_a(as_pre);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + (i / 4) * T::kRunA + ty * 4 + i % 4;
    if (gr >= m) continue;
    float* crow = c + static_cast<size_t>(gr) * n;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int gc = col0 + g * T::kRunB + tx * 4;
      if (vec_b && gc < n) {  // n % 4 == 0: the whole float4 fits
        *reinterpret_cast<float4*>(crow + gc) =
            make_float4(acc[i][g * 4], acc[i][g * 4 + 1], acc[i][g * 4 + 2],
                        acc[i][g * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gc + j < n) crow[gc + j] = acc[i][g * 4 + j];
      }
    }
  }
}

// The tiling timed fastest at the dense route's shape (PERF.md): 32 x 64
// blocks of 64 threads, 4 x 8 minima a thread, 8 blocks an SM.
using Tile = Tiling<32, 64, 4, 8, 16, 3, 8>;

template <class T>
int launch(const float* a, const float* b, float* c, int m, int n, int k,
           cudaStream_t stream) {
  auto kern = minplus_tiles<T>;
  static bool attr_set = false;  // above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  auto aligned16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  // whole float4 rows: of A (k % 4 == 0), of B and C (n % 4 == 0)
  const bool vec_a = aligned16(a) && k % 4 == 0;
  const bool vec_b = aligned16(b) && aligned16(c) && n % 4 == 0;
  dim3 grid((n + T::BN - 1) / T::BN, (m + T::BM - 1) / T::BM);
  kern<<<grid, T::kThreads, T::kSmemBytes, stream>>>(a, b, c, m, n, k, vec_a,
                                                      vec_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int islabel_minplus_matmul(const float* a, const float* b,
                                      float* c, int m, int n, int k,
                                      cudaStream_t stream) {
  if (m == 0 || n == 0) return 0;
  return launch<Tile>(a, b, c, m, n, k, stream);
}
