// GEMM for the decode path: C (M,N) = A (M,K) @ B (K,N), f32 accumulation,
// output in the input dtype (bf16 or f32; f32 is plain IEEE FMA, never TF32).
//
// Replaces src/repro/kernels/gemm.py:gemm_pallas (MXU-tiled, K innermost,
// VMEM f32 accumulator).  What bounds it on Hopper: at decode, M is the batch
// (1-8 rows), so every weight byte is used for M multiply-adds -- far below
// the ~295 operations per byte where tensor cores become the limit.  The
// kernel is bound by reading B once from device memory.  So it is built as a
// streaming skinny GEMM, not a tiled one: each B element is loaded exactly
// once, as part of a 16-byte vector, and multiplied into MR <= 8 row
// accumulators held in registers; A is tiny and is re-read from shared
// memory or L1.  M > 8 runs ceil(M/8) row groups (correct, re-reads B).
//
// B comes in two layouts, read in place by its strides:
//   NN  B(k,n) = b[k*ldb + n]  -- the projection weights (d_in, d_out)
//   NT  B(k,n) = b[n*ldb + k]  -- the tied LM head, embed.T, a view of the
//                                 (vocab, d) embedding: no per-step copy
// Ragged edges are masked in the loads; nothing is padded or copied.
#include "common.cuh"

namespace {
using namespace repro;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// NN: a block owns kNNColGroups 16-byte column vectors (16 bf16 / 8 f32
// columns, one 32-byte sector per weight row); its 256 threads split K in
// kNNKLanes interleaved rows.  Narrow column tiles give enough blocks to
// fill the card at decode widths (N = 2048 -> 128 blocks).  A is staged in
// shared memory kNNKChunk columns at a time.
constexpr int kNNColGroups = 2;
constexpr int kNNKLanes = kThreads / kNNColGroups;
constexpr int kNNKChunk = 1024;

template <typename T, int MR>
__global__ void __launch_bounds__(kThreads)
gemm_nn_kernel(const T* __restrict__ a, const T* __restrict__ b,
               T* __restrict__ c, int M, int N, int K, long lda, long ldb,
               bool vec_ok) {
  constexpr int V = Vec<T>::N;
  constexpr int TN = kNNColGroups * V;
  __shared__ float As[MR][kNNKChunk];
  __shared__ float red[kWarps][MR][TN];

  const int tid = threadIdx.x;
  const int cg = tid % kNNColGroups;
  const int kl = tid / kNNColGroups;
  const long n0 = (long)blockIdx.x * TN + cg * V;
  const int m0 = blockIdx.y * MR;

  float acc[MR][V];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[m][j] = 0.f;

  for (int kc = 0; kc < K; kc += kNNKChunk) {
    const int kn = min(kNNKChunk, K - kc);
    for (int i = tid; i < MR * kNNKChunk; i += kThreads) {
      const int mm = i / kNNKChunk, kk = i % kNNKChunk;
      const int m = m0 + mm;
      As[mm][kk] =
          (kk < kn && m < M) ? to_f32(a[(long)m * lda + kc + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = kl; kk < kn; kk += kNNKLanes) {
      float bv[V];
      load_vec(b + (long)(kc + kk) * ldb, n0, N, vec_ok, bv);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const float av = As[m][kk];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[m][j] = fmaf(av, bv[j], acc[m][j]);
      }
    }
    __syncthreads();
  }

  // the k-lanes of a warp that share a column group sit kNNColGroups
  // lanes apart
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < V; ++j)
#pragma unroll
      for (int o = kNNColGroups; o < 32; o <<= 1)
        acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], o);
  const int lane = tid % 32, warp = tid / 32;
  if (lane < kNNColGroups) {  // lane == cg
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < V; ++j) red[warp][m][cg * V + j] = acc[m][j];
  }
  __syncthreads();
  for (int i = tid; i < MR * TN; i += kThreads) {
    const int m = i / TN, col = i % TN;
    const long n = (long)blockIdx.x * TN + col;
    if (m0 + m < M && n < N) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][m][col];
      c[(long)(m0 + m) * N + n] = from_f32<T>(s);
    }
  }
}

// NT: a warp owns kNTCols output columns; its lanes walk K in 16-byte
// vectors of the (contiguous) B rows, and every A vector loaded serves all
// kNTCols columns.  Partial dot products are reduced across the warp.
constexpr int kNTCols = 4;

template <typename T, int MR>
__global__ void __launch_bounds__(kThreads)
gemm_nt_kernel(const T* __restrict__ a, const T* __restrict__ b,
               T* __restrict__ c, int M, int N, int K, long lda, long ldb,
               bool vec_ok) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long nb = ((long)blockIdx.x * kWarps + warp) * kNTCols;
  const int m0 = blockIdx.y * MR;

  float acc[MR][kNTCols];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < kNTCols; ++j) acc[m][j] = 0.f;

#pragma unroll 2
  for (long k = (long)lane * V; k < K; k += 32 * V) {
    float bv[kNTCols][V];
#pragma unroll
    for (int j = 0; j < kNTCols; ++j) {
      if (nb + j < N) {
        load_vec(b + (nb + j) * ldb, k, K, vec_ok, bv[j]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) bv[j][v] = 0.f;
      }
    }
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      if (m0 + m < M) {
        float av[V];
        load_vec(a + (long)(m0 + m) * lda, k, K, vec_ok, av);
#pragma unroll
        for (int j = 0; j < kNTCols; ++j)
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[m][j] = fmaf(av[v], bv[j][v], acc[m][j]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < kNTCols; ++j) acc[m][j] = warp_sum(acc[m][j]);
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < kNTCols; ++j)
        if (m0 + m < M && nb + j < N)
          c[(long)(m0 + m) * N + nb + j] = from_f32<T>(acc[m][j]);
  }
}

template <typename T, int MR>
void launch(const T* a, const T* b, T* c, int M, int N, int K, long lda,
            long ldb, bool b_k_contiguous, bool vec_ok, cudaStream_t s) {
  const dim3 block(kThreads);
  const unsigned gy = (M + MR - 1) / MR;
  if (b_k_contiguous) {
    constexpr int cols = kWarps * kNTCols;
    const dim3 grid((N + cols - 1) / cols, gy);
    gemm_nt_kernel<T, MR><<<grid, block, 0, s>>>(a, b, c, M, N, K, lda, ldb,
                                                 vec_ok);
  } else {
    constexpr int cols = kNNColGroups * Vec<T>::N;
    const dim3 grid((N + cols - 1) / cols, gy);
    gemm_nn_kernel<T, MR><<<grid, block, 0, s>>>(a, b, c, M, N, K, lda, ldb,
                                                 vec_ok);
  }
}

template <typename T>
void launch_rows(const void* a, const void* b, void* c, int M, int N, int K,
                 long lda, long ldb, bool nt, bool vec_ok, cudaStream_t s) {
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* pc = static_cast<T*>(c);
  if (M <= 1) launch<T, 1>(pa, pb, pc, M, N, K, lda, ldb, nt, vec_ok, s);
  else if (M <= 2) launch<T, 2>(pa, pb, pc, M, N, K, lda, ldb, nt, vec_ok, s);
  else if (M <= 4) launch<T, 4>(pa, pb, pc, M, N, K, lda, ldb, nt, vec_ok, s);
  else launch<T, 8>(pa, pb, pc, M, N, K, lda, ldb, nt, vec_ok, s);
}

}  // namespace

extern "C" int repro_gemm(const void* a, const void* b, void* c, int M, int N,
                          int K, long long lda, long long ldb,
                          int b_k_contiguous, int dtype, int vec_ok,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    launch_rows<bf16>(a, b, c, M, N, K, lda, ldb, b_k_contiguous, vec_ok, s);
  else if (dtype == kF32)
    launch_rows<float>(a, b, c, M, N, K, lda, ldb, b_k_contiguous, vec_ok, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
