// GEMM: C (M,N) = A (M,K) @ B (K,N), f32 accumulation, output in the input
// dtype (bf16 or f32; f32 is plain IEEE FMA, never TF32).
//
// Replaces src/repro/kernels/gemm.py:gemm_pallas (MXU-tiled, K innermost,
// VMEM f32 accumulator), which serves every projection, the LM head and, in
// training, both products of every backward (ops.py:71-75: g @ B^T and
// A^T @ g).  Two kernels here, on the routes kernels/gemm.py:plan picks by
// dtype, shape, layout and alignment (bf16 with operands 16-byte copies
// can read goes to gemm_tc.cu's tensor-core kernel; f32 at M <= 64 with A
// read along M, or with the span the skinny kernel spreads over its lanes
// at most 1024 -- K with B along N, N with B along K: the Caffe nets'
// convolutions, weight gradients and inner products -- to gemm_f32.cu's
// small-M kernel):
//
// * M <= SKINNY_MAX_M[dtype] (f32: 128; decode: M is the batch; chunked
//   prefill: M = B*C; the f32 decode and prefill products of the served
//   archs, K >= 2048 over wide weights): a streaming skinny GEMM.  Every
//   weight byte is used for M multiply-adds, far below the ~295 operations
//   per byte where tensor cores become the limit, so the kernel is bound by
//   reading B once from
//   device memory: each B element is loaded exactly once, as part of a
//   16-byte vector, and multiplied into MR <= 8 row accumulators held in
//   registers; A is tiny and is re-read from shared memory or L1.  M > 8
//   runs ceil(M/8) row groups (correct, re-reads B).
// * larger M (the check's teacher-forced forward, M = B*S = 320;
//   training, M = B*S = 512 tokens, or, for the weight gradient A^T @ g,
//   M = the layer's input width, up to 11008; the Caffe nets' dcols and
//   their inner products' x^T @ g): a shared-memory tiled
//   GEMM, 64 x 64 output tiles, K in steps of 16, each of 256 threads
//   holding a 4 x 4 block of outputs in registers.  Here the product is
//   bound by operations, and the skinny kernel would read B ceil(M/8)
//   times (64 times the 622 MB tied embedding per head product at
//   M = 512).  Its grid is only N/64 x M/64 blocks, so at small M it
//   loses to the skinny kernel except on the widest N (the head): hence
//   the measured cutoff.  Scalar f32 FMAs from shared memory: it serves
//   f32, whose IEEE products the tensor cores cannot compute, and bf16
//   operands whose strides or bases the 16-byte copies cannot follow.
//
// Operands are read in place by their strides, with a unit stride along
// one axis each:
//   A: K-contiguous, A(m,k) = a[m*lda + k] (activations), or
//      M-contiguous, A(m,k) = a[k*lda + m] (the transposed activations of a
//      weight gradient; not the skinny kernel)
//   B: NN  B(k,n) = b[k*ldb + n]  -- the projection weights (d_in, d_out)
//      NT  B(k,n) = b[n*ldb + k]  -- the tied LM head, embed.T, a view of
//                                    the (vocab, d) embedding, and W^T in
//                                    the input gradient g @ W^T
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

// Tiled: 64 x 64 outputs per block of 256 threads, K in steps of kTK; A
// and B tiles are staged in shared memory as f32, read along whichever
// axis is contiguous in device memory.
constexpr int kTM = 64, kTN = 64, kTK = 16;
constexpr int kTPad = 4;  // keeps rows 16-byte aligned for float4 reads

template <typename T, bool A_M, bool B_K>
__global__ void __launch_bounds__(kThreads)
gemm_tiled_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ c, int M, int N, int K, long lda,
                  long ldb) {
  __shared__ __align__(16) float As[kTK][kTM + kTPad];
  __shared__ __align__(16) float Bs[kTK][kTN + kTPad];
  const int tid = threadIdx.x;
  const int tx = tid % (kTN / 4), ty = tid / (kTN / 4);
  const long m0 = (long)blockIdx.y * kTM, n0 = (long)blockIdx.x * kTN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTK) {
#pragma unroll
    for (int i = tid; i < kTM * kTK; i += kThreads) {
      // consecutive threads walk the contiguous axis
      const int mm = A_M ? i % kTM : i / kTK;
      const int kk = A_M ? i / kTM : i % kTK;
      const long m = m0 + mm;
      const int k = k0 + kk;
      float x = 0.f;
      if (m < M && k < K)
        x = to_f32(A_M ? a[(long)k * lda + m] : a[m * lda + k]);
      As[kk][mm] = x;
    }
#pragma unroll
    for (int i = tid; i < kTN * kTK; i += kThreads) {
      const int nn = B_K ? i / kTK : i % kTN;
      const int kk = B_K ? i % kTK : i / kTN;
      const long n = n0 + nn;
      const int k = k0 + kk;
      float x = 0.f;
      if (n < N && k < K)
        x = to_f32(B_K ? b[n * ldb + k] : b[(long)k * ldb + n]);
      Bs[kk][nn] = x;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long n = n0 + tx * 4 + j;
      if (n < N) c[m * N + n] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, bool A_M, bool B_K>
void launch_tiled(const T* a, const T* b, T* c, int M, int N, int K,
                  long lda, long ldb, cudaStream_t s) {
  const dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM), block(kThreads);
  gemm_tiled_kernel<T, A_M, B_K><<<grid, block, 0, s>>>(a, b, c, M, N, K,
                                                        lda, ldb);
}

// skinny_max_m: the largest M the skinny kernel takes; kernels/gemm.py
// passes M on its skinny route and 0 on its tiled one.  An A read along M
// always takes the tiled kernel.
template <typename T>
void launch_rows(const void* a, const void* b, void* c, int M, int N, int K,
                 long lda, bool a_m, long ldb, bool nt, bool vec_ok,
                 int skinny_max_m, cudaStream_t s) {
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* pc = static_cast<T*>(c);
  if (M > skinny_max_m || a_m) {
    if (a_m && nt) launch_tiled<T, true, true>(pa, pb, pc, M, N, K, lda, ldb, s);
    else if (a_m) launch_tiled<T, true, false>(pa, pb, pc, M, N, K, lda, ldb, s);
    else if (nt) launch_tiled<T, false, true>(pa, pb, pc, M, N, K, lda, ldb, s);
    else launch_tiled<T, false, false>(pa, pb, pc, M, N, K, lda, ldb, s);
  } else if (M <= 1) launch<T, 1>(pa, pb, pc, M, N, K, lda, ldb, nt, vec_ok, s);
  else if (M <= 2) launch<T, 2>(pa, pb, pc, M, N, K, lda, ldb, nt, vec_ok, s);
  else if (M <= 4) launch<T, 4>(pa, pb, pc, M, N, K, lda, ldb, nt, vec_ok, s);
  else launch<T, 8>(pa, pb, pc, M, N, K, lda, ldb, nt, vec_ok, s);
}

}  // namespace

extern "C" int repro_gemm(const void* a, const void* b, void* c, int M, int N,
                          int K, long long lda, int a_m_contiguous,
                          long long ldb, int b_k_contiguous, int dtype,
                          int vec_ok, int skinny_max_m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    launch_rows<bf16>(a, b, c, M, N, K, lda, a_m_contiguous, ldb,
                      b_k_contiguous, vec_ok, skinny_max_m, s);
  else if (dtype == kF32)
    launch_rows<float>(a, b, c, M, N, K, lda, a_m_contiguous, ldb,
                       b_k_contiguous, vec_ok, skinny_max_m, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
