// GEMM in IEEE f32 at small M: C (M,N) = A (M,K) @ B (K,N), f32 operands,
// f32 scalar FMAs (never TF32), f32 output.
//
// Replaces src/repro/kernels/gemm.py:gemm_pallas at the Caffe nets'
// products, which kernels/gemm.py:plan sends here in f32 at M <= 64 (the
// "f32_small" and "f32_splitk" routes): every LeNet forward convolution
// w (F, C*K*K) @ cols (C*K*K, N*OH*OW) (M = F = 20-64, K = 25-800, N =
// 3136-65536), every weight gradient dw = dy_flat (F, N*OH*OW) @ cols^T
// (M = F, N = C*K*K = 25-800, K = 3136-65536), the inner products'
// forward and input gradient (M = the batch, 64), and an A read along M at
// M <= 64.  gemm.cu's skinny kernel keeps the products it serves well (M =
// 4 and 64 with K >= 2048 and a wide weight: decode and chunked prefill);
// its NN form spreads K over 128 lanes (at K = 25, 103 idle) and its NT form
// walks all of K in one warp over ceil(N/32) x ceil(M/8) blocks (3 blocks
// for MNIST conv1's dw on a 132-SM card).
//
// What bounds it on the H100: the products straddle f32's ridge of 20
// flops a byte (67 TFLOP/s over 3.35 TB/s).  A forward convolution does
// M/2 = 10-32 flops per byte of cols, a dw product M*N / (2(M + N)) =
// 5-30 per byte of dy_flat and cols: MNIST conv1 and CIFAR conv1-2 are
// bound by bytes, MNIST conv2 and CIFAR conv3 by operations, and at 2-14
// us of bound every one is within a few launch latencies of it.
//
// Design:
// * Block tile BM x 64 outputs, BM fitted to M: 32 or 64 (kernels/gemm.py
//   passes it).  256 threads in a 16 x 16 grid, each holding TM x 4
//   outputs in registers (TM = BM / 16: 2 x 4 or 4 x 4).  A 64-wide N
//   tile wastes less of the dw products' narrow N (25, 75) than 128 would,
//   and still gives the forward's wide N 49-1024 blocks.
// * K in steps of 16 through a 3-stage cp.async ring (30 KB of static
//   shared memory at most): two steps in flight while the third is
//   multiplied, one __syncthreads a step.
// * Operands read in place along their contiguous axis, no copy: A along
//   K (weights, dy_flat) or along M (x^T); B along N (cols) or along K
//   (cols^T, W^T).  A tile whose contiguous axis is K is stored as rows of
//   16 floats padded to 20 (80 bytes: rows r..r+7 fall in 8 distinct
//   16-byte bank groups), one whose contiguous axis is M or N as 16 rows
//   of BM or 64 floats.  Copies are 16 bytes where the operand's base is
//   16-byte aligned and its leading dimension a multiple of 4, else 4
//   bytes (the forward's A = w.reshape(F, 25) has 100-byte rows); ragged
//   edges are zero-filled by cp.async's source size.
// * Inner loop: four K values at a time, each thread reads its A rows and
//   B columns as float4 (float2 for an M-contiguous A at TM = 2).  A reads
//   are broadcasts (a warp spans two thread rows); B columns are tx*4..+3
//   of an N-contiguous tile (a warp reads 256 contiguous bytes) or tx +
//   16j of a K-contiguous one (16 distinct padded rows): no bank
//   conflicts.  Each output sums its K terms in ascending order.
// * Split K (kernels/gemm.py:split_k) where the output tiles cannot fill
//   the 132 SMs -- every dw product: slice z covers K [z*slice_k,
//   min(K, (z+1)*slice_k)) (slice_k a multiple of 16) and writes its f32
//   partial tile into an (splits, M, N) workspace; splitk_reduce_f32 then
//   sums the slices in the order z = 0..splits-1.  No atomics: results
//   are bitwise reproducible.  The dw products split into up to 256
//   slices of a single 32 x 64 tile, so the reduce stages 64 slices of 32
//   outputs at a time in shared memory, 8 loads in flight a thread, and
//   one warp adds them in order.
// Registers per thread (-Xptxas -v on sm_90a, chip_smoke.py's build): 64-88
// at BM = 32, 69-126 at BM = 64 (the unrolled 4-step inner loop keeps a
// TM x 4 A fragment and a 4 x 4 B fragment live), no spills; 18-30 KB of
// shared memory.  At 126, two 256-thread blocks fit an SM, the occupancy
// split_k aims for.
#include "common.cuh"

namespace {
using namespace repro;

constexpr int kThreads = 256;
constexpr int kBN = 64, kBK = 16, kStages = 3;
constexpr int kKPitch = kBK + 4;  // floats a K-contiguous tile row takes

// One operand's ROWS x kBK tile into shared memory `s`: rows (M or N) from
// row0, valid below row_lim; K from k0, valid below k_end.  K_CONTIG:
// element (row, k) at p[row*ld + k], stored at s[r*kKPitch + kk]; else at
// p[k*ld + row], stored at s[kk*ROWS + r].  vec: 16-byte copies along the
// contiguous axis (p 16-byte aligned, ld a multiple of 4), else 4-byte
// ones.  Consecutive threads take consecutive addresses of the contiguous
// axis.
template <int ROWS, bool K_CONTIG>
__device__ __forceinline__ void load_tile(float* s, const float* p, long ld,
                                          int row0, int row_lim, int k0,
                                          int k_end, bool vec, int tid) {
  if (vec) {
    constexpr int kChunks = ROWS * kBK / 4;
#pragma unroll
    for (int t = 0; t < (kChunks + kThreads - 1) / kThreads; ++t) {
      const int id = tid + t * kThreads;
      if (id >= kChunks) break;
      const int r = K_CONTIG ? id / (kBK / 4) : (id % (ROWS / 4)) * 4;
      const int kk = K_CONTIG ? (id % (kBK / 4)) * 4 : id / (ROWS / 4);
      const int row = row0 + r, k = k0 + kk;
      const int n = K_CONTIG ? (row < row_lim ? max(0, min(4, k_end - k)) : 0)
                             : (k < k_end ? max(0, min(4, row_lim - row)) : 0);
      const float* src = !n ? p
                         : K_CONTIG ? p + (long)row * ld + k
                                    : p + (long)k * ld + row;
      float* dst = K_CONTIG ? s + r * kKPitch + kk : s + kk * ROWS + r;
      cp_async16(smem_addr(dst), src, 4 * n);
    }
  } else {
#pragma unroll
    for (int t = 0; t < ROWS * kBK / kThreads; ++t) {
      const int id = tid + t * kThreads;
      const int r = K_CONTIG ? id / kBK : id % ROWS;
      const int kk = K_CONTIG ? id % kBK : id / ROWS;
      const int row = row0 + r, k = k0 + kk;
      const bool ok = row < row_lim && k < k_end;
      const float* src = !ok ? p
                         : K_CONTIG ? p + (long)row * ld + k
                                    : p + (long)k * ld + row;
      float* dst = K_CONTIG ? s + r * kKPitch + kk : s + kk * ROWS + r;
      cp_async4(smem_addr(dst), src, ok ? 4 : 0);
    }
  }
}

template <int BM, bool A_M, bool B_K>
__global__ void __launch_bounds__(kThreads)
gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ c, int M, int N, int K, long lda,
                long ldb, bool a_vec, bool b_vec, int slice_k) {
  constexpr int TM = BM / 16;
  constexpr int kAFloats = A_M ? kBK * BM : BM * kKPitch;
  constexpr int kBFloats = B_K ? kBN * kKPitch : kBK * kBN;
  __shared__ __align__(16) float As[kStages][kAFloats];
  __shared__ __align__(16) float Bs[kStages][kBFloats];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * slice_k;
  const int ke = min(K, kb + slice_k);
  const int nk = (ke - kb + kBK - 1) / kBK;

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  auto load_stage = [&](int st, int kt) {
    const int k0 = kb + kt * kBK;
    load_tile<BM, !A_M>(As[st], a, lda, m0, M, k0, ke, a_vec, tid);
    load_tile<kBN, B_K>(Bs[st], b, ldb, n0, N, k0, ke, b_vec, tid);
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; stage kt-1 is free for everyone
    if (kt + kStages - 1 < nk)
      load_stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
    const float* as = As[kt % kStages];
    const float* bs = Bs[kt % kStages];
#pragma unroll
    for (int k4 = 0; k4 < kBK; k4 += 4) {
      float av[TM][4], bv[4][4];  // [row][k], [column][k]
      if constexpr (A_M) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* src = as + (k4 + q) * BM + ty * TM;
          if constexpr (TM == 4) {
            const float4 v = *reinterpret_cast<const float4*>(src);
            av[0][q] = v.x; av[1][q] = v.y; av[2][q] = v.z; av[3][q] = v.w;
          } else {
            const float2 v = *reinterpret_cast<const float2*>(src);
            av[0][q] = v.x; av[1][q] = v.y;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              as + (ty * TM + i) * kKPitch + k4);
          av[i][0] = v.x; av[i][1] = v.y; av[i][2] = v.z; av[i][3] = v.w;
        }
      }
      if constexpr (B_K) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(
              bs + (tx + 16 * j) * kKPitch + k4);
          bv[j][0] = v.x; bv[j][1] = v.y; bv[j][2] = v.z; bv[j][3] = v.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v =
              *reinterpret_cast<const float4*>(bs + (k4 + q) * kBN + tx * 4);
          bv[0][q] = v.x; bv[1][q] = v.y; bv[2][q] = v.z; bv[3][q] = v.w;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[i][q], bv[j][q], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // the output, or this slice's partial tile of the (splits, M, N)
  // workspace; a thread's columns are tx*4..tx*4+3 (B along N: 16-byte
  // stores where N allows) or tx + 16j (B along K)
  float* out = c + (long)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
    float* row = out + (long)m * N;
    if constexpr (B_K) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n < N) row[n] = acc[i][j];
      }
    } else {
      const int n = n0 + tx * 4;
      if ((N & 3) == 0 && n < N) {
        *reinterpret_cast<float4*>(row + n) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) row[n + j] = acc[i][j];
      }
    }
  }
}

// c[i] = the sum over z = 0..splits-1 of ws[z*mn + i], in that order.  A
// block takes 32 consecutive outputs; its 8 warps stage kRound slices of
// them at a time in shared memory, and warp 0 adds them in slice order.
constexpr int kRound = 64;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
splitk_reduce_f32(const float* __restrict__ ws, float* __restrict__ c,
                  long mn, int splits) {
  __shared__ float part[kRound][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long i = (long)blockIdx.x * 32 + lane;
  float s = 0.f;
  for (int z0 = 0; z0 < splits; z0 += kRound) {
    const int nz = min(kRound, splits - z0);
#pragma unroll
    for (int t = 0; t < kRound / kWarps; ++t) {
      const int r = warp + t * kWarps;
      if (r < nz && i < mn) part[r][lane] = ws[(long)(z0 + r) * mn + i];
    }
    __syncthreads();
    if (warp == 0)
      for (int r = 0; r < nz; ++r) s += part[r][lane];
    __syncthreads();
  }
  if (warp == 0 && i < mn) c[i] = s;
}

template <int BM, bool A_M, bool B_K>
int launch(const float* a, const float* b, float* c, float* ws, int M, int N,
           int K, long lda, long ldb, bool a_vec, bool b_vec, int splits,
           int slice_k, cudaStream_t s) {
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  gemm_f32_kernel<BM, A_M, B_K><<<grid, kThreads, 0, s>>>(
      a, b, splits > 1 ? ws : c, M, N, K, lda, ldb, a_vec, b_vec,
      splits > 1 ? slice_k : K);
  if (splits > 1) {
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    const long mn = (long)M * N;
    splitk_reduce_f32<<<(unsigned)((mn + 31) / 32), kThreads, 0, s>>>(
        ws, c, mn, splits);
  }
  return (int)cudaGetLastError();
}

template <int BM>
int launch_layout(bool a_m, bool b_k, const float* a, const float* b,
                  float* c, float* ws, int M, int N, int K, long lda,
                  long ldb, bool a_vec, bool b_vec, int splits, int slice_k,
                  cudaStream_t s) {
  if (a_m && b_k)
    return launch<BM, true, true>(a, b, c, ws, M, N, K, lda, ldb, a_vec,
                                  b_vec, splits, slice_k, s);
  if (a_m)
    return launch<BM, true, false>(a, b, c, ws, M, N, K, lda, ldb, a_vec,
                                   b_vec, splits, slice_k, s);
  if (b_k)
    return launch<BM, false, true>(a, b, c, ws, M, N, K, lda, ldb, a_vec,
                                   b_vec, splits, slice_k, s);
  return launch<BM, false, false>(a, b, c, ws, M, N, K, lda, ldb, a_vec,
                                  b_vec, splits, slice_k, s);
}

}  // namespace

// a_m_contiguous: A(m,k) = a[k*lda + m], else a[m*lda + k];
// b_k_contiguous: B(k,n) = b[n*ldb + k], else b[k*ldb + n].  a_vec / b_vec:
// the caller (kernels/gemm.py) vouches for a 16-byte aligned base and a
// leading dimension that is a multiple of 4; c (and ws) are 16-byte
// aligned and dense.  tile_m: 32 or 64.  When splits > 1, ws holds splits
// * M * N floats, slice_k is a multiple of 16 and (splits - 1) * slice_k <
// K.
extern "C" int repro_gemm_f32(const void* a, const void* b, void* c,
                              void* ws, int M, int N, int K, long long lda,
                              int a_m_contiguous, long long ldb,
                              int b_k_contiguous, int a_vec, int b_vec,
                              int tile_m, int splits, int slice_k,
                              void* stream) {
  if (M < 1 || N < 1 || K < 0 || (tile_m != 32 && tile_m != 64) ||
      (M + tile_m - 1) / tile_m > 65535 || splits < 1 || splits > 65535 ||
      (splits > 1 && (ws == nullptr || slice_k < kBK || slice_k % kBK ||
                      (long)(splits - 1) * slice_k >= K)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  float* pc = static_cast<float*>(c);
  float* pw = static_cast<float*>(ws);
  if (tile_m == 32)
    return launch_layout<32>(a_m_contiguous, b_k_contiguous, pa, pb, pc, pw,
                             M, N, K, lda, ldb, a_vec, b_vec, splits,
                             slice_k, s);
  return launch_layout<64>(a_m_contiguous, b_k_contiguous, pa, pb, pc, pw, M,
                           N, K, lda, ldb, a_vec, b_vec, splits, slice_k, s);
}
