// GEMM on Hopper's tensor cores: C (M,N) = A (M,K) @ B (K,N) in bf16 with
// f32 accumulation, rounded once to bf16.
//
// Replaces src/repro/kernels/gemm.py:gemm_pallas on its tiled route in
// bf16 (the kernels/gemm.py planner sends M > SKINNY_MAX_M[bf16], or an A
// read along M, here when both operands are 16-byte aligned with leading
// dimensions that are multiples of 8 elements).  These are every product
// of a training step (M = B*S = 512 tokens, or M = a layer's input width
// for the weight gradient x^T @ g), the check's teacher-forced forward
// and, as this kernel beat the skinny one at every M measured in bf16
// (chip_smoke.py's crossover), decode and chunked prefill.
// f32 keeps gemm.cu's scalar tiled kernel: the JAX reference multiplies
// f32 in IEEE f32 (ROADMAP standing note), which the tensor cores do not
// (TF32 keeps 10 mantissa bits); so does a bf16 operand this kernel cannot
// read with 16-byte copies.
//
// What bounds it on the H100: operations.  A 512 x 2048 x 2048 product
// does 4.3 GFLOP on 10 MB: 430 flops a byte, above the ~295 where the bf16
// tensor cores (989 TFLOP/s dense) rather than HBM (3.35 TB/s) are the
// limit; the 2048 x 151936 head does 3,900.
//
// Design (mma.sync, not wgmma + TMA: the simpler of the two; wgmma, the
// only way to the tensor cores' full rate, is later work):
// * Block tile 128 x 128, K steps of 32, 256 threads = 8 warps in a 2 x 4
//   grid, each warp 64 x 32 outputs = 4 x 4 mma.sync.m16n8k16 tiles with
//   64 f32 accumulators in registers.
// * Operands read in place by their strides, no copy: A K-contiguous
//   (activations) or M-contiguous (the x^T of a weight gradient), B
//   N-contiguous (the weights) or K-contiguous (embed^T, W^T).  A tile
//   whose contiguous axis is K is stored as 128 rows of 64 bytes and read
//   by ldmatrix; one whose contiguous axis is M or N as 32 rows of 256
//   bytes and read by ldmatrix.trans.  Both are XOR-swizzled in 16-byte
//   chunks (common.cuh swz64 / swz), so ldmatrix meets no bank conflict.
// * A 4-stage cp.async ring of 16-byte copies (64 KB of dynamic shared
//   memory, opted in with cudaFuncSetAttribute): three K steps in flight
//   while the fourth is multiplied, one __syncthreads per step.  Ragged
//   M, N and K edges are zero-filled by cp.async's source size; stores
//   are masked.
// * Split K (kernels/gemm.py:split_k) where the output tiles cannot fill
//   the 132 SMs: slice z of `splits` covers K [z*slice_k, (z+1)*slice_k)
//   (slice_k a multiple of 32) and writes its f32 partial tile into an
//   (splits, M, N) workspace; splitk_reduce then sums the slices in the
//   order z = 0..splits-1 and rounds once.  No atomics: deterministic.
// * Epilogue (no split): the tile is rounded to bf16 once, staged in
//   shared memory and written with 16-byte stores where N allows.
#include "common.cuh"

namespace {
using namespace repro;

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kTileBytes = kBM * kBK * 2;          // 8 KB: one operand
constexpr int kStageBytes = 2 * kTileBytes;        // A then B
constexpr int kCPitch = kBN + 8;                   // bf16 epilogue tile
constexpr int kSmemBytes = kStages * kStageBytes;  // 64 KB
static_assert(kBM * kCPitch * 2 <= kSmemBytes, "epilogue tile fits");

// One operand's 128 x 32 tile of stage memory `s`: `rows` (M or N) along
// `row0`, K from k0, valid below `row_lim` and `k_end`.  K_CONTIG: the
// operand's unit stride is along K (element (row, k) at p[row*ld + k]),
// else along rows (element (row, k) at p[k*ld + row]).
template <bool K_CONTIG>
__device__ __forceinline__ void load_tile(uint32_t s, const bf16* p, long ld,
                                          int row0, int row_lim, int k0,
                                          int k_end, int tid) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int id = tid + j * kThreads;
    if (K_CONTIG) {
      const int r = id >> 2, c = id & 3;
      const int row = row0 + r, k = k0 + c * 8;
      const int bytes = row < row_lim ? max(0, min(16, (k_end - k) * 2)) : 0;
      cp_async16(s + swz64(r, c), bytes ? p + (long)row * ld + k : p, bytes);
    } else {
      const int r = id >> 4, c = id & 15;
      const int k = k0 + r, col = row0 + c * 8;
      const int bytes = k < k_end ? max(0, min(16, (row_lim - col) * 2)) : 0;
      cp_async16(s + swz(r, c, 256), bytes ? p + (long)k * ld + col : p,
                 bytes);
    }
  }
}

template <bool A_M, bool B_K>
__global__ void __launch_bounds__(kThreads, 2)
gemm_tc_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
               bf16* __restrict__ c, float* __restrict__ ws, int M, int N,
               int K, long lda, long ldb, int slice_k) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_addr(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int kb = blockIdx.z * slice_k;
  const int ke = min(K, kb + slice_k);
  const int nk = (ke - kb + kBK - 1) / kBK;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto load_stage = [&](int st, int kt) {
    const uint32_t sa = s0 + st * kStageBytes, sb = sa + kTileBytes;
    const int k0 = kb + kt * kBK;
    load_tile<!A_M>(sa, a, lda, m0, M, k0, ke, tid);
    load_tile<B_K>(sb, b, ldb, n0, N, k0, ke, tid);
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
    const uint32_t sa = s0 + (kt % kStages) * kStageBytes;
    const uint32_t sb = sa + kTileBytes;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int m = wm + mi * 16;
        if (!A_M) {
          ldsm_x4(af[mi], sa + swz64(m + (lane & 15), kk * 2 + (lane >> 4)));
        } else {
          const int i = lane >> 3;
          ldsm_x4_t(af[mi], sa + swz(kk * 16 + (lane & 7) + 8 * (i >> 1),
                                     (m >> 3) + (i & 1), 256));
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int n = wn + p * 16, i = lane >> 3;
        if (B_K) {
          ldsm_x4(bfr[p], sb + swz64(n + (lane & 7) + 8 * (i >> 1),
                                     kk * 2 + (i & 1)));
        } else {
          ldsm_x4_t(bfr[p], sb + swz(kk * 16 + (lane & 7) + 8 * (i & 1),
                                     (n >> 3) + (i >> 1), 256));
        }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bfr[ni >> 1][(ni & 1) * 2],
                   bfr[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the epilogue

  const int g = lane >> 2, t = lane & 3;
  if (ws != nullptr) {
    // split K: this slice's f32 partial tile, 8-byte stores
    float* w = ws + (long)blockIdx.z * M * N;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + g + 8 * h;
        if (row >= M) continue;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = n0 + wn + ni * 8 + 2 * t;
          float* dst = w + (long)row * N + col;
          const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
          if ((N & 1) == 0 && col < N) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            if (col < N) dst[0] = v0;
            if (col + 1 < N) dst[1] = v1;
          }
        }
      }
    return;
  }

  // no split: round once, stage the tile, 16-byte stores
  bf16* cs = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + mi * 16 + g + 8 * h, col = wn + ni * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(cs + r * kCPitch + col) =
            pack_bf16(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
  __syncthreads();
  const bool vec = (N & 7) == 0;
#pragma unroll
  for (int it = 0; it < kBM * kBN / 8 / kThreads; ++it) {
    const int id = tid + it * kThreads;
    const int r = id >> 4, col = (id & 15) * 8;
    const int row = m0 + r, n = n0 + col;
    if (row >= M || n >= N) continue;
    const bf16* src = cs + r * kCPitch + col;
    bf16* dst = c + (long)row * N + n;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && n + e < N; ++e) dst[e] = src[e];
    }
  }
}

// out = bf16(sum over z = 0..splits-1 of ws[z]), in that order
__global__ void __launch_bounds__(256)
splitk_reduce(const float* __restrict__ ws, bf16* __restrict__ c, long mn,
              int splits) {
  const long i = ((long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= mn) return;
  if ((mn & 3) == 0) {
    float4 s = *reinterpret_cast<const float4*>(ws + i);
    for (int z = 1; z < splits; ++z) {
      const float4 v = *reinterpret_cast<const float4*>(ws + z * mn + i);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    uint2 o;
    o.x = pack_bf16(s.x, s.y);
    o.y = pack_bf16(s.z, s.w);
    *reinterpret_cast<uint2*>(c + i) = o;
  } else {
    for (long e = i; e < i + 4 && e < mn; ++e) {
      float s = ws[e];
      for (int z = 1; z < splits; ++z) s += ws[z * mn + e];
      c[e] = from_f32<bf16>(s);
    }
  }
}

template <bool A_M, bool B_K>
int launch(const bf16* a, const bf16* b, bf16* c, float* ws, int M, int N,
           int K, long lda, long ldb, int splits, int slice_k,
           cudaStream_t s) {
  // the attribute is per kernel instantiation, set once per process (the
  // port drives one card)
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_tc_kernel<A_M, B_K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, splits);
  gemm_tc_kernel<A_M, B_K><<<grid, kThreads, kSmemBytes, s>>>(
      a, b, c, splits > 1 ? ws : nullptr, M, N, K, lda, ldb,
      splits > 1 ? slice_k : K);
  if (splits > 1) {
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    const long mn = (long)M * N;
    const long threads = (mn + 3) / 4;
    splitk_reduce<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
        ws, c, mn, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// a_m_contiguous: A(m,k) = a[k*lda + m], else a[m*lda + k];
// b_k_contiguous: B(k,n) = b[n*ldb + k], else b[k*ldb + n].  The caller
// (kernels/gemm.py) vouches for 16-byte aligned a, b, c and ws, lda and
// ldb multiples of 8, and, when splits > 1, an f32 workspace of
// splits * M * N elements with slice_k a multiple of 32 and
// (splits - 1) * slice_k < K.
extern "C" int repro_gemm_tc(const void* a, const void* b, void* c, void* ws,
                             int M, int N, int K, long long lda,
                             int a_m_contiguous, long long ldb,
                             int b_k_contiguous, int splits, int slice_k,
                             void* stream) {
  if (M < 1 || N < 1 || K < 1 || splits < 1 || splits > 65535 ||
      (splits > 1 && (ws == nullptr || slice_k < kBK || slice_k % kBK ||
                      (long)(splits - 1) * slice_k >= K)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* pa = static_cast<const bf16*>(a);
  const bf16* pb = static_cast<const bf16*>(b);
  bf16* pc = static_cast<bf16*>(c);
  float* pw = static_cast<float*>(ws);
  if (a_m_contiguous && b_k_contiguous)
    return launch<true, true>(pa, pb, pc, pw, M, N, K, lda, ldb, splits,
                              slice_k, s);
  if (a_m_contiguous)
    return launch<true, false>(pa, pb, pc, pw, M, N, K, lda, ldb, splits,
                               slice_k, s);
  if (b_k_contiguous)
    return launch<false, true>(pa, pb, pc, pw, M, N, K, lda, ldb, splits,
                               slice_k, s);
  return launch<false, false>(pa, pb, pc, pw, M, N, K, lda, ldb, splits,
                              slice_k, s);
}
