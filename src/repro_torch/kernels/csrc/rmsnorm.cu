// Row RMSNorm: out = cast(x * rsqrt(mean(x^2) + eps)) * w, statistics in
// f32, the cast to the storage dtype *before* the weight multiply; and its
// backward, dx = inv * (dxhat - xhat * mean(dxhat * xhat)) with
// xhat = x * inv, dxhat = dy * w, and per-row-block partial sums of
// dw = sum(dy * xhat).
//
// Replaces src/repro/kernels/rmsnorm.py:rmsnorm_pallas and
// rmsnorm_bwd_pallas (one VMEM pass per row block; the backward writes one
// f32 dw partial per block, summed outside the kernel).  What bounds both
// on Hopper: bytes -- each row is read (the backward reads x and dy) and
// written once, with a handful of flops per element; the repeated reads of
// a row hit L1/L2.  The forward takes one block per row.  The backward
// takes kBwdRows rows per block (128 blocks at the 512 rows of a training
// step): a thread owns the same columns in every row of its block, so its
// share of the dw partial is a running sum in shared memory that no other
// thread touches; each row's two sums are warp-shuffle reductions followed
// by one across the block's warps.
#include "common.cuh"

namespace {
using namespace repro;

constexpr int kThreads = 256;

// sum of v over the block; every thread gets it.  part: kThreads / 32
// floats of shared scratch, free again when the call returns
__device__ __forceinline__ float block_sum(float v, float* part) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = warp_sum(v);
  __syncthreads();  // part may still be read by a previous call
  if (lane == 0) part[warp] = v;
  __syncthreads();
  float t = lane < kThreads / 32 ? part[lane] : 0.f;
  return warp_sum(t);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int D, long ldx, float eps) {
  __shared__ float part[kThreads / 32];
  const T* xr = x + (long)blockIdx.x * ldx;
  T* orow = out + (long)blockIdx.x * D;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float v = to_f32(xr[d]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) part[0] = t;
  }
  __syncthreads();
  const float inv = 1.0f / sqrtf(part[0] / (float)D + eps);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float y = to_f32(from_f32<T>(to_f32(xr[d]) * inv));
    orow[d] = from_f32<T>(y * to_f32(w[d]));
  }
}

constexpr int kBwdRows = 4;

// dx (rows, D) in T, dwp (ceil(rows / kBwdRows), D) f32.  Dynamic shared
// memory: D floats of dw partial.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ dwp, int rows, int D, long ldx,
                   long lddy, float eps) {
  extern __shared__ float dw_acc[];
  __shared__ float part[kThreads / 32];
  for (int d = threadIdx.x; d < D; d += kThreads) dw_acc[d] = 0.f;
  const int r0 = blockIdx.x * kBwdRows;
  const int r1 = min(rows, r0 + kBwdRows);
  for (int r = r0; r < r1; ++r) {
    const T* xr = x + (long)r * ldx;
    const T* dyr = dy + (long)r * lddy;
    float ss = 0.f;
    for (int d = threadIdx.x; d < D; d += kThreads) {
      const float v = to_f32(xr[d]);
      ss += v * v;
    }
    const float inv = 1.0f / sqrtf(block_sum(ss, part) / (float)D + eps);
    float sd = 0.f;
    for (int d = threadIdx.x; d < D; d += kThreads) {
      const float xhat = to_f32(xr[d]) * inv;
      sd += to_f32(dyr[d]) * to_f32(w[d]) * xhat;
    }
    const float mean = block_sum(sd, part) / (float)D;
    T* dxr = dx + (long)r * D;
    for (int d = threadIdx.x; d < D; d += kThreads) {
      const float xhat = to_f32(xr[d]) * inv;
      const float g = to_f32(dyr[d]);
      dxr[d] = from_f32<T>(inv * (g * to_f32(w[d]) - xhat * mean));
      dw_acc[d] += g * xhat;  // this thread's own column
    }
  }
  float* out = dwp + (long)blockIdx.x * D;
  for (int d = threadIdx.x; d < D; d += kThreads) out[d] = dw_acc[d];
}

}  // namespace

extern "C" int repro_rmsnorm(const void* x, const void* w, void* out, int rows,
                             int D, long long ldx, float eps, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(rows), block(kThreads);
  if (dtype == kBF16)
    rmsnorm_kernel<bf16><<<grid, block, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(out), D, ldx, eps);
  else if (dtype == kF32)
    rmsnorm_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), D, ldx, eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int repro_rmsnorm_bwd(const void* x, const void* w, const void* dy,
                                 void* dx, void* dwp, int rows, int D,
                                 long long ldx, long long lddy, float eps,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((rows + kBwdRows - 1) / kBwdRows), block(kThreads);
  // the dw row (dynamic) and the block's part[kThreads / 32] (static)
  // share the 48 KB a block may have without opting in
  const size_t smem = (size_t)D * sizeof(float);
  if (smem + kThreads / 32 * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    rmsnorm_bwd_kernel<bf16><<<grid, block, smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
        static_cast<float*>(dwp), rows, D, ldx, lddy, eps);
  else if (dtype == kF32)
    rmsnorm_bwd_kernel<float><<<grid, block, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(dy), static_cast<float*>(dx),
        static_cast<float*>(dwp), rows, D, ldx, lddy, eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
