// Row RMSNorm: out = cast(x * rsqrt(mean(x^2) + eps)) * w, statistics in
// f32, the cast to the storage dtype *before* the weight multiply.
//
// Replaces src/repro/kernels/rmsnorm.py:rmsnorm_pallas (one VMEM pass per
// row block).  What bounds it on Hopper: bytes -- it reads each row twice
// (the second read hits L1/L2) and writes it once, with a handful of flops
// per element.  One block per row; the sum of squares is a warp-shuffle
// reduction followed by one across the block's warps.
#include "common.cuh"

namespace {
using namespace repro;

constexpr int kThreads = 256;

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
