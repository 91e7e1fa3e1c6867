// Shared helpers for the port's Hopper kernels: dtype codes, f32 <-> storage
// conversions, 16-byte vector loads and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes passed from Python (kernels/_build.py callers); int8 is a
// storage type only (the quantized KV pages)
enum DType : int { kF32 = 0, kBF16 = 1, kInt8 = 2 };

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
// round to nearest even, as torch and XLA round f32 to bf16
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// elements of T in one 16-byte vector
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<bf16> { static constexpr int N = 8; };

// 16-byte aligned load of Vec<T>::N elements, widened to f32
__device__ __forceinline__ void load16(const float* p, float (&out)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const bf16* p, float (&out)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // little endian: element 2i sits in the low half of word i
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Vec<T>::N elements of p[i0 ..], zero past n.  The 16-byte load is taken
// when the caller vouched for alignment (vec_ok) and the vector is whole;
// the ragged edge is read element by element.
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, long i0, long n,
                                         bool vec_ok,
                                         float (&out)[Vec<T>::N]) {
  constexpr int V = Vec<T>::N;
  if (vec_ok && i0 + V <= n) {
    load16(p + i0, out);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = (i0 + j < n) ? to_f32(p[i0 + j]) : 0.f;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

}  // namespace repro
