// Shared helpers for the port's Hopper kernels: dtype codes, f32 <-> storage
// conversions, 16-byte vector loads, warp reductions, and the tensor-core
// building blocks of the bf16 GEMM and attention backward (cp.async,
// ldmatrix, mma.sync m16n8k16).
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


// ---------------------------------------------------------------------------
// Tensor-core building blocks (sm_80+ PTX, run on sm_90a).
//
// mma.sync m16n8k16 fragments, g = lane / 4, t = lane % 4:
//   A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                     a3 (g+8, 2t+8..)
//   B (16 x 8, col):  b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C (16 x 8, f32):  c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..2t+1)
// ldmatrix.x4 hands lane l matrix i's row l / 4, elements 2(l % 4) and
// 2(l % 4) + 1 in register i (lanes 8i..8i+7 give matrix i's row
// addresses); .trans hands it column l / 4, rows 2(l % 4) and 2(l % 4) + 1.
// So a tile stored with the fragment's row index along its rows (A rows
// = m, B rows = n: "k-contiguous") is read without .trans, and a tile
// stored with k along its rows (an M-contiguous A, an N-contiguous B) is
// read with .trans.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy of `bytes` (0..16) valid bytes, the rest
// zero-filled: bytes == 0 writes 16 zeros (the ragged edge of a tile)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
// 4-byte global -> shared copy, `bytes` 0 or 4 (0 writes a zero)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (lo in the low half), rounded to
// nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of 16-byte chunk `c` of row `r` in a shared tile whose rows
// are 8 or more chunks long (`row_bytes` = 128, 256, ...): the chunk index
// is XORed with the row's low 3 bits, so the 8 rows one ldmatrix reads at
// one logical chunk fall in 8 distinct bank groups.
__device__ __forceinline__ uint32_t swz(int r, int c, int row_bytes) {
  return r * row_bytes + ((c ^ (r & 7)) << 4);
}
// the same for rows of 4 chunks (64 bytes: 32 bf16): two rows share a
// 128-byte bank line, so the XOR takes bits 1..2 of the row
__device__ __forceinline__ uint32_t swz64(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

}  // namespace repro
