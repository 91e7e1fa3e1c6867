// Decode attention over the contiguous KV cache: one query token per row,
// q (B, Hq, D) against k/v (B, Smax, Hkv, D) read in place by their strides,
// a per-row valid length (lens), an optional sliding window, f32 online
// softmax, output in the storage dtype.
//
// Replaces src/repro/kernels/flash_attention.py:flash_decode_pallas, whose
// TPU grid (B, Hkv, S/bk) walks the key blocks in order on one core with the
// softmax state in VMEM scratch, after transposing and padding the cache on
// every call.  Here a block owns one (row, kv head) pair and the sequential
// key axis becomes a loop inside the block; the GQA group (G = Hq/Hkv query
// heads) is folded into the block's rows, so each K/V tile is loaded once
// for all G heads.  Tiles that lie wholly past the valid length or before
// the window are never visited, and a row with no valid key writes zeros
// (the l == 0 guard).
//
// What bounds it on Hopper: bytes -- each live key and value is read once,
// B * len * Hkv * D * 2 elements.  At decode the grid is only B * Hkv blocks
// (8 at B = 4 for qwen2.5-3b), so the card is mostly idle during this
// kernel; splitting the key axis across blocks (split-K) is later work.
#include "common.cuh"

namespace {
using namespace repro;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;     // keys per tile: one per lane when scoring
constexpr int kDMax = 128;  // head dim limit (checked by the wrapper)
constexpr int kGMax = 8;    // query heads per kv head limit (wrapper-checked)
constexpr int kRowsPerWarp = kGMax / kWarps;
constexpr int kDPerLane = kDMax / 32;
constexpr float kNegInf = -1e30f;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lens,
                    T* __restrict__ out, int Smax, int G, int D, long q_sb,
                    long q_sh, long k_sb, long k_ss, long k_sh, long v_sb,
                    long v_ss, long v_sh, long o_sb, long o_sh, int window,
                    float scale) {
  __shared__ float qs[kGMax][kDMax];
  __shared__ float ks[kBK][kDMax + 1];  // +1: lanes read distinct rows
  __shared__ float vs[kBK][kDMax];

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int len = lens[b];
  const int hi = min(len, Smax);
  const int lo = window >= 0 ? max(0, len - window) : 0;

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    qs[g][d] = to_f32(q[b * q_sb + (long)(h * G + g) * q_sh + d]);
  }

  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
  float acc[kRowsPerWarp][kDPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDPerLane; ++i) acc[r][i] = 0.f;
  }

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  for (int t0 = (lo / kBK) * kBK; t0 < hi; t0 += kBK) {
    __syncthreads();  // q staged / previous tile consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i % D, s = t0 + j;
      float kv = 0.f, vv = 0.f;
      if (s < hi) {
        kv = to_f32(kb[s * k_ss + d]);
        vv = to_f32(vb[s * v_ss + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();

    const int pos = t0 + lane;
    bool valid = pos < hi;
    if (window >= 0) valid = valid && pos >= len - window;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int g = warp + r * kWarps;
      if (g < G) {  // warp-uniform
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(qs[g][d], ks[lane][d], s);
        s = valid ? s * scale : kNegInf;
        const float m_new = fmaxf(m_run[r], warp_max(s));
        const float p = valid ? expf(s - m_new) : 0.f;
        const float alpha = expf(m_run[r] - m_new);
        l_run[r] = l_run[r] * alpha + warp_sum(p);
#pragma unroll
        for (int i = 0; i < kDPerLane; ++i) acc[r][i] *= alpha;
        for (int j = 0; j < kBK; ++j) {
          const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
          for (int i = 0; i < kDPerLane; ++i) {
            const int d = lane + 32 * i;
            if (d < D) acc[r][i] = fmaf(pj, vs[j][d], acc[r][i]);
          }
        }
        m_run[r] = m_new;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int g = warp + r * kWarps;
    if (g < G) {
      const float inv = 1.f / (l_run[r] == 0.f ? 1.f : l_run[r]);
#pragma unroll
      for (int i = 0; i < kDPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D)
          out[b * o_sb + (long)(h * G + g) * o_sh + d] =
              from_f32<T>(acc[r][i] * inv);
      }
    }
  }
}

}  // namespace

extern "C" int repro_flash_decode(
    const void* q, const void* k, const void* v, const void* lens, void* out,
    int B, int Smax, int Hkv, int G, int D, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_sh,
    int window, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > kDMax || G > kGMax) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, Hkv), block(kThreads);
  const int* pl = static_cast<const int*>(lens);
  if (dtype == kBF16)
    flash_decode_kernel<bf16><<<grid, block, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), pl, static_cast<bf16*>(out), Smax, G, D,
        q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh, window,
        scale);
  else if (dtype == kF32)
    flash_decode_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), pl, static_cast<float*>(out), Smax, G,
        D, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh, window,
        scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
