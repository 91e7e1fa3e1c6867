// Direct convolution (implicit GEMM): x (N, C, H, W) and w (F, C, KH, KW),
// an optional f32 bias (F,), any stride >= 1 and pad >= 0, to y (N, F, OH,
// OW), contiguous.  y[n, f, oy, ox] = b[f] + the sum over c, i, j of
// w[f, c, i, j] * x[n, c, oy*stride + i - pad, ox*stride + j - pad] (0
// outside the plane), accumulated in f32 and rounded once to x's dtype.
//
// Replaces src/repro/kernels/conv_direct.py:53 conv2d_direct_pallas, whose
// grid runs over (image, filter tile of min(128, F) filters), F padded to a
// multiple of the tile, with the whole zero-padded image (jnp.pad in device
// memory) in VMEM and one (ft, C) x (C, OH*OW) MXU product per (i, j) shift.
// On Hopper blocks run in no order on 132 SMs with at most 227 KB of shared
// memory each, so the TPU's blocking does not carry over.
//
// What bounds it on this card: bytes = x read once + w + bias + y written
// once; operations = 2*N*F*C*KH*KW*OH*OW.  At LeNet's shapes (batch 64, f32)
// it is bound by operations, except MNIST conv1 (C = 1): its 3.15 MB of
// input and output take 0.0009 ms at 3.35 TB/s, its 36.9 MFLOP 0.0006 ms at
// 67 TFLOP/s.  Neither form of the work needs the column matrix that the
// im2col + gemm path writes and reads again (KH*KW copies of the input).
//
// What the design does about it.  The grid is (output-pixel tile, filter
// tile, image).  A block computes kFT filters x one kTOH x kTOW tile of
// output pixels; it loops over chunks of input channels, and for each chunk
// stages into shared memory, as f32:
//   - the input window that its pixel tile reads, (kTOH-1)*stride + KH rows
//     by (kTOW-1)*stride + KW columns a channel, read from x by its four
//     strides, with 0 chosen for a tap in the padding (bounds, no padded
//     copy in device memory);
//   - the chunk's weights of its kFT filters, laid out [c][i*KW+j][f] so
//     that one 16-byte load gives a warp's four filters for one tap; a
//     filter at or past F is staged as 0 and its sums are never written
//     (F is not padded in memory: the ragged edge is masked).
// Each thread keeps 4 filters x 2 pixels of sums in f32 registers: per tap
// one broadcast 16-byte weight load and two input loads feed 8 FMAs, and
// each staged input value serves every filter of the tile.  Scalar f32
// FMAs throughout; tensor cores (wgmma), TMA and a bf16 form are later work.
//
// Fixed constants, not tuned (the port has no tuning table yet; kFT is the
// first knob its tuning layer will take):
//   - kFT = 32 filters: one or two tiles cover LeNet's F of 20-64, and a
//     warp's 4 filters are one 16-byte load.  JAX's ft = min(128, F) would
//     leave 64 blocks for MNIST conv2 at batch 64 on 132 SMs;
//   - an 8 x 8 pixel tile: 64 pixels, two per lane, and a window of
//     (7*stride + K)^2 values a channel however large the image, so the
//     channel chunk, sized to the 48 KB of shared memory a block gets
//     without opting in, holds several channels (13 at LeNet's 5x5, stride
//     1); 256 threads.
#include "common.cuh"

namespace {
using namespace repro;

constexpr int kThreads = 256;
constexpr int kFT = 32;                   // filters a block
constexpr int kTOH = 8, kTOW = 8;         // output pixels a block
constexpr size_t kSmemBudget = 48 * 1024; // a channel chunk's staging
constexpr size_t kSmemMax = 227 * 1024;   // a block's most, opted in

static_assert(kThreads / 32 * 4 == kFT, "8 warps x 4 filters");
static_assert(kTOW * (kTOH / 2) == 32, "a lane's two pixels");

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_direct_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ out,
                   int C, int H, int W, long sn, long sc, long sh, long sw,
                   int F, int KH, int KW, int stride, int pad, int OH,
                   int OW, int tiles_x, int CC, int WH, int WW) {
  extern __shared__ __align__(16) float smem[];
  const int KK = KH * KW;
  const int win = WH * WW;
  float* ws = smem;                              // [CC][KK][kFT]
  float* xs = smem + (size_t)CC * KK * kFT;      // [CC][WH][WW]
  const int n = blockIdx.z;
  const int f0 = blockIdx.y * kFT;
  const int oy0 = (blockIdx.x / tiles_x) * kTOH;
  const int ox0 = (blockIdx.x % tiles_x) * kTOW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the lane's pixels: (py, px) and (py + kTOH/2, px) of the tile
  const int py = lane / kTOW, px = lane % kTOW;
  const int y0 = oy0 * stride - pad, x0 = ox0 * stride - pad;
  const T* xn = x + (long)n * sn;
  float acc[4][2];
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k][0] = acc[k][1] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    const int cc = min(CC, C - c0);
    __syncthreads();   // every read of the previous chunk is done
    // weights, f fastest: conflict-free shared stores (w is small and
    // read from L2)
    for (int idx = threadIdx.x; idx < cc * KK * kFT; idx += kThreads) {
      const int f = idx % kFT, t = idx / kFT;   // t = c*KK + i*KW + j
      const int fg = f0 + f;
      ws[idx] = fg < F ? to_f32(w[((long)fg * C + c0) * KK + t]) : 0.f;
    }
    // the input window, columns fastest: coalesced where x's rows are
    for (int idx = threadIdx.x; idx < cc * win; idx += kThreads) {
      const int c = idx / win, r = idx - c * win;
      const int y = y0 + r / WW, xx = x0 + r % WW;
      float v = 0.f;
      if (y >= 0 && y < H && xx >= 0 && xx < W)
        v = to_f32(xn[(long)(c0 + c) * sc + (long)y * sh + (long)xx * sw]);
      xs[idx] = v;
    }
    __syncthreads();
    for (int c = 0; c < cc; ++c) {
      const float* xc = xs + c * win;
      const float4* wc =
          reinterpret_cast<const float4*>(ws + (size_t)c * KK * kFT) + warp;
      for (int i = 0; i < KH; ++i) {
        const float* r0 = xc + (py * stride + i) * WW + px * stride;
        const float* r1 = r0 + (kTOH / 2) * stride * WW;
        const float4* wi = wc + i * KW * (kFT / 4);
        for (int j = 0; j < KW; ++j) {
          const float4 wv = wi[j * (kFT / 4)];
          const float a = r0[j], b = r1[j];
          acc[0][0] = fmaf(wv.x, a, acc[0][0]);
          acc[1][0] = fmaf(wv.y, a, acc[1][0]);
          acc[2][0] = fmaf(wv.z, a, acc[2][0]);
          acc[3][0] = fmaf(wv.w, a, acc[3][0]);
          acc[0][1] = fmaf(wv.x, b, acc[0][1]);
          acc[1][1] = fmaf(wv.y, b, acc[1][1]);
          acc[2][1] = fmaf(wv.z, b, acc[2][1]);
          acc[3][1] = fmaf(wv.w, b, acc[3][1]);
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int oy = oy0 + py + q * (kTOH / 2), ox = ox0 + px;
    if (oy >= OH || ox >= OW) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int f = f0 + warp * 4 + k;
      if (f >= F) continue;
      float v = acc[k][q];
      if (bias != nullptr) v += bias[f];
      out[(((long)n * F + f) * OH + oy) * OW + ox] = from_f32<T>(v);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out,
                   int N, int C, int H, int W, long sn, long sc, long sh,
                   long sw, int F, int KH, int KW, int stride, int pad,
                   int OH, int OW, cudaStream_t s) {
  const int WH = (kTOH - 1) * stride + KH, WW = (kTOW - 1) * stride + KW;
  const size_t per_c =
      sizeof(float) * ((size_t)KH * KW * kFT + (size_t)WH * WW);
  int CC = (int)(kSmemBudget / per_c);
  if (CC > C) CC = C;
  if (CC < 1) CC = 1;
  const size_t smem = per_c * CC;
  const int tiles_x = (OW + kTOW - 1) / kTOW;
  const long tiles = (long)((OH + kTOH - 1) / kTOH) * tiles_x;
  const int ftiles = (F + kFT - 1) / kFT;
  if (smem > kSmemMax || tiles > 0x7fffffffL || ftiles > 65535 || N > 65535)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        conv_direct_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((unsigned)tiles, (unsigned)ftiles, (unsigned)N);
  conv_direct_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<T*>(out), C, H, W, sn, sc,
      sh, sw, F, KH, KW, stride, pad, OH, OW, tiles_x, CC, WH, WW);
  return cudaGetLastError();
}

}  // namespace

// x by its strides (n, c, h, w); w contiguous (F, C, KH, KW) in x's dtype;
// bias f32 (F,) or NULL; out contiguous (N, F, OH, OW) in x's dtype
extern "C" int repro_conv2d_direct(const void* x, const void* w,
                                   const void* bias, void* out, int N, int C,
                                   int H, int W, long long sn, long long sc,
                                   long long sh, long long sw, int F, int KH,
                                   int KW, int stride, int pad, int OH,
                                   int OW, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return (int)launch<bf16>(x, w, bias, out, N, C, H, W, sn, sc, sh, sw, F,
                             KH, KW, stride, pad, OH, OW, s);
  if (dtype == kF32)
    return (int)launch<float>(x, w, bias, out, N, C, H, W, sn, sc, sh, sw,
                              F, KH, KW, stride, pad, OH, OW, s);
  return (int)cudaErrorInvalidValue;
}
