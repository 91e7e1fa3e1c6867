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
// f32 stays IEEE FMAs (no TF32); a bf16 x is widened to f32 on staging.
//
// Two routes, picked by kernels/conv_direct.py:plan from the shapes:
//
// "reg" (repro_conv2d_direct_reg): square windows of 3 or 5 at stride 1
// (every LeNet convolution, the autotuner's conv3x3 cell), the window a
// template parameter so that the tap loops unroll.  A thread owns kRegP = 4
// consecutive output pixels of one row x kRegFT = 8 filters: 32 f32 sums in
// registers.  For each (channel, tap row i) it loads the 8 input values of
// that row (two 16-byte shared loads) once and slides them across the KW
// taps; each tap's 8 weights come as two broadcast 16-byte loads, laid out
// [c][i][j][f].  At 5 x 5 that is 12 shared loads for 160 FMAs (the scalar
// route: 3 loads for 8).  (8 pixels a thread -- 320 FMAs for 13 loads,
// half the threads a block -- timed slower at every LeNet shape.)  A
// block is (toh x tow output pixels, fb filters, one image) x ks channel
// groups: group g sums the channels c = g mod ks in ascending order, and at
// the end the groups' sums meet in shared memory, added in group order by
// group 0 (no atomics: the same bits on every call), then the bias in f32.
// The channel groups are how a 7 x 7 or 8 x 8 image keeps 7-8 warps a
// block busy.  The block stages chunks of cc channels (their input window,
// read by x's four strides with 0 for a tap in the padding, and their
// weights) through a ring of two cp.async stages in 4-byte copies (the
// windows' rows start at any column), so the next chunk's copies fly while
// this one computes; bf16 is widened on a synchronous stage.  The tiles
// come from kernels/conv_direct.py:tiles (shapes alone): at least 132
// blocks at each LeNet shape at batch 64.
//
// "scalar" (repro_conv2d_direct): every other window and stride (JAX's 2 x 2
// windows, strides 2 and 3).  The grid is (output-pixel tile, filter tile,
// image).  A block computes kFT filters x one kTOH x kTOW tile of output
// pixels; it loops over chunks of input channels, and for each chunk
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
// one broadcast 16-byte weight load and two input loads feed 8 FMAs.
// Fixed constants: kFT = 32 filters, an 8 x 8 pixel tile, a channel chunk
// sized to 48 KB of shared memory, 256 threads.
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

// ---------------------------------------------------------------------------
// route "reg"
// ---------------------------------------------------------------------------
constexpr int kRegP = 4;             // output pixels a thread, one row
constexpr int kRegFT = 8;            // filters a thread
constexpr int kRegAcc = kRegP * kRegFT;
constexpr int kRegMaxThreads = 256;

// A block's tile (kernels/conv_direct.py:Tiles): fb filters (a multiple of
// kRegFT), toh x tow output pixels (tow a multiple of kRegP), a stage of cc
// channels (a multiple of ks, or all C), ks channel groups
struct RegTile { int fb, toh, tow, cc, ks; };

// floats between two taps' weights in shared memory: fb, padded so that a
// warp's 8 filters x 4 taps of staging writes fall in 32 distinct banks
__host__ __device__ inline int reg_fbp(int fb) {
  return fb % 16 == 8 ? fb : fb + 8;
}
// floats of one staged channel: its taps' weights, then its input window
// (toh + K - 1 rows of tow + 4 columns: a row's last strip reads 8 values)
__host__ __device__ inline int reg_channel(const RegTile& t, int K) {
  return K * K * reg_fbp(t.fb) + (t.toh + K - 1) * (t.tow + 4);
}
// threads of one channel group: strips of kRegP pixels x filter groups
__host__ __device__ inline int reg_group(const RegTile& t) {
  return t.toh * (t.tow / kRegP) * (t.fb / kRegFT);
}

// one element global -> shared: f32 by a 4-byte cp.async (0 bytes read
// writes a zero), bf16 widened by a load and a store
__device__ __forceinline__ void stage1(float* dst, const float* src,
                                       bool ok) {
  cp_async4(smem_addr(dst), src, ok ? 4 : 0);
}
__device__ __forceinline__ void stage1(float* dst, const bf16* src, bool ok) {
  *dst = ok ? __bfloat162float(*src) : 0.f;
}

template <typename T, int K>
__global__ void __launch_bounds__(kRegMaxThreads, 2)
conv_reg_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const float* __restrict__ bias, T* __restrict__ out, int C,
                int H, int W, long sn, long sc, long sh, long sw, int F,
                int pad, int OH, int OW, int tiles_x, RegTile t) {
  static_assert(kRegP + K - 1 <= 8, "a tap row is two 16-byte loads");
  constexpr int KK = K * K;
  extern __shared__ __align__(16) float smem[];
  const int spr = t.tow / kRegP;         // strips a row
  const int strips = t.toh * spr;
  const int per_group = reg_group(t);
  const int fbp = reg_fbp(t.fb);
  const int wh = t.toh + K - 1, wwp = t.tow + 4, wwin = t.tow + K - 1;
  const int ws_c = KK * fbp, xs_c = wh * wwp;
  const int stage = t.cc * reg_channel(t, K);
  const int nthr = blockDim.x;

  const int n = blockIdx.z;
  const int f0 = blockIdx.y * t.fb;
  const int oy0 = (blockIdx.x / tiles_x) * t.toh;
  const int ox0 = (blockIdx.x % tiles_x) * t.tow;
  const int y0 = oy0 - pad, x0 = ox0 - pad;
  const T* xn = x + (long)n * sn;

  // thread -> (channel group g, filter group fgi, strip (r, cs))
  const int tid = threadIdx.x;
  const int g = tid / per_group, tig = tid % per_group;
  const int fgi = tig / strips, s = tig % strips;
  const int r = s / spr, cs = s % spr;
  const bool busy = tid < per_group * t.ks;

  float acc[kRegFT][kRegP];
#pragma unroll
  for (int f = 0; f < kRegFT; ++f)
#pragma unroll
    for (int p = 0; p < kRegP; ++p) acc[f][p] = 0.f;

  // channels [c0, c0 + cc) into stage b: weights [c][i*K+j][f] (lane l of
  // a warp copies filter l % 8 of each group of 8 at taps 4 * warp + l / 8,
  // + 4 * warps, ...: w is read along its taps, and a warp's 32 stores fall
  // in 32 banks), then the input windows [c][row][col]
  auto stage_chunk = [&](int c0, int b) {
    const int cc = min(t.cc, C - c0);
    float* ws = smem + (size_t)b * stage;
    float* xs = ws + (size_t)t.cc * ws_c;
    const int taps = cc * KK, lane = tid % 32;
    for (int f = lane % 8; f < t.fb; f += 8) {
      const bool ok = f0 + f < F;
      const T* src = w + ((long)(ok ? f0 + f : 0) * C + c0) * KK;
      for (int rr = (tid / 32) * 4 + lane / 8; rr < taps; rr += nthr / 8)
        stage1(ws + rr * fbp + f, src + rr, ok);
    }
    // the window, columns fastest; the row, column and channel of element
    // e advance by those of nthr (no division in the loop)
    const int dcol = nthr % wwp, drow = (nthr / wwp) % wh,
              dcl = nthr / (wwp * wh);
    int col = tid % wwp, row = (tid / wwp) % wh, cl = tid / (wwp * wh);
    for (int e = tid; cl < cc; e += nthr) {
      const int y = y0 + row, xx = x0 + col;
      const bool ok = col < wwin && y >= 0 && y < H && xx >= 0 && xx < W;
      stage1(xs + e,
             ok ? xn + (long)(c0 + cl) * sc + (long)y * sh + (long)xx * sw
                : xn, ok);
      col += dcol; row += drow; cl += dcl;
      if (col >= wwp) { col -= wwp; ++row; }
      if (row >= wh) { row -= wh; ++cl; }
    }
  };

  // the ring: chunk k + 1's copies fly while chunk k computes
  const int chunks = (C + t.cc - 1) / t.cc;
  stage_chunk(0, 0);
  cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    if (k + 1 < chunks) stage_chunk((k + 1) * t.cc, (k + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (busy) {
      const int cc = min(t.cc, C - k * t.cc);
      const float* ws = smem + (size_t)(k & 1) * stage;
      const float* xs = ws + (size_t)t.cc * ws_c;
      // a chunk starts at a multiple of ks: its channel cl is the global
      // channel k * cc + cl of group cl mod ks
      for (int cl = g; cl < cc; cl += t.ks) {
        const float* xr = xs + cl * xs_c + r * wwp + cs * kRegP;
        const float* wr = ws + cl * ws_c + fgi * kRegFT;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(xr + i * wwp);
          const float4 b = *reinterpret_cast<const float4*>(xr + i * wwp + 4);
          const float in[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const float* wt = wr + (i * K + j) * fbp;
            const float4 u = *reinterpret_cast<const float4*>(wt);
            const float4 v = *reinterpret_cast<const float4*>(wt + 4);
            const float wv[kRegFT] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
            for (int f = 0; f < kRegFT; ++f)
#pragma unroll
              for (int p = 0; p < kRegP; ++p)
                acc[f][p] = fmaf(wv[f], in[p + j], acc[f][p]);
          }
        }
      }
    }
    __syncthreads();   // every read of stage k & 1 is done
  }

  // the channel groups' sums, added in group order by group 0 (the stages
  // are free)
  if (t.ks > 1) {
    float* red = smem;   // [ks - 1][kRegAcc][per_group]
    if (busy && g > 0) {
#pragma unroll
      for (int q = 0; q < kRegAcc; ++q)
        red[((size_t)(g - 1) * kRegAcc + q) * per_group + tig] =
            acc[q / kRegP][q % kRegP];
    }
    __syncthreads();
    if (busy && g == 0) {
      for (int gg = 1; gg < t.ks; ++gg) {
#pragma unroll
        for (int q = 0; q < kRegAcc; ++q)
          acc[q / kRegP][q % kRegP] +=
              red[((size_t)(gg - 1) * kRegAcc + q) * per_group + tig];
      }
    }
  }
  if (!busy || g != 0) return;
  // a strip past the plane's last row or column writes nothing (a tile of
  // tow columns overhangs OW where OW > tow is no multiple of tow)
  const int oy = oy0 + r, ox = ox0 + cs * kRegP;
  if (oy >= OH || ox >= OW) return;
#pragma unroll
  for (int f = 0; f < kRegFT; ++f) {
    const int fo = f0 + fgi * kRegFT + f;
    if (fo >= F) break;
    float v[kRegP];
#pragma unroll
    for (int p = 0; p < kRegP; ++p) v[p] = acc[f][p];
    if (bias != nullptr) {
      const float bv = bias[fo];
#pragma unroll
      for (int p = 0; p < kRegP; ++p) v[p] += bv;
    }
    T* o = out + (((long)n * F + fo) * OH + oy) * OW + ox;
    if constexpr (sizeof(T) == 4) {
      if (OW % kRegP == 0) {
        // a whole strip inside the row (ox < OW, both multiples of kRegP),
        // 16-byte aligned (out is contiguous and aligned)
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        continue;
      }
    }
#pragma unroll
    for (int p = 0; p < kRegP; ++p)
      if (ox + p < OW) o[p] = from_f32<T>(v[p]);
  }
}

template <typename T, int K>
cudaError_t launch_reg(const void* x, const void* w, const void* bias,
                       void* out, int N, int C, int H, int W, long sn,
                       long sc, long sh, long sw, int F, int pad, int OH,
                       int OW, RegTile t, int threads, cudaStream_t s) {
  if (t.fb < kRegFT || t.fb % kRegFT || t.tow < kRegP || t.tow % kRegP ||
      t.toh < 1 || t.ks < 1 || t.cc < 1 || (t.cc % t.ks && t.cc < C) ||
      threads % 32 || threads > kRegMaxThreads ||
      reg_group(t) * t.ks > threads)
    return cudaErrorInvalidValue;
  const size_t stages = 2 * (size_t)t.cc * reg_channel(t, K);
  const size_t red = (size_t)(t.ks - 1) * kRegAcc * reg_group(t);
  const size_t smem = sizeof(float) * (stages > red ? stages : red);
  const int tiles_x = (OW + t.tow - 1) / t.tow;
  const long tiles = (long)((OH + t.toh - 1) / t.toh) * tiles_x;
  const int ftiles = (F + t.fb - 1) / t.fb;
  if (smem > kSmemMax || tiles > 0x7fffffffL || ftiles > 65535 || N > 65535)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        conv_reg_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((unsigned)tiles, (unsigned)ftiles, (unsigned)N);
  conv_reg_kernel<T, K><<<grid, threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<T*>(out), C, H, W, sn, sc,
      sh, sw, F, pad, OH, OW, tiles_x, t);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_reg_k(int K, const void* x, const void* w,
                         const void* bias, void* out, int N, int C, int H,
                         int W, long sn, long sc, long sh, long sw, int F,
                         int pad, int OH, int OW, RegTile t, int threads,
                         cudaStream_t s) {
  if (K == 5)
    return launch_reg<T, 5>(x, w, bias, out, N, C, H, W, sn, sc, sh, sw, F,
                            pad, OH, OW, t, threads, s);
  if (K == 3)
    return launch_reg<T, 3>(x, w, bias, out, N, C, H, W, sn, sc, sh, sw, F,
                            pad, OH, OW, t, threads, s);
  return cudaErrorInvalidValue;
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

// route "reg": the scalar route's arguments, then the tile (fb, toh, tow,
// cc, ks) and the block's threads; KH == KW in {3, 5} at stride 1, else
// refused (kernels/conv_direct.py:plan never sends another)
extern "C" int repro_conv2d_direct_reg(
    const void* x, const void* w, const void* bias, void* out, int N, int C,
    int H, int W, long long sn, long long sc, long long sh, long long sw,
    int F, int KH, int KW, int stride, int pad, int OH, int OW, int fb,
    int toh, int tow, int cc, int ks, int threads, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KH != KW || stride != 1) return (int)cudaErrorInvalidValue;
  const RegTile t{fb, toh, tow, cc, ks};
  if (dtype == kBF16)
    return (int)launch_reg_k<bf16>(KH, x, w, bias, out, N, C, H, W, sn, sc,
                                   sh, sw, F, pad, OH, OW, t, threads, s);
  if (dtype == kF32)
    return (int)launch_reg_k<float>(KH, x, w, bias, out, N, C, H, W, sn, sc,
                                    sh, sw, F, pad, OH, OW, t, threads, s);
  return (int)cudaErrorInvalidValue;
}
