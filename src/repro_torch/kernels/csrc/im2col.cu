// im2col (Caffe's Convolution, the paper's merged penta-loop): an NCHW
// image to its column matrix.  Output element (n, r, p), with row
// r = c*KH*KW + i*KW + j and column p = oy*OW + ox, is
// x[n, c, oy*stride + i - pad, ox*stride + j - pad], or 0 outside the
// plane.
//
// Replaces src/repro/kernels/im2col.py:im2col_pallas, which pads the image
// in device memory (jnp.pad), then, per (batch, channel block) grid cell,
// slices the padded plane KH*KW times in VMEM.  What bounds it on Hopper:
// bytes -- one write of the KH*KW-times larger output and a read of the
// image, no arithmetic.  No padded copy is made in device memory.
//
// The output is addressed by two strides (o_sn for n, o_sr for r; p has
// unit stride): (N, R, P) for the registered op, or (R, N*P) -- the batch
// flattened into the columns -- for the convolution's one GEMM
// (kernels/ops.py), which then needs no transpose copy.  The image is
// read by its four strides (a column-major blob from the paper's boundary
// mode is read in place).  Two routes, picked by
// kernels/im2col.py:im2col_plan from the window, the stride and the
// extents:
//
// * "band" (repro_im2col_band): the 5 x 5 and 3 x 3 windows at stride 1
//   (every LeNet convolution) with every offset under 2^31.  A block owns
//   a band of `rows` output rows (blockIdx.x; kernels/im2col.py:
//   im2col_band splits a plane where the planes alone would not fill the
//   card) of one (n, c) plane (blockIdx.z, blockIdx.y).  It stages the
//   input rows its windows touch in shared memory once, the padding
//   written as zeros, read by the image's strides (neighbouring threads on
//   neighbouring columns), each thread's loads all issued before its first
//   shared store.  Then a thread owns VE output columns -- one 16-byte
//   vector (4 f32, 8 bf16) where the rows' stride keeps vectors aligned,
//   else one column -- works out their band offsets
//   once, and writes all KH*KW tap rows of them from shared memory: the
//   index arithmetic runs once per KH*KW outputs, in 32 bits, with no
//   division in the tap loop (the window is a template parameter, so the
//   loop unrolls to constant offsets).  The vectors are aligned in the
//   output row, not in the image's segment: in the (R, N*P) layout image
//   n's segment starts at n*P, which an odd P leaves off the 16-byte grid,
//   so the vector that straddles a segment's (or a band's) edge is written
//   element by element, each element by the block that owns it, and no
//   store leaves its block's part of its row.
// * "flat" (repro_im2col): every other window or stride, or offsets past
//   2^31.  The first port's kernel: one thread per output element in a
//   grid-stride loop, the flat index decomposed with p fastest (64-bit
//   divisions), an out-of-plane tap a 0 chosen in registers.
//
// col2im, im2col's adjoint (the convolution's input gradient), stride 1:
// image element (n, c, y, x) = the sum over the in-range taps (i, j) of
// cols[n, c*KH*KW + i*KW + j, (y+pad-i)*OW + (x+pad-j)].  Replaces
// src/repro/kernels/im2col.py:col2im_pallas, which pads the (OH, OW) grid
// in VMEM so that each of the KH*KW shifts is a static slice, and adds
// them into an f32 accumulator.  On Hopper the scatter-add form would need
// atomics; the gather form needs none: one thread per image element, the
// taps summed in f32 in the TPU kernel's order (i outer, j inner, a tap in
// the padding adding 0) and rounded once to cols' dtype.  Bound by bytes:
// one read of cols' in-range taps (each belongs to exactly one output; a
// tap in the padding is read by none), one write of the image.  cols is
// read by three strides (c_sn, c_sr, c_sp for n, r and p), so the
// (N, R, P) layout of the registered op and the (R, N*P) product of the
// convolution's backward (c_sn = P, c_sr = N*P) are read in place.  Two
// routes, picked by kernels/im2col.py:col2im_plan:
//
// * "tile" (repro_col2im_tile): 5 x 5 and 3 x 3 windows with every offset
//   under 2^31.  A block owns `rows` image rows of one (n, c) plane
//   (kernels/im2col.py:col2im_tile); the window is a template
//   parameter, so each thread issues all of its KH*KW in-range loads
//   before the first add, with 32-bit indices.  The sum's order is the
//   flat kernel's (an add of 0 leaves an f32 sum that started at +0
//   unchanged), so the two routes agree bit for bit.
// * "flat" (repro_col2im): other windows or extents.  The first port's
//   kernel: one thread per image element in a grid-stride loop (64-bit
//   divisions), the taps walked under runtime bounds.
#include "common.cuh"

namespace {
using namespace repro;

constexpr int kThreads = 256;
constexpr long kMaxBlocks = 32768;

template <typename T>
__global__ void __launch_bounds__(kThreads)
im2col_kernel(const T* __restrict__ x, T* __restrict__ out, int N, int C,
              int H, int W, long sn, long sc, long sh, long sw, int KH,
              int KW, int stride, int pad, int OH, int OW, long o_sn,
              long o_sr) {
  const long P = (long)OH * OW;
  const long R = (long)C * KH * KW;
  const long total = (long)N * R * P;
  const T zero = from_f32<T>(0.f);
  for (long idx = (long)blockIdx.x * kThreads + threadIdx.x; idx < total;
       idx += (long)gridDim.x * kThreads) {
    const long p = idx % P;
    const long t = idx / P;
    const int r = (int)(t % R);
    const long n = t / R;
    const int c = r / (KH * KW);
    const int ij = r - c * KH * KW;
    const int i = ij / KW, j = ij - (ij / KW) * KW;
    const int oy = (int)(p / OW), ox = (int)(p - (long)(p / OW) * OW);
    const int y = oy * stride + i - pad, xx = ox * stride + j - pad;
    T v = zero;
    if (y >= 0 && y < H && xx >= 0 && xx < W)
      v = x[n * sn + c * sc + y * sh + xx * sw];
    out[n * o_sn + r * o_sr + p] = v;
  }
}

template <typename T>
void launch(const void* x, void* out, int N, int C, int H, int W, long sn,
            long sc, long sh, long sw, int KH, int KW, int stride, int pad,
            int OH, int OW, long o_sn, long o_sr, cudaStream_t s) {
  const long total = (long)N * C * KH * KW * OH * OW;
  long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  im2col_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), N, C, H, W, sn, sc,
      sh, sw, KH, KW, stride, pad, OH, OW, o_sn, o_sr);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
col2im_kernel(const T* __restrict__ cols, T* __restrict__ out, int N, int C,
              int H, int W, int KH, int KW, int pad, int OH, int OW,
              long c_sn, long c_sr, long c_sp) {
  const long total = (long)N * C * H * W;
  for (long idx = (long)blockIdx.x * kThreads + threadIdx.x; idx < total;
       idx += (long)gridDim.x * kThreads) {
    const int x = (int)(idx % W);
    long t = idx / W;
    const int y = (int)(t % H);
    t /= H;
    const int c = (int)(t % C);
    const long n = t / C;
    const T* base = cols + n * c_sn + (long)c * KH * KW * c_sr;
    float acc = 0.f;
    for (int i = 0; i < KH; ++i) {
      const int oy = y + pad - i;
      if (oy < 0 || oy >= OH) continue;
      for (int j = 0; j < KW; ++j) {
        const int ox = x + pad - j;
        if (ox < 0 || ox >= OW) continue;
        acc += to_f32(base[(long)(i * KW + j) * c_sr
                           + ((long)oy * OW + ox) * c_sp]);
      }
    }
    out[idx] = from_f32<T>(acc);
  }
}

template <typename T>
void launch_col2im(const void* cols, void* out, int N, int C, int H, int W,
                   int KH, int KW, int pad, int OH, int OW, long c_sn,
                   long c_sr, long c_sp, cudaStream_t s) {
  const long total = (long)N * C * H * W;
  long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  col2im_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(cols), static_cast<T*>(out), N, C, H, W, KH, KW,
      pad, OH, OW, c_sn, c_sr, c_sp);
}


// the "band" and "tile" kernels' most threads a block
// (kernels/im2col.py:BAND_MAX_THREADS, TILE_MAX_THREADS), and the most
// bytes of the band's staged rows (BAND_SMEM): dynamic shared memory
// within the 48 KB a block takes without an opt-in (neither kernel has
// static shared memory)
constexpr int kBandMaxThreads = 512;
constexpr int kBandSmem = 48 * 1024;
constexpr int kTileMaxThreads = 512;
// staged cells a "band" thread loads before it stores any: a band of up
// to kStage cells a thread (every LeNet band) takes one round of
// device-memory latency
constexpr int kStage = 8;

// VE elements of T, aligned as a whole: one 16-byte store where
// VE * sizeof(T) is 16 (the caller vouches for the address)
template <typename T, int VE>
struct alignas(VE * sizeof(T)) Pack {
  T v[VE];
};

// KH x KW window at stride S; VE output columns a thread (Vec<T>::N with
// 16-byte stores, or 1).  Grid: (bands of `rows` output rows, C, N).
// Shared memory: the band's rin staged rows of wpu = (OW-1)*S + KW padded
// columns, in T.
template <typename T, int KH, int KW, int S, int VE>
__global__ void __launch_bounds__(kBandMaxThreads)
im2col_band_kernel(const T* __restrict__ x, T* __restrict__ out, int H,
                   int W, int sn, int sc, int sh, int sw, int pad, int OH,
                   int OW, int o_sn, int o_sr, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* band = reinterpret_cast<T*>(smem_raw);
  constexpr int KK = KH * KW;
  const int n = blockIdx.z, c = blockIdx.y;
  const int oy0 = blockIdx.x * rows;
  const int ra = min(rows, OH - oy0);
  const int rin = (ra - 1) * S + KH;
  const int wpu = (OW - 1) * S + KW;
  const int y0 = oy0 * S - pad;  // the image row of staged row 0
  const int cells = rin * wpu;
  const T zero = from_f32<T>(0.f);
  const T* xb = x + n * sn + c * sc;
  for (int t0 = threadIdx.x; t0 < cells; t0 += kStage * blockDim.x) {
    T v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int t = t0 + u * blockDim.x;
      const int yy = t / wpu;
      const int y = y0 + yy, xx = t - yy * wpu - pad;
      v[u] = (t < cells && y >= 0 && y < H && xx >= 0 && xx < W)
                 ? xb[y * sh + xx * sw]
                 : zero;
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u)
      if (t0 + u * blockDim.x < cells) band[t0 + u * blockDim.x] = v[u];
  }
  __syncthreads();
  // the block's columns p_lo .. p_hi - 1 of image n sit at q = n*o_sn + p
  // of each output row; the threads take the VE-aligned groups of q that
  // meet them
  const int p_lo = oy0 * OW, p_hi = p_lo + ra * OW;
  const int qb = n * o_sn;
  const int g0 = (qb + p_lo) / VE;
  const int groups = (qb + p_hi + VE - 1) / VE - g0;
  T* const rows_c = out + c * KK * o_sr;  // tap row 0 of channel c
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int col = (g0 + g) * VE;  // q of the group's first element
    const int p0 = col - qb;
    const int pc = max(p0, p_lo);   // the first column the block owns
    int oy = pc / OW, ox = pc - oy * OW;
    const int first = (oy - oy0) * S * wpu + ox * S;
    int off[VE];
    bool ok[VE];
    bool whole = true;
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const int p = p0 + e;
      ok[e] = p >= p_lo && p < p_hi;
      whole = whole && ok[e];
      off[e] = ok[e] ? (oy - oy0) * S * wpu + ox * S : first;
      if (ok[e] && ++ox == OW) {
        ox = 0;
        ++oy;
      }
    }
#pragma unroll
    for (int i = 0; i < KH; ++i) {
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        Pack<T, VE> v;
#pragma unroll
        for (int e = 0; e < VE; ++e) v.v[e] = band[off[e] + i * wpu + j];
        T* d = rows_c + (i * KW + j) * o_sr + col;
        if (whole) {
          if constexpr (VE * sizeof(T) == 16)
            *reinterpret_cast<uint4*>(d) =
                *reinterpret_cast<const uint4*>(&v);
          else
            *reinterpret_cast<Pack<T, VE>*>(d) = v;
        } else {
#pragma unroll
          for (int e = 0; e < VE; ++e)
            if (ok[e]) d[e] = v.v[e];
        }
      }
    }
  }
}

template <typename T, int KH, int KW, int S>
cudaError_t launch_band_k(const void* x, void* out, int N, int C, int H,
                          int W, int sn, int sc, int sh, int sw, int pad,
                          int OH, int OW, int o_sn, int o_sr, int rows,
                          int threads, bool vec, cudaStream_t s) {
  const dim3 grid((OH + rows - 1) / rows, C, N);
  const int smem =
      ((rows - 1) * S + KH) * ((OW - 1) * S + KW) * (int)sizeof(T);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (vec)
    im2col_band_kernel<T, KH, KW, S, Vec<T>::N><<<grid, threads, smem, s>>>(
        xp, op, H, W, sn, sc, sh, sw, pad, OH, OW, o_sn, o_sr, rows);
  else
    im2col_band_kernel<T, KH, KW, S, 1><<<grid, threads, smem, s>>>(
        xp, op, H, W, sn, sc, sh, sw, pad, OH, OW, o_sn, o_sr, rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_band(const void* x, void* out, int N, int C, int H, int W,
                        int sn, int sc, int sh, int sw, int KH, int KW,
                        int stride, int pad, int OH, int OW, int o_sn,
                        int o_sr, int rows, int threads, int vec,
                        cudaStream_t s) {
  const long long smem = (long long)((rows - 1) * stride + KH) *
                         ((OW - 1) * stride + KW) * (long long)sizeof(T);
  // what the kernel assumes: its grid within CUDA's limits, the band in
  // the 48 KB, aligned vectors in every output row
  if (rows < 1 || rows > OH || threads < 32 || threads % 32 ||
      threads > kBandMaxThreads || smem > kBandSmem || C > 65535 ||
      N > 65535 ||
      (vec && (o_sr % Vec<T>::N ||
               reinterpret_cast<uintptr_t>(out) % 16)))
    return cudaErrorInvalidValue;
  const bool v = vec != 0;
  if (KH == 5 && KW == 5 && stride == 1)
    return launch_band_k<T, 5, 5, 1>(x, out, N, C, H, W, sn, sc, sh, sw, pad,
                                     OH, OW, o_sn, o_sr, rows, threads, v, s);
  if (KH == 3 && KW == 3 && stride == 1)
    return launch_band_k<T, 3, 3, 1>(x, out, N, C, H, W, sn, sc, sh, sw, pad,
                                     OH, OW, o_sn, o_sr, rows, threads, v, s);
  return cudaErrorInvalidValue;  // not instantiated: the planner's "flat"
}

// KH x KW window, stride 1.  Grid: (bands of `rows` image rows, C, N); a
// thread per image element, x fastest.
template <typename T, int KH, int KW>
__global__ void __launch_bounds__(kTileMaxThreads)
col2im_tile_kernel(const T* __restrict__ cols, T* __restrict__ out, int C,
                   int H, int W, int pad, int OH, int OW, int c_sn,
                   int c_sr, int c_sp, int rows) {
  constexpr int KK = KH * KW;
  const int n = blockIdx.z, c = blockIdx.y;
  const int y0 = blockIdx.x * rows;
  const int ra = min(rows, H - y0);
  const T* base = cols + n * c_sn + c * KK * c_sr;
  for (int e = threadIdx.x; e < ra * W; e += blockDim.x) {
    const int yl = e / W;
    const int y = y0 + yl, xx = e - yl * W;
    float v[KK];
#pragma unroll
    for (int i = 0; i < KH; ++i) {
      const int oy = y + pad - i;
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        const int ox = xx + pad - j;
        v[i * KW + j] = (oy >= 0 && oy < OH && ox >= 0 && ox < OW)
                            ? to_f32(base[(i * KW + j) * c_sr +
                                          (oy * OW + ox) * c_sp])
                            : 0.f;
      }
    }
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < KK; ++t) acc += v[t];
    out[((n * C + c) * H + y) * W + xx] = from_f32<T>(acc);
  }
}

template <typename T>
cudaError_t launch_tile(const void* cols, void* out, int N, int C, int H,
                        int W, int KH, int KW, int pad, int OH, int OW,
                        int c_sn, int c_sr, int c_sp, int rows, int threads,
                        cudaStream_t s) {
  if (rows < 1 || rows > H || threads < 32 || threads % 32 ||
      threads > kTileMaxThreads || C > 65535 || N > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((H + rows - 1) / rows, C, N);
  const T* cp = static_cast<const T*>(cols);
  T* op = static_cast<T*>(out);
  if (KH == 5 && KW == 5)
    col2im_tile_kernel<T, 5, 5><<<grid, threads, 0, s>>>(
        cp, op, C, H, W, pad, OH, OW, c_sn, c_sr, c_sp, rows);
  else if (KH == 3 && KW == 3)
    col2im_tile_kernel<T, 3, 3><<<grid, threads, 0, s>>>(
        cp, op, C, H, W, pad, OH, OW, c_sn, c_sr, c_sp, rows);
  else
    return cudaErrorInvalidValue;  // not instantiated: the planner's "flat"
  return cudaGetLastError();
}

}  // namespace

// cols by the strides of n, r and p; out contiguous (N, C, H, W); stride 1
extern "C" int repro_col2im(const void* cols, void* out, int N, int C, int H,
                            int W, int KH, int KW, int pad, int OH, int OW,
                            long long c_sn, long long c_sr, long long c_sp,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    launch_col2im<bf16>(cols, out, N, C, H, W, KH, KW, pad, OH, OW, c_sn,
                        c_sr, c_sp, s);
  else if (dtype == kF32)
    launch_col2im<float>(cols, out, N, C, H, W, KH, KW, pad, OH, OW, c_sn,
                         c_sr, c_sp, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int repro_im2col(const void* x, void* out, int N, int C, int H,
                            int W, long long sn, long long sc, long long sh,
                            long long sw, int KH, int KW, int stride,
                            int pad, int OH, int OW, long long o_sn,
                            long long o_sr, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    launch<bf16>(x, out, N, C, H, W, sn, sc, sh, sw, KH, KW, stride, pad,
                 OH, OW, o_sn, o_sr, s);
  else if (dtype == kF32)
    launch<float>(x, out, N, C, H, W, sn, sc, sh, sw, KH, KW, stride, pad,
                  OH, OW, o_sn, o_sr, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// route "band": x read by its four strides, out by o_sn and o_sr (p unit
// stride), every offset under 2^31 (kernels/im2col.py:im2col_plan); a
// block's output rows and threads and the 16-byte stores from
// kernels/im2col.py:im2col_band.  A window or stride not instantiated
// (5 x 5 and 3 x 3 at stride 1) is refused, not run on the flat kernel.
extern "C" int repro_im2col_band(const void* x, void* out, int N, int C,
                                 int H, int W, int sn, int sc, int sh,
                                 int sw, int KH, int KW, int stride, int pad,
                                 int OH, int OW, int o_sn, int o_sr,
                                 int rows, int threads, int vec, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return (int)launch_band<bf16>(x, out, N, C, H, W, sn, sc, sh, sw, KH, KW,
                                  stride, pad, OH, OW, o_sn, o_sr, rows,
                                  threads, vec, s);
  if (dtype == kF32)
    return (int)launch_band<float>(x, out, N, C, H, W, sn, sc, sh, sw, KH,
                                   KW, stride, pad, OH, OW, o_sn, o_sr, rows,
                                   threads, vec, s);
  return (int)cudaErrorInvalidValue;
}

// route "tile", stride 1: cols by the strides of n, r and p, every offset
// under 2^31 (kernels/im2col.py:col2im_plan); out contiguous (N, C, H, W);
// a block's image rows and threads from kernels/im2col.py:col2im_tile.  A
// window not instantiated (5 x 5, 3 x 3) is refused.
extern "C" int repro_col2im_tile(const void* cols, void* out, int N, int C,
                                 int H, int W, int KH, int KW, int pad,
                                 int OH, int OW, int c_sn, int c_sr,
                                 int c_sp, int rows, int threads, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return (int)launch_tile<bf16>(cols, out, N, C, H, W, KH, KW, pad, OH, OW,
                                  c_sn, c_sr, c_sp, rows, threads, s);
  if (dtype == kF32)
    return (int)launch_tile<float>(cols, out, N, C, H, W, KH, KW, pad, OH,
                                   OW, c_sn, c_sr, c_sp, rows, threads, s);
  return (int)cudaErrorInvalidValue;
}
