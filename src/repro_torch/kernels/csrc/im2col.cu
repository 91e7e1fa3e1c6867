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
// image, no arithmetic.  So the design keeps every store coalesced and
// builds no padded copy: one thread per output element in a grid-stride
// loop, the flat index decomposed with p fastest, so neighbouring threads
// write neighbouring addresses along OH*OW and read the image at the pool
// stride; an out-of-plane tap is a 0 chosen in registers.
//
// The output is addressed by two strides (o_sn for n, o_sr for r; p has
// unit stride): (N, R, P) for the registered op, or (R, N*P) -- the batch
// flattened into the columns -- for the convolution's one GEMM
// (kernels/ops.py), which then needs no transpose copy.  The image is
// read by its four strides (a column-major blob from the paper's boundary
// mode is read in place).
//
// col2im, im2col's adjoint (the convolution's input gradient), stride 1:
// image element (n, c, y, x) = the sum over the in-range taps (i, j) of
// cols[n, c*KH*KW + i*KW + j, (y+pad-i)*OW + (x+pad-j)].  Replaces
// src/repro/kernels/im2col.py:col2im_pallas, which pads the (OH, OW) grid
// in VMEM so that each of the KH*KW shifts is a static slice, and adds
// them into an f32 accumulator.  On Hopper the scatter-add form would need
// atomics; the gather form needs none: one thread per image element (x
// fastest, so neighbouring threads read neighbouring columns), the taps
// summed in f32 in the TPU kernel's order (i outer, j inner) and rounded
// once to cols' dtype.  Bound by bytes: one read of cols' in-range taps
// (each belongs to exactly one output; a tap in the padding is read by
// none), one write of the image.  cols is read
// by three strides (c_sn, c_sr, c_sp for n, r and p), so the (N, R, P)
// layout of the registered op and the (R, N*P) product of the
// convolution's backward (c_sn = P, c_sr = N*P) are read in place.
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
