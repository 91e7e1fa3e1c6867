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

}  // namespace

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
