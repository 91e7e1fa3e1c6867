// Max pooling with argmax (Caffe's Pooling, pool: MAX): for every k x k
// window of the padded plane, its largest value and the int32 index
// row*WP + col of that value in the padded plane (WP = W + 2*pad).
//
// Replaces src/repro/kernels/pooling.py:maxpool_pallas, which pads the
// image with finfo(dtype).min in device memory, then, per (batch, channel
// block) grid cell, unrolls the window over strided VMEM slices, keeping
// the running best and its index with a strict '>' (the first maximum in
// row-major window order wins).  What bounds it on Hopper: bytes -- a read
// of the image and a write of the outputs, k*k compares per output.  One
// thread per output element in a grid-stride loop (neighbouring threads
// write neighbouring outputs); it visits its window in the same row-major
// order with the same strict '>', and an out-of-plane cell is a candidate
// of value finfo(dtype).min at its padded index, so ties and windows that
// lie wholly in the padding give JAX's argmax bit for bit without a padded
// copy.  Values are compared in f32 (exact for both storage types) and
// the winner is stored back unchanged.  The image is read by its four
// strides; the outputs are contiguous (N, C, OH, OW).
//
// The backward, for windows that do not overlap (stride >= k): pixel
// (y, x) of the unpadded plane lies at (y+pad, x+pad) of the padded one,
// in the one window (oy, ox) = ((y+pad)/stride, (x+pad)/stride) if that
// window exists (oy < OH, ox < OW), and gets that window's dy if the
// stored argmax is its own padded index, else 0.  Replaces
// src/repro/kernels/pooling.py:maxpool_bwd_pallas, which upsamples dy and
// the argmax by repeat and compares them with an iota of padded indices
// (a broadcast and a select, no scatter).  The same gather form here: one
// thread per input pixel, no atomics, the winner's dy copied unchanged
// (a tie went to the first maximum in the forward, so exactly one pixel
// of a window receives it).  Bound by bytes: a read of dy and the argmax,
// a write of the image.  dy and the argmax are read by their strides; the
// output is contiguous (N, C, H, W).  Overlapping windows (stride < k)
// would add several windows into one pixel: the wrapper refuses them and
// the ops layer takes the plain scatter, as JAX does.
#include "common.cuh"

namespace {
using namespace repro;

constexpr int kThreads = 256;
constexpr long kMaxBlocks = 32768;

// finfo(T).min, the padding value of the TPU kernel, as f32 (exact)
template <typename T> __device__ __forceinline__ float lowest();
template <> __device__ __forceinline__ float lowest<float>() {
  return __uint_as_float(0xff7fffffu);  // -3.4028235e38
}
template <> __device__ __forceinline__ float lowest<bf16>() {
  return __uint_as_float(0xff7f0000u);  // -3.3895314e38
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxpool_kernel(const T* __restrict__ x, T* __restrict__ out,
               int* __restrict__ arg, int N, int C, int H, int W, long sn,
               long sc, long sh, long sw, int k, int stride, int pad, int OH,
               int OW) {
  const long total = (long)N * C * OH * OW;
  const int WP = W + 2 * pad;
  const float neg = lowest<T>();
  for (long idx = (long)blockIdx.x * kThreads + threadIdx.x; idx < total;
       idx += (long)gridDim.x * kThreads) {
    const int ox = (int)(idx % OW);
    long t = idx / OW;
    const int oy = (int)(t % OH);
    t /= OH;
    const int c = (int)(t % C);
    const long n = t / C;
    const T* plane = x + n * sn + c * sc;
    float best = neg;
    int best_at = 0;
    for (int i = 0; i < k; ++i) {
      const int row = oy * stride + i;  // in the padded plane
      const int y = row - pad;
      for (int j = 0; j < k; ++j) {
        const int col = ox * stride + j;
        const int xx = col - pad;
        const float v = (y >= 0 && y < H && xx >= 0 && xx < W)
                            ? to_f32(plane[y * sh + xx * sw])
                            : neg;
        if ((i == 0 && j == 0) || v > best) {
          best = v;
          best_at = row * WP + col;
        }
      }
    }
    out[idx] = from_f32<T>(best);
    arg[idx] = best_at;
  }
}

template <typename T>
void launch(const void* x, void* out, int* arg, int N, int C, int H, int W,
            long sn, long sc, long sh, long sw, int k, int stride, int pad,
            int OH, int OW, cudaStream_t s) {
  const long total = (long)N * C * OH * OW;
  long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  maxpool_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), arg, N, C, H, W, sn,
      sc, sh, sw, k, stride, pad, OH, OW);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxpool_bwd_kernel(const T* __restrict__ dy, const int* __restrict__ arg,
                   T* __restrict__ out, int N, int C, int H, int W,
                   long d_sn, long d_sc, long d_sh, long d_sw, long a_sn,
                   long a_sc, long a_sh, long a_sw, int stride, int pad,
                   int OH, int OW) {
  const long total = (long)N * C * H * W;
  const int WP = W + 2 * pad;
  const T zero = from_f32<T>(0.f);
  for (long idx = (long)blockIdx.x * kThreads + threadIdx.x; idx < total;
       idx += (long)gridDim.x * kThreads) {
    const int x = (int)(idx % W);
    long t = idx / W;
    const int y = (int)(t % H);
    t /= H;
    const int c = (int)(t % C);
    const long n = t / C;
    const int py = y + pad, px = x + pad;
    const int oy = py / stride, ox = px / stride;
    T v = zero;
    if (oy < OH && ox < OW &&
        arg[n * a_sn + c * a_sc + oy * a_sh + ox * a_sw] == py * WP + px)
      v = dy[n * d_sn + c * d_sc + oy * d_sh + ox * d_sw];
    out[idx] = v;
  }
}

template <typename T>
void launch_bwd(const void* dy, const int* arg, void* out, int N, int C,
                int H, int W, long d_sn, long d_sc, long d_sh, long d_sw,
                long a_sn, long a_sc, long a_sh, long a_sw, int stride,
                int pad, int OH, int OW, cudaStream_t s) {
  const long total = (long)N * C * H * W;
  long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  maxpool_bwd_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(dy), arg, static_cast<T*>(out), N, C, H, W, d_sn,
      d_sc, d_sh, d_sw, a_sn, a_sc, a_sh, a_sw, stride, pad, OH, OW);
}

}  // namespace

// dy and argmax (N, C, OH, OW) by strides, out contiguous (N, C, H, W);
// stride >= k (non-overlapping windows)
extern "C" int repro_maxpool_bwd(const void* dy, const void* arg, void* out,
                                 int N, int C, int H, int W, long long d_sn,
                                 long long d_sc, long long d_sh,
                                 long long d_sw, long long a_sn,
                                 long long a_sc, long long a_sh,
                                 long long a_sw, int stride, int pad, int OH,
                                 int OW, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(arg);
  if (dtype == kBF16)
    launch_bwd<bf16>(dy, a, out, N, C, H, W, d_sn, d_sc, d_sh, d_sw, a_sn,
                     a_sc, a_sh, a_sw, stride, pad, OH, OW, s);
  else if (dtype == kF32)
    launch_bwd<float>(dy, a, out, N, C, H, W, d_sn, d_sc, d_sh, d_sw, a_sn,
                      a_sc, a_sh, a_sw, stride, pad, OH, OW, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int repro_maxpool(const void* x, void* out, void* arg, int N,
                             int C, int H, int W, long long sn, long long sc,
                             long long sh, long long sw, int k, int stride,
                             int pad, int OH, int OW, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* a = static_cast<int*>(arg);
  if (dtype == kBF16)
    launch<bf16>(x, out, a, N, C, H, W, sn, sc, sh, sw, k, stride, pad, OH,
                 OW, s);
  else if (dtype == kF32)
    launch<float>(x, out, a, N, C, H, W, sn, sc, sh, sw, k, stride, pad, OH,
                  OW, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
