// Elementwise kernels of src/repro/kernels/eltwise.py.  What bounds them
// on Hopper: bytes -- one read of each input, one write of the output, one
// operation per element.  Each is a grid-stride loop with one thread per
// element; neighbouring threads touch neighbouring addresses.
//
// * Bias over rows (the paper's matrixPlusVectorRows functor): out[i, :] =
//   m[i, :] + v, added in f32 and rounded to the storage dtype.  Replaces
//   bias_add_rows_pallas ((bm, bn) VMEM tiles).
// * Caffe's leaky-capable ReLU: out = x > 0 ? x : slope * x, the product
//   in f32 rounded to the storage dtype (x itself is passed through).
//   Replaces relu_pallas (tiles of the flattened tensor).  It walks the
//   storage in memory order, so any dense layout (a column-major blob of
//   the paper's boundary mode too) is read in place and the output keeps
//   the input's strides.
// * ReLU's backward: dx = x > 0 ? dy : slope * dy (a NaN in x takes the
//   slope, as x > 0 is false), the product in f32 rounded to the storage
//   dtype.  Replaces relu_bwd_pallas.  x, dy and dx may each have their
//   own layout (in the paper's transposed boundary mode a column-major x
//   meets the row-major gradient of the next layer's crossing), so the
//   kernel walks the logical index, fastest along the last axis, and
//   addresses each of the three by its own strides (up to 4 axes); dx
//   keeps x's layout.
#include "common.cuh"

namespace {
using namespace repro;

constexpr int kThreads = 256;
constexpr long kMaxBlocks = 4096;

template <typename T>
__global__ void __launch_bounds__(kThreads)
bias_add_rows_kernel(const T* __restrict__ m, const T* __restrict__ v,
                     T* __restrict__ out, int M, int N, long ldm) {
  const long total = (long)M * N;
  for (long i = (long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (long)gridDim.x * kThreads) {
    const long r = i / N, col = i % N;
    out[i] = from_f32<T>(to_f32(m[r * ldm + col]) + to_f32(v[col]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
relu_kernel(const T* __restrict__ x, T* __restrict__ out, long n,
            float slope) {
  for (long i = (long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long)gridDim.x * kThreads) {
    const T v = x[i];
    const float f = to_f32(v);
    out[i] = f > 0.f ? v : from_f32<T>(slope * f);
  }
}

// up to 4 axes, the leading ones padded with extent 1
struct Shape4 { long d1, d2, d3; };
struct Strides4 { long s0, s1, s2, s3; };

__device__ __forceinline__ long offset4(long i0, long i1, long i2, long i3,
                                        const Strides4& s) {
  return i0 * s.s0 + i1 * s.s1 + i2 * s.s2 + i3 * s.s3;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
relu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                T* __restrict__ dx, long n, Shape4 d, Strides4 xs,
                Strides4 ys, Strides4 os, float slope) {
  for (long i = (long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long)gridDim.x * kThreads) {
    const long i3 = i % d.d3;
    long t = i / d.d3;
    const long i2 = t % d.d2;
    t /= d.d2;
    const long i1 = t % d.d1;
    const long i0 = t / d.d1;
    const T g = dy[offset4(i0, i1, i2, i3, ys)];
    dx[offset4(i0, i1, i2, i3, os)] =
        to_f32(x[offset4(i0, i1, i2, i3, xs)]) > 0.f
            ? g : from_f32<T>(slope * to_f32(g));
  }
}

}  // namespace

// shape (d0 implied by n), then the strides of x, dy and dx, 4 each
extern "C" int repro_relu_bwd(const void* x, const void* dy, void* dx,
                              long long n, long long d1, long long d2,
                              long long d3, long long xs0, long long xs1,
                              long long xs2, long long xs3, long long ys0,
                              long long ys1, long long ys2, long long ys3,
                              long long os0, long long os1, long long os2,
                              long long os3, float slope, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid((unsigned)blocks), block(kThreads);
  const Shape4 d{d1, d2, d3};
  const Strides4 xs{xs0, xs1, xs2, xs3}, ys{ys0, ys1, ys2, ys3},
      os{os0, os1, os2, os3};
  if (dtype == kBF16)
    relu_bwd_kernel<bf16><<<grid, block, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
        static_cast<bf16*>(dx), n, d, xs, ys, os, slope);
  else if (dtype == kF32)
    relu_bwd_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        static_cast<float*>(dx), n, d, xs, ys, os, slope);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int repro_relu(const void* x, void* out, long long n,
                          float slope, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid((unsigned)blocks), block(kThreads);
  if (dtype == kBF16)
    relu_kernel<bf16><<<grid, block, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<bf16*>(out), n, slope);
  else if (dtype == kF32)
    relu_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, slope);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int repro_bias_add_rows(const void* m, const void* v, void* out,
                                   int M, int N, long long ldm, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long total = (long)M * N;
  long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid((unsigned)blocks), block(kThreads);
  if (dtype == kBF16)
    bias_add_rows_kernel<bf16><<<grid, block, 0, s>>>(
        static_cast<const bf16*>(m), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), M, N, ldm);
  else if (dtype == kF32)
    bias_add_rows_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(m), static_cast<const float*>(v),
        static_cast<float*>(out), M, N, ldm);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
