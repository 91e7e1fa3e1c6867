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

}  // namespace

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
