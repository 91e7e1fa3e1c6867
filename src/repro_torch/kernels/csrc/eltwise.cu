// Bias over rows (the paper's matrixPlusVectorRows functor):
// out[i, :] = m[i, :] + v, added in f32 and rounded to the storage dtype.
//
// Replaces src/repro/kernels/eltwise.py:bias_add_rows_pallas ((bm, bn)
// VMEM tiles).  What bounds it on Hopper: bytes -- one read of m and v, one
// write of out, one add per element.  A grid-stride loop with one thread
// per element; neighbouring threads touch neighbouring addresses.
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

}  // namespace

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
