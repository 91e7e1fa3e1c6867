// Row softmax and the fused softmax + cross-entropy (Caffe's Softmax and
// SoftmaxWithLoss), over the last axis of a (rows, V) matrix, f32 inside.
//
// Replaces src/repro/kernels/softmax_xent.py:softmax_pallas and
// softmax_xent_pallas, which hold a block of rows whole in VMEM (the grid
// over row blocks).  softmax: p = e / sum(e), e = exp(x - max), cast to the
// input's dtype.  softmax_xent: logp = (x - max) - lse, lse = log(sum(e)),
// probs = exp(logp) in the logits' dtype and, per row, nll = -logp[label]
// in f32, or 0 for a label outside [0, V) (the TPU kernel's one-hot never
// matches it); the caller takes the mean over all rows, as JAX's
// .mean() does outside its kernel.  Both are the same row reduction, so
// they share one kernel template.  What bounds them on Hopper: bytes at
// large V; at LeNet's (64, 10), launch latency.  One warp per row (8 rows
// per block): the lanes stride the row, the max and the sum are warp
// shuffles in f32, and the label's element is read directly.  No atomics;
// every row is written by its own warp.  The logits are read by their row
// and column strides (a column-major blob from the paper's boundary mode
// is read in place); probs are contiguous.
//
// softmax_xent's backward (replaces softmax_xent_bwd_pallas): dlogits =
// (p - [j == label]) * (1/B), in f32 and rounded once to p's dtype; a
// label outside [0, V) matches no column, so its row is p / B, as the TPU
// kernel's one-hot.  Bound by bytes (a read of p, a write of the same
// size); the same geometry, one warp per row, lanes striding the row, p
// read by its strides, the output contiguous (B, V).
#include "common.cuh"

namespace {
using namespace repro;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, bool kXent>
__global__ void __launch_bounds__(kThreads)
softmax_rows_kernel(const T* __restrict__ x,
                    const long long* __restrict__ labels,
                    T* __restrict__ probs, float* __restrict__ nll, int rows,
                    int V, long sr, long sc) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + (long)row * sr;
  float m = __int_as_float(0xff800000);  // -inf
  for (int v = lane; v < V; v += 32) m = fmaxf(m, to_f32(xr[v * sc]));
  m = warp_max(m);
  float s = 0.f;
  for (int v = lane; v < V; v += 32) s += expf(to_f32(xr[v * sc]) - m);
  s = warp_sum(s);
  T* pr = probs + (long)row * V;
  if (kXent) {
    const float lse = logf(s);
    for (int v = lane; v < V; v += 32)
      pr[v] = from_f32<T>(expf((to_f32(xr[v * sc]) - m) - lse));
    if (lane == 0) {
      const long long y = labels[row];
      nll[row] = (y >= 0 && y < V) ? -((to_f32(xr[y * sc]) - m) - lse)
                                   : 0.f;
    }
  } else {
    for (int v = lane; v < V; v += 32)
      pr[v] = from_f32<T>(expf(to_f32(xr[v * sc]) - m) / s);
  }
}

template <typename T>
void launch(const void* x, const long long* labels, void* probs, float* nll,
            int rows, int V, long sr, long sc, cudaStream_t s) {
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  if (labels)
    softmax_rows_kernel<T, true><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), labels, static_cast<T*>(probs), nll, rows,
        V, sr, sc);
  else
    softmax_rows_kernel<T, false><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), nullptr, static_cast<T*>(probs), nullptr,
        rows, V, sr, sc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const T* __restrict__ p, const long long* __restrict__ labels,
                T* __restrict__ out, int rows, int V, long sr, long sc,
                float scale) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const T* pr = p + (long)row * sr;
  T* o = out + (long)row * V;
  const long long y = labels[row];
  for (int v = lane; v < V; v += 32)
    o[v] = from_f32<T>((to_f32(pr[v * sc]) - (v == y ? 1.f : 0.f)) * scale);
}

}  // namespace

// probs (rows, V) by strides, labels int64, out contiguous; scale = 1/B
extern "C" int repro_softmax_xent_bwd(const void* probs, const void* labels,
                                      void* out, int rows, int V,
                                      long long sr, long long sc,
                                      float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* y = static_cast<const long long*>(labels);
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  if (dtype == kBF16)
    xent_bwd_kernel<bf16><<<blocks, kThreads, 0, s>>>(
        static_cast<const bf16*>(probs), y, static_cast<bf16*>(out), rows, V,
        sr, sc, scale);
  else if (dtype == kF32)
    xent_bwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(probs), y, static_cast<float*>(out), rows,
        V, sr, sc, scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// labels == nullptr: softmax (nll unused); else softmax_xent, labels int64
extern "C" int repro_softmax_rows(const void* x, const void* labels,
                                  void* probs, void* nll, int rows, int V,
                                  long long sr, long long sc, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* y = static_cast<const long long*>(labels);
  float* out_nll = static_cast<float*>(nll);
  if (dtype == kBF16)
    launch<bf16>(x, y, probs, out_nll, rows, V, sr, sc, s);
  else if (dtype == kF32)
    launch<float>(x, y, probs, out_nll, rows, V, sr, sc, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
