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
// is read in place); probs are contiguous.  softmax and softmax_xent take
// this kernel as their route "strided" (rows of non-unit stride, a base off
// 16 bytes), softmax_xent then takes the mean with a second kernel
// (torch's .mean() in the wrapper).
//
// softmax's route "rows" (repro_softmax_reg; kernels/softmax_xent.py:
// softmax_plan, softmax_rows): rows of unit stride.  Each row is read
// once, into registers: TPR threads serve a row (a power of two; under 32
// a sub-warp, so that a warp serves several narrow rows; above, whole
// warps whose max and sum meet in shared memory), each holding up to
// kPer items -- 16-byte vectors where the base, the row stride and V are
// whole vectors, else single elements (V = 10: 40 or 20 bytes a row).
// The max and the sum are shuffle trees over the row's lanes, exp is
// computed once per element and kept, and p = e / sum(e) (a division, as
// JAX's) is stored from the registers.  A row of -inf gives NaN, as the
// plain version (exp(-inf - -inf)).
//
// softmax_xent's route "rows" (repro_softmax_xent_reg; kernels/
// softmax_xent.py:softmax_xent_plan, softmax_xent_rows): the same kernel,
// a template flag apart.  It keeps s = x - max in the registers, takes lse
// = log(sum(exp(s))) by the same shuffle tree, computes logp = s - lse once
// per element and stores exp(logp); the lane that holds the label's
// element writes the row's -logp to shared memory (lane 0 writes 0 for a
// label outside [0, V)).  The mean is fused, in a fixed order and with no
// atomics: warp 0 sums the block's rows (lane l rows l, l + 32, ... in
// order, then the xor tree).  Where the planner fits the whole batch in one
// block (LeNet's 64 x 10: 8 lanes a row, 2 elements a lane, 512 threads)
// that block divides by B and writes the f32 loss: one launch, no (B,) NLL
// tensor.  Past one block each block writes its partial and a one-block
// second kernel (xent_mean_kernel) sums them in block order and divides by
// B: two launches.  At LeNet's sizes the loss is launch latency, so the
// one-block grid is the point: the first kernel plus torch's mean took two
// launches (0.0096 ms at 64 x 10 on the H100, chip_smoke.py phase 3).
//
// softmax_xent's backward (replaces softmax_xent_bwd_pallas): t = (p -
// [j == label]) * (1/B), in f32 and rounded once to p's dtype; a label
// outside [0, V) matches no column, so its row is p / B, as the TPU
// kernel's one-hot.  The loss's cotangent g (an f32 scalar read from device
// memory, no host sync) is folded in: out = round(float(t) * float(g_T)),
// g_T being g rounded to T as torch's multiply rounds a 0-d operand, the
// roundings of the kernel-then-`* g` composition that JAX runs outside its
// kernel (repro/kernels/ops.py:_xent_p_bwd), so the result is the port's
// composition on the card bit for bit, in one launch; with no g (NULL) the
// kernel writes t, JAX's kernel function.  Bound by bytes (a read of p, a write of
// the same size); at LeNet's 64 x 10, launch latency.  Two routes
// (kernels/softmax_xent.py:softmax_xent_bwd_plan):
//   "strided" (repro_softmax_xent_bwd): the first port's geometry, one warp
//   per row, lanes striding the row, p read by its strides;
//   "rows" (repro_softmax_xent_bwd_reg): p's rows of unit stride on a
//   16-byte aligned base, packed by sub-warps of tpr lanes as the forward's
//   register rows (softmax_xent_bwd_rows: LeNet's whole batch in one block,
//   8 lanes of 2 elements a row), every lane's items loaded (16-byte
//   vectors where whole) before its first store.
// Both write a contiguous (B, V).
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

// the cotangent as the composition's multiply takes it: torch's product of
// a T tensor and an f32 0-d tensor on the card rounds the 0-d operand to T
// first (bf16: 1.7 -> 1.703125); 1 where the caller gave none
template <typename T>
__device__ __forceinline__ float xent_g(const float* g) {
  return g ? to_f32(from_f32<T>(__ldg(g))) : 1.f;
}

// the backward's value at column c of a row whose label is y and element
// p: t = (p - onehot) * scale rounded to T, then times g (xent_g) in f32,
// exact for bf16 operands, so one rounding as torch's; g = 1 gives t
template <typename T>
__device__ __forceinline__ float xent_grad(float p, int c, long long y,
                                           float scale, float g) {
  return to_f32(from_f32<T>((p - (c == y ? 1.f : 0.f)) * scale)) * g;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const T* __restrict__ p, const long long* __restrict__ labels,
                const float* __restrict__ g, T* __restrict__ out, int rows,
                int V, long sr, long sc, float scale) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const T* pr = p + (long)row * sr;
  T* o = out + (long)row * V;
  const long long y = labels[row];
  const float gv = xent_g<T>(g);
  for (int v = lane; v < V; v += 32)
    o[v] = from_f32<T>(xent_grad<T>(to_f32(pr[v * sc]), v, y, scale, gv));
}

// ---------------------------------------------------------------------------
// softmax, route "rows"
// ---------------------------------------------------------------------------

constexpr int kRowsMaxThreads = 512;

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(bf16* p, const float (&v)[8]) {
  uint4 u;
  u.x = pack_bf16(v[0], v[1]);
  u.y = pack_bf16(v[2], v[3]);
  u.z = pack_bf16(v[4], v[5]);
  u.w = pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = u;
}

// x reduced over the tpr threads of each row: xor shuffles within a warp
// (groups of tpr lanes, or the whole warp), then, where a row spans
// warps, their values in shared memory taken in warp order
template <bool kMax>
__device__ __forceinline__ float row_reduce(float x, int tpr, float* red) {
  const int span = tpr < 32 ? tpr : 32;
  for (int o = span / 2; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  if (tpr <= 32) return x;
  const int warp = threadIdx.x / 32, wpr = tpr / 32;
  if (threadIdx.x % 32 == 0) red[warp] = x;
  __syncthreads();
  const float* mine = red + (warp / wpr) * wpr;
  x = mine[0];
  for (int i = 1; i < wpr; ++i) x = kMax ? fmaxf(x, mine[i]) : x + mine[i];
  __syncthreads();  // red is free again
  return x;
}

// the fused mean's second pass (softmax_xent's route "rows" where the
// batch spans several blocks): its threads
constexpr int kXentSumThreads = 256;

// kXent: softmax_xent, else softmax.  softmax stores e / sum(e); softmax_xent
// keeps s = x - max, stores exp(s - lse) and takes each row's NLL from the
// lane that holds its label's element (0 where the label is outside [0, V):
// lane 0 of the row writes it), into nll_s; then warp 0 sums the block's
// rows in a fixed order (lane l rows l, l + 32, ... in row order, then the
// xor tree) and writes loss = sum / rows where the grid is one block, else
// its partial part[blockIdx.x] for xent_mean_kernel.
template <typename T, bool kVec, int kPer, bool kXent>
__global__ void __launch_bounds__(kRowsMaxThreads)
softmax_reg_kernel(const T* __restrict__ x,
                   const long long* __restrict__ labels,
                   T* __restrict__ probs, float* __restrict__ part,
                   float* __restrict__ loss, int rows, int V, long sr,
                   int tpr, int rpb) {
  constexpr int E = kVec ? Vec<T>::N : 1;  // elements an item
  __shared__ float red[kRowsMaxThreads / 32];
  __shared__ float nll_s[kXent ? kRowsMaxThreads : 1];
  const int j = threadIdx.x % tpr;
  const int row = blockIdx.x * rpb + threadIdx.x / tpr;
  const bool live = row < rows;
  const int items = V / E;
  const T* xr = x + (long)(live ? row : 0) * sr;
  T* pr = probs + (long)(live ? row : 0) * V;
  long long y = -1;
  if (kXent && live) y = labels[row];
  float v[kPer][E];
  float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = j + i * tpr;
    if (live && idx < items) {
      if constexpr (kVec)
        load16(xr + (long)idx * E, v[i]);
      else
        v[i][0] = to_f32(xr[idx]);
#pragma unroll
      for (int e = 0; e < E; ++e) m = fmaxf(m, v[i][e]);
    }
  }
  m = row_reduce<true>(m, tpr, red);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (live && j + i * tpr < items) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if constexpr (kXent) {
          v[i][e] = v[i][e] - m;
          s += expf(v[i][e]);
        } else {
          v[i][e] = expf(v[i][e] - m);
          s += v[i][e];
        }
      }
    }
  }
  s = row_reduce<false>(s, tpr, red);
  const float lse = kXent ? logf(s) : 0.f;
  float mine = 0.f;
  bool found = false;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = j + i * tpr;
    if (live && idx < items) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if constexpr (kXent) {
          const float logp = v[i][e] - lse;
          if (idx * E + e == y) {
            mine = -logp;
            found = true;
          }
          v[i][e] = expf(logp);
        } else {
          v[i][e] = v[i][e] / s;
        }
      }
      if constexpr (kVec)
        store16(pr + (long)idx * E, v[i]);
      else
        pr[idx] = from_f32<T>(v[i][0]);
    }
  }
  if constexpr (kXent) {
    // one writer a row: the label's lane, or lane 0 for a label outside
    if (live && (found || (j == 0 && !(y >= 0 && y < V))))
      nll_s[threadIdx.x / tpr] = mine;
    __syncthreads();
    if (threadIdx.x < 32) {
      const long long left = rows - (long long)blockIdx.x * rpb;
      const int ra = left < rpb ? (int)left : rpb;
      float t = 0.f;
      for (int q = threadIdx.x; q < ra; q += 32) t += nll_s[q];
      t = warp_sum(t);
      if (threadIdx.x == 0) {
        if (gridDim.x == 1)
          *loss = t / (float)rows;
        else
          part[blockIdx.x] = t;
      }
    }
  }
}

// softmax_xent's second pass: the blocks' partials summed in a fixed order
// (thread t partials t, t + kXentSumThreads, ... in order, the xor tree of
// each warp, the warps in order), divided by the rows
__global__ void __launch_bounds__(kXentSumThreads)
xent_mean_kernel(const float* __restrict__ part, int n,
                 float* __restrict__ loss, int rows) {
  __shared__ float red[kXentSumThreads / 32];
  float t = 0.f;
  for (int i = threadIdx.x; i < n; i += kXentSumThreads) t += part[i];
  t = warp_sum(t);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = red[0];
    for (int w = 1; w < kXentSumThreads / 32; ++w) sum += red[w];
    *loss = sum / (float)rows;
  }
}

// softmax_xent's backward, route "rows": tpr lanes a row (no reductions,
// so rows need not fill warps), each holding up to kPer items of p in
// registers, all loaded before the first store; the row's label and g read
// once; the same xent_grad as the strided kernel, so the same bits
template <typename T, bool kVec, int kPer>
__global__ void __launch_bounds__(kRowsMaxThreads)
xent_bwd_reg_kernel(const T* __restrict__ p,
                    const long long* __restrict__ labels,
                    const float* __restrict__ g, T* __restrict__ out,
                    int rows, int V, long sr, int tpr, int rpb,
                    float scale) {
  constexpr int E = kVec ? Vec<T>::N : 1;  // elements an item
  const int j = threadIdx.x % tpr;
  const int row = blockIdx.x * rpb + threadIdx.x / tpr;
  if (row >= rows) return;
  const int items = V / E;
  const T* pr = p + (long)row * sr;
  T* o = out + (long)row * V;
  const long long y = labels[row];
  const float gv = xent_g<T>(g);
  float v[kPer][E];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = j + i * tpr;
    if (idx < items) {
      if constexpr (kVec)
        load16(pr + (long)idx * E, v[i]);
      else
        v[i][0] = to_f32(pr[idx]);
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = j + i * tpr;
    if (idx < items) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        v[i][e] = xent_grad<T>(v[i][e], idx * E + e, y, scale, gv);
      if constexpr (kVec)
        store16(o + (long)idx * E, v[i]);
      else
        o[idx] = from_f32<T>(v[i][0]);
    }
  }
}

template <typename T, bool kVec>
int bwd_reg_launch(const void* p, const long long* labels, const float* g,
                   void* out, int rows, int V, long sr, int tpr, int rpb,
                   int per, float scale, cudaStream_t s) {
  const unsigned blocks = (unsigned)((rows + rpb - 1) / rpb);
  const T* pi = static_cast<const T*>(p);
  T* po = static_cast<T*>(out);
#define X(P_)                                                              \
  if (per == P_) {                                                         \
    xent_bwd_reg_kernel<T, kVec, P_><<<blocks, tpr * rpb, 0, s>>>(         \
        pi, labels, g, po, rows, V, sr, tpr, rpb, scale);                  \
    return (int)cudaGetLastError();                                        \
  }
  X(1) X(2) X(4) X(8)
#undef X
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool kVec, bool kXent>
int reg_launch(const void* x, const long long* labels, void* probs,
               float* part, float* loss, int rows, int V, long sr, int tpr,
               int rpb, int per, cudaStream_t s) {
  const unsigned blocks = (unsigned)((rows + rpb - 1) / rpb);
  const T* xi = static_cast<const T*>(x);
  T* po = static_cast<T*>(probs);
  cudaError_t err = cudaErrorInvalidValue;
#define X(P_)                                                              \
  if (per == P_) {                                                         \
    softmax_reg_kernel<T, kVec, P_, kXent><<<blocks, tpr * rpb, 0, s>>>(   \
        xi, labels, po, part, loss, rows, V, sr, tpr, rpb);                \
    err = cudaGetLastError();                                              \
  }
  X(1) X(2) X(4) X(8)
#undef X
  if (err != cudaSuccess || !kXent || blocks == 1) return (int)err;
  xent_mean_kernel<<<1, kXentSumThreads, 0, s>>>(part, (int)blocks, loss,
                                                 rows);
  return (int)cudaGetLastError();
}

// what the "rows" kernel assumes of its launch (both externs)
bool reg_ok(const void* x, int rows, int V, long long sr, int tpr, int rpb,
            int per, int vec, int dtype) {
  const int e = vec ? (dtype == kBF16 ? 8 : 4) : 1;
  return !(rows < 1 || V < 1 || tpr < 1 || (tpr & (tpr - 1)) != 0 ||
           rpb < 1 || tpr * rpb > kRowsMaxThreads || (tpr * rpb) % 32 != 0 ||
           (long long)per * tpr * e < V ||
           (vec && (reinterpret_cast<uintptr_t>(x) % 16 != 0 || sr % e != 0 ||
                    V % e != 0)));
}

template <bool kXent>
int reg_dispatch(const void* x, const long long* labels, void* probs,
                 float* part, float* loss, int rows, int V, long long sr,
                 int tpr, int rpb, int per, int vec, int dtype,
                 cudaStream_t s) {
  if (dtype == kBF16)
    return vec ? reg_launch<bf16, true, kXent>(x, labels, probs, part, loss,
                                              rows, V, sr, tpr, rpb, per, s)
               : reg_launch<bf16, false, kXent>(x, labels, probs, part, loss,
                                               rows, V, sr, tpr, rpb, per, s);
  if (dtype == kF32)
    return vec ? reg_launch<float, true, kXent>(x, labels, probs, part, loss,
                                               rows, V, sr, tpr, rpb, per, s)
               : reg_launch<float, false, kXent>(x, labels, probs, part,
                                                loss, rows, V, sr, tpr, rpb,
                                                per, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// softmax_xent's backward, route "strided": probs (rows, V) by strides,
// labels int64, g the f32 scalar cotangent (NULL: none, JAX's kernel
// function), out contiguous; scale = 1/B
extern "C" int repro_softmax_xent_bwd(const void* probs, const void* labels,
                                      const void* g, void* out, int rows,
                                      int V, long long sr, long long sc,
                                      float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* y = static_cast<const long long*>(labels);
  const float* gp = static_cast<const float*>(g);
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  if (dtype == kBF16)
    xent_bwd_kernel<bf16><<<blocks, kThreads, 0, s>>>(
        static_cast<const bf16*>(probs), y, gp, static_cast<bf16*>(out), rows,
        V, sr, sc, scale);
  else if (dtype == kF32)
    xent_bwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(probs), y, gp, static_cast<float*>(out),
        rows, V, sr, sc, scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// softmax_xent's backward, route "rows": probs (rows, V) of unit stride and
// row stride sr, labels int64, g as repro_softmax_xent_bwd's, out
// contiguous; tpr, rpb, per and vec as repro_softmax_reg's (no reduction:
// rpb rows need not make whole warps, but the launch keeps reg_ok's rules)
extern "C" int repro_softmax_xent_bwd_reg(const void* probs,
                                          const void* labels, const void* g,
                                          void* out, int rows, int V,
                                          long long sr, int tpr, int rpb,
                                          int per, int vec, float scale,
                                          int dtype, void* stream) {
  if (!reg_ok(probs, rows, V, sr, tpr, rpb, per, vec, dtype) || !labels)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* y = static_cast<const long long*>(labels);
  const float* gp = static_cast<const float*>(g);
  if (dtype == kBF16)
    return vec ? bwd_reg_launch<bf16, true>(probs, y, gp, out, rows, V, sr,
                                            tpr, rpb, per, scale, s)
               : bwd_reg_launch<bf16, false>(probs, y, gp, out, rows, V, sr,
                                             tpr, rpb, per, scale, s);
  if (dtype == kF32)
    return vec ? bwd_reg_launch<float, true>(probs, y, gp, out, rows, V, sr,
                                             tpr, rpb, per, scale, s)
               : bwd_reg_launch<float, false>(probs, y, gp, out, rows, V, sr,
                                              tpr, rpb, per, scale, s);
  return (int)cudaErrorInvalidValue;
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

// softmax's route "rows": x (rows, V) of unit stride and row stride sr,
// probs contiguous; tpr threads a row (a power of two, whole warps above
// 32), rpb rows a block (whole warps: the shuffles take every lane), per
// items a lane (1, 2, 4 or 8), vec: 16-byte items (x's base, sr and V
// whole vectors), else single elements
extern "C" int repro_softmax_reg(const void* x, void* probs, int rows, int V,
                                 long long sr, int tpr, int rpb, int per,
                                 int vec, int dtype, void* stream) {
  if (!reg_ok(x, rows, V, sr, tpr, rpb, per, vec, dtype))
    return (int)cudaErrorInvalidValue;
  return reg_dispatch<false>(x, nullptr, probs, nullptr, nullptr, rows, V,
                             sr, tpr, rpb, per, vec, dtype,
                             static_cast<cudaStream_t>(stream));
}

// softmax_xent's route "rows": as repro_softmax_reg, with the int64 labels
// (rows,), the f32 scalar loss, and part: f32 (ceil(rows / rpb),) partials
// where that is more than one block (then a second launch sums them), else
// unused (may be NULL)
extern "C" int repro_softmax_xent_reg(const void* x, const void* labels,
                                      void* probs, void* part, void* loss,
                                      int rows, int V, long long sr, int tpr,
                                      int rpb, int per, int vec, int dtype,
                                      void* stream) {
  if (!reg_ok(x, rows, V, sr, tpr, rpb, per, vec, dtype) || !labels ||
      !loss || (rows > rpb && !part))
    return (int)cudaErrorInvalidValue;
  return reg_dispatch<true>(x, static_cast<const long long*>(labels), probs,
                            static_cast<float*>(part),
                            static_cast<float*>(loss), rows, V, sr, tpr, rpb,
                            per, vec, dtype,
                            static_cast<cudaStream_t>(stream));
}
