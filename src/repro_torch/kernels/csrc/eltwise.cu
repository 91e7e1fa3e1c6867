// Elementwise kernels of src/repro/kernels/eltwise.py.  What bounds them
// on Hopper: bytes -- one read of each input, one write of the output, one
// operation per element.  The first port's kernels are grid-stride loops
// with one thread per element, neighbouring threads on neighbouring
// addresses; the ReLU's and its backward's "vec" routes take 16-byte
// vectors.
//
// * Bias over rows (the paper's matrixPlusVectorRows functor): out[i, :] =
//   m[i, :] + v, added in f32 and rounded to the storage dtype.  Replaces
//   bias_add_rows_pallas ((bm, bn) VMEM tiles).  Two routes, picked by
//   kernels/eltwise.py:bias_plan:
//   - "vec" (repro_bias_add_rows_vec): N whole 16-byte vectors, 16-byte
//     aligned bases of m, v and out and a row stride ldm of whole vectors
//     (qwen's 2048- and 256-wide q, k and v biases, LeNet's 500 and 64).
//     A 2-D grid of row tiles and column vectors: a thread loads its
//     16-byte bias vector once, then issues the 16-byte loads of its rows
//     of m (1, 2, 4 or kBiasRows, fixed at compile time: no loop) before
//     its first store; 32-bit indices where the sizes allow, no
//     division.  kernels/eltwise.py:bias_grid shapes
//     the block and grid from M and N alone.  The first port's kernel
//     moved 2 or 4 bytes a load with a 64-bit division and remainder per
//     element and re-read the bias for every element.
//   - "scalar" (repro_bias_add_rows): every other N or alignment (LeNet's
//     N = 10 in f32, 40-byte rows; a view offset by one element).  The
//     first port's grid-stride loop, one element a thread.
// * Caffe's leaky-capable ReLU: out = x > 0 ? x : slope * x, the product
//   in f32 rounded to the storage dtype (x itself is passed through; a NaN
//   in x takes the slope).  In both ReLU kernels the slope is first
//   rounded to the storage dtype, as JAX's weakly typed slope * x rounds
//   it (a bf16 product of two bf16 values is exact in f32, so one rounding
//   follows).  Replaces relu_pallas (tiles of the flattened tensor).  Both
//   routes walk the storage in memory order, so any dense layout (a
//   column-major blob of the paper's boundary mode too) is read in place
//   and the output keeps the input's strides.  Two routes, picked by
//   kernels/eltwise.py:relu_plan:
//   - "vec" (repro_relu_vec): 16-byte aligned bases of x and out (every
//     LeNet ReLU, in every boundary mode).  The backward's vector walk
//     below with x in place of dy (one operand read): kVecs 16-byte loads
//     a thread before it uses any, 32-bit indices where n allows, the grid
//     from n alone (kernels/eltwise.py:relu_vec_grid), one
//     thread of block 0 a leftover element.  The first port's kernel moved
//     4 bytes a load, one load in flight a thread, with a 64-bit index.
//   - "scalar" (repro_relu): a misaligned base (a view offset by one
//     element).  The first port's kernel.
// * ReLU's backward: dx = x > 0 ? dy : slope * dy (a NaN in x takes the
//   slope, as x > 0 is false), the product in f32 rounded to the storage
//   dtype.  Replaces relu_bwd_pallas.  Two routes, picked by
//   kernels/eltwise.py:relu_bwd_plan; dx keeps x's layout in both.
//   - "vec" (repro_relu_bwd_vec): x and dy share one dense layout (every
//     call of the fused train step; a column-major blob whose dy is
//     column-major too) and 16-byte aligned bases.  The kernel walks
//     storage in memory order, as relu does: each thread issues kVecs = 2
//     16-byte loads of x and of dy (4 f32 or 8 bf16 each) before it uses
//     any (the count a sweep of 1, 2, 4 and 8 settled on: PERF.md), the
//     block's threads on neighbouring vectors, 32-bit indices where n
//     allows; the grid (kernels/eltwise.py:relu_vec_grid) comes from n
//     alone, and one thread of block 0 a leftover element takes the tail.
//   - "strided" (repro_relu_bwd): mixed layouts (in the paper's transposed
//     boundary mode a column-major x meets the row-major gradient of the
//     next layer's crossing).  The kernel walks the logical index, fastest
//     along the last axis, and addresses each of the three by its own
//     strides (up to 4 axes).
#include "common.cuh"

namespace {
using namespace repro;

constexpr int kThreads = 256;
constexpr long kMaxBlocks = 4096;
// the vec ReLU kernels' 16-byte vectors of each operand a thread loads
// before it uses any (kernels/eltwise.py:RELU_VECS)
constexpr int kVecs = 2;

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

// the "vec" bias's rows of m a thread at most (1, 2, 4 or 8:
// kernels/eltwise.py:bias_grid picks)
constexpr int kBiasRows = 8;

// a + b, 16 bytes of T each, added in f32 and rounded to T (bf16: element
// 2i in the low half of word i, little endian)
template <typename T>
__device__ __forceinline__ uint4 add16(const uint4& a, const uint4& b);
template <>
__device__ __forceinline__ uint4 add16<float>(const uint4& a,
                                              const uint4& b) {
  return make_uint4(
      __float_as_uint(__uint_as_float(a.x) + __uint_as_float(b.x)),
      __float_as_uint(__uint_as_float(a.y) + __uint_as_float(b.y)),
      __float_as_uint(__uint_as_float(a.z) + __uint_as_float(b.z)),
      __float_as_uint(__uint_as_float(a.w) + __uint_as_float(b.w)));
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  return pack_bf16(__uint_as_float(a << 16) + __uint_as_float(b << 16),
                   __uint_as_float(a & 0xffff0000u) +
                       __uint_as_float(b & 0xffff0000u));
}
template <>
__device__ __forceinline__ uint4 add16<bf16>(const uint4& a, const uint4& b) {
  return make_uint4(add_bf16x2(a.x, b.x), add_bf16x2(a.y, b.y),
                    add_bf16x2(a.z, b.z), add_bf16x2(a.w, b.w));
}

// The "vec" bias.  m (M rows of ldv vectors), out (M, nvec) contiguous,
// both as 16-byte vectors.  Thread (tx, ty) of block (k, i) owns column
// vector j = i * blockDim.x + tx and rows t * R .. t * R + R - 1 of row
// tile t = k * blockDim.y + ty (row tiles on gridDim.x, which has room
// for any M; column blocks on gridDim.y).  R, the rows a thread, is fixed
// at compile time (1, 2, 4 or 8) and there is no loop: a lane's code is
// its R loads, then its R stores.  I: the index type (int where the sizes
// allow).
template <typename T, typename I, int R>
__global__ void __launch_bounds__(kThreads)
bias_add_rows_vec_kernel(const uint4* __restrict__ m,
                         const uint4* __restrict__ v, uint4* __restrict__ out,
                         int M, int nvec, I ldv) {
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  const int r0 = (blockIdx.x * blockDim.y + threadIdx.y) * R;
  if (j >= nvec || r0 >= M) return;
  const uint4 b = __ldg(v + j);
  uint4 a[R];
#pragma unroll
  for (int u = 0; u < R; ++u)
    if (r0 + u < M) a[u] = __ldg(m + (I)(r0 + u) * ldv + j);
#pragma unroll
  for (int u = 0; u < R; ++u)
    if (r0 + u < M) out[(I)(r0 + u) * nvec + j] = add16<T>(a[u], b);
}

template <typename T, typename I>
cudaError_t launch_bias_vec(const uint4* m, const uint4* v, uint4* out,
                            int M, int nvec, I ldv, int rpt, dim3 grid,
                            dim3 block, cudaStream_t s) {
  if (rpt == 1)
    bias_add_rows_vec_kernel<T, I, 1><<<grid, block, 0, s>>>(m, v, out, M,
                                                             nvec, ldv);
  else if (rpt == 2)
    bias_add_rows_vec_kernel<T, I, 2><<<grid, block, 0, s>>>(m, v, out, M,
                                                             nvec, ldv);
  else if (rpt == 4)
    bias_add_rows_vec_kernel<T, I, 4><<<grid, block, 0, s>>>(m, v, out, M,
                                                             nvec, ldv);
  else
    bias_add_rows_vec_kernel<T, I, kBiasRows><<<grid, block, 0, s>>>(
        m, v, out, M, nvec, ldv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bias_vec(const void* m, const void* v, void* out, int M,
                            int N, long ldm, int rpt, int bx, int by, int gx,
                            int gy, cudaStream_t s) {
  constexpr int E = 16 / sizeof(T);
  const int nvec = N / E;
  const long ldv = ldm / E;
  const uint4* mp = static_cast<const uint4*>(m);
  const uint4* vp = static_cast<const uint4*>(v);
  uint4* op = static_cast<uint4*>(out);
  const dim3 grid((unsigned)gy, (unsigned)gx), block(bx, by);
  // int indices while every vector of m and out lies below 2^31
  if ((long)M * (ldv > nvec ? ldv : nvec) < 0x7fffffffL)
    return launch_bias_vec<T, int>(mp, vp, op, M, nvec, (int)ldv, rpt, grid,
                                   block, s);
  return launch_bias_vec<T, long>(mp, vp, op, M, nvec, ldv, rpt, grid, block,
                                  s);
}

// the slope as the storage dtype holds it
template <typename T>
__device__ __forceinline__ float storage_slope(float slope) {
  return to_f32(from_f32<T>(slope));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
relu_kernel(const T* __restrict__ x, T* __restrict__ out, long n,
            float slope) {
  slope = storage_slope<T>(slope);
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
  slope = storage_slope<T>(slope);
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

// one 32-bit word of g where x > 0, else slope * g rounded to the storage
// dtype: the backward's dx (g = dy) or the forward's out (g = x); one f32,
// or two bf16 (element 2i in the low half of word i, little endian)
template <typename T>
__device__ __forceinline__ uint32_t relu_word(uint32_t xw, uint32_t gw,
                                              float slope);
template <>
__device__ __forceinline__ uint32_t relu_word<float>(uint32_t xw,
                                                     uint32_t gw,
                                                     float slope) {
  return __uint_as_float(xw) > 0.f
             ? gw : __float_as_uint(slope * __uint_as_float(gw));
}
template <>
__device__ __forceinline__ uint32_t relu_word<bf16>(uint32_t xw,
                                                    uint32_t gw,
                                                    float slope) {
  uint32_t out = 0;
#pragma unroll
  for (int h = 0; h < 32; h += 16) {
    const uint32_t g = (gw >> h) & 0xffffu;
    const uint32_t r =
        __uint_as_float(((xw >> h) & 0xffffu) << 16) > 0.f
            ? g
            : __bfloat16_as_ushort(
                  __float2bfloat16_rn(slope * __uint_as_float(g << 16)));
    out |= r << h;
  }
  return out;
}

template <typename T>
__device__ __forceinline__ uint4 relu16(const uint4& a, const uint4& g,
                                        float slope) {
  return make_uint4(relu_word<T>(a.x, g.x, slope),
                    relu_word<T>(a.y, g.y, slope),
                    relu_word<T>(a.z, g.z, slope),
                    relu_word<T>(a.w, g.w, slope));
}

// the "vec" walk of both ReLU kernels.  I: the index type (int where n
// allows); a thread's kVecs vectors lie kThreads vectors apart.  kFwd: the
// forward, whose g is x itself (dy is not read); else the backward.
template <typename T, typename I, bool kFwd>
__global__ void __launch_bounds__(kThreads)
relu_vec_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                T* __restrict__ out, I n, float slope) {
  slope = storage_slope<T>(slope);
  constexpr int E = 16 / sizeof(T);
  const I nv = n / E;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* gv = reinterpret_cast<const uint4*>(dy);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const I span = (I)gridDim.x * (kThreads * kVecs);
  for (I v0 = (I)blockIdx.x * (kThreads * kVecs) + threadIdx.x; v0 < nv;
       v0 += span) {
    uint4 a[kVecs], g[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const I v = v0 + u * kThreads;
      if (v < nv) {
        a[u] = __ldg(xv + v);
        if (!kFwd) g[u] = __ldg(gv + v);
      }
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const I v = v0 + u * kThreads;
      if (v < nv) ov[v] = relu16<T>(a[u], kFwd ? a[u] : g[u], slope);
    }
  }
  const I i = nv * E + threadIdx.x;
  if (blockIdx.x == 0 && i < n) {
    const T gi = kFwd ? x[i] : dy[i];
    out[i] = to_f32(x[i]) > 0.f ? gi : from_f32<T>(slope * to_f32(gi));
  }
}

template <typename T, bool kFwd>
cudaError_t launch_relu_vec(const void* x, const void* dy, void* out, long n,
                            float slope, int blocks, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(dy);
  T* op = static_cast<T*>(out);
  const dim3 grid((unsigned)blocks), block(kThreads);
  // int indices while n and a grid's span of vectors past it fit
  if (n + (long)blocks * kThreads * kVecs * (16 / sizeof(T)) < 0x7fffffffL)
    relu_vec_kernel<T, int, kFwd><<<grid, block, 0, s>>>(xp, gp, op, (int)n,
                                                         slope);
  else
    relu_vec_kernel<T, long, kFwd><<<grid, block, 0, s>>>(xp, gp, op, n,
                                                          slope);
  return cudaGetLastError();
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

// route "vec": x, dy and dx of one dense layout, 16-byte aligned bases,
// walked in memory order; blocks from kernels/eltwise.py:relu_vec_grid
extern "C" int repro_relu_bwd_vec(const void* x, const void* dy, void* dx,
                                  long long n, float slope, int blocks,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks < 1 || blocks > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    return (int)launch_relu_vec<bf16, false>(x, dy, dx, n, slope, blocks, s);
  if (dtype == kF32)
    return (int)launch_relu_vec<float, false>(x, dy, dx, n, slope, blocks,
                                              s);
  return (int)cudaErrorInvalidValue;
}

// route "vec" of the forward: x and out of one dense layout, 16-byte
// aligned bases, walked in memory order; blocks from
// kernels/eltwise.py:relu_vec_grid
extern "C" int repro_relu_vec(const void* x, void* out, long long n,
                              float slope, int blocks, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks < 1 || blocks > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    return (int)launch_relu_vec<bf16, true>(x, x, out, n, slope, blocks, s);
  if (dtype == kF32)
    return (int)launch_relu_vec<float, true>(x, x, out, n, slope, blocks, s);
  return (int)cudaErrorInvalidValue;
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

// route "vec": N and ldm whole 16-byte vectors, 16-byte aligned bases of
// m, v and out, out (M, N) contiguous; rpt rows a thread (1, 2, 4 or
// kBiasRows), a block of bx x by threads (bx * by <= 256), gx blocks
// across the N / E vectors and gy across the row tiles, covering them
// (kernels/eltwise.py:bias_grid)
extern "C" int repro_bias_add_rows_vec(const void* m, const void* v,
                                       void* out, int M, int N,
                                       long long ldm, int rpt, int bx,
                                       int by, int gx, int gy, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int E = dtype == kBF16 ? 8 : 4;
  if ((dtype != kBF16 && dtype != kF32) || M < 1 || N < E || N % E ||
      ldm % E || ldm < 0 ||
      (rpt != 1 && rpt != 2 && rpt != 4 && rpt != kBiasRows) || bx < 1 ||
      by < 1 || bx * by > kThreads || gx < 1 || gx > 65535 || gy < 1 ||
      (long)gx * bx < N / E || (long)gy * by * rpt < M)
    return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    return (int)launch_bias_vec<bf16>(m, v, out, M, N, ldm, rpt, bx, by, gx,
                                      gy, s);
  return (int)launch_bias_vec<float>(m, v, out, M, N, ldm, rpt, bx, by, gx,
                                     gy, s);
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
