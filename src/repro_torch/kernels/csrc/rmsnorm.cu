// Row RMSNorm: out = cast(x * rsqrt(mean(x^2) + eps)) * w, statistics in
// f32, the cast to the storage dtype *before* the weight multiply; and its
// backward, dx = inv * (dxhat - xhat * mean(dxhat * xhat)) with
// xhat = x * inv, dxhat = dy * w, and dw = sum over rows of dy * xhat.
//
// Replaces src/repro/kernels/rmsnorm.py:rmsnorm_pallas (:29) and
// rmsnorm_bwd_pallas (:74; kernel :56-71: one VMEM pass per row block, one
// f32 dw partial per block, summed outside the kernel).  What bounds both
// on Hopper: bytes -- each row is read (the backward reads x and dy) and
// written once, with a handful of flops per element.
//
// The forward has two routes (kernels/rmsnorm.py:fwd_plan picks one from
// dtype, width and alignment):
//
// * "vec" (rmsnorm_vec_kernel), rows whose width and strides are
//   multiples of 16 bytes, up to 32 * 8 * kFwdVecs vectors.  At the
//   serving widths a call is latency-bound: 4 rows of 2048 bf16 move 36 KB
//   (0.00001 ms at 3.35 TB/s).  The scalar kernel took one 256-thread
//   block a row whatever the width, read x twice in 2-byte loads and
//   first read w after two block barriers, so a cold call waited for two
//   dependent trips to memory.  Here a group of `group` warps (1, 2, 4 or
//   8) owns a row; each lane issues all its 16-byte loads of x and w
//   (up to kFwdVecs of each, a count fixed at compile time: 1, 2, 4 or 8)
//   before the first sum, so a call takes one trip; x stays in registers; the f32 sum of squares goes by warp
//   shuffles, then across the group's warps through shared memory and a
//   named barrier of the group alone; the output leaves in 16-byte
//   stores.  kernels/rmsnorm.py:fwd_rows spreads a few rows over more
//   warps (a shorter chain of loads a lane) and packs many rows a block.
// * "scalar" (rmsnorm_kernel, the first port's): one block a row, for
//   every other width and alignment.
//
// Both compute inv = 1 / sqrtf(mean(x^2) + eps) in f32, x * inv rounded to
// the storage dtype, times w, rounded once; only the order of the sum of
// squares differs.
//
// The backward has two routes (kernels/rmsnorm.py:bwd_plan picks one from
// dtype, width and alignment), and both end in the same second kernel,
// dw_sum_kernel, which sums the f32 dw partials of the first in a fixed
// order and writes dw in w's dtype: two launches a call, no atomics, the
// same bits on every call.  The sum is launched as a programmatic
// dependent of the first kernel, so its launch overlaps that kernel.
//
// * "vec" (rmsnorm_bwd_vec_kernel), rows whose width and strides are
//   multiples of 16 bytes.  At a training step's 512 rows of 2048 bf16 a
//   call moves 6.3 MB (0.0019 ms at 3.35 TB/s); the scalar kernel took 13x
//   that, latency-bound: 128 blocks of 8 warps, each walking its 4 rows one
//   after another in three passes of 2-byte loads with four block barriers
//   a row.  Here a group of `group` warps (1, 2, 4 or 8) owns a row: each
//   lane loads its 16-byte vectors of x, dy and w (kVecs of each,
//   coalesced) and keeps them in registers through both reductions (sum
//   x^2 and sum (dy * w) * x, warp shuffles, then across the group's warps
//   through shared memory and a named barrier of the group alone, never
//   the block) and the dx write, also 16 bytes a store.  All of a row's
//   loads are issued before the first sum, and the block's groups run
//   their rows independently, so a call's reads are in flight together.
//   A row wider than the group's registers (32 * group * kVecs vectors) is
//   walked in chunks: the statistics pass over every chunk, then the dx
//   pass from the last chunk (still in registers) back, re-reading the
//   others from L2.  Each group adds dy * xhat of its rows into its own
//   f32 row of shared memory, lane-major so no access conflicts (a lane
//   always owns the same columns, so no lane reads another's until the
//   end); the block then sums its groups' rows in group order into one
//   f32 partial row.  kernels/rmsnorm.py:bwd_rows picks group, warps and
//   rows a block from shapes.
// * "scalar" (rmsnorm_bwd_kernel, the first port's), every other width and
//   alignment up to 12280: kBwdRows rows per block, a thread owning the
//   same columns in every row of its block, its share of the block's dw
//   partial a running sum in shared memory.
#include "common.cuh"

namespace {
using namespace repro;

constexpr int kThreads = 256;

// sum of v over the block; every thread gets it.  part: kThreads / 32
// floats of shared scratch, free again when the call returns
__device__ __forceinline__ float block_sum(float v, float* part) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = warp_sum(v);
  __syncthreads();  // part may still be read by a previous call
  if (lane == 0) part[warp] = v;
  __syncthreads();
  float t = lane < kThreads / 32 ? part[lane] : 0.f;
  return warp_sum(t);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int D, long ldx, float eps) {
  __shared__ float part[kThreads / 32];
  const T* xr = x + (long)blockIdx.x * ldx;
  T* orow = out + (long)blockIdx.x * D;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float v = to_f32(xr[d]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) part[0] = t;
  }
  __syncthreads();
  const float inv = 1.0f / sqrtf(part[0] / (float)D + eps);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float y = to_f32(from_f32<T>(to_f32(xr[d]) * inv));
    orow[d] = from_f32<T>(y * to_f32(w[d]));
  }
}

constexpr int kBwdRows = 4;

// The "scalar" route: dx (rows, D) in T, dwp (ceil(rows / kBwdRows), D)
// f32.  Dynamic shared memory: D floats of dw partial.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ dwp, int rows, int D, long ldx,
                   long lddy, float eps) {
  extern __shared__ float dw_acc[];
  __shared__ float part[kThreads / 32];
  for (int d = threadIdx.x; d < D; d += kThreads) dw_acc[d] = 0.f;
  const int r0 = blockIdx.x * kBwdRows;
  const int r1 = min(rows, r0 + kBwdRows);
  for (int r = r0; r < r1; ++r) {
    const T* xr = x + (long)r * ldx;
    const T* dyr = dy + (long)r * lddy;
    float ss = 0.f;
    for (int d = threadIdx.x; d < D; d += kThreads) {
      const float v = to_f32(xr[d]);
      ss += v * v;
    }
    const float inv = 1.0f / sqrtf(block_sum(ss, part) / (float)D + eps);
    float sd = 0.f;
    for (int d = threadIdx.x; d < D; d += kThreads) {
      const float xhat = to_f32(xr[d]) * inv;
      sd += to_f32(dyr[d]) * to_f32(w[d]) * xhat;
    }
    const float mean = block_sum(sd, part) / (float)D;
    T* dxr = dx + (long)r * D;
    for (int d = threadIdx.x; d < D; d += kThreads) {
      const float xhat = to_f32(xr[d]) * inv;
      const float g = to_f32(dyr[d]);
      dxr[d] = from_f32<T>(inv * (g * to_f32(w[d]) - xhat * mean));
      dw_acc[d] += g * xhat;  // this thread's own column
    }
  }
  float* out = dwp + (long)blockIdx.x * D;
  for (int d = threadIdx.x; d < D; d += kThreads) out[d] = dw_acc[d];
}

// ---------------------------------------------------------------------------
// The "vec" route
// ---------------------------------------------------------------------------

constexpr int kVecs = 4;         // 16-byte vectors of x, dy, w a lane
constexpr int kMaxBwdWarps = 8;  // warps a block
constexpr int kMaxGroup = 8;     // warps a row
// dynamic shared memory a block may take: the 227 KB an H100 block can
// opt into, less 1 KB kept for the static arrays
constexpr int kMaxBwdSmem = 227 * 1024 - 1024;

// 16 bytes of T as f32 (little endian: element 2i in the low half of word
// i for bf16), and back, rounded to nearest even
__device__ __forceinline__ void unpack(uint4 v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(uint4 v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                    pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

template <typename T>
__device__ __forceinline__ uint4 ld16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// barrier `id` (1..15; 0 is __syncthreads') over the `n` threads of one
// group of warps
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// The forward's "vec" route
// ---------------------------------------------------------------------------

constexpr int kFwdVecs = 8;      // 16-byte vectors of x (and of w) a lane
constexpr int kMaxFwdWarps = 8;  // warps a block

// v rounded to the storage dtype and widened back
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return to_f32(from_f32<T>(v));
}

// out (rows, D) in T, contiguous.  Block: `warps` warps in warps / group
// groups; group k owns row blockIdx.x * groups + k.  Lane gl of a group
// holds vectors gl, gl + 32 * group, ... (V of them, the last ones past
// the row left out) of x and of w in registers, loaded before the first
// sum.  V is a compile-time count (1, 2, 4 or 8), so a lane's code is no
// longer than its row needs.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxFwdWarps * 32)
rmsnorm_vec_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ out, int rows, int D, long ldx, float eps,
                   int group) {
  constexpr int E = Vec<T>::N;  // elements a 16-byte vector
  __shared__ float red[kMaxFwdWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = (blockDim.x >> 5) / group;
  const int grp = warp / group;
  const int r = blockIdx.x * groups + grp;
  if (r >= rows) return;  // the whole group: its barrier is its own
  const int gl = (warp - grp * group) * 32 + lane;  // lane within the group
  const int gthreads = group * 32;
  const int nvec = D / E;
  const T* xr = x + (long)r * ldx;
  uint4 xv[V], wv[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = v * gthreads + gl;
    if (j < nvec) {
      xv[v] = ld16(xr + j * E);
      wv[v] = ld16(w + j * E);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (v * gthreads + gl < nvec) {
      float xf[E];
      unpack(xv[v], xf);
#pragma unroll
      for (int e = 0; e < E; ++e) ss += xf[e] * xf[e];
    }
  }
  ss = warp_sum(ss);
  if (group > 1) {
    // the group's warps' sums, added in warp order by every warp
    if (lane == 0) red[warp] = ss;
    group_sync(1 + grp, gthreads);
    ss = 0.f;
    for (int i = 0; i < group; ++i) ss += red[grp * group + i];
  }
  const float inv = 1.0f / sqrtf(ss / (float)D + eps);
  T* orow = out + (long)r * D;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = v * gthreads + gl;
    if (j < nvec) {
      float xf[E], wf[E], o[E];
      unpack(xv[v], xf);
      unpack(wv[v], wf);
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] = rounded<T>(xf[e] * inv) * wf[e];
      *reinterpret_cast<uint4*>(orow + j * E) = pack(o);
    }
  }
}

template <typename T>
int fwd_vec(const void* x, const void* w, void* out, int rows, int D,
            long ldx, float eps, int group, int warps, int blocks,
            cudaStream_t s) {
  const int per_lane = (D / Vec<T>::N + 32 * group - 1) / (32 * group);
  const dim3 grid(blocks), block(warps * 32);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (per_lane <= 1)
    rmsnorm_vec_kernel<T, 1><<<grid, block, 0, s>>>(xp, wp, op, rows, D, ldx,
                                                     eps, group);
  else if (per_lane <= 2)
    rmsnorm_vec_kernel<T, 2><<<grid, block, 0, s>>>(xp, wp, op, rows, D, ldx,
                                                     eps, group);
  else if (per_lane <= 4)
    rmsnorm_vec_kernel<T, 4><<<grid, block, 0, s>>>(xp, wp, op, rows, D, ldx,
                                                     eps, group);
  else
    rmsnorm_vec_kernel<T, kFwdVecs><<<grid, block, 0, s>>>(
        xp, wp, op, rows, D, ldx, eps, group);
  return (int)cudaGetLastError();
}

// The f32 dw rows (a group's in shared memory, a block's partial in dwp)
// are kept lane-major: element e of 16-byte vector j (column j * E + e)
// sits at ((j / 32) * E + e) * 32 + j % 32, so the 32 lanes holding
// vectors 32q .. 32q + 31 touch 32 consecutive words for each e (no bank
// conflict, coalesced) -- in the column order a lane would touch 8 or 4
// words apart, an 8- or 4-way conflict.  A row of D columns takes
// ceil(D / (32 E)) * 32 E floats.  E = 1 is the plain column order.
__host__ __device__ constexpr int lane_major(int j, int e, int E) {
  return ((j >> 5) * E + e) * 32 + (j & 31);
}
__host__ __device__ constexpr int padded_row(int D, int E) {
  return (D + 32 * E - 1) / (32 * E) * (32 * E);
}

// dx (rows, D) in T, contiguous; dwp (ceil(rows / rows_per_block),
// padded_row(D, E)) f32, lane-major, one partial row a block.  Block:
// `warps` warps in warps / group groups; group k walks rows r0 + k,
// r0 + k + groups, ... of the block's rows [r0, r0 + rows_per_block).
// Dynamic shared memory: groups lane-major rows.
template <typename T>
__global__ void __launch_bounds__(kMaxBwdWarps * 32)
rmsnorm_bwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ dwp, int rows, int D, long ldx,
                       long lddy, float eps, int group, int rows_per_block) {
  constexpr int E = Vec<T>::N;  // elements a 16-byte vector
  // let the dw sum's blocks launch now (they wait for this grid's end)
  asm volatile("griddepcontrol.launch_dependents;");
  extern __shared__ float4 dyn[];
  float* dws = reinterpret_cast<float*>(dyn);
  __shared__ float2 red[2][kMaxBwdWarps];  // each warp's sums, by parity

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = (blockDim.x >> 5) / group;
  const int grp = warp / group;
  const int gl = (warp - grp * group) * 32 + lane;  // lane within the group
  const int gthreads = group * 32;
  const int nvec = D / E, cvec = kVecs * gthreads;  // vectors: row, chunk
  const int nchunks = (nvec + cvec - 1) / cvec;
  const int dpad = padded_row(D, E);
  float* acc = dws + (long)grp * dpad;  // this group's dw row
  // this lane's columns: vector c * cvec + v * gthreads + gl of each chunk
  for (int c = 0; c < nchunks; ++c)
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const int j = c * cvec + v * gthreads + gl;
      if (j < nvec)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[lane_major(j, e, E)] = 0.f;
    }

  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  int parity = 0;
  for (int r = r0 + grp; r < r1; r += groups) {
    const T* xr = x + (long)r * ldx;
    const T* dyr = dy + (long)r * lddy;
    uint4 xv[kVecs], gv[kVecs], wv[kVecs];
    float ss = 0.f, sdx = 0.f;  // sum x^2, sum (dy * w) * x
    for (int c = 0; c < nchunks; ++c) {
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        const int j = c * cvec + v * gthreads + gl;
        if (j < nvec) {
          xv[v] = ld16(xr + j * E);
          gv[v] = ld16(dyr + j * E);
          wv[v] = ld16(w + j * E);
        }
      }
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        const int j = c * cvec + v * gthreads + gl;
        if (j < nvec) {
          float xf[E], gf[E], wf[E];
          unpack(xv[v], xf);
          unpack(gv[v], gf);
          unpack(wv[v], wf);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            ss += xf[e] * xf[e];
            sdx += gf[e] * wf[e] * xf[e];
          }
        }
      }
    }
    ss = warp_sum(ss);
    sdx = warp_sum(sdx);
    if (group > 1) {
      // the group's warps' sums, added in warp order by every warp; the
      // slots alternate by row, so a slot is rewritten only after the
      // next row's barrier, which every warp reaches after reading it
      if (lane == 0) red[parity][warp] = make_float2(ss, sdx);
      group_sync(1 + grp, gthreads);
      ss = sdx = 0.f;
      for (int i = 0; i < group; ++i) {
        const float2 p = red[parity][grp * group + i];
        ss += p.x;
        sdx += p.y;
      }
      parity ^= 1;
    }
    const float inv = 1.0f / sqrtf(ss / (float)D + eps);
    const float mean = inv * sdx / (float)D;  // mean(dxhat * xhat)
    T* dxr = dx + (long)r * D;
    // the last chunk from registers, the others again (from L2)
    for (int c = nchunks - 1; c >= 0; --c) {
      if (c != nchunks - 1) {
#pragma unroll
        for (int v = 0; v < kVecs; ++v) {
          const int j = c * cvec + v * gthreads + gl;
          if (j < nvec) {
            xv[v] = ld16(xr + j * E);
            gv[v] = ld16(dyr + j * E);
            wv[v] = ld16(w + j * E);
          }
        }
      }
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        const int j = c * cvec + v * gthreads + gl;
        if (j < nvec) {
          float xf[E], gf[E], wf[E], o[E];
          unpack(xv[v], xf);
          unpack(gv[v], gf);
          unpack(wv[v], wf);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float xh = xf[e] * inv;
            o[e] = inv * (gf[e] * wf[e] - xh * mean);
            acc[lane_major(j, e, E)] += gf[e] * xh;
          }
          *reinterpret_cast<uint4*>(dxr + j * E) = pack(o);
        }
      }
    }
  }
  __syncthreads();
  // the block's partial: its groups' rows added in group order
  float* out = dwp + (long)blockIdx.x * dpad;
  for (int p = threadIdx.x; p < dpad; p += blockDim.x) {
    float t = dws[p];
    for (int k = 1; k < groups; ++k) t += dws[(long)k * dpad + p];
    out[p] = t;
  }
}

constexpr int kSumSlices = 8;  // warps of the dw sum's block

// dw (D) in T = the nb partial rows of dwp (rows of ld floats, lane-major
// over E-element vectors; E = 1: plain columns) summed in a fixed order:
// warp k of block i adds rows [k * per, (k + 1) * per) in row order at the
// block's 32 positions (per = ceil(nb / kSumSlices)), then warp 0 adds the
// slices' sums in slice order and writes each position's column
template <typename T>
__global__ void __launch_bounds__(kSumSlices * 32)
dw_sum_kernel(const float* __restrict__ dwp, T* __restrict__ dw, int nb,
              int D, int E, int ld) {
  // launched early (programmatic dependent launch): wait here until the
  // kernel that writes dwp has finished and its writes are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __shared__ float part[kSumSlices][32];
  const int lane = threadIdx.x & 31, k = threadIdx.x >> 5;
  const int p = blockIdx.x * 32 + lane;
  // position p holds element e of vector j: column j * E + e
  const int q = p / (32 * E), e = (p / 32) % E;
  const int d = (q * 32 + (p & 31)) * E + e;
  const int per = (nb + kSumSlices - 1) / kSumSlices;
  const int b0 = k * per, b1 = min(nb, b0 + per);
  float s = 0.f;
  if (d < D) {
#pragma unroll 8
    for (int b = b0; b < b1; ++b) s += __ldg(dwp + (long)b * ld + p);
  }
  part[k][lane] = s;
  __syncthreads();
  if (k == 0 && d < D) {
    float t = part[0][lane];
#pragma unroll
    for (int i = 1; i < kSumSlices; ++i) t += part[i][lane];
    dw[d] = from_f32<T>(t);
  }
}

// the sum of nb partial rows of ld floats, launched as a programmatic
// dependent of the kernel before it on the stream: its blocks start while
// that kernel runs and wait for it in griddepcontrol.wait, so the second
// launch's latency hides behind the first kernel
template <typename T>
int dw_sum(const void* dwp, void* dw, int nb, int D, int E, int ld,
           cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(padded_row(D, E) / 32);
  cfg.blockDim = dim3(kSumSlices * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, dw_sum_kernel<T>, static_cast<const float*>(dwp),
      static_cast<T*>(dw), nb, D, E, ld);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

template <typename T>
int bwd_vec(const void* x, const void* w, const void* dy, void* dx,
            void* dwp, void* dw, int rows, int D, long ldx, long lddy,
            float eps, int group, int warps, int rows_per_block,
            cudaStream_t s) {
  constexpr int E = Vec<T>::N;
  // opted in once per instance (one card a process) for the largest block
  static const cudaError_t opted = cudaFuncSetAttribute(
      rmsnorm_bwd_vec_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxBwdSmem);
  if (opted != cudaSuccess) return (int)opted;
  const int nb = (rows + rows_per_block - 1) / rows_per_block;
  const size_t smem =
      (size_t)(warps / group) * padded_row(D, E) * sizeof(float);
  rmsnorm_bwd_vec_kernel<T><<<nb, warps * 32, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(dwp), rows, D, ldx, lddy, eps, group,
      rows_per_block);
  const int rc = (int)cudaGetLastError();
  return rc != 0 ? rc : dw_sum<T>(dwp, dw, nb, D, E, padded_row(D, E), s);
}

}  // namespace

extern "C" int repro_rmsnorm(const void* x, const void* w, void* out, int rows,
                             int D, long long ldx, float eps, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(rows), block(kThreads);
  if (dtype == kBF16)
    rmsnorm_kernel<bf16><<<grid, block, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(out), D, ldx, eps);
  else if (dtype == kF32)
    rmsnorm_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), D, ldx, eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The forward's "vec" route.  The caller (kernels/rmsnorm.py) vouches for
// 16-byte aligned x, w and out, D and the row stride ldx multiples of 16
// bytes, out (rows, D) contiguous.  group: warps a row (1, 2, 4 or 8),
// the row at most 32 * group * kFwdVecs vectors; warps: a block's (a
// multiple of group, at most 8); blocks: ceil(rows / (warps / group)).
extern "C" int repro_rmsnorm_vec(const void* x, const void* w, void* out,
                                 int rows, int D, long long ldx, float eps,
                                 int group, int warps, int blocks, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int E = dtype == kBF16 ? 8 : 4;
  if ((dtype != kBF16 && dtype != kF32) || rows < 1 || D < E || D % E ||
      ldx % E || (group != 1 && group != 2 && group != 4 && group != 8) ||
      warps < group || warps > kMaxFwdWarps || warps % group ||
      D / E > 32 * group * kFwdVecs ||
      (long)blocks * (warps / group) < rows ||
      (long)(blocks - 1) * (warps / group) >= rows)
    return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    return fwd_vec<bf16>(x, w, out, rows, D, ldx, eps, group, warps, blocks,
                         s);
  return fwd_vec<float>(x, w, out, rows, D, ldx, eps, group, warps, blocks,
                        s);
}

// The "scalar" route: dwp is f32 (ceil(rows / kBwdRows), D) scratch, dw
// (D) in the dtype of x; then dw_sum_kernel.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* w, const void* dy,
                                 void* dx, void* dwp, void* dw, int rows,
                                 int D, long long ldx, long long lddy,
                                 float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (rows + kBwdRows - 1) / kBwdRows;
  const dim3 grid(nb), block(kThreads);
  // the dw row (dynamic) and the block's part[kThreads / 32] (static)
  // share the 48 KB a block may have without opting in
  const size_t smem = (size_t)D * sizeof(float);
  if (rows < 1 || D < 1 || smem + kThreads / 32 * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  int rc;
  if (dtype == kBF16) {
    rmsnorm_bwd_kernel<bf16><<<grid, block, smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
        static_cast<float*>(dwp), rows, D, ldx, lddy, eps);
    rc = (int)cudaGetLastError();
    return rc != 0 ? rc : dw_sum<bf16>(dwp, dw, nb, D, 1, D, s);
  }
  if (dtype == kF32) {
    rmsnorm_bwd_kernel<float><<<grid, block, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(dy), static_cast<float*>(dx),
        static_cast<float*>(dwp), rows, D, ldx, lddy, eps);
    rc = (int)cudaGetLastError();
    return rc != 0 ? rc : dw_sum<float>(dwp, dw, nb, D, 1, D, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The "vec" route.  The caller (kernels/rmsnorm.py) vouches for 16-byte
// aligned x, w, dy and dx, D and the row strides ldx, lddy multiples of
// 16 bytes, dx (rows, D) contiguous, dwp f32 (ceil(rows / rows_per_block),
// padded_row(D, E)) scratch and dw (D) in the dtype of x.  group: warps a
// row (1, 2, 4 or 8); warps: a block's (a multiple of group, at most 8);
// the groups' f32 dw rows, (warps / group) * padded_row(D, E) floats,
// within kMaxBwdSmem.
extern "C" int repro_rmsnorm_bwd_vec(const void* x, const void* w,
                                     const void* dy, void* dx, void* dwp,
                                     void* dw, int rows, int D,
                                     long long ldx, long long lddy, float eps,
                                     int group, int warps, int rows_per_block,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int E = dtype == kBF16 ? 8 : 4;
  if ((dtype != kBF16 && dtype != kF32) || rows < 1 || D < E || D % E ||
      ldx % E || lddy % E || (group != 1 && group != 2 && group != 4 &&
                              group != kMaxGroup) ||
      warps < group || warps > kMaxBwdWarps || warps % group ||
      rows_per_block < 1 ||
      (long)(warps / group) * padded_row(D, E) * (long)sizeof(float) >
          kMaxBwdSmem)
    return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    return bwd_vec<bf16>(x, w, dy, dx, dwp, dw, rows, D, ldx, lddy, eps,
                         group, warps, rows_per_block, s);
  return bwd_vec<float>(x, w, dy, dx, dwp, dw, rows, D, ldx, lddy, eps,
                        group, warps, rows_per_block, s);
}

