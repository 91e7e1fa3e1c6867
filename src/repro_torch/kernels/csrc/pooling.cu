// Max pooling with argmax (Caffe's Pooling, pool: MAX): for every k x k
// window of the padded plane, its largest value and the int32 index
// row*WP + col of that value in the padded plane (WP = W + 2*pad).
//
// Replaces src/repro/kernels/pooling.py:maxpool_pallas, which pads the
// image with finfo(dtype).min in device memory, stages each padded plane
// whole in VMEM, then, per (batch, channel block) grid cell, unrolls the
// window over strided VMEM slices, keeping the running best and its index
// with a strict '>' (the first maximum in row-major window order wins).
// What bounds it on Hopper: bytes -- a read of the image and a write of
// the outputs and argmaxes, k*k compares per output.  Both routes visit a
// window in the same row-major order with the same strict '>', treat an
// out-of-plane cell as a candidate of value finfo(dtype).min at its padded
// index (so ties and windows that lie wholly in the padding give JAX's
// argmax bit for bit without a padded copy), compare in f32 (exact for
// both storage types) and store the winner back unchanged; the outputs are
// contiguous (N, C, OH, OW).  Two routes, picked by
// kernels/pooling.py:maxpool_plan from the layout:
//
// * "plane" (repro_maxpool_plane): x's rows have unit stride (every
//   row-major input, contiguous or not: every call of the fused forward
//   and of the transfer boundary mode).  The Hopper form of the TPU
//   kernel's staged plane: a block stages in shared memory, as f32 in
//   padded coordinates, the band of input rows that its output rows'
//   windows touch, of `planes` whole planes where one plane is too small
//   to fill the block (MNIST pool2: 3,200 planes of 8 x 8), or of `rows`
//   output rows of one plane (kernels/pooling.py:maxpool_band fixes both
//   from the shape, the shared memory within the static 48 KB, the grid
//   at >= 132 blocks where the shape allows).  Each input byte the
//   windows need is read from device memory once (rows past
//   (OH-1)*stride + k - pad, which the floor of conv_out_size leaves out,
//   are never read), with coalesced loads: 16-byte vectors where the
//   planner vouched for the base, the strides and the row length, else
//   one element a thread, neighbouring threads on neighbouring columns.
//   The padding is written into the band as it is read.  Threads then
//   take outputs from shared memory, neighbouring threads on neighbouring
//   (contiguous) outputs.  All index arithmetic is 32-bit: a block's
//   planes and band come from blockIdx, each plane's 64-bit base offset
//   is computed once a block; no 64-bit division or remainder anywhere
//   (the old kernel's three of each per output were emulated in software,
//   dozens of instructions each).  The window is a template parameter for
//   k = 2 and 3 (the LeNet pools), a runtime loop for any other.
// * "strided" (repro_maxpool): every other layout (the column-major blob
//   of the transposed boundary mode).  The first port's kernel: one
//   thread per output in a grid-stride loop, its window's k*k cells read
//   by the image's four strides.
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
// the ops layer takes the plain scatter, as JAX does.  Two routes, picked
// by kernels/pooling.py:maxpool_bwd_plan from the layouts and the stride:
//
// * "window" (repro_maxpool_bwd_window): dy's and the argmax's rows of
//   unit stride, stride 2 or 3 (a template parameter; the window k does
//   not enter the backward, whose argmax already names the winner, so any
//   k <= stride).  The first kernel's time went to index arithmetic, not
//   bytes: three 64-bit div/mod pairs and a runtime division by the
//   stride per pixel, the window's argmax and dy loaded again by every
//   pixel of it, one element stored at a time.  Here a thread owns one
//   16-byte vector of output columns (4 f32, 8 bf16) across the `stride`
//   image rows of one window row: it loads the argmax and dy of the (at
//   most NW) windows its columns fall in once, then writes `stride`
//   16-byte vectors, each element dy where its padded index equals one of
//   those argmaxes (windows do not overlap, so at most one does), else
//   0.  The block is three-dimensional, (vectors, window rows, planes):
//   several small planes a block, or a band of a large plane's window
//   rows (kernels/pooling.py:maxpool_bwd_band), so a thread's unit comes
//   from its thread and block indices with no division but the plane's
//   (n, c).  Window rows past OH and columns past the last window (stride
//   > k, or H + 2 pad - k not a multiple of the stride) get 0 from their
//   owner, with no load; rows that are not whole vectors (W not a
//   multiple of 4 f32 / 8 bf16, so that the rows' starts are off 16
//   bytes) are stored element by element.  dy is copied as bits, so the
//   route is bit for bit the first kernel's.
// * "pixel" (repro_maxpool_bwd): every other layout and stride: the first
//   port's kernel above.
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

// the "plane" kernel's most threads a block and planes a block
// (kernels/pooling.py:POOL_THREADS, POOL_MAX_PLANES), and the most bytes
// of its staged band (POOL_SMEM): the static limit of 48 KB a block, no
// opt-in, less the block's staged plane bases, which share it
constexpr int kPlaneThreads = 256;
constexpr int kMaxPlanes = 256;
constexpr int kPlaneSmem = 48 * 1024 - kMaxPlanes * (int)sizeof(long long);

// K: the window (0: k at run time).  A block takes `planes` planes (then
// all OH output rows) or `rows` output rows of one plane; `bands` =
// ceil(OH / rows).  The band in shared memory: the block's planes, each
// its rin staged rows of wpu = (OW-1)*stride + k padded columns, f32.
template <typename T, int K>
__global__ void __launch_bounds__(kPlaneThreads)
maxpool_plane_kernel(const T* __restrict__ x, T* __restrict__ out,
                     int* __restrict__ arg, int P, int C, int H, int W,
                     long long sn, long long sc, long long sh, int k_arg,
                     int stride, int pad, int OH, int OW, int rows,
                     int planes, int bands, bool vec) {
  extern __shared__ float band[];
  __shared__ long long base[kMaxPlanes];
  const int k = K ? K : k_arg;  // a constant where K is: the loops unroll
  const int g = blockIdx.x / bands;
  const int oy0 = (blockIdx.x - g * bands) * rows;
  const int p0 = g * planes;
  const int pa = min(planes, P - p0);
  const int ra = min(rows, OH - oy0);
  const int rin = (ra - 1) * stride + k;
  const int wpu = (OW - 1) * stride + k;
  const int y0 = oy0 * stride - pad;  // the image row of staged row 0
  const float neg = lowest<T>();
  for (int q = threadIdx.x; q < pa; q += blockDim.x) {
    const int p = p0 + q, n = p / C;
    base[q] = n * sn + (p - n * C) * sc;
  }
  __syncthreads();
  // a staged row's units: the image's row in 16-byte vectors (or single
  // elements), then its left and right padding cells that a window reads
  constexpr int E = 16 / sizeof(T);
  const int e = vec ? E : 1;
  const int nv = W / e;
  const int lp = min(pad, wpu);
  const int units = nv + lp + max(0, wpu - pad - W);
  const int total = pa * rin * units;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int s = t / units, u = t - s * units;  // s = q * rin + staged row
    const int q = s / rin;
    const int y = y0 + s - q * rin;
    const bool in = y >= 0 && y < H;
    float* dst = band + s * wpu;
    if (u < nv) {
      const int c0 = pad + u * e;
      if (vec) {
        float v[E];
        if (in) {
          load16(x + base[q] + y * sh + u * E, v);
        } else {
#pragma unroll
          for (int j = 0; j < E; ++j) v[j] = neg;
        }
#pragma unroll
        for (int j = 0; j < E; ++j)
          if (c0 + j < wpu) dst[c0 + j] = v[j];
      } else if (c0 < wpu) {
        dst[c0] = in ? to_f32(x[base[q] + y * sh + u]) : neg;
      }
    } else {
      const int pu = u - nv;
      dst[pu < lp ? pu : pad + W + pu - lp] = neg;
    }
  }
  __syncthreads();
  // outputs: the block's are contiguous, (p0, oy0, 0) onwards
  const int per_plane = ra * OW;
  const int cnt = pa * per_plane;
  const int WP = W + 2 * pad;
  const long long o0 = ((long long)p0 * OH + oy0) * OW;
  for (int o = threadIdx.x; o < cnt; o += blockDim.x) {
    const int q = o / per_plane, r = o - q * per_plane;
    const int oy = r / OW, ox = r - oy * OW;
    const float* win = band + (q * rin + oy * stride) * wpu + ox * stride;
    float best = win[0];
    int bi = 0, bj = 0;
#pragma unroll
    for (int i = 0; i < k; ++i) {
#pragma unroll
      for (int j = 0; j < k; ++j) {
        const float v = win[i * wpu + j];
        if (v > best) {
          best = v;
          bi = i;
          bj = j;
        }
      }
    }
    out[o0 + o] = from_f32<T>(best);
    arg[o0 + o] = ((oy0 + oy) * stride + bi) * WP + ox * stride + bj;
  }
}

template <typename T, int K>
cudaError_t launch_plane_k(const void* x, void* out, int* arg, int P, int C,
                           int H, int W, long long sn, long long sc,
                           long long sh, int k, int stride, int pad, int OH,
                           int OW, int rows, int planes, int bands,
                           int blocks, int threads, int smem, bool vec,
                           cudaStream_t s) {
  maxpool_plane_kernel<T, K><<<blocks, threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), arg, P, C, H, W, sn,
      sc, sh, k, stride, pad, OH, OW, rows, planes, bands, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_plane(const void* x, void* out, int* arg, int P, int C,
                         int H, int W, long long sn, long long sc,
                         long long sh, int k, int stride, int pad, int OH,
                         int OW, int rows, int planes, int threads, int vec,
                         cudaStream_t s) {
  const long long bands = (OH + rows - 1) / rows;
  const long long blocks = (P + (long long)planes - 1) / planes * bands;
  const long long smem =
      4LL * planes * ((rows - 1) * stride + k) * ((OW - 1) * stride + k);
  // what the kernel assumes: a block's outputs contiguous (several planes
  // only with whole planes), its planes' bases staged, the band in the
  // static limit, aligned vectors of whole rows
  if (rows < 1 || rows > OH || planes < 1 || planes > kMaxPlanes ||
      (planes > 1 && rows != OH) || threads < 32 || threads % 32 ||
      threads > kPlaneThreads || smem > kPlaneSmem ||
      blocks > 0x7fffffffLL || (vec && W % (16 / (int)sizeof(T))) ||
      (vec && reinterpret_cast<uintptr_t>(x) % 16))
    return cudaErrorInvalidValue;
  const bool v = vec != 0;
  if (k == 2)
    return launch_plane_k<T, 2>(x, out, arg, P, C, H, W, sn, sc, sh, k,
                                stride, pad, OH, OW, rows, planes,
                                (int)bands, (int)blocks, threads, (int)smem,
                                v, s);
  if (k == 3)
    return launch_plane_k<T, 3>(x, out, arg, P, C, H, W, sn, sc, sh, k,
                                stride, pad, OH, OW, rows, planes,
                                (int)bands, (int)blocks, threads, (int)smem,
                                v, s);
  return launch_plane_k<T, 0>(x, out, arg, P, C, H, W, sn, sc, sh, k, stride,
                              pad, OH, OW, rows, planes, (int)bands,
                              (int)blocks, threads, (int)smem, v, s);
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


// the "window" kernel's most threads a block and planes a block (the
// block's z extent; kernels/pooling.py:BWD_THREADS, BWD_MAX_PLANES)
constexpr int kBwdThreads = 512;
constexpr int kBwdMaxPlanes = 64;

// a 16-byte store of a vector's bits
__device__ __forceinline__ void store_bits(uint32_t* p,
                                           const uint32_t (&v)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_bits(uint16_t* p,
                                           const uint16_t (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(
      v[0] | (uint32_t)v[1] << 16, v[2] | (uint32_t)v[3] << 16,
      v[4] | (uint32_t)v[5] << 16, v[6] | (uint32_t)v[7] << 16);
}

// Bits: the storage type's bits (uint32_t f32, uint16_t bf16); S: the
// stride.  Thread (tx, ty, tz) of block (bx, by): plane p = bx * planes +
// tz (and on in steps of blockDim.z), window row g = g0 + by * groups + ty
// (on in steps of blockDim.y, within the band's `groups`), columns [v E,
// v E + E) for v = tx (on in steps of blockDim.x).  g0 = pad / S is the
// first window row that holds an image row.
template <typename Bits, int S, bool kVec>
__global__ void __launch_bounds__(kBwdThreads)
maxpool_bwd_window_kernel(const Bits* __restrict__ dy,
                          const int* __restrict__ arg, Bits* __restrict__ out,
                          int P, int C, int H, int W, long long d_sn,
                          long long d_sc, long long d_sh, long long a_sn,
                          long long a_sc, long long a_sh, int pad, int OH,
                          int OW, int groups, int planes) {
  constexpr int E = 16 / sizeof(Bits);
  constexpr int NW = (E + S - 2) / S + 1;  // windows E columns can touch
  const int g0 = pad / S;
  const int G = (H - 1 + pad) / S - g0 + 1;
  const int nv = (W + E - 1) / E;
  const int WP = W + 2 * pad;
  const int gb = blockIdx.y * groups;
  const int ga = min(groups, G - gb);
  const int p0 = blockIdx.x * planes;
  const int pa = min(planes, P - p0);
  for (int q = threadIdx.z; q < pa; q += blockDim.z) {
    const int p = p0 + q, n = p / C, c = p - n * C;
    const int* ap = arg + n * a_sn + c * a_sc;
    const Bits* dp = dy + n * d_sn + c * d_sc;
    Bits* op = out + (long long)p * H * W;
    for (int gi = threadIdx.y; gi < ga; gi += blockDim.y) {
      const int g = g0 + gb + gi;
      for (int v = threadIdx.x; v < nv; v += blockDim.x) {
        const int x0 = v * E;
        const int ox0 = (x0 + pad) / S;
        int a[NW];
        Bits d[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          a[w] = -1;  // matches no padded index
          d[w] = 0;
        }
        if (g < OH) {
          const int* ar = ap + g * a_sh;
          const Bits* dr = dp + g * d_sh;
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            const int ox = ox0 + w;
            if (ox < OW && ox * S - pad < x0 + E) {
              a[w] = ar[ox];
              d[w] = dr[ox];
            }
          }
        }
#pragma unroll
        for (int i = 0; i < S; ++i) {
          const int y = g * S - pad + i;
          if (y < 0 || y >= H) continue;
          const int at = (y + pad) * WP + pad + x0;  // column x0's index
          Bits o[E];
#pragma unroll
          for (int e = 0; e < E; ++e) {
            o[e] = 0;
#pragma unroll
            for (int w = 0; w < NW; ++w)
              if (a[w] == at + e) o[e] = d[w];
          }
          Bits* orow = op + (long long)y * W + x0;
          if constexpr (kVec) {
            store_bits(orow, o);
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e)
              if (x0 + e < W) orow[e] = o[e];
          }
        }
      }
    }
  }
}

template <typename Bits, int S>
cudaError_t launch_bwd_window_s(const void* dy, const int* arg, void* out,
                                int P, int C, int H, int W, long long d_sn,
                                long long d_sc, long long d_sh,
                                long long a_sn, long long a_sc,
                                long long a_sh, int pad, int OH, int OW,
                                int cols, int groups, int planes, bool vec,
                                dim3 grid, cudaStream_t s) {
  const dim3 block(cols, groups, planes);
  const Bits* d = static_cast<const Bits*>(dy);
  Bits* o = static_cast<Bits*>(out);
  if (vec)
    maxpool_bwd_window_kernel<Bits, S, true><<<grid, block, 0, s>>>(
        d, arg, o, P, C, H, W, d_sn, d_sc, d_sh, a_sn, a_sc, a_sh, pad, OH,
        OW, groups, planes);
  else
    maxpool_bwd_window_kernel<Bits, S, false><<<grid, block, 0, s>>>(
        d, arg, o, P, C, H, W, d_sn, d_sc, d_sh, a_sn, a_sc, a_sh, pad, OH,
        OW, groups, planes);
  return cudaGetLastError();
}

template <typename Bits>
cudaError_t launch_bwd_window(const void* dy, const int* arg, void* out,
                              int P, int C, int H, int W, long long d_sn,
                              long long d_sc, long long d_sh, long long a_sn,
                              long long a_sc, long long a_sh, int stride,
                              int pad, int OH, int OW, int cols, int groups,
                              int planes, int vec, cudaStream_t s) {
  constexpr int E = 16 / sizeof(Bits);
  if (stride < 1 || pad < 0 || H < 1 || W < 1 || P < 1)
    return cudaErrorInvalidValue;
  const long long G = (H - 1LL + pad) / stride - pad / stride + 1;
  const long long nv = (W + E - 1LL) / E;
  const long long bands = (G + groups - 1) / groups;
  const long long pgroups = (P + (long long)planes - 1) / planes;
  // what the kernel assumes: a block within the limits, every extent
  // reached, 32-bit padded indices, aligned whole-vector rows for 16-byte
  // stores
  if (cols < 1 || cols > nv || groups < 1 || groups > G || planes < 1 ||
      planes > kBwdMaxPlanes ||
      (long long)cols * groups * planes > kBwdThreads || bands > 65535 ||
      pgroups > 0x7fffffffLL ||
      (H + 2LL * pad) * (W + 2LL * pad) > 0x7fffffffLL ||
      (vec && (W % E || reinterpret_cast<uintptr_t>(out) % 16)))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)pgroups, (unsigned)bands);
  const bool v = vec != 0;
  if (stride == 2)
    return launch_bwd_window_s<Bits, 2>(dy, arg, out, P, C, H, W, d_sn, d_sc,
                                        d_sh, a_sn, a_sc, a_sh, pad, OH, OW,
                                        cols, groups, planes, v, grid, s);
  if (stride == 3)
    return launch_bwd_window_s<Bits, 3>(dy, arg, out, P, C, H, W, d_sn, d_sc,
                                        d_sh, a_sn, a_sc, a_sh, pad, OH, OW,
                                        cols, groups, planes, v, grid, s);
  return cudaErrorInvalidValue;  // a stride it is not instantiated for
}

}  // namespace

// route "window": dy and argmax (N, C, OH, OW) with rows of unit stride,
// read by the strides of their other three axes; out contiguous (N, C, H,
// W); stride 2 or 3 (>= k); the block's extents (vectors, window rows,
// planes) and the 16-byte stores from kernels/pooling.py:maxpool_bwd_band
extern "C" int repro_maxpool_bwd_window(
    const void* dy, const void* arg, void* out, int N, int C, int H, int W,
    long long d_sn, long long d_sc, long long d_sh, long long a_sn,
    long long a_sc, long long a_sh, int stride, int pad, int OH, int OW,
    int cols, int groups, int planes, int vec, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(arg);
  const long long P = (long long)N * C;
  if (P > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    return (int)launch_bwd_window<uint16_t>(
        dy, a, out, (int)P, C, H, W, d_sn, d_sc, d_sh, a_sn, a_sc, a_sh,
        stride, pad, OH, OW, cols, groups, planes, vec, s);
  if (dtype == kF32)
    return (int)launch_bwd_window<uint32_t>(
        dy, a, out, (int)P, C, H, W, d_sn, d_sc, d_sh, a_sn, a_sc, a_sh,
        stride, pad, OH, OW, cols, groups, planes, vec, s);
  return (int)cudaErrorInvalidValue;
}

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

// route "plane": x's rows of unit stride (sw = 1), read by the strides of
// its other three axes; out and argmax contiguous (N, C, OH, OW); a
// block's output rows, planes and threads and the 16-byte loads from
// kernels/pooling.py:maxpool_band
extern "C" int repro_maxpool_plane(const void* x, void* out, void* arg,
                                   int N, int C, int H, int W, long long sn,
                                   long long sc, long long sh, int k,
                                   int stride, int pad, int OH, int OW,
                                   int rows, int planes, int threads,
                                   int vec, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* a = static_cast<int*>(arg);
  const long long P = (long long)N * C;
  if (P > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    return (int)launch_plane<bf16>(x, out, a, (int)P, C, H, W, sn, sc, sh, k,
                                   stride, pad, OH, OW, rows, planes,
                                   threads, vec, s);
  if (dtype == kF32)
    return (int)launch_plane<float>(x, out, a, (int)P, C, H, W, sn, sc, sh,
                                    k, stride, pad, OH, OW, rows, planes,
                                    threads, vec, s);
  return (int)cudaErrorInvalidValue;
}
