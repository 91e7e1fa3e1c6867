// Mamba-2 SSD chunked scan: y (B, S, H, P) and the final state (B, H, P, N)
// f32 from x (B, S, H, P), dt (B, S, H) f32, A (H,) f32, B and C (B, S, 1, N)
// and an optional carried state (B, H, P, N) f32.  Decode is the S = 1 call.
//
// Replaces src/repro/kernels/mamba_scan.py:ssd_scan_pallas.  Its TPU grid
// (B, H, n_chunks) walks the chunks in order on one core with the (P, N)
// state in VMEM scratch, after padding the sequence to a chunk multiple.
// Per chunk of length L (the last one ragged, which is the padded chunk's
// math without the padding: a padded position has dt = 0) every route
// computes what mamba_scan.py:_ssd_kernel computes:
//
//   cum     = cumsum(dt * a)                                   (L,)
//   y[t]    = sum_{u <= t} (C_t . B_u) exp(cum_t - cum_u) dt_u x_u
//             + (C_t exp(cum_t)) . state                        (L, P)
//   state'  = exp(cum_L) state + x^T (B * exp(cum_L - cum) dt)  (P, N)
//
// exp(cum_t - cum_u) grows without bound for u > t (cum falls), so those
// terms are skipped by a branch, never multiplied by a 0/1 mask (inf * 0 is
// NaN).  A position with dt = 0 contributes exactly zero to the state, and
// a chunk with dt = 0 everywhere leaves it bit for bit (exp(0) = 1: the
// update is fma(1, h, +-0)).  B, C, x and dt are read in place by their
// strides (B and C are column slices of the in_proj output, row stride
// 2 d_inner + 2 N + H).  What bounds it on Hopper: at decode (S = 1)
// bytes -- a read and a write of the f32 state, 2 * 4 * B * H * P * N
// (21 MB at mamba2-2.7b, B = 4: 6.3 us at 3.35 TB/s); over a long chunk
// the O(L^2 N) products, which run as scalar f32 FMAs (tensor cores on the
// C B^T and att x products, and C . B shared across heads, are later
// work).  Three routes, picked by kernels/mamba_scan.py:ssd_plan from the
// dtype, the shape, B's and C's row strides and the bases' alignment:
//
// - "step" (repro_ssd_scan_step), S = 1: the state streams once through
//   registers, with no shared memory and no barrier.  A group of G lanes
//   owns whole state rows (N = 4 G VPL floats: lane q holds the 16-byte
//   vectors q + G j, j < VPL), up to kStepMaxRows / VPL rows at once,
//   whose loads (state, x, dt, B, C) it issues before it uses any.  Per
//   row p:  y[p] = (C.B) dt x[p] + e (C.h[p,:]),
//           h'[p,:] = fma(e, h[p,:], x[p] (B dt)),  e = exp(dt a),
//   C.B and C.h as lane partials summed by xor shuffles within the group;
//   the new state is stored from the same registers.  The grid covers the
//   B * H * P rows (kernels/mamba_scan.py:ssd_step).
// - "split" (repro_ssd_scan_split), S > 1: the chunk algorithm with each
//   head's P rows split across blocks (kernels/mamba_scan.py:ssd_split).
//   A block owns PS whole state rows of one (row, head), one lane group a
//   row, the row's state in that group's registers from the first chunk
//   to the last (so no other block reads or writes it: the in-place write
//   is safe).  Per chunk it stages dt, B (16-byte vectors) and its x rows,
//   runs the cumsum as a warp scan, and for each tile of kTile = 16
//   positions stages the C rows and the tile's (kTile, L) intra-chunk
//   matrix, entries u <= t only, its C_t . B_u in 4 x 4 blocks of pairs
//   (8 lanes a block, each over every 8th vector of N, then folded), so
//   that a row of C or B read from shared memory serves 4 pairs (both are
//   recomputed by every block of a head: cheap at C = 16, which is why
//   the planner splits less at long chunks).  Each lane then
//   holds 16 partial y values of its row (its n's of e_t C_t.h, its u's of
//   att x), and the group folds them so that each lane ends with 16 / G of
//   the full sums (half the values cross at each xor step), then stores
//   them.  The state update runs in registers: each lane's 4 VPL
//   accumulators over the chunk's positions, then fma(e, h, acc) as the
//   block route does.
// - "block" (repro_ssd_scan): the first port's kernel, one block per
//   (row, head), for what the planner sends to neither: B or C slices
//   whose base or row stride breaks the 16-byte vectors, an N the routes
//   above do not instantiate.  The state lives in shared memory (f32, rows
//   padded to N + 1 so that lanes reading a column hit distinct banks) and
//   y is produced in tiles of kTT rows: the tile's C rows, its (kTT, L)
//   block of the intra-chunk matrix and its outputs.
#include "common.cuh"

namespace {
using namespace repro;

constexpr int kThreads = 256;
constexpr int kTT = 16;  // y rows per tile (route "block")

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* h0;  // (B, H, P, N) contiguous, or nullptr (zeros)
  void* y;
  float* hf;        // (B, H, P, N) contiguous
  int S, H, P, N, L, TT;
  long x_sb, x_ss, x_sh;  // unit stride along P
  long dt_sb, dt_ss, dt_sh;
  long b_sb, b_ss;        // unit stride along N
  long c_sb, c_ss;
  long y_sb, y_ss, y_sh;
};

// floats of dynamic shared memory for a chunk of L and a y tile of TT rows
// (kernels/mamba_scan.py:smem_bytes computes the same)
inline long smem_floats(int P, int N, int L, int TT) {
  return (long)P * (N + 1) + (long)L * (N + 1) + (long)L * P + 2L * TT * N +
         (long)TT * L + 3L * L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(SsdArgs a) {
  extern __shared__ float sm[];
  const int P = a.P, N = a.N, L = a.L, TT = a.TT, NP = N + 1;
  float* st = sm;                // P x NP  the running state
  float* bs = st + P * NP;       // L x NP  B of the chunk
  float* xs = bs + L * NP;       // L x P   x of the chunk
  float* cs = xs + L * P;        // TT x N  C rows of the tile
  float* ce = cs + TT * N;       // TT x N  C_t exp(cum_t)
  float* att = ce + TT * N;      // TT x L  the tile's intra-chunk matrix
  float* cum = att + TT * L;     // L
  float* dts = cum + L;          // L
  float* w = dts + L;            // L       exp(cum_L - cum_u) dt_u

  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.B);
  const T* Cm = static_cast<const T*>(a.C);
  T* y = static_cast<T*>(a.y);
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const float A = a.A[h];
  const long sbase = ((long)b * a.H + h) * P * N;

  for (int i = tid; i < P * N; i += kThreads)
    st[(i / N) * NP + i % N] = a.h0 ? a.h0[sbase + i] : 0.f;

  for (int t0 = 0; t0 < a.S; t0 += L) {
    const int len = min(L, a.S - t0);
    __syncthreads();  // the previous chunk's state update is done
    for (int u = tid; u < len; u += kThreads)
      dts[u] = a.dt[b * a.dt_sb + (long)(t0 + u) * a.dt_ss + h * a.dt_sh];
    for (int i = tid; i < len * N; i += kThreads) {
      const int u = i / N, n = i % N;
      bs[u * NP + n] = to_f32(Bm[b * a.b_sb + (long)(t0 + u) * a.b_ss + n]);
    }
    for (int i = tid; i < len * P; i += kThreads) {
      const int u = i / P, p = i % P;
      xs[u * P + p] =
          to_f32(x[b * a.x_sb + (long)(t0 + u) * a.x_ss + h * a.x_sh + p]);
    }
    __syncthreads();
    if (tid == 0) {  // L <= 128 terms: a serial cumsum in order
      float c = 0.f;
      for (int u = 0; u < len; ++u) {
        c += dts[u] * A;
        cum[u] = c;
      }
    }
    __syncthreads();
    const float cum_last = cum[len - 1];
    for (int u = tid; u < len; u += kThreads)
      w[u] = expf(cum_last - cum[u]) * dts[u];

    for (int r0 = 0; r0 < len; r0 += TT) {
      const int nr = min(TT, len - r0);
      __syncthreads();  // the previous tile's readers are done
      for (int i = tid; i < nr * N; i += kThreads) {
        const int r = i / N, n = i % N;
        const float c =
            to_f32(Cm[b * a.c_sb + (long)(t0 + r0 + r) * a.c_ss + n]);
        cs[r * N + n] = c;
        ce[r * N + n] = c * expf(cum[r0 + r]);
      }
      __syncthreads();
      for (int i = tid; i < nr * len; i += kThreads) {
        const int r = i / len, u = i % len, t = r0 + r;
        float v = 0.f;
        if (u <= t) {  // the branch keeps exp(cum_t - cum_u) finite
          float dot = 0.f;
          for (int n = 0; n < N; ++n)
            dot = fmaf(cs[r * N + n], bs[u * NP + n], dot);
          v = dot * expf(cum[t] - cum[u]) * dts[u];
        }
        att[r * L + u] = v;
      }
      __syncthreads();
      for (int i = tid; i < nr * P; i += kThreads) {
        const int r = i / P, p = i % P, t = r0 + r;
        float intra = 0.f, inter = 0.f;
        for (int u = 0; u <= t; ++u)
          intra = fmaf(att[r * L + u], xs[u * P + p], intra);
        for (int n = 0; n < N; ++n)
          inter = fmaf(ce[r * N + n], st[p * NP + n], inter);
        y[b * a.y_sb + (long)(t0 + t) * a.y_ss + h * a.y_sh + p] =
            from_f32<T>(intra + inter);
      }
    }
    __syncthreads();  // every read of the old state is done
    const float e = expf(cum_last);
    for (int i = tid; i < P * N; i += kThreads) {
      const int p = i / N, n = i % N;
      float acc = 0.f;
      for (int u = 0; u < len; ++u)
        acc = fmaf(xs[u * P + p], bs[u * NP + n] * w[u], acc);
      st[p * NP + n] = fmaf(e, st[p * NP + n], acc);
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads)
    a.hf[sbase + i] = st[(i / N) * NP + i % N];
}

template <typename T>
int launch(const SsdArgs& a, int Bn, cudaStream_t s) {
  const long bytes = smem_floats(a.P, a.N, a.L, a.TT) * 4;
  static long granted = 48 * 1024;  // per instantiation
  if (bytes > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    granted = bytes;
  }
  ssd_scan_kernel<T><<<dim3(Bn, a.H), kThreads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Routes "step" and "split".  Lane groups of G lanes own whole state rows;
// lane q of a group holds the row's 16-byte vectors q + G j, j < VPL.  The
// (G, VPL) pairs instantiated are kernels/mamba_scan.py:LANES.
// ---------------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;
// rows x vectors a lane of the step kernel holds at once
// (kernels/mamba_scan.py:STEP_MAX_ROWS)
constexpr int kStepMaxRows = 4;
// y positions a split tile folds (kernels/mamba_scan.py:SPLIT_TILE): 16
// keeps a lane's partials and its row's state within the 64 registers
// that let two 512-thread blocks share an SM
constexpr int kTile = 16;
// threads of a step or split block at most (kernels/mamba_scan.py:
// MAX_THREADS)
constexpr int kMaxThreads = 512;

// 4 elements of T at p (16 bytes of f32, 8 of bf16, aligned), widened
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&o)[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  o[0] = __uint_as_float(v.x << 16);
  o[1] = __uint_as_float(v.x & 0xffff0000u);
  o[2] = __uint_as_float(v.y << 16);
  o[3] = __uint_as_float(v.y & 0xffff0000u);
}

// the sum of x over the G lanes of each aligned group (every lane gets it)
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Fold C values v[0 .. C) across the G lanes of each aligned group: at
// offset o = G / 2 the lanes with bit o set keep the upper half of their
// values and send the lower, the others the reverse (keep + received),
// and so on down to offset 1; once a lane holds one value the remaining
// offsets add it to its partner's (v + received).  A lane then holds
// max(C / G, 1) full sums, those of positions base .. (base starts at 0).
template <int G, int C>
__device__ __forceinline__ void fold(float* v, int lane, int& base) {
  if constexpr (G > 1 && C == 1) {
    v[0] += __shfl_xor_sync(kFull, v[0], G / 2);
    fold<G / 2, 1>(v, lane, base);
  } else if constexpr (G > 1) {
    constexpr int o = G / 2, c = C / 2;
    const bool up = (lane & o) != 0;
    if (up) base += c;
#pragma unroll
    for (int m = 0; m < c; ++m) {
      const float send = up ? v[m] : v[m + c];
      const float keep = up ? v[m + c] : v[m];
      v[m] = keep + __shfl_xor_sync(kFull, send, o);
    }
    fold<o, c>(v, lane, base);
  }
}

struct StepArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* h0;  // (B, H, P, N) contiguous, or nullptr (zeros)
  void* y;
  float* hf;        // (B, H, P, N) contiguous; may be h0
  int rows;         // B * H * P (< 2^31)
  int H, P, N, K;   // K: rows a lane group holds at once
  long x_sb, x_sh, dt_sb, dt_sh, b_sb, c_sb, y_sb, y_sh;
};

template <typename T, int G, int VPL>
__global__ void __launch_bounds__(kMaxThreads, 2)
    ssd_step_kernel(StepArgs a) {
  constexpr int RG = 32 / G;              // row groups a warp
  constexpr int KM = kStepMaxRows / VPL;  // rows a group holds at most
  const int lane = threadIdx.x & 31, q = lane % G, grp = lane / G;
  const unsigned warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int N = a.N;
  const unsigned P = a.P, H = a.H;
  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.B);
  const T* Cm = static_cast<const T*>(a.C);

  // the state rows' loads first, all in flight together; then row by row
  // its x, dt, a, B and C (B and C are one row of the batch's, from cache)
  float h[KM][VPL][4];
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const unsigned row = (warp * a.K + k) * RG + grp;
    const bool live = k < a.K && row < (unsigned)a.rows;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      if (live && a.h0) {
        const float4 v = *reinterpret_cast<const float4*>(
            a.h0 + (long)row * N + 4 * (q + G * j));
        h[k][j][0] = v.x; h[k][j][1] = v.y; h[k][j][2] = v.z;
        h[k][j][3] = v.w;
      } else {
        h[k][j][0] = h[k][j][1] = h[k][j][2] = h[k][j][3] = 0.f;
      }
    }
  }
  T* y = static_cast<T*>(a.y);
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    if (k >= a.K) break;  // uniform across the warp
    const unsigned row = (warp * a.K + k) * RG + grp;
    const bool live = row < (unsigned)a.rows;
    const unsigned bh = live ? row / P : 0, p = live ? row - bh * P : 0;
    const unsigned b = bh / H, hh = bh - b * H;
    float bv[VPL][4], cv[VPL][4];
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      if (live) {
        load4(Bm + b * a.b_sb + 4 * (q + G * j), bv[j]);
        load4(Cm + b * a.c_sb + 4 * (q + G * j), cv[j]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[j][c] = cv[j][c] = 0.f;
      }
    }
    const float xv = live ? to_f32(x[b * a.x_sb + hh * a.x_sh + p]) : 0.f;
    const float dt = live ? a.dt[b * a.dt_sb + hh * a.dt_sh] : 0.f;
    const float av = live ? a.A[hh] : 0.f;
    float cb = 0.f, ch = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        cb = fmaf(cv[j][c], bv[j][c], cb);
        ch = fmaf(cv[j][c], h[k][j][c], ch);
      }
    cb = group_sum<G>(cb);
    ch = group_sum<G>(ch);
    if (!live) continue;
    const float e = expf(dt * av);
    if (q == 0)
      y[b * a.y_sb + hh * a.y_sh + p] = from_f32<T>(fmaf(cb * dt, xv, e * ch));
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      float4 v;
      v.x = fmaf(e, h[k][j][0], xv * (bv[j][0] * dt));
      v.y = fmaf(e, h[k][j][1], xv * (bv[j][1] * dt));
      v.z = fmaf(e, h[k][j][2], xv * (bv[j][2] * dt));
      v.w = fmaf(e, h[k][j][3], xv * (bv[j][3] * dt));
      *reinterpret_cast<float4*>(a.hf + (long)row * N + 4 * (q + G * j)) = v;
    }
  }
}

struct SplitArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* h0;  // (B, H, P, N) contiguous, or nullptr (zeros)
  void* y;
  float* hf;        // (B, H, P, N) contiguous; may be h0
  int S, H, P, N, L, PS, slices;  // PS: state rows a block
  long x_sb, x_ss, x_sh;  // unit stride along P
  long dt_sb, dt_ss, dt_sh;
  long b_sb, b_ss;        // unit stride along N
  long c_sb, c_ss;
  long y_sb, y_ss, y_sh;
};

// floats of the split kernel's dynamic shared memory, in order: B of the
// chunk (rows padded by one vector, so that lanes reading one column of
// different rows hit distinct banks), the tile's C rows, its intra-chunk
// matrix, the block's x rows transposed (padded by G), dt, cum, exp(cum)
// and exp(cum_L - cum) dt.  The kernel declares no static shared memory
// (kernels/mamba_scan.py:split_smem computes the same).
inline long split_floats(int N, int L, int PS, int G) {
  const int tt = L < kTile ? L : kTile;
  return (long)L * (N + 4) + (long)tt * N + (long)tt * (L + 1) +
         (long)PS * (L + G) + 4L * L;
}

template <typename T, int G, int VPL>
__global__ void __launch_bounds__(kMaxThreads, 2)
    ssd_split_kernel(SplitArgs a) {
  extern __shared__ __align__(16) float sm[];
  constexpr int RG = 32 / G;
  constexpr int NV = kTile / G > 0 ? kTile / G : 1;  // y values a lane keeps
  constexpr int VE = 16 / sizeof(T);          // elements of a 16-byte load
  const int N = a.N, L = a.L, NB = N + 4, XS = L + G, AS = L + 1;
  const int TT = L < kTile ? L : kTile;
  float* bs = sm;                  // L x NB
  float* cs = bs + L * NB;         // TT x N
  float* att = cs + TT * N;        // TT x AS
  float* xs = att + TT * AS;       // PS x XS: x[u][p0 + r] at r * XS + u
  float* dts = xs + a.PS * XS;     // L
  float* cum = dts + L;            // L
  float* ecum = cum + L;           // L  exp(cum)
  float* w = ecum + L;             // L  exp(cum_L - cum) dt

  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.B);
  const T* Cm = static_cast<const T*>(a.C);
  T* y = static_cast<T*>(a.y);
  const int slice = blockIdx.x % a.slices, bh = blockIdx.x / a.slices;
  const int h = bh % a.H, b = bh / a.H;
  const int p0 = slice * a.PS, np = min(a.PS, a.P - p0);
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int q = lane % G, r = (tid >> 5) * RG + lane / G;
  const bool live = r < np;
  const float A = a.A[h];
  const long srow = ((long)bh * a.P + p0 + r) * N;

  float st[VPL][4];  // the row's state, n = 4 (q + G j) + c
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    if (live && a.h0) {
      const float4 v =
          *reinterpret_cast<const float4*>(a.h0 + srow + 4 * (q + G * j));
      st[j][0] = v.x; st[j][1] = v.y; st[j][2] = v.z; st[j][3] = v.w;
    } else {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
    }
  }

  const int nvec = N / VE;
  // C rows t0 + r0 .. + nr of the chunk at t0 into cs, as 16-byte vectors
  auto stage_c = [&](int t0, int r0, int nr) {
    for (int i = tid; i < nr * nvec; i += nt) {
      const int rr = i / nvec, v = i % nvec;
      float f[VE];
      load16(Cm + b * a.c_sb + (long)(t0 + r0 + rr) * a.c_ss + v * VE, f);
#pragma unroll
      for (int c = 0; c < VE; c += 4)
        *reinterpret_cast<float4*>(cs + rr * N + v * VE + c) =
            make_float4(f[c], f[c + 1], f[c + 2], f[c + 3]);
    }
  };
  for (int t0 = 0; t0 < a.S; t0 += L) {
    const int len = min(L, a.S - t0);
    __syncthreads();  // the previous chunk's readers of smem are done
    for (int u = tid; u < len; u += nt)
      dts[u] = a.dt[b * a.dt_sb + (long)(t0 + u) * a.dt_ss + h * a.dt_sh];
    for (int i = tid; i < len * nvec; i += nt) {
      const int u = i / nvec, v = i % nvec;
      float f[VE];
      load16(Bm + b * a.b_sb + (long)(t0 + u) * a.b_ss + v * VE, f);
#pragma unroll
      for (int c = 0; c < VE; c += 4)
        *reinterpret_cast<float4*>(bs + u * NB + v * VE + c) =
            make_float4(f[c], f[c + 1], f[c + 2], f[c + 3]);
    }
    for (int i = tid; i < len * np; i += nt) {
      const int u = i / np, rr = i % np;
      xs[rr * XS + u] = to_f32(
          x[b * a.x_sb + (long)(t0 + u) * a.x_ss + h * a.x_sh + p0 + rr]);
    }
    stage_c(t0, 0, min(kTile, len));  // the first tile's, in the same round
    __syncthreads();
    if (tid < 32) {  // the cumsum: a warp scan, 32 terms at a time
      float carry = 0.f;
      for (int u0 = 0; u0 < len; u0 += 32) {
        const int u = u0 + lane;
        float v = u < len ? dts[u] * A : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float n = __shfl_up_sync(kFull, v, o);
          if (lane >= o) v += n;
        }
        v += carry;
        if (u < len) cum[u] = v;
        carry = __shfl_sync(kFull, v, 31);
      }
    }
    __syncthreads();
    const float cum_last = cum[len - 1];
    for (int u = tid; u < len; u += nt) {
      w[u] = expf(cum_last - cum[u]) * dts[u];
      ecum[u] = expf(cum[u]);
    }

    for (int r0 = 0; r0 < len; r0 += kTile) {
      const int nr = min(kTile, len - r0), ul = r0 + nr;
      if (r0 > 0) {
        __syncthreads();  // the previous tile's readers of cs, att are done
        stage_c(t0, r0, nr);
        __syncthreads();
      }
      // the tile's intra-chunk matrix, its entries u <= t (the only ones
      // read): 4 x 4 blocks of (t, u) on or below the diagonal, a group of
      // 8 lanes a block, each lane summing its 16-byte vectors j = q8
      // (mod 8) of C_t . B_u for the 16 pairs, then the 8 lanes folded
      {
        const int q8 = lane & 7, tr = (nr + 3) / 4, d0 = r0 / 4;
        const int nblk = tr * d0 + tr * (tr + 1) / 2;
        for (int k0 = (tid >> 5) * 4; k0 < nblk; k0 += (nt >> 5) * 4) {
          const int k = k0 + (lane >> 3);  // uniform trip count a warp
          int ti = 0, ui = k;
          while (ti < tr - 1 && ui >= d0 + ti + 1) ui -= d0 + ++ti;
          float acc[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[e] = 0.f;
          if (k < nblk) {
            int cr[4], br[4];  // float4 offsets of the rows, clamped
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              cr[e] = min(4 * ti + e, nr - 1) * (N / 4);
              br[e] = min(4 * ui + e, len - 1) * (NB / 4);
            }
            const float4* c4s = reinterpret_cast<const float4*>(cs);
            const float4* b4s = reinterpret_cast<const float4*>(bs);
            for (int j = q8; j < N / 4; j += 8) {
#pragma unroll
              for (int t4 = 0; t4 < 4; ++t4) {  // few registers live: one
                const float4 cc = c4s[cr[t4] + j];  // C and one B vector
#pragma unroll
                for (int u4 = 0; u4 < 4; ++u4) {
                  const float4 bb = b4s[br[u4] + j];
                  float v = fmaf(cc.x, bb.x, acc[4 * t4 + u4]);
                  v = fmaf(cc.y, bb.y, v);
                  v = fmaf(cc.z, bb.z, v);
                  acc[4 * t4 + u4] = fmaf(cc.w, bb.w, v);
                }
              }
            }
          }
          int base = 0;
          fold<8, 16>(acc, lane, base);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int rr = 4 * ti + (base + m) / 4, t = r0 + rr;
            const int u = 4 * ui + (base + m) % 4;
            if (k < nblk && rr < nr && u <= t)
              att[rr * AS + u] =
                  acc[m] * expf(cum[t] - cum[u]) * dts[u];
          }
        }
      }
      __syncthreads();
      // the lane's partial y of its row at each of the tile's positions:
      // its n's of e_t C_t . h, its u's (u = q mod G) of att x
      float part[kTile];
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        float s = 0.f;
        if (i < nr) {  // uniform across the block
          const int t = r0 + i;
          float c = 0.f;
#pragma unroll
          for (int j = 0; j < VPL; ++j) {
            const float4 c4 = *reinterpret_cast<const float4*>(
                cs + i * N + 4 * (q + G * j));
            c = fmaf(c4.x, st[j][0], c);
            c = fmaf(c4.y, st[j][1], c);
            c = fmaf(c4.z, st[j][2], c);
            c = fmaf(c4.w, st[j][3], c);
          }
          float in = 0.f;
          for (int u = q; u <= t; u += G)
            in = fmaf(att[i * AS + u], xs[r * XS + u], in);
          s = fmaf(ecum[t], c, in);
        }
        part[i] = s;
      }
      int base = 0;
      fold<G, kTile>(part, lane, base);
      if (live) {
#pragma unroll
        for (int m = 0; m < NV; ++m)
          if (base + m < nr)
            y[b * a.y_sb + (long)(t0 + r0 + base + m) * a.y_ss +
              h * a.y_sh + p0 + r] = from_f32<T>(part[m]);
      }
    }
    __syncthreads();  // every reader of the raw B is done
    for (int i = tid; i < len * (N / 4); i += nt) {
      const int u = i / (N / 4), j = i % (N / 4);
      float4* v = reinterpret_cast<float4*>(bs + u * NB) + j;
      const float wu = w[u];
      float4 f = *v;
      f.x *= wu; f.y *= wu; f.z *= wu; f.w *= wu;
      *v = f;
    }
    __syncthreads();
    // the state update in registers: fma(e, state, acc), acc the ordered
    // sum over the chunk of x_u (B_u w_u), as the block route adds it
    const float e = expf(cum_last);
    float acc[VPL][4];
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int u = 0; u < len; ++u) {
      const float xv = xs[r * XS + u];
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const float4 b4 = *reinterpret_cast<const float4*>(
            bs + u * NB + 4 * (q + G * j));
        acc[j][0] = fmaf(xv, b4.x, acc[j][0]);
        acc[j][1] = fmaf(xv, b4.y, acc[j][1]);
        acc[j][2] = fmaf(xv, b4.z, acc[j][2]);
        acc[j][3] = fmaf(xv, b4.w, acc[j][3]);
      }
    }
#pragma unroll
    for (int j = 0; j < VPL; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[j][c] = fmaf(e, st[j][c], acc[j][c]);
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      *reinterpret_cast<float4*>(a.hf + srow + 4 * (q + G * j)) =
          make_float4(st[j][0], st[j][1], st[j][2], st[j][3]);
  }
}

template <typename T, int G, int VPL>
int step_one(const StepArgs& a, int warps, cudaStream_t s) {
  const long per = (long)warps * (32 / G) * a.K;
  const long blocks = ((long)a.rows + per - 1) / per;
  ssd_step_kernel<T, G, VPL><<<(unsigned)blocks, 32 * warps, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int G, int VPL>
int split_one(const SplitArgs& a, long blocks, cudaStream_t s) {
  const long bytes = split_floats(a.N, a.L, a.PS, G) * 4;
  static long granted = 48 * 1024;  // per instantiation
  if (bytes > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_split_kernel<T, G, VPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    granted = bytes;
  }
  ssd_split_kernel<T, G, VPL>
      <<<(unsigned)blocks, 32 * (a.PS / (32 / G)), bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// the (G, VPL) pairs of kernels/mamba_scan.py:LANES
#define REPRO_SSD_LANES(X) \
  X(4, 1) X(8, 1) X(8, 2) X(8, 4) X(16, 1) X(16, 2) X(32, 1)

template <typename T>
int step_launch(const StepArgs& a, int g, int vpl, int warps,
                cudaStream_t s) {
#define X(G_, V_) \
  if (g == G_ && vpl == V_) return step_one<T, G_, V_>(a, warps, s);
  REPRO_SSD_LANES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int split_launch(const SplitArgs& a, int g, int vpl, long blocks,
                 cudaStream_t s) {
#define X(G_, V_) \
  if (g == G_ && vpl == V_) return split_one<T, G_, V_>(a, blocks, s);
  REPRO_SSD_LANES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the 16-byte vectors of B and C (and of the f32 state) that the step and
// split routes load: what kernels/mamba_scan.py:ssd_plan checks, checked
// again here
inline bool vectors_ok(const void* B, const void* C, const void* h0,
                       const void* hf, int N, int S, long long b_sb,
                       long long b_ss, long long c_sb, long long c_ss,
                       int esize) {
  const long long ve = 16 / esize;
  return aligned16(B) && aligned16(C) && (!h0 || aligned16(h0)) &&
         aligned16(hf) && N % ve == 0 && b_sb % ve == 0 && c_sb % ve == 0 &&
         (S == 1 || (b_ss % ve == 0 && c_ss % ve == 0));
}

}  // namespace

extern "C" int repro_ssd_scan(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* h0, void* y, void* hf, int Bn, int S, int H,
    int P, int N, int chunk, long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss, long long y_sb,
    long long y_ss, long long y_sh, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S < 1 || chunk < 1 || P < 1 || N < 1 || H < 1 || Bn < 1)
    return (int)cudaErrorInvalidValue;
  const int L = chunk < S ? chunk : S;
  SsdArgs a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
            B, C, static_cast<const float*>(h0), y, static_cast<float*>(hf),
            S, H, P, N, L, L < kTT ? L : kTT,
            x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss,
            y_sb, y_ss, y_sh};
  if (smem_floats(P, N, a.L, a.TT) * 4 > 232448)
    return (int)cudaErrorInvalidValue;
  if (dtype == kBF16) return launch<bf16>(a, Bn, s);
  if (dtype == kF32) return launch<float>(a, Bn, s);
  return (int)cudaErrorInvalidValue;
}

// route "step" (S = 1): rows_held rows a lane group, warps a block; g lanes
// a state row and vpl 16-byte vectors a lane (N = 4 g vpl)
extern "C" int repro_ssd_scan_step(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* h0, void* y, void* hf, int Bn, int H, int P,
    int N, long long x_sb, long long x_sh, long long dt_sb, long long dt_sh,
    long long b_sb, long long c_sb, long long y_sb, long long y_sh, int g,
    int vpl, int rows_held, int warps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int es = dtype == kBF16 ? 2 : 4;
  if (P < 1 || H < 1 || Bn < 1 || (long long)Bn * H * P >= (1LL << 31) ||
      g < 1 || vpl < 1 || 4 * g * vpl != N || rows_held < 1 ||
      rows_held * vpl > kStepMaxRows || warps < 1 ||
      32 * warps > kMaxThreads ||
      !vectors_ok(B, C, h0, hf, N, 1, b_sb, 0, c_sb, 0, es))
    return (int)cudaErrorInvalidValue;
  StepArgs a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
             B, C, static_cast<const float*>(h0), y, static_cast<float*>(hf),
             Bn * H * P, H, P, N, rows_held,
             x_sb, x_sh, dt_sb, dt_sh, b_sb, c_sb, y_sb, y_sh};
  if (dtype == kBF16) return step_launch<bf16>(a, g, vpl, warps, s);
  if (dtype == kF32) return step_launch<float>(a, g, vpl, warps, s);
  return (int)cudaErrorInvalidValue;
}

// route "split" (S > 1): rows state rows a block (a multiple of 32 / g, at
// most kMaxThreads / 32 warps' worth), g lanes a row and vpl 16-byte
// vectors a lane
extern "C" int repro_ssd_scan_split(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* h0, void* y, void* hf, int Bn, int S, int H,
    int P, int N, int chunk, long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss, long long y_sb,
    long long y_ss, long long y_sh, int g, int vpl, int rows, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int es = dtype == kBF16 ? 2 : 4;
  if (S < 1 || chunk < 1 || P < 1 || H < 1 || Bn < 1 || g < 1 || vpl < 1 ||
      4 * g * vpl != N || rows < 1 || rows % (32 / g) != 0 ||
      32 * (rows / (32 / g)) > kMaxThreads ||
      !vectors_ok(B, C, h0, hf, N, S, b_sb, b_ss, c_sb, c_ss, es))
    return (int)cudaErrorInvalidValue;
  const int L = chunk < S ? chunk : S;
  if (split_floats(N, L, rows, g) * 4 > 232448)
    return (int)cudaErrorInvalidValue;
  const int slices = (P + rows - 1) / rows;
  SplitArgs a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
              B, C, static_cast<const float*>(h0), y,
              static_cast<float*>(hf), S, H, P, N, L, rows, slices,
              x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss,
              y_sb, y_ss, y_sh};
  const long blocks = (long)Bn * H * slices;
  if (dtype == kBF16) return split_launch<bf16>(a, g, vpl, blocks, s);
  if (dtype == kF32) return split_launch<float>(a, g, vpl, blocks, s);
  return (int)cudaErrorInvalidValue;
}
