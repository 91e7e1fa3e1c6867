// Mamba-2 SSD chunked scan: y (B, S, H, P) and the final state (B, H, P, N)
// f32 from x (B, S, H, P), dt (B, S, H) f32, A (H,) f32, B and C (B, S, 1, N)
// and an optional carried state (B, H, P, N) f32.  Decode is the S = 1 call.
//
// Replaces src/repro/kernels/mamba_scan.py:ssd_scan_pallas.  Its TPU grid
// (B, H, n_chunks) walks the chunks in order on one core with the (P, N)
// state in VMEM scratch, after padding the sequence to a chunk multiple.
// Here one block owns one (row, head): the state lives in shared memory
// (f32, rows padded to N + 1 so that lanes reading a column hit distinct
// banks) and the chunk axis is a loop inside the block.  Per chunk of
// length L (the last one ragged, which is the padded chunk's math without
// the padding: a padded position has dt = 0) it computes what
// mamba_scan.py:_ssd_kernel computes:
//
//   cum     = cumsum(dt * a)                                   (L,)
//   y[t]    = sum_{u <= t} (C_t . B_u) exp(cum_t - cum_u) dt_u x_u
//             + (C_t exp(cum_t)) . state                        (L, P)
//   state'  = exp(cum_L) state + x^T (B * exp(cum_L - cum) dt)  (P, N)
//
// exp(cum_t - cum_u) grows without bound for u > t (cum falls), so those
// terms are skipped by a branch, never multiplied by a 0/1 mask (inf * 0 is
// NaN).  A position with dt = 0 contributes exactly zero to the state, and
// a chunk with dt = 0 everywhere leaves it bit for bit (exp(0) = 1).  y is
// produced in tiles of kTT rows: the tile's C rows, its (kTT, L) block of
// the intra-chunk matrix and its outputs.  B, C, x and dt are read in
// place by their strides (B and C are column slices of the in_proj output,
// row stride 2 d_inner + 2 N + H), each element once per chunk.
//
// What bounds it on Hopper: at decode (S = 1) bytes -- a read and a write
// of the f32 state, 2 * 4 * B * H * P * N (21 MB at mamba2-2.7b, B = 4:
// 6.3 us at 3.35 TB/s); over a long chunk the O(L^2 N) products, which
// run here as scalar f32 FMAs on shared-memory tiles.  Tensor cores
// (mma.sync on the C B^T and att x products), and splitting a head's P
// across blocks to fill the card at small B * H, are later work.
#include "common.cuh"

namespace {
using namespace repro;

constexpr int kThreads = 256;
constexpr int kTT = 16;  // y rows per tile

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
