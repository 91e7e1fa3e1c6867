// Backward of the attention forward (flash_attention.cu's forward mode):
// q (B, Sq, Hq, D), k, v (B, Sk, Hkv, D), the forward's out (B, Sq, Hq, D)
// and lse (B, Hq, Sq) f32, and do (B, Sq, Hq, D) give dq in q's layout and
// dk, dv in k's, all in the input dtype; query i sits at position i,
// causal or not, optionally windowed.  Everything is recomputed from lse
// in f32: p = exp(s - lse) under the forward's mask, dp = do . v,
// ds = p * (dp - dd) with dd = rowsum(do * out).
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_bwd_pallas
// (its _flash_dq_kernel and _flash_dkv_kernel) in f32, and in bf16 where
// flash_attention_bwd_tc.cu's tensor-core kernels do not apply (a head
// dim that is no multiple of 16, strides the 16-byte copies cannot
// follow; kernels/flash_attention.py:bwd_plan).  Two passes, as there:
//
//   * dq pass: a block owns one (row, kv head, tile of kRows query rows).
//     As in the forward, row r of a (row, kv head) pair is query token
//     r / G of group head r % G, so each K/V tile serves the whole GQA
//     group.  The block computes dd for its rows (and writes it for the
//     second pass), then walks the key tiles that its rows can see (the
//     causal / window skip of flash_attention.py:196-199) with dq in f32
//     registers: lanes own keys while scoring, dimensions while
//     accumulating ds . k.
//   * dk/dv pass: a block owns one (row, kv head, tile of kBK keys) and
//     walks every (group head, query tile) that can see them (the skip of
//     :234-237), so dk and dv are summed over the group in f32 inside the
//     block, with no atomics.  Query rows past Sq are masked (:247-249).
//     Lanes own keys while scoring; then a thread owns one key and every
//     fourth dimension of its dk and dv.
//
// What bounds it on Hopper: at the training shapes (B 2, S 256, D 128) the
// operations, about 10 flops per (query, key, dimension) triple in f32
// against 3.35 TB/s for reading each input once; these are scalar FMAs
// over shared-memory tiles: IEEE f32, as the reference computes.  The
// dk/dv grid is small: B * Hkv * Sk / 32 blocks (32 at qwen2.5-3b's 2 kv
// heads).
#include "common.cuh"

namespace {
using namespace repro;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;     // keys per tile: one per lane when scoring
constexpr int kDMax = 128;  // head dim limit (checked by the wrapper)
constexpr int kRows = 8;    // query rows per tile
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kDPerLane = kDMax / 32;
constexpr int kDPerThread = kDMax / 4;  // dk/dv pass: 4 threads per key

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;
  float* dd;  // (B, Hq, Sq) f32 scratch: written by the dq pass
  void* dq;
  void* dk;
  void* dv;
  int G, Sq, Sk, D;
  int causal;
  int window;  // < 0: none
  long q_sb, q_ss, q_sh;    // q, out, do, dq share one layout
  long o_sb, o_ss, o_sh;
  long do_sb, do_ss, do_sh;
  long k_sb, k_ss, k_sh;    // k, v, dk, dv: (B, Sk, Hkv, D)
  long v_sb, v_ss, v_sh;
  long dq_sb, dq_ss, dq_sh;
  long dk_sb, dk_ss, dk_sh;
  long l_sb, l_sh;          // lse and dd: (B, Hq, Sq), unit stride in Sq
  float scale;
};

__device__ __forceinline__ bool visible(const BwdArgs& a, int qp, int kp) {
  if (qp >= a.Sq || kp >= a.Sk) return false;
  if (a.causal && kp > qp) return false;
  if (a.window >= 0 && kp <= qp - a.window) return false;
  return true;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dq_kernel(BwdArgs a) {
  __shared__ float qs[kRows][kDMax];
  __shared__ float dos[kRows][kDMax];
  __shared__ float ks[kBK][kDMax + 1];  // +1: lanes read distinct rows
  __shared__ float vs[kBK][kDMax + 1];
  __shared__ float lse_s[kRows], dd_s[kRows];

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* o = static_cast<const T*>(a.out);
  const T* dout = static_cast<const T*>(a.dout);
  T* dq = static_cast<T*>(a.dq);
  const int b = blockIdx.x, h = blockIdx.y;
  const int r0 = blockIdx.z * kRows;
  const int nr = min(kRows, a.G * a.Sq - r0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int D = a.D;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    float x = 0.f, g = 0.f;
    if (rr < nr) {
      const int r = r0 + rr, qi = r / a.G, hq = h * a.G + r % a.G;
      x = to_f32(q[b * a.q_sb + qi * a.q_ss + hq * a.q_sh + d]);
      g = to_f32(dout[b * a.do_sb + qi * a.do_ss + hq * a.do_sh + d]);
    }
    qs[rr][d] = x;
    dos[rr][d] = g;
  }
  // dd = rowsum(do * out) in f32, one warp per row
  for (int rr = warp; rr < kRows; rr += kWarps) {
    float acc = 0.f, l = 0.f;
    if (rr < nr) {
      const int r = r0 + rr, qi = r / a.G, hq = h * a.G + r % a.G;
      const T* orow = o + b * a.o_sb + qi * a.o_ss + hq * a.o_sh;
      const T* drow = dout + b * a.do_sb + qi * a.do_ss + hq * a.do_sh;
      for (int d = lane; d < D; d += 32)
        acc += to_f32(drow[d]) * to_f32(orow[d]);
      l = a.lse[b * a.l_sb + hq * a.l_sh + qi];
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      dd_s[rr] = acc;
      lse_s[rr] = l;
      if (rr < nr) {
        const int r = r0 + rr;
        a.dd[b * a.l_sb + (h * a.G + r % a.G) * a.l_sh + r / a.G] = acc;
      }
    }
  }

  // the keys the tile's rows can see: rows are ordered by query token
  const int q_lo = r0 / a.G, q_hi = (r0 + nr - 1) / a.G;
  const int hi = a.causal ? min(q_hi + 1, a.Sk) : a.Sk;
  const int lo = a.window >= 0 ? max(0, q_lo - a.window + 1) : 0;

  float acc[kRowsPerWarp][kDPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < kDPerLane; ++i) acc[r][i] = 0.f;

  for (int t0 = (lo / kBK) * kBK; t0 < hi; t0 += kBK) {
    __syncthreads();  // q/do/dd staged, or the previous tile consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i % D, s = t0 + j;
      const bool in = s < a.Sk;
      ks[j][d] = in ? to_f32(k[b * a.k_sb + (long)s * a.k_ss + h * a.k_sh + d])
                    : 0.f;
      vs[j][d] = in ? to_f32(v[b * a.v_sb + (long)s * a.v_ss + h * a.v_sh + d])
                    : 0.f;
    }
    __syncthreads();
    const int kp = t0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int rr = warp + r * kWarps;
      if (rr < nr) {  // warp-uniform
        const int qp = (r0 + rr) / a.G;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(qs[rr][d], ks[lane][d], s);
          dp = fmaf(dos[rr][d], vs[lane][d], dp);
        }
        const float p = visible(a, qp, kp) ? expf(s * a.scale - lse_s[rr])
                                           : 0.f;
        const float ds = p * (dp - dd_s[rr]);
        for (int j = 0; j < kBK; ++j) {
          const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
          for (int i = 0; i < kDPerLane; ++i) {
            const int d = lane + 32 * i;
            if (d < D) acc[r][i] = fmaf(dsj, ks[j][d], acc[r][i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int rr = warp + r * kWarps;
    if (rr < nr) {
      const int row = r0 + rr, qi = row / a.G, hq = h * a.G + row % a.G;
#pragma unroll
      for (int i = 0; i < kDPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D)
          dq[b * a.dq_sb + qi * a.dq_ss + hq * a.dq_sh + d] =
              from_f32<T>(acc[r][i] * a.scale);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dkv_kernel(BwdArgs a) {
  __shared__ float ks[kBK][kDMax + 1];
  __shared__ float vs[kBK][kDMax + 1];
  __shared__ float qs[kRows][kDMax];
  __shared__ float dos[kRows][kDMax];
  __shared__ float ps[kRows][kBK], dss[kRows][kBK];
  __shared__ float lse_s[kRows], dd_s[kRows];

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  const int b = blockIdx.x, h = blockIdx.y, k0 = blockIdx.z * kBK;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int D = a.D;

  for (int i = tid; i < kBK * D; i += kThreads) {
    const int j = i / D, d = i % D, s = k0 + j;
    const bool in = s < a.Sk;
    ks[j][d] = in ? to_f32(k[b * a.k_sb + (long)s * a.k_ss + h * a.k_sh + d])
                  : 0.f;
    vs[j][d] = in ? to_f32(v[b * a.v_sb + (long)s * a.v_ss + h * a.v_sh + d])
                  : 0.f;
  }

  // the query positions that can see a key of this tile
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window >= 0 ? min(a.Sq, k0 + kBK - 1 + a.window) : a.Sq;

  // accumulation: thread owns key jk and dimensions dq0 + 4 i
  const int jk = tid / 4, dq0 = tid % 4;
  float dk_acc[kDPerThread], dv_acc[kDPerThread];
#pragma unroll
  for (int i = 0; i < kDPerThread; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int g = 0; g < a.G; ++g) {
    const int hq = h * a.G + g;
    for (int qt = (q_lo / kRows) * kRows; qt < q_hi; qt += kRows) {
      __syncthreads();  // K/V staged, or the previous query tile consumed
      for (int i = tid; i < kRows * D; i += kThreads) {
        const int rr = i / D, d = i % D, qi = qt + rr;
        const bool in = qi < a.Sq;
        qs[rr][d] = in ? to_f32(q[b * a.q_sb + qi * a.q_ss + hq * a.q_sh + d])
                       : 0.f;
        dos[rr][d] =
            in ? to_f32(dout[b * a.do_sb + qi * a.do_ss + hq * a.do_sh + d])
               : 0.f;
      }
      if (tid < kRows) {
        const int qi = qt + tid;
        const bool in = qi < a.Sq;
        lse_s[tid] = in ? a.lse[b * a.l_sb + hq * a.l_sh + qi] : 0.f;
        dd_s[tid] = in ? a.dd[b * a.l_sb + hq * a.l_sh + qi] : 0.f;
      }
      __syncthreads();
      const int kp = k0 + lane;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int rr = warp + r * kWarps, qp = qt + rr;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(qs[rr][d], ks[lane][d], s);
          dp = fmaf(dos[rr][d], vs[lane][d], dp);
        }
        // padded query rows and masked pairs: p = 0
        const float p = visible(a, qp, kp) ? expf(s * a.scale - lse_s[rr])
                                           : 0.f;
        ps[rr][lane] = p;
        dss[rr][lane] = p * (dp - dd_s[rr]);
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float p = ps[rr][jk], ds = dss[rr][jk];
#pragma unroll
        for (int i = 0; i < kDPerThread; ++i) {
          const int d = dq0 + 4 * i;
          if (d < D) {
            dv_acc[i] = fmaf(p, dos[rr][d], dv_acc[i]);
            dk_acc[i] = fmaf(ds, qs[rr][d], dk_acc[i]);
          }
        }
      }
    }
  }

  const int s = k0 + jk;
  if (s < a.Sk) {
#pragma unroll
    for (int i = 0; i < kDPerThread; ++i) {
      const int d = dq0 + 4 * i;
      if (d < D) {
        dk[b * a.dk_sb + (long)s * a.dk_ss + h * a.dk_sh + d] =
            from_f32<T>(dk_acc[i] * a.scale);
        dv[b * a.dk_sb + (long)s * a.dk_ss + h * a.dk_sh + d] =
            from_f32<T>(dv_acc[i]);
      }
    }
  }
}

template <typename T>
int launch(const BwdArgs& a, int B, int Hkv, cudaStream_t s) {
  const dim3 block(kThreads);
  const dim3 g1(B, Hkv, (a.G * a.Sq + kRows - 1) / kRows);
  dq_kernel<T><<<g1, block, 0, s>>>(a);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const dim3 g2(B, Hkv, (a.Sk + kBK - 1) / kBK);
  dkv_kernel<T><<<g2, block, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dk and dv share one layout (the wrapper allocates both contiguous)
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dd, void* dq, void* dk,
    void* dv, int B, int Hkv, int G, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh, long long dq_sb,
    long long dq_ss, long long dq_sh, long long dk_sb, long long dk_ss,
    long long dk_sh, long long l_sb, long long l_sh, int causal, int window,
    float scale, int dtype, void* stream) {
  if (D < 1 || D > kDMax || G < 1 || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{q, k, v, out, dout, static_cast<const float*>(lse),
            static_cast<float*>(dd), dq, dk, dv, G, Sq, Sk, D, causal,
            window, q_sb, q_ss, q_sh, o_sb, o_ss, o_sh, do_sb, do_ss, do_sh,
            k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, dq_sb, dq_ss, dq_sh,
            dk_sb, dk_ss, dk_sh, l_sb, l_sh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch<bf16>(a, B, Hkv, s);
  if (dtype == kF32) return launch<float>(a, B, Hkv, s);
  return (int)cudaErrorInvalidValue;
}
