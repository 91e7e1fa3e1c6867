// Attention backward on Hopper's tensor cores, bf16: from q (B, Sq, Hq, D),
// k, v (B, Sk, Hkv, D), the forward's out and lse (B, Hq, Sq) f32 and the
// output gradient do, dq in q's layout and dk, dv in k's; query i at
// position i, causal or not, optionally windowed (flash_attention_bwd.cu's
// semantics: p = exp(s * scale - lse) under the forward's mask, dp = do .
// v, ds = p * (dp - dd) with dd = rowsum(do * out)).
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_bwd_pallas
// (_flash_dq_kernel :184, _flash_dkv_kernel :220) for bf16 at head dims
// that are multiples of 16 up to 128 with strides the 16-byte copies can
// follow; f32 (and any other shape) keeps flash_attention_bwd.cu's scalar
// kernels, IEEE f32 end to end as the reference computes (the tensor
// cores take no f32 operands, and TF32 keeps 10 mantissa bits).
//
// What bounds it on the H100: at qwen2.5-3b's training shape (B 2, S 256,
// 16 q heads of 128, causal) the pass reads and writes 9.4 MB (2.8 us at
// 3.35 TB/s) and does 7 products of 2 D flops per visible (query, key)
// pair, 1.9 GFLOP (1.9 us at 989 TFLOP/s), so bytes bound it; but the
// 128-block grid, one block an SM with 4 warps, is short, so what holds
// it in practice is the latency of each block's chain of tiles.
//
// Three kernels, no atomics:
// * dq_tc_kernel: one block per (b, q head, 64 query rows), 4 warps of 16
//   rows.  It computes dd for its rows in f32 (written for the next
//   kernel), then walks the key tiles its rows can see
//   (kernels/flash_attention.py:dq_key_tiles; the visible predicate masks
//   inside a tile), K/V tiles double-buffered by cp.async: S = Q K^T and
//   dP = dO V^T on mma.sync m16n8k16 with f32 accumulators, P and dS in
//   f32 registers, then dQ += dS K with dS rounded to bf16 as the A
//   operand straight from the accumulator fragments (FlashAttention-2's
//   register reuse).  dQ stays in f32 registers and is scaled and rounded
//   once.
// * dkv_tc_kernel: one block per (b, q head, 64 keys), 4 warps of 16 keys;
//   K and V stay in shared memory while the query tiles that can see the
//   keys (flash_attention.py:dkv_query_tiles) stream through a cp.async
//   double buffer: S^T = K Q^T, dP^T = V dO^T, then dV += P^T dO and dK +=
//   dS^T Q with P^T and dS^T rounded to bf16, in halves of 32 queries to
//   bound registers.  With G = Hq / Hkv = 1 it writes dk, dv; with G > 1
//   it writes its q head's f32 partials into a (B, Sk, Hq, D) scratch.
// * gqa_reduce: dk, dv = the sum of each kv head's G partials in the order
//   g = 0..G-1, dk scaled, each rounded once.
// Grids: B * Hq * ceil(S / 64) blocks, 128 at qwen2.5-3b's shape, 256 at
// zamba2-2.7b's and mixtral-8x7b's.  Shared tiles are 64 rows of 256 bytes
// (D <= 128 bf16), XOR-swizzled in 16-byte chunks (common.cuh swz).
//
// The one numeric difference from the scalar kernels: P and dS are
// rounded to bf16 before the second products (dQ, dK, dV), as the tensor
// cores take them.
#include "common.cuh"

namespace {
using namespace repro;

constexpr int kThreads = 128;
constexpr int kT = 64;          // query rows / keys per tile
constexpr int kDMax = 128;
constexpr int kRowBytes = 256;  // kDMax bf16
constexpr int kTileBytes = kT * kRowBytes;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* out;
  const bf16* dout;
  const float* lse;
  float* dd;       // (B, Hq, Sq) f32: written by dq_tc_kernel
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* dk_part;  // (B, Sk, Hq, D) f32 when G > 1
  float* dv_part;
  int Hq, G, Sq, Sk, D;
  int causal;
  int window;  // < 0: none
  long q_sb, q_ss, q_sh;
  long k_sb, k_ss, k_sh;
  long v_sb, v_ss, v_sh;
  long o_sb, o_ss, o_sh;
  long do_sb, do_ss, do_sh;
  long dq_sb, dq_ss, dq_sh;
  long dk_sb, dk_ss, dk_sh;  // dk and dv share one layout
  long l_sb, l_sh;           // lse and dd, unit stride in Sq
  float scale;
};

__device__ __forceinline__ bool visible(const Args& a, int qp, int kp) {
  if (qp >= a.Sq || kp >= a.Sk) return false;
  if (a.causal && kp > qp) return false;
  if (a.window >= 0 && kp <= qp - a.window) return false;
  return true;
}

// rows [row0, row0 + 64) of one head of a (B, S, H, D) tensor into a
// swizzled shared tile, zero past `rows`
__device__ __forceinline__ void load_rows(uint32_t s, const bf16* base,
                                          long ss, int row0, int rows, int D,
                                          int tid) {
  const int nc = D >> 3;
  for (int id = tid; id < kT * nc; id += kThreads) {
    const int r = id / nc, c = id - r * nc;
    const bool in = row0 + r < rows;
    cp_async16(s + swz(r, c, kRowBytes),
               in ? base + (long)(row0 + r) * ss + c * 8 : base, in ? 16 : 0);
  }
}

// The B operand of 16 x 16 (k) x (n = 2 x 8) from a tile whose rows are n
// and whose columns are k: rows n0.., k chunk pair kk (non-transposed)
__device__ __forceinline__ void ldsm_b_nk(uint32_t (&r)[4], uint32_t s,
                                          int n0, int kk, int lane) {
  const int i = lane >> 3;
  ldsm_x4(r, s + swz(n0 + (lane & 7) + 8 * (i >> 1), kk * 2 + (i & 1),
                     kRowBytes));
}
// the same from a tile whose rows are k and whose columns are n (rows
// k0.., n chunk pair np): transposed
__device__ __forceinline__ void ldsm_b_kn(uint32_t (&r)[4], uint32_t s,
                                          int k0, int np, int lane) {
  const int i = lane >> 3;
  ldsm_x4_t(r, s + swz(k0 + (lane & 7) + 8 * (i & 1), np * 2 + (i >> 1),
                       kRowBytes));
}
// the A operand (16 rows from row0, k chunk pair kk) of a row-major tile
__device__ __forceinline__ void ldsm_a(uint32_t (&r)[4], uint32_t s,
                                       int row0, int kk, int lane) {
  ldsm_x4(r, s + swz(row0 + (lane & 15), kk * 2 + (lane >> 4), kRowBytes));
}

__global__ void __launch_bounds__(kThreads)
dq_tc_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = smem_addr(smem), sDO = sQ + kTileBytes;
  const uint32_t sK = sQ + 2 * kTileBytes;   // 2 buffers
  const uint32_t sV = sQ + 4 * kTileBytes;   // 2 buffers
  float* lse_s = reinterpret_cast<float*>(smem + 6 * kTileBytes);
  float* dd_s = lse_s + kT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kT, hq = blockIdx.y, b = blockIdx.z;
  const int h = hq / a.G, D = a.D, nd16 = D >> 4;
  const bf16* kb = a.k + b * a.k_sb + h * a.k_sh;
  const bf16* vb = a.v + b * a.v_sb + h * a.v_sh;

  load_rows(sQ, a.q + b * a.q_sb + hq * a.q_sh, a.q_ss, q0, a.Sq, D, tid);
  load_rows(sDO, a.dout + b * a.do_sb + hq * a.do_sh, a.do_ss, q0, a.Sq, D,
            tid);
  cp_async_commit();

  // the key tiles these rows can see (flash_attention.py:dq_key_tiles)
  const int hi = a.causal ? min(a.Sk, min(q0 + kT, a.Sq)) : a.Sk;
  const int lo = a.window >= 0 ? max(0, q0 - a.window + 1) : 0;
  const int t_first = (lo / kT) * kT;
  const int ntiles = hi > t_first ? (hi - t_first + kT - 1) / kT : 0;
  if (ntiles > 0) {
    load_rows(sK, kb, a.k_ss, t_first, a.Sk, D, tid);
    load_rows(sV, vb, a.v_ss, t_first, a.Sk, D, tid);
  }
  cp_async_commit();

  // dd = rowsum(do * out) in f32: two threads a row, 16-byte loads
  {
    const int r = tid >> 1, half = tid & 1, qi = q0 + r;
    float acc = 0.f;
    if (qi < a.Sq) {
      const bf16* orow = a.out + b * a.o_sb + (long)qi * a.o_ss + hq * a.o_sh;
      const bf16* drow =
          a.dout + b * a.do_sb + (long)qi * a.do_ss + hq * a.do_sh;
      for (int c = half; c < (D >> 3); c += 2) {
        float o[8], g[8];
        load16(orow + c * 8, o);
        load16(drow + c * 8, g);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(o[e], g[e], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      dd_s[r] = acc;
      lse_s[r] = qi < a.Sq ? a.lse[b * a.l_sb + hq * a.l_sh + qi] : 0.f;
      if (qi < a.Sq) a.dd[b * a.l_sb + hq * a.l_sh + qi] = acc;
    }
  }

  __syncthreads();  // dd_s and lse_s written
  const int wr = warp * 16, g = lane >> 2, t = lane & 3;
  const float sl2 = a.scale * kLog2e;
  float lse_r[2], dd_r[2];
  int qp_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    lse_r[hh] = lse_s[wr + g + 8 * hh] * kLog2e;
    dd_r[hh] = dd_s[wr + g + 8 * hh];
    qp_r[hh] = q0 + wr + g + 8 * hh;
  }
  float dq[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int t0 = t_first + j * kT;
    const uint32_t kbuf = sK + (j & 1) * kTileBytes;
    const uint32_t vbuf = sV + (j & 1) * kTileBytes;
    if (j + 1 < ntiles) {
      load_rows(sK + ((j + 1) & 1) * kTileBytes, kb, a.k_ss, t0 + kT, a.Sk, D,
                tid);
      load_rows(sV + ((j + 1) & 1) * kTileBytes, vb, a.v_ss, t0 + kT, a.Sk, D,
                tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // Q, dO and tile j landed

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDMax / 16; ++kk) {
      if (kk < nd16) {
        uint32_t qa[4], da[4];
        ldsm_a(qa, sQ, wr, kk, lane);
        ldsm_a(da, sDO, wr, kk, lane);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t kf[4], vf[4];
          ldsm_b_nk(kf, kbuf, p * 16, kk, lane);
          ldsm_b_nk(vf, vbuf, p * 16, kk, lane);
          mma_bf16(s[2 * p], qa, kf[0], kf[1]);
          mma_bf16(s[2 * p + 1], qa, kf[2], kf[3]);
          mma_bf16(dp[2 * p], da, vf[0], vf[1]);
          mma_bf16(dp[2 * p + 1], da, vf[2], vf[3]);
        }
      }
    }
    // P and dS in f32, dS rounded to bf16 A fragments (16 keys each)
    uint32_t dsa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, kp = t0 + n * 8 + 2 * t + (e & 1);
        const float p = visible(a, qp_r[hh], kp)
                            ? exp2f(fmaf(s[n][e], sl2, -lse_r[hh]))
                            : 0.f;
        ds[e] = p * (dp[n][e] - dd_r[hh]);
      }
      dsa[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dQ += dS K: K read as (keys = k) x (D = n), transposed
#pragma unroll
    for (int kq = 0; kq < 4; ++kq)
#pragma unroll
      for (int np = 0; np < kDMax / 16; ++np) {
        if (np < nd16) {
          uint32_t kf[4];
          ldsm_b_kn(kf, kbuf, kq * 16, np, lane);
          mma_bf16(dq[2 * np], dsa[kq], kf[0], kf[1]);
          mma_bf16(dq[2 * np + 1], dsa[kq], kf[2], kf[3]);
        }
      }
    __syncthreads();  // tile j consumed before its buffer is refilled
  }
  cp_async_wait<0>();

  // dq = scale * dQ, rounded once
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + wr + g + 8 * hh;
    if (qi >= a.Sq) continue;
    bf16* row = a.dq + b * a.dq_sb + (long)qi * a.dq_ss + hq * a.dq_sh;
#pragma unroll
    for (int n = 0; n < kDMax / 8; ++n) {
      const int d = n * 8 + 2 * t;
      if (d < D)
        *reinterpret_cast<uint32_t*>(row + d) =
            pack_bf16(dq[n][2 * hh] * a.scale, dq[n][2 * hh + 1] * a.scale);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dkv_tc_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sK = smem_addr(smem), sV = sK + kTileBytes;
  const uint32_t sQ = sK + 2 * kTileBytes;   // 2 buffers
  const uint32_t sDO = sK + 4 * kTileBytes;  // 2 buffers
  float* lse_s = reinterpret_cast<float*>(smem + 6 * kTileBytes);  // [2][64]
  float* dd_s = lse_s + 2 * kT;                                    // [2][64]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * kT, hq = blockIdx.y, b = blockIdx.z;
  const int h = hq / a.G, D = a.D, nd16 = D >> 4;
  const bf16* qb = a.q + b * a.q_sb + hq * a.q_sh;
  const bf16* dob = a.dout + b * a.do_sb + hq * a.do_sh;
  const float* lrow = a.lse + b * a.l_sb + hq * a.l_sh;
  const float* drow = a.dd + b * a.l_sb + hq * a.l_sh;

  load_rows(sK, a.k + b * a.k_sb + h * a.k_sh, a.k_ss, k0, a.Sk, D, tid);
  load_rows(sV, a.v + b * a.v_sb + h * a.v_sh, a.v_ss, k0, a.Sk, D, tid);

  // the query tiles that can see these keys
  // (flash_attention.py:dkv_query_tiles)
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window >= 0 ? min(a.Sq, k0 + kT - 1 + a.window) : a.Sq;
  const int t_first = (q_lo / kT) * kT;
  const int ntiles = q_hi > t_first ? (q_hi - t_first + kT - 1) / kT : 0;

  auto load_q = [&](int buf, int qt0) {
    load_rows(sQ + buf * kTileBytes, qb, a.q_ss, qt0, a.Sq, D, tid);
    load_rows(sDO + buf * kTileBytes, dob, a.do_ss, qt0, a.Sq, D, tid);
    if (tid < kT) {
      const int qi = qt0 + tid;
      lse_s[buf * kT + tid] = qi < a.Sq ? lrow[qi] * kLog2e : 0.f;
      dd_s[buf * kT + tid] = qi < a.Sq ? drow[qi] : 0.f;
    }
  };
  if (ntiles > 0) load_q(0, t_first);
  cp_async_commit();

  const int kr = warp * 16, g = lane >> 2, t = lane & 3;
  const float sl2 = a.scale * kLog2e;
  const int kp_r[2] = {k0 + kr + g, k0 + kr + g + 8};
  float dk[16][4], dv[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int qt0 = t_first + j * kT, buf = j & 1;
    if (j + 1 < ntiles) load_q(buf ^ 1, qt0 + kT);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // K, V and query tile j landed
    const uint32_t qbuf = sQ + buf * kTileBytes;
    const uint32_t dbuf = sDO + buf * kTileBytes;
    const float* ls = lse_s + buf * kT;
    const float* ds_ = dd_s + buf * kT;

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries a warp
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDMax / 16; ++kk) {
        if (kk < nd16) {
          uint32_t ka[4], va[4];
          ldsm_a(ka, sK, kr, kk, lane);
          ldsm_a(va, sV, kr, kk, lane);
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            uint32_t qf[4], df[4];
            ldsm_b_nk(qf, qbuf, hf * 32 + p * 16, kk, lane);
            ldsm_b_nk(df, dbuf, hf * 32 + p * 16, kk, lane);
            mma_bf16(st[2 * p], ka, qf[0], qf[1]);
            mma_bf16(st[2 * p + 1], ka, qf[2], qf[3]);
            mma_bf16(dpt[2 * p], va, df[0], df[1]);
            mma_bf16(dpt[2 * p + 1], va, df[2], df[3]);
          }
        }
      }
      // P^T and dS^T, rounded to bf16 A fragments (16 queries each)
      uint32_t pa[2][4], dsa[2][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float pv[4], dv_[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = hf * 32 + n * 8 + 2 * t + (e & 1);
          const float p = visible(a, qt0 + col, kp_r[e >> 1])
                              ? exp2f(fmaf(st[n][e], sl2, -ls[col]))
                              : 0.f;
          pv[e] = p;
          dv_[e] = p * (dpt[n][e] - ds_[col]);
        }
        pa[n >> 1][(n & 1) * 2] = pack_bf16(pv[0], pv[1]);
        pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
        dsa[n >> 1][(n & 1) * 2] = pack_bf16(dv_[0], dv_[1]);
        dsa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(dv_[2], dv_[3]);
      }
      // dV += P^T dO, dK += dS^T Q: dO and Q read as (queries = k) x
      // (D = n), transposed
#pragma unroll
      for (int kq = 0; kq < 2; ++kq)
#pragma unroll
        for (int np = 0; np < kDMax / 16; ++np) {
          if (np < nd16) {
            uint32_t df[4], qf[4];
            ldsm_b_kn(df, dbuf, hf * 32 + kq * 16, np, lane);
            ldsm_b_kn(qf, qbuf, hf * 32 + kq * 16, np, lane);
            mma_bf16(dv[2 * np], pa[kq], df[0], df[1]);
            mma_bf16(dv[2 * np + 1], pa[kq], df[2], df[3]);
            mma_bf16(dk[2 * np], dsa[kq], qf[0], qf[1]);
            mma_bf16(dk[2 * np + 1], dsa[kq], qf[2], qf[3]);
          }
        }
    }
    __syncthreads();  // query tile j consumed before its buffer is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int s = kp_r[hh];
    if (s >= a.Sk) continue;
    if (a.G == 1) {
      bf16* krow = a.dk + b * a.dk_sb + (long)s * a.dk_ss + h * a.dk_sh;
      bf16* vrow = a.dv + b * a.dk_sb + (long)s * a.dk_ss + h * a.dk_sh;
#pragma unroll
      for (int n = 0; n < kDMax / 8; ++n) {
        const int d = n * 8 + 2 * t;
        if (d < D) {
          *reinterpret_cast<uint32_t*>(krow + d) = pack_bf16(
              dk[n][2 * hh] * a.scale, dk[n][2 * hh + 1] * a.scale);
          *reinterpret_cast<uint32_t*>(vrow + d) =
              pack_bf16(dv[n][2 * hh], dv[n][2 * hh + 1]);
        }
      }
    } else {
      const long off = (((long)b * a.Sk + s) * a.Hq + hq) * D;
#pragma unroll
      for (int n = 0; n < kDMax / 8; ++n) {
        const int d = n * 8 + 2 * t;
        if (d < D) {
          *reinterpret_cast<float2*>(a.dk_part + off + d) =
              make_float2(dk[n][2 * hh], dk[n][2 * hh + 1]);
          *reinterpret_cast<float2*>(a.dv_part + off + d) =
              make_float2(dv[n][2 * hh], dv[n][2 * hh + 1]);
        }
      }
    }
  }
}

// dk, dv (b, s, h, d) = the G q heads' partials summed in order g = 0..G-1
// (dk times scale), rounded once; 4 dims a thread
__global__ void __launch_bounds__(256) gqa_reduce(Args a, int B, int Hkv) {
  const long i = ((long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  const int D = a.D;
  const long total = (long)B * a.Sk * Hkv * D;
  if (i >= total) return;
  const int d = (int)(i % D);
  long r = i / D;
  const int h = (int)(r % Hkv);
  r /= Hkv;
  const int s = (int)(r % a.Sk), b = (int)(r / a.Sk);
  const long base = (((long)b * a.Sk + s) * a.Hq + (long)h * a.G) * D + d;
  float4 sk = *reinterpret_cast<const float4*>(a.dk_part + base);
  float4 sv = *reinterpret_cast<const float4*>(a.dv_part + base);
  for (int gg = 1; gg < a.G; ++gg) {
    const float4 xk =
        *reinterpret_cast<const float4*>(a.dk_part + base + (long)gg * D);
    const float4 xv =
        *reinterpret_cast<const float4*>(a.dv_part + base + (long)gg * D);
    sk.x += xk.x; sk.y += xk.y; sk.z += xk.z; sk.w += xk.w;
    sv.x += xv.x; sv.y += xv.y; sv.z += xv.z; sv.w += xv.w;
  }
  const long o = b * a.dk_sb + (long)s * a.dk_ss + h * a.dk_sh + d;
  uint2 pk, pv;
  pk.x = pack_bf16(sk.x * a.scale, sk.y * a.scale);
  pk.y = pack_bf16(sk.z * a.scale, sk.w * a.scale);
  pv.x = pack_bf16(sv.x, sv.y);
  pv.y = pack_bf16(sv.z, sv.w);
  *reinterpret_cast<uint2*>(a.dk + o) = pk;
  *reinterpret_cast<uint2*>(a.dv + o) = pv;
}

constexpr int kSmemBytes = 6 * kTileBytes + 4 * kT * (int)sizeof(float);

}  // namespace

// The caller (kernels/flash_attention.py) vouches for bf16 tensors with D
// a multiple of 16 up to 128, unit stride on D, 16-byte aligned bases and
// other strides multiples of 8; dk and dv contiguous (B, Sk, Hkv, D), and,
// when G > 1, two f32 (B, Sk, Hq, D) scratch tensors.
extern "C" int repro_flash_attention_bwd_tc(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dd, void* dq, void* dk,
    void* dv, void* dk_part, void* dv_part, int B, int Hkv, int G, int Sq,
    int Sk, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh, long long dk_sb,
    long long dk_ss, long long dk_sh, long long l_sb, long long l_sh,
    int causal, int window, float scale, void* stream) {
  if (D < 16 || D > kDMax || D % 16 || G < 1 || Sq < 1 || Sk < 1 ||
      (G > 1 && (dk_part == nullptr || dv_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
         static_cast<const bf16*>(v), static_cast<const bf16*>(out),
         static_cast<const bf16*>(dout), static_cast<const float*>(lse),
         static_cast<float*>(dd), static_cast<bf16*>(dq),
         static_cast<bf16*>(dk), static_cast<bf16*>(dv),
         static_cast<float*>(dk_part), static_cast<float*>(dv_part),
         Hkv * G, G, Sq, Sk, D, causal, window, q_sb, q_ss, q_sh, k_sb,
         k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, do_sb, do_ss,
         do_sh, dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, l_sb, l_sh, scale};
  static bool opted = false;  // set once per process: one card
  if (!opted) {
    cudaError_t e = cudaFuncSetAttribute(
        dq_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dkv_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Hq = Hkv * G;
  dq_tc_kernel<<<dim3((Sq + kT - 1) / kT, Hq, B), kThreads, kSmemBytes, s>>>(
      a);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  dkv_tc_kernel<<<dim3((Sk + kT - 1) / kT, Hq, B), kThreads, kSmemBytes,
                  s>>>(a);
  rc = (int)cudaGetLastError();
  if (rc != 0 || G == 1) return rc;
  const long threads = (long)B * Sk * Hkv * D / 4;
  gqa_reduce<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(a, B, Hkv);
  return (int)cudaGetLastError();
}
