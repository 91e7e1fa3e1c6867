// Attention forward on Hopper's tensor cores, bf16: q (B, Sq, Hq, D)
// against k, v (B, Sk, Hkv, D), query i at position i, causal or not,
// optionally windowed -> out (B, Sq, Hq, D) in q's dtype and lse (B, Hq,
// Sq) f32, lse = m + log(l) in natural-log units with l == 0 taken as 1
// (the backward recomputes p = exp(s * scale - lse) from it).
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_pallas
// (:120; kernel _flash_fwd_kernel :62, pallas_call :145) for bf16 at head
// dims that are multiples of 16 up to 128 with strides the 16-byte copies
// can follow; f32 (and any other shape) keeps flash_attention.cu's forward
// mode, IEEE f32 as the reference computes.
//
// What bounds it on the H100: at the --check shape (B 2, S 160, qwen2.5-3b's
// 16/2 heads of 128, causal) a call moves 3.0 MB (0.9 us at 3.35 TB/s) and
// does 4 D flops per visible (query, key) pair, 0.21 GFLOP (0.2 us at 989
// TFLOP/s): bytes bound it, and both are far below what a launch and one
// block's chain of tiles take.  The template it replaces runs 8 query rows
// a block with scalar FMAs and rereads every K/V tile for each 8 rows
// (0.101 ms a call).  Here the products are the tensor cores' and what is
// left is latency: the grid is B * Hq * ceil(Sq / 64) blocks (96 at the
// --check shape, 128 at the training shape), at most one an SM, and a warp
// alone on its scheduler waits out every instruction's latency (in
// development runs on the card a 64-key tile cost about as much whichever
// of the loads, S, the softmax or PV was left out).  So while the grid
// fits one block an SM, a block's key tiles are split between two groups
// of 4 warps, which halves each warp's chain of tiles and puts two warps
// on every scheduler; a larger grid (zamba2-2.7b's 32 heads) runs one
// group a block, two blocks an SM.
//
// Design: dq_tc_kernel of flash_attention_bwd_tc.cu run forward.  One block
// per (b, q head, 64 query rows), 4 warps of 16 rows a group, one or two
// groups.  Q is staged once in a swizzled shared tile (common.cuh swz) and
// read into A fragments by ldmatrix once; the key tiles are exactly those
// the rows can see (kernels/flash_attention.py:dq_key_tiles), 64 keys
// each, walked in rounds (with two groups, tile 2r to group 0 and 2r + 1
// to group 1), each round's K and V copied by cp.async while the round
// before is computed.  Per tile: S = Q K^T on mma.sync m16n8k16 with
// f32 accumulators, the mask inside the tile (causal, window, the Sk edge;
// only on tiles that hold a hidden pair), then the online softmax in f32
// registers in base-2 units (scores times scale * log2 e), each row's max
// reduced across its quad by shuffles and its sum kept per thread until
// the end; P is rounded to bf16 and packed straight from the accumulator
// fragments as the A operand of O += P V, with V read by ldmatrix.trans.
// At the end group 1 hands its (m, l, O) to the group-0 thread that holds
// the same fragment positions through shared memory, which merges the two
// (m = max, each side scaled by 2^(m_side - m)); O is scaled by 1 / l and
// rounded once.  Shared memory: Q 16 KB and two rounds of K and V tiles
// of 16 KB, 144 KB with two groups (opted in), 80 KB with one.
//
// One block per q head rather than one per kv head with the GQA group
// folded into its rows: at the --check shape that keeps 96 blocks in
// flight (a folded block of 64 rows would hold 8 heads' 8 rows and leave
// 2 * 2 * 20 = 80 blocks doing 8x the key tiles each), and the K/V tiles a
// group shares are read from L2.
//
// The one numeric difference from the template: P is rounded to bf16
// before the PV product, as the tensor cores take it (the backward does the
// same); l sums the f32 p, so lse is the template's up to f32 rounding.
#include "common.cuh"

namespace {
using namespace repro;

constexpr int kGroupThreads = 128;  // a group: 4 warps of 16 query rows
constexpr int kMaxThreads = 2 * kGroupThreads;
constexpr int kT = 64;          // query rows / keys per tile
constexpr int kDMax = 128;
constexpr int kRowBytes = 256;  // kDMax bf16
constexpr int kTileBytes = kT * kRowBytes;
constexpr int kMerge = 2 + 2 + 64;  // floats a thread hands over: m, l, O
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  float* lse;
  int G, Sq, Sk, D;
  int causal;
  int window;  // < 0: none
  long q_sb, q_ss, q_sh;
  long k_sb, k_ss, k_sh;
  long v_sb, v_ss, v_sh;
  long o_sb, o_ss, o_sh;
  long l_sb, l_sh;  // unit stride in Sq
  float scale;
  int groups;  // warp groups splitting the key tiles: 2, or 1 when the
               // grid needs more than one block an SM
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
                                          int tid, int nthreads) {
  const int nc = D >> 3;
  for (int id = tid; id < kT * nc; id += nthreads) {
    const int r = id / nc, c = id - r * nc;
    const bool in = row0 + r < rows;
    cp_async16(s + swz(r, c, kRowBytes),
               in ? base + (long)(row0 + r) * ss + c * 8 : base, in ? 16 : 0);
  }
}

// One 64-key tile for this warp's 16 query rows: S = Q K^T, the mask, the
// online softmax (base 2) and O += P V
__device__ __forceinline__ void tile_step(
    const Args& a, uint32_t kbuf, uint32_t vbuf, int t0, int q0,
    const uint32_t (&qa)[kDMax / 16][4], const int (&qp_r)[2],
    float (&m_r)[2], float (&l_r)[2], float (&o)[kDMax / 8][4], int lane) {
  const int t = lane & 3, nd16 = a.D >> 4;
  const float sl2 = a.scale * kLog2e;
  // S = Q K^T: 16 rows x 64 keys
  float s[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kDMax / 16; ++kk) {
    if (kk < nd16) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t kf[4];
        const int i = lane >> 3;
        ldsm_x4(kf, kbuf + swz(p * 16 + (lane & 7) + 8 * (i >> 1),
                               kk * 2 + (i & 1), kRowBytes));
        mma_bf16(s[2 * p], qa[kk], kf[0], kf[1]);
        mma_bf16(s[2 * p + 1], qa[kk], kf[2], kf[3]);
      }
    }
  }
  // the mask only on a tile that holds a hidden pair (the causal
  // diagonal, the window's edge, past Sk); scores to base 2
  const bool edge = (a.causal && t0 + kT - 1 > q0) || t0 + kT > a.Sk ||
                    (a.window >= 0 && t0 <= q0 + kT - 1 - a.window);
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1, kp = t0 + n * 8 + 2 * t + (e & 1);
      s[n][e] = !edge || visible(a, qp_r[hh], kp) ? s[n][e] * sl2 : kNegInf;
      mx[hh] = fmaxf(mx[hh], s[n][e]);
    }
  float alpha[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    const float m_new = fmaxf(m_r[hh], mx[hh]);
    alpha[hh] = exp2f(m_r[hh] - m_new);
    m_r[hh] = m_new;
    l_r[hh] *= alpha[hh];
  }
#pragma unroll
  for (int n = 0; n < kDMax / 8; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
  // P in f32 (masked pairs 0, whatever the running max), its row sums,
  // and P rounded to bf16 A fragments of 16 keys each
  uint32_t pa[4][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1;
      p[e] = s[n][e] > 0.5f * kNegInf ? exp2f(s[n][e] - m_r[hh]) : 0.f;
      l_r[hh] += p[e];
    }
    pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
    pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
  // O += P V: V read as (keys = k) x (D = n), transposed
#pragma unroll
  for (int kq = 0; kq < 4; ++kq)
#pragma unroll
    for (int np = 0; np < kDMax / 16; ++np) {
      if (np < nd16) {
        uint32_t vf[4];
        const int i = lane >> 3;
        ldsm_x4_t(vf, vbuf + swz(kq * 16 + (lane & 7) + 8 * (i & 1),
                                 np * 2 + (i >> 1), kRowBytes));
        mma_bf16(o[2 * np], pa[kq], vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], pa[kq], vf[2], vf[3]);
      }
    }
}

__global__ void __launch_bounds__(kMaxThreads)
fwd_tc_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ng = a.groups, nthreads = ng * kGroupThreads;
  const int nbufs = 2 * ng;  // two rounds of ng tiles
  const uint32_t sQ = smem_addr(smem);
  const uint32_t sK = sQ + kTileBytes;             // nbufs buffers
  const uint32_t sV = sK + nbufs * kTileBytes;     // nbufs buffers

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp >> 2;  // the key tiles j with j % ng == grp
  const int q0 = blockIdx.x * kT, hq = blockIdx.y, b = blockIdx.z;
  const int h = hq / a.G, D = a.D, nd16 = D >> 4;
  const bf16* kb = a.k + b * a.k_sb + h * a.k_sh;
  const bf16* vb = a.v + b * a.v_sb + h * a.v_sh;

  // the key tiles these rows can see (flash_attention.py:dq_key_tiles),
  // walked in rounds of ng: round r gives tile ng * r + grp to group grp;
  // Q and the first two rounds in flight at once
  const int hi = a.causal ? min(a.Sk, min(q0 + kT, a.Sq)) : a.Sk;
  const int lo = a.window >= 0 ? max(0, q0 - a.window + 1) : 0;
  const int t_first = (lo / kT) * kT;
  const int ntiles = hi > t_first ? (hi - t_first + kT - 1) / kT : 0;
  auto load_round = [&](int r) {
    for (int u = 0; u < ng; ++u) {
      const int jt = ng * r + u;
      if (jt < ntiles) {
        const int buf = jt % nbufs;
        load_rows(sK + buf * kTileBytes, kb, a.k_ss, t_first + jt * kT, a.Sk,
                  D, tid, nthreads);
        load_rows(sV + buf * kTileBytes, vb, a.v_ss, t_first + jt * kT, a.Sk,
                  D, tid, nthreads);
      }
    }
    cp_async_commit();
  };
  load_rows(sQ, a.q + b * a.q_sb + hq * a.q_sh, a.q_ss, q0, a.Sq, D, tid,
            nthreads);
  load_round(0);
  load_round(1);

  const int wr = (warp & 3) * 16, g = lane >> 2, t = lane & 3;
  int qp_r[2];
  float m_r[2], l_r[2];  // running max (base 2) and this thread's part of l
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    qp_r[hh] = q0 + wr + g + 8 * hh;
    m_r[hh] = kNegInf;
    l_r[hh] = 0.f;
  }
  float o[kDMax / 8][4];
#pragma unroll
  for (int j = 0; j < kDMax / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  uint32_t qa[kDMax / 16][4];  // this warp's Q rows as A fragments

  const int nrounds = (ntiles + ng - 1) / ng;
  for (int r = 0; r < nrounds; ++r) {
    cp_async_wait<1>();
    __syncthreads();  // Q and round r landed
    if (r == 0) {
#pragma unroll
      for (int kk = 0; kk < kDMax / 16; ++kk)
        if (kk < nd16)
          ldsm_x4(qa[kk], sQ + swz(wr + (lane & 15), kk * 2 + (lane >> 4),
                                   kRowBytes));
    }
    const int jt = ng * r + grp;
    if (jt < ntiles)
      tile_step(a, sK + (jt % nbufs) * kTileBytes,
                sV + (jt % nbufs) * kTileBytes, t_first + jt * kT, q0, qa,
                qp_r, m_r, l_r, o, lane);
    __syncthreads();  // round r consumed before its buffers are refilled
    load_round(r + 2);
  }
  cp_async_wait<0>();
  __syncthreads();

  // with two groups, group 1 hands its (m, l, O) to the thread of group 0
  // that holds the same fragment positions, through the K/V buffers, and
  // group 0 merges
  float* xs = reinterpret_cast<float*>(smem + kTileBytes);
  const int u = tid & (kGroupThreads - 1);
  auto slot = [&](int f) -> float& { return xs[f * kGroupThreads + u]; };
  if (grp == 1) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      slot(hh) = m_r[hh];
      slot(2 + hh) = l_r[hh];
    }
#pragma unroll
    for (int n = 0; n < kDMax / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) slot(4 + 4 * n + e) = o[n][e];
  }
  if (ng == 2) {
    __syncthreads();
    if (grp == 1) return;
    float w0[2], w1[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m1 = slot(hh), m = fmaxf(m_r[hh], m1);
      w0[hh] = exp2f(m_r[hh] - m);
      w1[hh] = exp2f(m1 - m);
      m_r[hh] = m;
      l_r[hh] = l_r[hh] * w0[hh] + slot(2 + hh) * w1[hh];
    }
#pragma unroll
    for (int n = 0; n < kDMax / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[n][e] = o[n][e] * w0[e >> 1] + slot(4 + 4 * n + e) * w1[e >> 1];
  }

  // l across the quad; out = O / l rounded once; lse in natural-log units
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_r[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qi = qp_r[hh];
    if (qi >= a.Sq) continue;
    const float l_safe = l == 0.f ? 1.f : l;
    const float inv = 1.f / l_safe;
    if (t == 0)
      a.lse[b * a.l_sb + hq * a.l_sh + qi] =
          l == 0.f ? kNegInf : m_r[hh] * kLn2 + logf(l_safe);
    bf16* row = a.out + b * a.o_sb + (long)qi * a.o_ss + hq * a.o_sh;
#pragma unroll
    for (int n = 0; n < kDMax / 8; ++n) {
      const int d = n * 8 + 2 * t;
      if (d < D)
        *reinterpret_cast<uint32_t*>(row + d) =
            pack_bf16(o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
    }
  }
}

// Q and two rounds of `groups` K and V tiles
constexpr int smem_bytes(int groups) {
  return (1 + 4 * groups) * kTileBytes;
}
static_assert(kMerge * kGroupThreads * 4 <= 8 * kTileBytes,
              "the merge fits the K/V buffers");

}  // namespace

// The caller (kernels/flash_attention.py) vouches for bf16 tensors with D
// a multiple of 16 up to 128, unit stride on D, 16-byte aligned bases and
// other strides multiples of 8; out (B, Sq, Hq, D) of q's dtype, lse
// (B, Hq, Sq) f32 with unit stride in Sq.
extern "C" int repro_flash_attention_tc(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int Hkv, int G, int Sq, int Sk, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, long long l_sb, long long l_sh,
    int causal, int window, float scale, void* stream) {
  if (D < 16 || D > kDMax || D % 16 || G < 1 || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  static int n_sms = 0;  // set once per process: one card
  if (n_sms == 0) {
    int dev = 0, n = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fwd_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(2));
    if (e != cudaSuccess) return (int)e;
    n_sms = n;
  }
  const dim3 grid((Sq + kT - 1) / kT, Hkv * G, B);
  // two groups a block while the grid fits one block an SM (168 registers
  // a thread hold a 256-thread block to one an SM); a larger grid runs one
  // group a block, two or three blocks an SM
  const int groups = (long)grid.x * grid.y * grid.z > n_sms ? 1 : 2;
  Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
         static_cast<const bf16*>(v), static_cast<bf16*>(out),
         static_cast<float*>(lse), G, Sq, Sk, D, causal, window,
         q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
         o_sb, o_ss, o_sh, l_sb, l_sh, scale, groups};
  fwd_tc_kernel<<<grid, groups * kGroupThreads, smem_bytes(groups),
                  static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
