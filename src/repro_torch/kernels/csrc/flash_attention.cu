// Attention for decode, chunked prefill and the full forward: C query tokens
// per row (C = 1 at decode), q (B, C, Hq, D) against keys read in place by
// their strides, f32 online softmax, output in the query's dtype.  One
// kernel template serves the seven ported kernels:
//
//   flash_decode               contiguous (B, Smax, Hkv, D), C = 1
//   flash_decode_paged         page pool (P, page, Hkv, D) + block table, C = 1
//   flash_decode_paged_quant   int8 page pool + f32 scales (P, Hkv), C = 1
//   flash_prefill_chunk        contiguous, C query tokens at start .. start+C-1
//   flash_prefill_chunk_paged  page pool + block table, C query tokens
//   flash_prefill_chunk_paged_quant  int8 page pool + scales, C query tokens
//   flash_attention            forward: q (B, Sq, Hq, D) against k, v
//                              (B, Sk, Hkv, D), query i at position i,
//                              causal or not, plus lse (B, Hq, Sq) f32
//
// Replaces src/repro/kernels/flash_attention.py:flash_decode_pallas,
// flash_decode_paged_pallas, flash_decode_paged_quant_pallas,
// flash_prefill_chunk_pallas, flash_prefill_chunk_paged_pallas,
// flash_prefill_chunk_paged_quant_pallas and flash_attention_pallas.
// Their TPU grids (B, Hkv or Hq, [query blocks,] key blocks) walk the key
// blocks in order on one core with the softmax state in VMEM scratch, after
// transposing (and padding) q and the cache on every call, and the paged
// ones pick each page in a BlockSpec index map from a scalar-prefetched
// block table.  Here a block owns one (row, kv head, query-row tile) and
// the sequential key axis becomes a loop inside the block:
//
//   * query rows: row r of the (row, kv head) pair is chunk token i = r / G
//     and group head g = r % G, so the GQA group is folded into the rows and
//     each K/V tile serves all of them.  A tile holds kRows = 8 rows (the
//     whole group at decode for G <= 8); the third grid axis walks the
//     G * C rows of a chunk in tiles (128 rows at qwen2.5-3b with C = 16).
//   * positions: chunk token i sits at qpos = start + min(i, width - 1)
//     (padding tokens alias the last real one, so every row keeps a finite
//     score); decode passes the valid length instead, qpos = len - 1; the
//     forward has qpos = i.  Key s is valid for a row when s <= qpos
//     (causal; the forward may drop it) and, windowed, s > qpos - window.
//     A tile walks keys only from its lowest row's window start to its
//     highest row's qpos.
//   * addresses: contiguous key s of row b is at b * k_sb + s * k_ss; paged,
//     it is at bt[b, s / page] * k_sb + (s % page) * k_ss, and an unmapped
//     block (-1) is masked.  The block loads its own table entries (no
//     scalar prefetch): one thread per key of the tile resolves its offset
//     into shared memory, and a tile with no live key is skipped.
//   * storage: K/V have their own type TKV (float, bf16 or int8) beside the
//     query/output type T; instantiated for (f32, f32), (bf16, bf16),
//     (f32, bf16) -- a half-width pool under an f32 model -- and (f32,
//     int8), (bf16, int8).  Every K/V element is upcast to f32 as its tile
//     is loaded; an int8 pool comes with f32 scale pools ksc/vsc, one
//     scale per (page, kv head), multiplied in right after the upcast
//     (the TPU kernels' _decode_accum/_prefill_chunk_accum do the same).
//     The page comes from the block-table entry the tile already
//     resolves; an unmapped key reads no scale.
//   * a row with no valid key writes zeros (the l == 0 guard); lse is
//     m + log(l) with l == 0 taken as 1 (flash_attention.py:99-104).
//
// What bounds it on Hopper: bytes -- each live key and value is read once
// per query-row tile, B * keys * Hkv * D * 2 elements at decode (one byte
// each from an int8 pool, plus a 4-byte scale per key and page).  The
// scores and the PV product are scalar FMAs over shared-memory tiles; the
// grid is only B * Hkv * ceil(G * C / 8) blocks (8 at decode, B = 4).
// So the routes that matter left it: the bf16 forward for tensor cores
// (flash_attention_tc.cu), the bf16 decodes for split keys
// (flash_decode_split.cu), and the bf16 chunked prefills over the slab and
// an int8 pool for both (flash_chunk_tc.cu).  What stays here is f32 (its
// token identity and JAX's f32 parity rest on this summation order), the
// chunk over a bf16 pool, and every shape those kernels do not take.
#include "common.cuh"

namespace {
using namespace repro;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;     // keys per tile: one per lane when scoring
constexpr int kDMax = 128;  // head dim limit (checked by the wrapper)
constexpr int kRows = 8;    // query rows per block
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kDPerLane = kDMax / 32;
constexpr float kNegInf = -1e30f;

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int* pos0;   // (B,) chunk start; with width == nullptr, valid length
  const int* width;  // (B,) real tokens per chunk, or nullptr (decode)
  const int* bt;     // (B, .) block table, or nullptr (contiguous)
  const float* ksc;  // (P, Hkv) f32 scales of an int8 pool, or nullptr
  const float* vsc;
  float* lse;        // (B, Hq, C) f32, or nullptr
  int fwd;           // 1: query i sits at position i (pos0, width unused)
  int causal;        // 0: no upper bound on the keys (forward only)
  int C, G, D;
  int n_keys;        // Smax, or max_blocks * page
  int page;
  int window;        // < 0: none
  long bt_sb;
  long q_sb, q_sc, q_sh;
  long k_sb, k_ss, k_sh;  // k_sb: batch stride, or page stride when paged
  long v_sb, v_ss, v_sh;
  long o_sb, o_sc, o_sh;
  long l_sb, l_sh;
  long sc_sp, sc_sh;  // scale pools: page and head strides
  float scale;
};

__device__ __forceinline__ int query_pos(const AttnArgs& a, int b, int i) {
  if (a.fwd) return i;
  return a.width ? a.pos0[b] + min(i, a.width[b] - 1) : a.pos0[b] - 1;
}

template <typename T, typename TKV>
__global__ void __launch_bounds__(kThreads) attention_kernel(AttnArgs a) {
  __shared__ float qs[kRows][kDMax];
  __shared__ float ks[kBK][kDMax + 1];  // +1: lanes read distinct rows
  __shared__ float vs[kBK][kDMax];
  __shared__ long koff[kBK], voff[kBK];  // element offsets; -1 = masked
  __shared__ float ksf[kBK], vsf[kBK];   // per-key dequant scales
  __shared__ int qpos[kRows];

  const T* q = static_cast<const T*>(a.q);
  const TKV* k = static_cast<const TKV*>(a.k);
  const TKV* v = static_cast<const TKV*>(a.v);
  T* out = static_cast<T*>(a.out);
  const int b = blockIdx.x, h = blockIdx.y;
  const int r0 = blockIdx.z * kRows;
  const int nr = min(kRows, a.G * a.C - r0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int D = a.D;

  // rows are ordered by chunk token, so the tile's first row has the
  // lowest position and its last row the highest
  const int q_lo = query_pos(a, b, r0 / a.G);
  const int q_hi = query_pos(a, b, (r0 + nr - 1) / a.G);
  const int hi = a.causal ? min(q_hi + 1, a.n_keys) : a.n_keys;
  const int lo = a.window >= 0 ? max(0, q_lo - a.window + 1) : 0;

  if (tid < kRows) qpos[tid] = tid < nr ? query_pos(a, b, (r0 + tid) / a.G) : -1;
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    float x = 0.f;
    if (rr < nr) {
      const int r = r0 + rr, ci = r / a.G, g = r % a.G;
      x = to_f32(q[b * a.q_sb + ci * a.q_sc + (long)(h * a.G + g) * a.q_sh + d]);
    }
    qs[rr][d] = x;
  }

  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
  float acc[kRowsPerWarp][kDPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDPerLane; ++i) acc[r][i] = 0.f;
  }

  for (int t0 = (lo / kBK) * kBK; t0 < hi; t0 += kBK) {
    __syncthreads();  // q staged / previous tile consumed
    bool live = false;
    if (tid < kBK) {
      const int s = t0 + tid;
      long ko = -1, vo = -1;
      float kf = 1.f, vf = 1.f;
      if (s >= lo && s < hi) {
        if (a.bt) {
          const int pg = a.bt[b * a.bt_sb + s / a.page];
          if (pg >= 0) {
            ko = (long)pg * a.k_sb + (long)(s % a.page) * a.k_ss;
            vo = (long)pg * a.v_sb + (long)(s % a.page) * a.v_ss;
            if (a.ksc) {
              const long so = (long)pg * a.sc_sp + (long)h * a.sc_sh;
              kf = a.ksc[so];
              vf = a.vsc[so];
            }
          }
        } else {
          ko = (long)b * a.k_sb + (long)s * a.k_ss;
          vo = (long)b * a.v_sb + (long)s * a.v_ss;
        }
      }
      koff[tid] = ko;
      voff[tid] = vo;
      ksf[tid] = kf;
      vsf[tid] = vf;
      live = ko >= 0;
    }
    if (!__syncthreads_or(live)) continue;  // no live key in this tile
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const long ko = koff[j], vo = voff[j];
      // the dequant scale (1 for an unquantized pool) right after the upcast
      ks[j][d] = ko >= 0 ? to_f32(k[ko + h * a.k_sh + d]) * ksf[j] : 0.f;
      vs[j][d] = vo >= 0 ? to_f32(v[vo + h * a.v_sh + d]) * vsf[j] : 0.f;
    }
    __syncthreads();

    const int kpos = t0 + lane;
    const bool mapped = koff[lane] >= 0;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int rr = warp + r * kWarps;
      if (rr < nr) {  // warp-uniform
        const int qp = qpos[rr];
        bool valid = mapped && (!a.causal || kpos <= qp);
        if (a.window >= 0) valid = valid && kpos > qp - a.window;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(qs[rr][d], ks[lane][d], s);
        s = valid ? s * a.scale : kNegInf;
        const float m_new = fmaxf(m_run[r], warp_max(s));
        const float p = valid ? expf(s - m_new) : 0.f;
        const float alpha = expf(m_run[r] - m_new);
        l_run[r] = l_run[r] * alpha + warp_sum(p);
#pragma unroll
        for (int i = 0; i < kDPerLane; ++i) acc[r][i] *= alpha;
        for (int j = 0; j < kBK; ++j) {
          const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
          for (int i = 0; i < kDPerLane; ++i) {
            const int d = lane + 32 * i;
            if (d < D) acc[r][i] = fmaf(pj, vs[j][d], acc[r][i]);
          }
        }
        m_run[r] = m_new;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int rr = warp + r * kWarps;
    if (rr < nr) {
      const int row = r0 + rr, ci = row / a.G, g = row % a.G;
      const float l_safe = l_run[r] == 0.f ? 1.f : l_run[r];
      const float inv = 1.f / l_safe;
      if (a.lse && lane == 0)
        a.lse[b * a.l_sb + (long)(h * a.G + g) * a.l_sh + ci] =
            m_run[r] + logf(l_safe);
#pragma unroll
      for (int i = 0; i < kDPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D)
          out[b * a.o_sb + ci * a.o_sc + (long)(h * a.G + g) * a.o_sh + d] =
              from_f32<T>(acc[r][i] * inv);
      }
    }
  }
}

// (query/output type, K/V storage type) pairs; an int8 pool needs scales
int launch(const AttnArgs& a, int B, int Hkv, int dtype, int kv_dtype,
           cudaStream_t s) {
  if (a.D > kDMax || a.D < 1 || a.G < 1 || a.C < 1 || (a.bt && a.page < 1) ||
      ((kv_dtype == kInt8) != (a.ksc != nullptr && a.vsc != nullptr)) ||
      (a.ksc && !a.bt))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B, Hkv, (a.G * a.C + kRows - 1) / kRows), block(kThreads);
  if (dtype == kBF16 && kv_dtype == kBF16)
    attention_kernel<bf16, bf16><<<grid, block, 0, s>>>(a);
  else if (dtype == kF32 && kv_dtype == kF32)
    attention_kernel<float, float><<<grid, block, 0, s>>>(a);
  else if (dtype == kF32 && kv_dtype == kBF16)
    attention_kernel<float, bf16><<<grid, block, 0, s>>>(a);
  else if (dtype == kF32 && kv_dtype == kInt8)
    attention_kernel<float, int8_t><<<grid, block, 0, s>>>(a);
  else if (dtype == kBF16 && kv_dtype == kInt8)
    attention_kernel<bf16, int8_t><<<grid, block, 0, s>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_attention(
    const void* q, const void* k, const void* v, void* out, const void* pos0,
    const void* width, const void* bt, const void* ksc, const void* vsc,
    int B, int Hkv, int G, int C, int D, int n_keys, int page,
    long long bt_sb, long long q_sb, long long q_sc, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_sc,
    long long o_sh, long long sc_sp, long long sc_sh, int window,
    float scale, int dtype, int kv_dtype, void* stream) {
  AttnArgs a{q, k, v, out, static_cast<const int*>(pos0),
             static_cast<const int*>(width), static_cast<const int*>(bt),
             static_cast<const float*>(ksc), static_cast<const float*>(vsc),
             nullptr, 0, 1, C, G, D, n_keys, page, window, bt_sb,
             q_sb, q_sc, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
             o_sb, o_sc, o_sh, 0, 0, sc_sp, sc_sh, scale};
  return launch(a, B, Hkv, dtype, kv_dtype,
                static_cast<cudaStream_t>(stream));
}

extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int Hkv, int G, int Sq, int Sk, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, long long l_sb, long long l_sh,
    int causal, int window, float scale, int dtype, void* stream) {
  AttnArgs a{q, k, v, out, nullptr, nullptr, nullptr, nullptr, nullptr,
             static_cast<float*>(lse), 1, causal, Sq, G, D, Sk, 1, window, 0,
             q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
             o_sb, o_ss, o_sh, l_sb, l_sh, 0, 0, scale};
  return launch(a, B, Hkv, dtype, dtype, static_cast<cudaStream_t>(stream));
}
