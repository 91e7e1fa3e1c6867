// Split-KV decode (flash-decoding): one query token per row, q (B, Hq, D)
// bf16 against K/V read from one of three stores, output (B, Hq, D) bf16:
//
// * an int8 (P, page, Hkv, D) pool through a (B, max_blocks) int32 block
//   table, with f32 (P, Hkv) per-(page, head) scales;
// * a bf16 (P, page, Hkv, D) pool through the block table, no scales;
// * the bf16 (B, Smax, Hkv, D) contiguous slab, no table.
//
// Replaces src/repro/kernels/flash_attention.py's
// flash_decode_paged_quant_pallas (:654; kernel :618), flash_decode_pallas
// (:459; kernel :428) and flash_decode_paged_pallas (:547; kernel :497) for
// bf16 queries at head dims that are multiples of 16 up to 128 with K/V
// strides and bases the 16-byte copies can follow (16 int8 or 8 bf16
// elements); f32 queries (phase 5's token identity and JAX's f32 parity
// rest on the template's summation order) and every other shape keep
// flash_attention.cu's template.  Semantics as there (_decode_accum
// :392-418): scores in f32, each int8 page's scale multiplying the upcast
// keys and values before any product; keys at or past cache_len (or the
// slab's end), before the window (s < cache_len - window), or in unmapped
// (-1) pages are masked; a row with no valid key returns zeros.
//
// What bounds it on the H100: bytes, and far below a launch: at
// qwen2.5-3b's serving shape (B 4, Hkv 2, G 8, rows of 17-96 keys in
// chip_smoke.py) a call reads 111 KB of int8 K/V or 222 KB of bf16, 0.03-
// 0.07 us at 3.35 TB/s.  The template ran it as 8 blocks on 132 SMs, each
// walking its row's whole cache alone with 128 serial FMAs a score (0.065-
// 0.070 ms a call): pure in-block latency.  Here the cache is split across
// blocks so each block's chain is a tile or a few long:
//
// * grid (B, Hkv * ceil(G / 16), n_split): a block owns one row, one kv
//   head, up to 16 of its G query rows, and a run of `pages_per_split`
//   consecutive pages of its split: block-table entries of the pools, or
//   32-key tiles of the slab [0, Smax), the last one ragged
//   (kernels/flash_attention.py:decode_splits fixes both from shapes only,
//   never cache_len: no host sync).  A paged split resolves its pages from
//   the table itself; the slab's key s of row b sits at b * k_sb + s * k_ss
//   + h * k_sh.
// * keys in tiles of 32: one thread a key resolves its offset (and an int8
//   page's scales); the tile's K and V rows are read with 16-byte loads,
//   coalesced along the head (D = 128: 8 chunks a key row in int8, 16 in
//   bf16; zamba2's D = 80: 5 and 10), widened to f32 (int8: times the
//   scale) into f32 shared tiles, masked keys zero.  The storage is a
//   template parameter (Store<T>); scores, softmax and PV are shared.
// * scores: a quad of lanes per (query row, key) pair, each lane a quarter
//   of D (dims strided by 4 over rows padded to D + 4 floats, so the 8
//   pairs a warp reads fall in distinct banks), reduced by two shuffles,
//   over the positions of the tile before the split's end: all 256
//   threads work at G = 1 (zamba2) as at G = 8, where one thread a pair
//   would leave most warps idle at G = 1 and run D serial FMAs.
// * the online softmax in f32, one warp a query row (a lane a key), and
//   acc[G][D] += P V with a thread per (row, dim) slot.
// * 8 warps a block: the block is one short chain of dependent steps, and
//   a warp alone on its scheduler waits out each one; 8 warps halve each
//   thread's share of the scores and PV and put two warps on every
//   scheduler (faster than 4 in development runs on the card).
// * n_split > 1: the split writes its partial (m, l, acc) in f32 to
//   scratch (B, Hq, n_split[, D]); a split with no live key (past the
//   length, before the window, or all pages unmapped) writes m = -1e30,
//   l = 0.  The combine kernel, grid (B, Hq), merges the partials in split
//   order 0..n-1 with no atomics: M = max m_i, L = sum l_i e^(m_i - M),
//   O = sum acc_i e^(m_i - M) / L, L == 0 giving zeros.  n_split == 1: the
//   split writes the output itself and no combine launches.
#include "common.cuh"

namespace {
using namespace repro;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 32;          // keys per tile: one a lane in the softmax
constexpr int kDMax = 128;
constexpr int kRows = 16;       // query rows a block
constexpr int kKPad = kDMax + 4;
constexpr int kSlots = kRows * kDMax / kThreads;  // (row, dim) slots a thread
constexpr float kNegInf = -1e30f;

// K/V storage: the elements one 16-byte chunk holds, whether a page scale
// multiplies them, and the chunk widened to f32 into dst (16-byte aligned
// shared memory), masked chunks (all zero bits) giving zeros
template <typename T> struct Store;

template <> struct Store<int8_t> {
  static constexpr int kElems = 16;
  static constexpr bool kScaled = true;
  static __device__ __forceinline__ void widen(const int4& r, float f,
                                               float* dst) {
    const int w[4] = {r.x, r.y, r.z, r.w};
    float x[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      // byte e (little endian), sign-extended by the arithmetic shift
      const int sh = 24 - 8 * (e & 3);
      x[e] = (float)((w[e >> 2] << sh) >> 24) * f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      reinterpret_cast<float4*>(dst)[i] =
          make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  }
};

template <> struct Store<bf16> {
  static constexpr int kElems = 8;
  static constexpr bool kScaled = false;
  static __device__ __forceinline__ void widen(const int4& r, float,
                                               float* dst) {
    const uint32_t w[4] = {(uint32_t)r.x, (uint32_t)r.y, (uint32_t)r.z,
                           (uint32_t)r.w};
    float x[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // element 2i in the low half of word i (little endian); exact
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
    reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
};

struct Args {
  const bf16* q;
  const void* k;    // the pool (P, page, Hkv, D) or the slab (B, Smax, Hkv, D)
  const void* v;
  const float* ksc;  // (P, Hkv) page scales of an int8 pool, else nullptr
  const float* vsc;
  const int* len;  // (B,) valid length, the new token included
  const int* bt;   // (B, max_blocks) of a pool, else nullptr
  bf16* out;
  float* part_m;   // (B, Hq, n_split) f32, or nullptr when n_split == 1
  float* part_l;
  float* part_acc;  // (B, Hq, n_split, D) f32
  // n_keys: the keys the table spans (max_blocks * page) or Smax; page and
  // max_blocks: the pool's, or 32 and ceil(Smax / 32) on the slab
  int Hq, G, D, n_rc, n_keys, page, max_blocks, pps, n_split;
  int window;  // < 0: none
  long bt_sb;
  long q_sb, q_sh;
  long k_s0, k_ss, k_sh;  // page (pool) or row (slab), slot, head strides
  long v_s0, v_ss, v_sh;
  long sc_sp, sc_sh;
  long o_sb, o_sh;
  float scale;
};

template <typename T, bool kPaged>
__global__ void __launch_bounds__(kThreads) split_kernel(Args a) {
  constexpr int kE = Store<T>::kElems;
  constexpr int kChunks = kT * kDMax / kE / kThreads;  // 16-byte loads a thread
  __shared__ float qs[kRows][kDMax];
  __shared__ __align__(16) float ks[kT][kKPad];
  __shared__ __align__(16) float vs[kT][kDMax];
  __shared__ float sc[kRows][kT];
  __shared__ long koff[kT], voff[kT];  // element offsets; -1 = masked
  __shared__ float ksf[kT], vsf[kT];
  __shared__ float m_s[kRows], l_s[kRows], al_s[kRows];

  const int b = blockIdx.x, h = blockIdx.y / a.n_rc;
  const int r0 = (blockIdx.y - h * a.n_rc) * kRows;
  const int nr = min(kRows, a.G - r0);
  const int sp = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = a.D;

  // the split's keys: its run of table entries, or of the slab's tiles
  const int s_lo = sp * a.pps * a.page;
  const int s_hi = min(s_lo + a.pps * a.page, a.n_keys);
  // a pool's first table entries, read before the length arrives (the
  // first tile starts at the split's start unless a window cuts it)
  int pg_first = -1;
  if constexpr (kPaged)
    if (tid < kT && s_lo + tid < s_hi)
      pg_first = a.bt[b * a.bt_sb + (s_lo + tid) / a.page];
  // the split's keys, cut to the valid range
  const int len = a.len[b];
  const int lo = a.window >= 0 ? max(0, len - a.window) : 0;
  const int k_lo = max(s_lo, lo), k_hi = min(s_hi, len);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    qs[r][d] = r < nr ? __bfloat162float(
                            a.q[b * a.q_sb + (long)(h * a.G + r0 + r) * a.q_sh
                                + d])
                      : 0.f;
  }
  if (tid < kRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kSlots];
  int sr[kSlots], sd[kSlots];  // each slot's (row, dim)
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    acc[i] = 0.f;
    sr[i] = (tid + i * kThreads) / D;
    sd[i] = tid + i * kThreads - sr[i] * D;
  }

  const int nc = D / kE;  // 16-byte chunks a key row
  const int dq = D >> 2;  // dims a lane of a quad sums
  for (int t0 = k_lo >= k_hi ? k_hi : s_lo + ((k_lo - s_lo) / kT) * kT;
       t0 < k_hi; t0 += kT) {
    __syncthreads();  // q staged / the previous tile consumed
    bool live = false;
    if (tid < kT) {
      const int s = t0 + tid;
      long ko = -1, vo = -1;
      float kf = 0.f, vf = 0.f;
      if (s >= k_lo && s < k_hi) {
        if constexpr (kPaged) {
          const int pg =
              t0 == s_lo ? pg_first : a.bt[b * a.bt_sb + s / a.page];
          if (pg >= 0) {
            const long slot = s % a.page;
            ko = (long)pg * a.k_s0 + slot * a.k_ss + (long)h * a.k_sh;
            vo = (long)pg * a.v_s0 + slot * a.v_ss + (long)h * a.v_sh;
            if constexpr (Store<T>::kScaled) {
              const long so = (long)pg * a.sc_sp + (long)h * a.sc_sh;
              kf = a.ksc[so];
              vf = a.vsc[so];
            }
          }
        } else {
          ko = (long)b * a.k_s0 + (long)s * a.k_ss + (long)h * a.k_sh;
          vo = (long)b * a.v_s0 + (long)s * a.v_ss + (long)h * a.v_sh;
        }
      }
      koff[tid] = ko;
      voff[tid] = vo;
      ksf[tid] = kf;
      vsf[tid] = vf;
      live = ko >= 0;
    }
    if (!__syncthreads_or(live)) continue;  // no live key in this tile

    // K and V rows: 16-byte loads issued together, then widened (int8:
    // times the page's scale) into the f32 tiles (masked keys zero)
    int4 kr[kChunks], vr[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int id = tid + c * kThreads, j = id / nc, ch = id - j * nc;
      kr[c] = vr[c] = make_int4(0, 0, 0, 0);
      if (j < kT && koff[j] >= 0) {
        kr[c] = __ldg(reinterpret_cast<const int4*>(kp + koff[j] + ch * kE));
        vr[c] = __ldg(reinterpret_cast<const int4*>(vp + voff[j] + ch * kE));
      }
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int id = tid + c * kThreads, j = id / nc, ch = id - j * nc;
      if (j < kT) {
        Store<T>::widen(kr[c], ksf[j], &ks[j][ch * kE]);
        Store<T>::widen(vr[c], vsf[j], &vs[j][ch * kE]);
      }
    }
    __syncthreads();

    // scores: a quad per (row, key) pair, 8 pairs a warp at a time, over
    // the nt positions of the tile before the split's (or the row's) end
    const int nt = min(kT, k_hi - t0);
    {
      const int qd = lane & 3;
      const int npairs = nr * nt;
      for (int base = warp * 8; base < npairs; base += kWarps * 8) {
        const int pr = min(base + (lane >> 2), npairs - 1);
        const int r = pr / nt, j = pr - r * nt;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
        for (int i = 0; i < dq; i += 2) {
          s0 = fmaf(qs[r][4 * i + qd], ks[j][4 * i + qd], s0);
          s1 = fmaf(qs[r][4 * i + 4 + qd], ks[j][4 * i + 4 + qd], s1);
        }
        float s = s0 + s1;
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (qd == 0 && base + (lane >> 2) < npairs) sc[r][j] = s * a.scale;
      }
    }
    __syncthreads();

    // the online softmax: a warp a row, a lane a key
    for (int r = warp; r < nr; r += kWarps) {
      const bool valid = koff[lane] >= 0;
      const float s = sc[r][lane];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(valid ? s : kNegInf));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m_old - m_new);
      const float l = l_s[r] * alpha + warp_sum(p);
      sc[r][lane] = p;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l;
        al_s[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int r = sr[i], d = sd[i];
      if (r < nr) {
        float x = acc[i] * al_s[r];
#pragma unroll 8
        for (int j = 0; j < nt; ++j) x = fmaf(sc[r][j], vs[j][d], x);
        acc[i] = x;
      }
    }
  }
  __syncthreads();  // m_s, l_s final

  if (a.n_split == 1) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int r = sr[i], d = sd[i];
      if (r < nr) {
        const float l = l_s[r];
        a.out[b * a.o_sb + (long)(h * a.G + r0 + r) * a.o_sh + d] =
            __float2bfloat16_rn(acc[i] / (l == 0.f ? 1.f : l));
      }
    }
    return;
  }
  const long row0 = ((long)b * a.Hq + h * a.G + r0) * a.n_split + sp;
  if (tid < nr) {
    a.part_m[row0 + (long)tid * a.n_split] = m_s[tid];
    a.part_l[row0 + (long)tid * a.n_split] = l_s[tid];
  }
#pragma unroll
  for (int i = 0; i < kSlots; ++i)
    if (sr[i] < nr)
      a.part_acc[(row0 + (long)sr[i] * a.n_split) * D + sd[i]] = acc[i];
}

// out (b, hq) = the partials merged in split order; a thread per dim
__global__ void __launch_bounds__(kThreads) combine_kernel(Args a) {
  const int b = blockIdx.x, hq = blockIdx.y, d = threadIdx.x;
  if (d >= a.D) return;
  const long row = ((long)b * a.Hq + hq) * a.n_split;
  float M = kNegInf;
#pragma unroll 4
  for (int i = 0; i < a.n_split; ++i)
    if (a.part_l[row + i] > 0.f) M = fmaxf(M, a.part_m[row + i]);
  float L = 0.f, O = 0.f;
#pragma unroll 4
  for (int i = 0; i < a.n_split; ++i) {
    const float l = a.part_l[row + i];
    if (l > 0.f) {
      const float w = expf(a.part_m[row + i] - M);
      L += l * w;
      O += a.part_acc[(row + i) * a.D + d] * w;
    }
  }
  a.out[b * a.o_sb + hq * a.o_sh + d] =
      __float2bfloat16_rn(L == 0.f ? 0.f : O / L);
}

template <typename T, bool kPaged>
int launch(const Args& a, int B, int Hkv, cudaStream_t s) {
  split_kernel<T, kPaged>
      <<<dim3(B, Hkv * a.n_rc, a.n_split), kThreads, 0, s>>>(a);
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || a.n_split == 1) return rc;
  combine_kernel<<<dim3(B, Hkv * a.G), kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The caller (kernels/flash_attention.py) vouches for bf16 q and out with
// unit stride on D, K/V of the storage kv_dtype whose base and page (or
// row), slot and head strides are multiples of 16 bytes, D a multiple of
// 16 up to 128, an int32 (B,) length, and, when n_split > 1, f32 scratch
// part_m, part_l (B, Hq, n_split) and part_acc (B, Hq, n_split, D),
// contiguous.  A pool comes with its (B, max_blocks) table (unit column
// stride) and n_keys = max_blocks * page; an int8 pool also with f32
// scale pools of one layout.  The slab comes with no table, n_keys = Smax,
// page 32 and max_blocks = ceil(Smax / 32).  Instances: int8 pool, bf16
// pool, bf16 slab; any other combination is refused.
extern "C" int repro_flash_decode_split(
    const void* q, const void* k, const void* v, const void* ksc,
    const void* vsc, const void* len, const void* bt, void* out,
    void* part_m, void* part_l, void* part_acc, int B, int Hkv, int G, int D,
    int n_keys, int page, int max_blocks, int pps, int n_split,
    long long bt_sb, long long q_sb, long long q_sh, long long k_s0,
    long long k_ss, long long k_sh, long long v_s0, long long v_ss,
    long long v_sh, long long sc_sp, long long sc_sh, long long o_sb,
    long long o_sh, int window, float scale, int kv_dtype, void* stream) {
  const bool paged = bt != nullptr, scaled = ksc != nullptr;
  if (D < 16 || D > kDMax || D % 16 || G < 1 || page < 1 || pps < 1 ||
      n_split < 1 || n_keys < 0 || max_blocks < 0 ||
      (long)n_split * pps < max_blocks ||
      n_keys > (long)max_blocks * page || scaled != (vsc != nullptr) ||
      (n_split > 1 && (!part_m || !part_l || !part_acc)))
    return (int)cudaErrorInvalidValue;
  const int n_rc = (G + kRows - 1) / kRows;
  Args a{static_cast<const bf16*>(q), k, v, static_cast<const float*>(ksc),
         static_cast<const float*>(vsc), static_cast<const int*>(len),
         static_cast<const int*>(bt), static_cast<bf16*>(out),
         static_cast<float*>(part_m), static_cast<float*>(part_l),
         static_cast<float*>(part_acc), Hkv * G, G, D, n_rc, n_keys, page,
         max_blocks, pps, n_split, window, bt_sb, q_sb, q_sh, k_s0, k_ss,
         k_sh, v_s0, v_ss, v_sh, sc_sp, sc_sh, o_sb, o_sh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == kInt8 && paged && scaled)
    return launch<int8_t, true>(a, B, Hkv, s);
  if (kv_dtype == kBF16 && !scaled)
    return paged ? launch<bf16, true>(a, B, Hkv, s)
                 : launch<bf16, false>(a, B, Hkv, s);
  return (int)cudaErrorInvalidValue;
}
