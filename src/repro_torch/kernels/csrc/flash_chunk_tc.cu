// Chunked-prefill attention on Hopper's tensor cores: C query tokens per
// row, q (B, C, Hq, D) bf16, against K/V read from one of three stores,
// output (B, C, Hq, D) bf16:
//
// * the bf16 (B, Smax, Hkv, D) contiguous slab, no table;
// * a bf16 (P, page, Hkv, D) pool through a (B, max_blocks) int32 block
//   table;
// * an int8 (P, page, Hkv, D) pool through the table, with f32 (P, Hkv)
//   per-(page, head) scales.
//
// The three are instances of one template: the storage (Store<bf16>,
// Store<int8_t>) and the addressing (kPaged) are template parameters.
//
// Replaces src/repro/kernels/flash_attention.py's flash_prefill_chunk_pallas
// (:809; kernel _flash_prefill_chunk_kernel :777),
// flash_prefill_chunk_paged_pallas (:909; kernel
// _flash_prefill_chunk_paged_kernel :877) and
// flash_prefill_chunk_paged_quant_pallas (:1019; kernel
// _flash_prefill_chunk_paged_quant_kernel :984) for bf16 queries at head
// dims that are multiples of 16 up to 128 with q and K/V strides and bases
// the 16-byte copies can follow; f32 queries (phase 5's token identity and
// JAX's f32 parity rest on the template's order), over a bf16 pool too,
// and every other shape keep flash_attention.cu's template.  Semantics as
// there (_prefill_chunk_accum :754, _prefill_chunk_mask :744): chunk token
// i of row b sits at qpos = start[b] + min(i, width[b] - 1), so padding
// tokens alias the last real one and stay finite; key s is valid when
// s <= qpos, and, under a window, s > qpos - window; keys in unmapped (-1)
// pages or past the slab or the table are masked; a row with no valid key
// returns zeros; the softmax and its sums stay f32.
//
// What bounds it on the H100: bytes, far below a launch.  At qwen2.5-3b's
// prefill shape (B 4, C 16, 16/2 heads of 128, rows of 17-96 keys in
// chip_smoke.py) a call reads the chunk's live K/V once, ≈ 0.15 MB of bf16
// (≈ 0.05 us at 3.35 TB/s), and does ≈ 50 MFLOP (0.05 us at 989 TFLOP/s).
// The template ran it as 64 blocks of 8 query rows, each walking its row's
// whole key range again with 128 serial FMAs a score (≈ 0.065 ms a call):
// in-block latency and rereads.  Here:
//
// * a warp owns 16 query rows: one q head's 16 chunk tokens (an m16 row
//   tile of mma.sync m16n8k16).  A block holds `warps` such items of one
//   (row, kv head), the GQA group folded (items ordered token tile first,
//   then group head), so each K/V tile in shared memory serves all of
//   them; kernels/flash_attention.py:chunk_rows picks `warps` (at most
//   CHUNK_WARPS = 4) and the block count per (row, kv head).  Every block
//   runs at least 4 warps: those without an item only copy and widen
//   tiles (zamba2's G 1 has one item a kv head).  Swept on the H100
//   (chip_smoke.py phase 3, "chunk sweep"): with each split one tile,
//   the cap barely moves qwen's G 8 (0.0154-0.0159 ms a call at caps 1,
//   2 and 4, 0.0172 at 8, the whole group) and a cap of 4 is as fast as
//   any at mixtral's G 4 int8 (0.0198 ms), where 1 or 2 warps a block
//   need more blocks than a split target of 128 allows: 4 keeps both.
// * keys in tiles of 32 (two 16-key pages, or eight of 4: a tile may span
//   several pages, each key resolving its own), the block walking only the
//   tiles between its lowest row's window start and its highest row's
//   qpos, in rounds double-buffered by 16-byte cp.async into swizzled
//   shared tiles (common.cuh swz), read by ldmatrix (.trans for V).  A
//   pool's keys resolve their pages from the table inside the block (each
//   copying thread reads its key's entry; lane j of warp 0 also records
//   key j's validity -- mapped and below max_blocks * page -- and, int8,
//   its page's two scales, which stay 1 for bf16); the slab's key s
//   of row b sits at b * k_sb + s * k_ss + h * k_sh.  The storage is a
//   template parameter (Store<T>), the addressing another (kPaged), as in
//   flash_decode_split.cu.
// * S = Q K^T and O += P V on mma.sync m16n8k16, bf16 operands, f32
//   accumulators; the online softmax in f32 registers in base-2 units; the
//   mask only on a tile that holds a hidden pair for the warp's rows (the
//   causal diagonal, the window's edge, an unmapped page, the slab's end).
// * int8 without loss on the way in: values -127..127 are exact in bf16,
//   so the staged int8 tile is widened to bf16 exactly; the key scale then
//   multiplies S's columns in f32 and the value scale P's columns in f32
//   before P is rounded to bf16 for PV.  That is JAX's upcast-then-scale
//   (k * k_s before q k^T, v * v_s before p v) up to the order of f32
//   roundings.  P rounded to bf16 before PV is the one numeric difference
//   from the template, as in flash_attention_tc.cu; l sums the f32 P.
// * splits: the ceil(n_keys / 32) tiles are cut into n_split runs of
//   tiles_per_split (kernels/flash_attention.py:chunk_splits fixes both
//   from shapes only, never start or width: no host sync) so the grid
//   (B, Hkv * row blocks, n_split) comes near CHUNK_BLOCKS = 128 blocks.
//   Swept on the H100 as the warps: qwen's 16 and mixtral's 32 row blocks
//   run fastest a tile a split (4 splits of 128 keys); zamba2's 128 run
//   its slab fastest unsplit (0.0162-0.0166 ms against 0.0204 in 4
//   splits: the combine's launch costs more than a split saves), its int8
//   pool 10% faster in 4 splits, and 128 takes the slab's side (a step
//   runs both as often).  n_split > 1: each
//   split writes f32 (m, l, acc) partials to scratch (B, C, Hq,
//   n_split[, D]), m in base 2; a split with no live key writes m =
//   -1e30, l = 0; the combine kernel, grid (B * C, Hq), merges them in
//   split order 0..n-1 with no atomics (flash_decode_split.cu's
//   convention: M = max m_i over l_i > 0, L = sum l_i 2^(m_i - M), O =
//   sum acc_i 2^(m_i - M) / L, L == 0 giving zeros).  n_split == 1: the
//   split writes the output itself and no combine launches.
#include "common.cuh"

namespace {
using namespace repro;

constexpr int kT = 32;         // keys a tile: lane j of a warp checks key j
constexpr int kRows = 16;      // query rows a warp: one m16 row tile
constexpr int kMaxWarps = 8;
constexpr int kMinWarps = 4;  // a block's warps at least: they all load
constexpr int kDMax = 128;
constexpr int kRowBytes = 256;  // kDMax bf16: a swizzled tile row
constexpr int kTileBytes = kT * kRowBytes;
constexpr int kQBytes = kRows * kRowBytes;
constexpr int kStageBytes = kT * kDMax;  // an int8 tile, rows of 128 bytes
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;

// K/V storage: the elements one 16-byte copy moves, and whether the tile
// is staged and widened to bf16 (int8, with its page scales)
template <typename T> struct Store;
template <> struct Store<int8_t> {
  static constexpr int kElems = 16;
  static constexpr bool kScaled = true;
};
template <> struct Store<bf16> {
  static constexpr int kElems = 8;
  static constexpr bool kScaled = false;
};

struct Args {
  const bf16* q;
  const void* k;  // the slab (B, Smax, Hkv, D) or the pool (P, page, Hkv, D)
  const void* v;
  const float* ksc;  // (P, Hkv) page scales of an int8 pool, else nullptr
  const float* vsc;
  const int* start;  // (B,) position of chunk token 0
  const int* width;  // (B,) real tokens of the chunk
  const int* bt;     // (B, max_blocks) of a pool, else nullptr
  bf16* out;
  float* part_m;  // (B, C, Hq, n_split) f32, or nullptr when n_split == 1
  float* part_l;
  float* part_acc;  // (B, C, Hq, n_split, D) f32
  // n_items: G * ceil(C / 16) 16-row items a (row, kv head); n_rb: blocks
  // a (row, kv head), `warps` items each; n_keys: Smax, or max_blocks *
  // page; tps: 32-key tiles a split
  int Hq, G, C, D, n_items, warps, n_rb, n_keys, page, tps, n_split;
  int window;  // < 0: none
  long bt_sb;
  long q_sb, q_sc, q_sh;
  long k_s0, k_ss, k_sh;  // row (slab) or page (pool), slot, head strides
  long v_s0, v_ss, v_sh;
  long sc_sp, sc_sh;
  long o_sb, o_sc, o_sh;
  float scale;
};

// One 32-key tile for this warp's 16 query rows: S = Q K^T (times the key
// scales), the mask, the online softmax (base 2) and O += P V (P times the
// value scales, rounded to bf16)
template <bool kScaled>
__device__ __forceinline__ void tile_step(
    const Args& a, uint32_t kbuf, uint32_t vbuf, const int* kval,
    const float* ksf, const float* vsf, int t0, bool edge,
    const uint32_t (&qa)[kDMax / 16][4], const int (&qp)[2],
    float (&m_r)[2], float (&l_r)[2], float (&o)[kDMax / 8][4], int lane) {
  const int t = lane & 3, nd16 = a.D >> 4, i = lane >> 3;
  const float sl2 = a.scale * kLog2e;
  float s[kT / 8][4];
#pragma unroll
  for (int n = 0; n < kT / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kDMax / 16; ++kk) {
    if (kk < nd16) {
#pragma unroll
      for (int p = 0; p < kT / 16; ++p) {
        uint32_t kf[4];
        ldsm_x4(kf, kbuf + swz(p * 16 + (lane & 7) + 8 * (i >> 1),
                               kk * 2 + (i & 1), kRowBytes));
        mma_bf16(s[2 * p], qa[kk], kf[0], kf[1]);
        mma_bf16(s[2 * p + 1], qa[kk], kf[2], kf[3]);
      }
    }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < kT / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1, j = n * 8 + 2 * t + (e & 1), kp = t0 + j;
      float x = s[n][e] * sl2;
      if constexpr (kScaled) x *= ksf[j];
      if (edge && !(kval[j] && kp <= qp[hh] &&
                    (a.window < 0 || kp > qp[hh] - a.window)))
        x = kNegInf;
      s[n][e] = x;
      mx[hh] = fmaxf(mx[hh], x);
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
  // then (int8: times the value scales) rounded to bf16 A fragments of 16
  // keys each
  uint32_t pa[kT / 16][4];
#pragma unroll
  for (int n = 0; n < kT / 8; ++n) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1;
      p[e] = s[n][e] > 0.5f * kNegInf ? exp2f(s[n][e] - m_r[hh]) : 0.f;
      l_r[hh] += p[e];
      if constexpr (kScaled) p[e] *= vsf[n * 8 + 2 * t + (e & 1)];
    }
    pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
    pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
  // O += P V: V read as (keys = k) x (D = n), transposed
#pragma unroll
  for (int kq = 0; kq < kT / 16; ++kq)
#pragma unroll
    for (int np = 0; np < kDMax / 16; ++np) {
      if (np < nd16) {
        uint32_t vf[4];
        ldsm_x4_t(vf, vbuf + swz(kq * 16 + (lane & 7) + 8 * (i & 1),
                                 np * 2 + (i >> 1), kRowBytes));
        mma_bf16(o[2 * np], pa[kq], vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], pa[kq], vf[2], vf[3]);
      }
    }
}

// 8 int8 values (two little-endian words) -> 8 bf16, exact
__device__ __forceinline__ uint4 widen8(uint2 w) {
  float x[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint32_t word = e < 4 ? w.x : w.y;
    x[e] = (float)(int)(signed char)(word >> (8 * (e & 3)));
  }
  return make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                    pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
}

// shared memory: the warps' Q rows, two rounds of bf16 K and V tiles, and
// for int8 two rounds of staged K and V tiles
__host__ __device__ constexpr int smem_bytes(int warps, bool staged) {
  return warps * kQBytes + 4 * kTileBytes + (staged ? 4 * kStageBytes : 0);
}

template <typename T, bool kPaged>
__global__ void __launch_bounds__(kMaxWarps * 32) chunk_kernel(Args a) {
  constexpr bool kStaged = Store<T>::kScaled;
  constexpr int kE = Store<T>::kElems;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int kval[2][kT];  // key j of the round's tile: mapped, < n_keys
  __shared__ float ksf[2][kT], vsf[2][kT];  // its page's scales (int8)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int b = blockIdx.x, h = blockIdx.y / a.n_rb;
  const int rb = blockIdx.y - h * a.n_rb, sp = blockIdx.z;
  const int D = a.D, nd16 = D >> 4;
  const int oK = a.warps * kQBytes, oV = oK + 2 * kTileBytes,
            oS = oV + 2 * kTileBytes;
  const uint32_t sbase = smem_addr(smem);

  // this warp's item: token tile ct, group head g (items token tile first)
  const int i0 = rb * a.warps, item = i0 + warp;
  const bool has = warp < a.warps && item < a.n_items;
  const int ct = (has ? item : i0) / a.G;
  const int hq = h * a.G + (has ? item : i0) - ct * a.G;
  const int c0 = ct * kRows;

  const int start = a.start[b], width = a.width[b];
  const int g8 = lane >> 2, t = lane & 3;
  int qp[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    qp[hh] = start + min(min(c0 + g8 + 8 * hh, a.C - 1), width - 1);
  // the warp's lowest and highest positions (the edge test), the block's
  // (the tiles it walks): from its first and last items' tokens
  const int wq_lo = start + min(c0, width - 1);
  const int wq_hi = start + min(min(c0 + kRows, a.C) - 1, width - 1);
  const int i_last = min(i0 + a.warps, a.n_items) - 1;
  const int bq_lo = start + min((i0 / a.G) * kRows, width - 1);
  const int bq_hi =
      start + min(min((i_last / a.G + 1) * kRows, a.C) - 1, width - 1);
  const int lo = a.window >= 0 ? max(0, bq_lo - a.window + 1) : 0;
  const int hi = min(a.n_keys, bq_hi + 1);
  // the split's tiles that hold keys of [lo, hi)
  const int j_lo = max(sp * a.tps, lo / kT);
  const int j_hi = lo < hi ? min((sp + 1) * a.tps, (hi + kT - 1) / kT) : 0;
  const int ntiles = max(0, j_hi - j_lo);

  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  // round r's tile into buffer r & 1: its keys' validity and scales (warp
  // 0, lane j key j), then K and V by 16-byte copies, zero-filled where
  // masked (int8: into the staging tiles)
  auto load_tile = [&](int r) {
    if (r < ntiles) {
      const int t0 = (j_lo + r) * kT, buf = r & 1;
      if (tid < kT) {
        const int s = t0 + tid;
        int ok = s < a.n_keys;
        float kf = 1.f, vf = 1.f;
        if constexpr (kPaged) {
          const int pg = ok ? a.bt[b * a.bt_sb + s / a.page] : -1;
          ok = pg >= 0;
          if constexpr (Store<T>::kScaled) {
            if (ok) {
              const long so = (long)pg * a.sc_sp + (long)h * a.sc_sh;
              kf = a.ksc[so];
              vf = a.vsc[so];
            }
          }
        }
        kval[buf][tid] = ok;
        ksf[buf][tid] = kf;
        vsf[buf][tid] = vf;
      }
      const int nc = D / kE;  // 16-byte copies a key row
      for (int id = tid; id < kT * nc; id += nthreads) {
        const int j = id / nc, ch = id - j * nc, s = t0 + j;
        long ko = -1, vo = -1;
        if (s < a.n_keys) {
          if constexpr (kPaged) {
            const int pg = a.bt[b * a.bt_sb + s / a.page];
            if (pg >= 0) {
              const long slot = s % a.page;
              ko = (long)pg * a.k_s0 + slot * a.k_ss + (long)h * a.k_sh;
              vo = (long)pg * a.v_s0 + slot * a.v_ss + (long)h * a.v_sh;
            }
          } else {
            ko = (long)b * a.k_s0 + (long)s * a.k_ss + (long)h * a.k_sh;
            vo = (long)b * a.v_s0 + (long)s * a.v_ss + (long)h * a.v_sh;
          }
        }
        uint32_t kd, vd;
        if constexpr (kStaged) {
          kd = sbase + oS + buf * kStageBytes + j * kDMax + ch * 16;
          vd = kd + 2 * kStageBytes;
        } else {
          kd = sbase + oK + buf * kTileBytes + swz(j, ch, kRowBytes);
          vd = kd + (oV - oK);
        }
        cp_async16(kd, ko >= 0 ? kp + ko + ch * kE : kp, ko >= 0 ? 16 : 0);
        cp_async16(vd, vo >= 0 ? vp + vo + ch * kE : vp, vo >= 0 ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float o[kDMax / 8][4];
#pragma unroll
  for (int n = 0; n < kDMax / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  if (ntiles > 0) {
    // Q (the warp's 16 rows; tokens past C zero) with the first round,
    // then the second round, in flight at once
    const uint32_t sq = sbase + warp * kQBytes;
    if (has) {
      const bf16* qb = a.q + b * a.q_sb + (long)hq * a.q_sh;
      const int nq = D >> 3;
      for (int id = lane; id < kRows * nq; id += 32) {
        const int r = id / nq, ch = id - r * nq, c = c0 + r;
        const bool in = c < a.C;
        cp_async16(sq + swz(r, ch, kRowBytes),
                   in ? qb + (long)c * a.q_sc + ch * 8 : qb, in ? 16 : 0);
      }
    }
    load_tile(0);
    load_tile(1);

    uint32_t qa[kDMax / 16][4];  // this warp's Q rows as A fragments
    for (int r = 0; r < ntiles; ++r) {
      cp_async_wait<1>();
      __syncthreads();  // Q and round r landed
      const int buf = r & 1;
      if constexpr (kStaged) {
        // the int8 tiles widened to bf16 (exact) into the swizzled tiles
        const int nc8 = D >> 3;
        for (int id = tid; id < 2 * kT * nc8; id += nthreads) {
          const int isv = id >= kT * nc8, id2 = id - isv * kT * nc8;
          const int j = id2 / nc8, ch = id2 - j * nc8;
          const uint2 w = *reinterpret_cast<const uint2*>(
              smem + oS + (2 * isv + buf) * kStageBytes + j * kDMax + ch * 8);
          *reinterpret_cast<uint4*>(smem + (isv ? oV : oK) +
                                    buf * kTileBytes +
                                    swz(j, ch, kRowBytes)) = widen8(w);
        }
        __syncthreads();
      }
      if (has) {
        if (r == 0) {
#pragma unroll
          for (int kk = 0; kk < kDMax / 16; ++kk)
            if (kk < nd16)
              ldsm_x4(qa[kk], sq + swz(lane & 15, kk * 2 + (lane >> 4),
                                       kRowBytes));
        }
        const int t0 = (j_lo + r) * kT;
        // a hidden pair for these rows: an invalid key, past the lowest
        // row's position, or before the highest row's window
        const bool edge = !__all_sync(0xffffffffu, kval[buf][lane]) ||
                          t0 + kT - 1 > wq_lo ||
                          (a.window >= 0 && t0 <= wq_hi - a.window);
        tile_step<Store<T>::kScaled>(
            a, sbase + oK + buf * kTileBytes, sbase + oV + buf * kTileBytes,
            kval[buf], ksf[buf], vsf[buf], t0, edge, qa, qp, m_r, l_r, o,
            lane);
      }
      __syncthreads();  // round r consumed before its buffers are refilled
      load_tile(r + 2);
    }
    cp_async_wait<0>();
  }
  if (!has) return;

  // l across the quad; the output (one split) or the split's partials
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_r[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int c = c0 + g8 + 8 * hh;
    if (c >= a.C) continue;
    if (a.n_split == 1) {
      const float inv = 1.f / (l == 0.f ? 1.f : l);
      bf16* row = a.out + b * a.o_sb + (long)c * a.o_sc + (long)hq * a.o_sh;
#pragma unroll
      for (int n = 0; n < kDMax / 8; ++n) {
        const int d = n * 8 + 2 * t;
        if (d < D)
          *reinterpret_cast<uint32_t*>(row + d) =
              pack_bf16(o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
      }
    } else {
      const long prow =
          (((long)b * a.C + c) * a.Hq + hq) * a.n_split + sp;
      if (t == 0) {
        a.part_m[prow] = m_r[hh];
        a.part_l[prow] = l;
      }
      float* acc = a.part_acc + prow * D;
#pragma unroll
      for (int n = 0; n < kDMax / 8; ++n) {
        const int d = n * 8 + 2 * t;
        if (d < D)
          *reinterpret_cast<float2*>(acc + d) =
              make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
      }
    }
  }
}

// out (b, c, hq) = the partials merged in split order (m in base 2); a
// thread per dim
__global__ void __launch_bounds__(kDMax) combine_kernel(Args a) {
  const int bc = blockIdx.x, hq = blockIdx.y, d = threadIdx.x;
  if (d >= a.D) return;
  const int b = bc / a.C, c = bc - b * a.C;
  const long row = ((long)bc * a.Hq + hq) * a.n_split;
  float M = kNegInf;
  for (int i = 0; i < a.n_split; ++i)
    if (a.part_l[row + i] > 0.f) M = fmaxf(M, a.part_m[row + i]);
  float L = 0.f, O = 0.f;
  for (int i = 0; i < a.n_split; ++i) {
    const float l = a.part_l[row + i];
    if (l > 0.f) {
      const float w = exp2f(a.part_m[row + i] - M);
      L += l * w;
      O += a.part_acc[(row + i) * a.D + d] * w;
    }
  }
  a.out[b * a.o_sb + (long)c * a.o_sc + (long)hq * a.o_sh + d] =
      __float2bfloat16_rn(L == 0.f ? 0.f : O / L);
}

template <typename T, bool kPaged>
int launch(const Args& a, int B, int Hkv, cudaStream_t s) {
  constexpr bool staged = Store<T>::kScaled;
  // opted in once per instance (one card a process) for the largest block
  static const cudaError_t opted = cudaFuncSetAttribute(
      chunk_kernel<T, kPaged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(kMaxWarps, staged));
  if (opted != cudaSuccess) return (int)opted;
  chunk_kernel<T, kPaged>
      <<<dim3(B, Hkv * a.n_rb, a.n_split), max(a.warps, kMinWarps) * 32,
         smem_bytes(a.warps, staged), s>>>(a);
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || a.n_split == 1) return rc;
  combine_kernel<<<dim3(B * a.C, a.Hq), kDMax, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The caller (kernels/flash_attention.py) vouches for bf16 q and out with
// unit stride on D, q's base 16-byte aligned and its strides multiples of
// 8, K/V of the storage kv_dtype whose base and row (or page), slot and
// head strides are multiples of 16 bytes (8 bf16, 16 int8 elements), D a
// multiple of 16 up to 128, int32 (B,) start and width, and, when
// n_split > 1, f32 scratch part_m, part_l (B, C, Hq, n_split) and
// part_acc (B, C, Hq, n_split, D), contiguous.  A pool comes with its
// (B, max_blocks) table (unit column stride) and n_keys = max_blocks *
// page; an int8 pool also with f32 scale pools of one layout, a bf16 pool
// with none.  The slab comes with no table and n_keys = Smax.  warps:
// 16-row items a block (1..8); the splits cover the ceil(n_keys / 32)
// tiles.  Instances: the bf16 slab, the bf16 pool, the int8 pool; any
// other combination is refused.
extern "C" int repro_flash_chunk_tc(
    const void* q, const void* k, const void* v, const void* ksc,
    const void* vsc, const void* start, const void* width, const void* bt,
    void* out, void* part_m, void* part_l, void* part_acc, int B, int Hkv,
    int G, int C, int D, int n_keys, int page, int warps,
    int tiles_per_split, int n_split, long long bt_sb, long long q_sb,
    long long q_sc, long long q_sh, long long k_s0, long long k_ss,
    long long k_sh, long long v_s0, long long v_ss, long long v_sh,
    long long sc_sp, long long sc_sh, long long o_sb, long long o_sc,
    long long o_sh, int window, float scale, int kv_dtype, void* stream) {
  const bool paged = bt != nullptr, scaled = ksc != nullptr;
  const long n_tiles = ((long)n_keys + kT - 1) / kT;
  if (D < 16 || D > kDMax || D % 16 || G < 1 || C < 1 || B < 0 ||
      Hkv < 1 || n_keys < 0 || page < 1 || warps < 1 ||
      warps > kMaxWarps || tiles_per_split < 1 || n_split < 1 ||
      (long)n_split * tiles_per_split < n_tiles ||
      scaled != (vsc != nullptr) || (scaled && !paged) ||
      (n_split > 1 && (!part_m || !part_l || !part_acc)))
    return (int)cudaErrorInvalidValue;
  const int n_items = G * ((C + kRows - 1) / kRows);
  const int n_rb = (n_items + warps - 1) / warps;
  Args a{static_cast<const bf16*>(q), k, v, static_cast<const float*>(ksc),
         static_cast<const float*>(vsc), static_cast<const int*>(start),
         static_cast<const int*>(width), static_cast<const int*>(bt),
         static_cast<bf16*>(out), static_cast<float*>(part_m),
         static_cast<float*>(part_l), static_cast<float*>(part_acc),
         Hkv * G, G, C, D, n_items, warps, n_rb, n_keys, page,
         tiles_per_split, n_split, window, bt_sb, q_sb, q_sc, q_sh, k_s0,
         k_ss, k_sh, v_s0, v_ss, v_sh, sc_sp, sc_sh, o_sb, o_sc, o_sh,
         scale};
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == kInt8 && paged && scaled)
    return launch<int8_t, true>(a, B, Hkv, s);
  if (kv_dtype == kBF16 && paged && !scaled)
    return launch<bf16, true>(a, B, Hkv, s);
  if (kv_dtype == kBF16 && !paged && !scaled)
    return launch<bf16, false>(a, B, Hkv, s);
  return (int)cudaErrorInvalidValue;
}
