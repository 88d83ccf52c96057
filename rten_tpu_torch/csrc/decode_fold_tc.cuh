// decode_mha's fold on tensor cores, split over blocks: s8, int4 and bf16
// head-major caches at head dims up to 128 (instances DP 64 and 128), with
// or without a bf16 recent window (deferred KV). Included by
// decode_mha.cuh; f32 caches, f32 windows and D 129-512 keep
// decode_fold.cuh's CUDA-core kernel, split the same way.
//
// Replaces rten_tpu/kernels/flash_attention.py:772 _decode_mha_folded.
//
// Function (decode_mha.cu states it): query row s of slot b, head h, at
// position lens[b] + s, reads kv head h / (H / Hkv) and attends columns
// j <= lens[b] + s, j < cap and, with a window, j > lens[b] + s - window;
// s_j = (q . k_j) * scale * ks[j]; out = sum_j p_j vs[j] v_j / sum_j p_j;
// a row with no column gives 0. Deferred KV (W > 0): every row attends the
// cache strictly below lens[b] and the window rows r <= t, the step's new
// row first written, rounded to bf16, into window row min(max(t, 0), W - 1).
//
// Bound on the H100: bytes. At TinyLlama's decode step (16 slots, 4 kv
// heads, D 64, lens about 160) a call reads about 1 MB of bf16 K/V and the
// f32 q and output (0.13 MB), about 0.35 us at 3.35 TB/s; its 8 query rows
// a kv head make 4 flops a K/V element, far below the tensor cores' rate.
// So the design is about latency: enough blocks, every copy in flight
// early, few dependent round trips.
//
// Split: the grid is (slots, kv heads, splits); block z takes the columns
// [z * chunk, (z + 1) * chunk) of its (slot, kv head)
// (kernels/flash_attention.py, decode_split_plan, from the shapes alone: 4
// chunks of 64 at TinyLlama's 16 x 4, one at GPT-2's 120 x 12). A block
// reads lens (and t) first and issues the loads of q (and of the step's
// new row), then its warps' first K/V copies, then stages q; its four warps
// take the chunk's 16-key tiles in turn, each through its own ring of
// stages filled by cp.async (16-byte copies where the rows are 16-byte
// aligned words, element copies otherwise; keys past the block's last
// column are zero-filled, never read). The recent window belongs to the
// last split: that block alone writes the new row (before its barrier), and
// the window's tiles come first in its warps' turns, read by plain loads
// after the barrier while the cache tiles' copies are in flight.
// With one split the block writes the output; with more, it writes its
// rows' states (m, l, acc[D]) to the workspace, and after a barrier thread
// 0 bumps the (slot, kv head)'s counter with one acquire-release atomic
// (the barrier orders the block's stores before it; no fence per thread).
// The block that arrives last merges the states in split order and resets
// the counter: two calls give the same bits.
//
// Arithmetic: mma.sync.m16n8k16 on bf16 operands with f32 accumulation,
// the keys on the M side and the block's query rows (group * S <= 16) on
// the N side: S^T = K . q^T, O^T = V^T . P^T, so a group of 1-8 rows is
// one n-tile (two above 8). K and V enter exact: s8 codes and int4 codes
// (nibble - 8) widened to bf16 by exact f32 bit tricks, bf16 as it is. q
// enters as three bf16 parts (hi = bf16(q), mid = bf16(q - hi), lo =
// bf16(q - hi - mid): about 24 bits), and so does p * vs[j]; bf16 x bf16
// products are exact in f32. One rounding of q (the TPU kernel's bf16 dot)
// is 2e-3 away and two parts 4e-6, which parts the small engines' tokens
// on card and CPU (decode_heads_tc.cuh): so three. The softmax runs in
// base 2 (the scale carries log2(e); ex2.approx). The score keeps one
// accumulator a part of q (three short chains of mma, summed after). A
// thread holds two query rows of each n-tile and two keys of the tile
// (rows 2tg, 2tg + 1; keys g, g + 8): a row's max and sum reduce over the
// eight lanes that share tg;
// p * vs, split into its parts, becomes P^T's B fragment by shuffles
// (every lane takes part: no shuffle sits in a divergent branch). s8 and
// int4 tiles land raw with their scales and are widened by the warp into
// its one bf16 tile, K's for the scores, then V's; bf16 tiles land as they
// are. The warps' states merge in
// shared memory in warp order, the splits' in split order.
//
// Built without --use_fast_math (IEEE division).

#pragma once

#include "decode_fold.cuh"
#include "decode_heads_tc.cuh"

namespace {

constexpr int FTC_KEYS = 16;  // keys of a warp's tile: one mma M tile

// The layout of decode_fold_tc_kernel<DP, T, NT>: q's three bf16 parts
// [3][ROWS][PITCH], then each warp's ring of STAGES stages (bf16: a K and
// a V tile; s8/int4: raw K and V rows and their scales) and, for s8/int4,
// the warp's one widened bf16 tile (K's, then V's). Rows are padded by 16
// bytes (the 8 rows an ldmatrix reads start in 8 bank groups). After the
// tiles the rings hold the warps' partial outputs. The s8/int4 layout is
// kept small (one widened tile, two stages of rows of 64 bytes or more) so
// that GPT-2's 1440 blocks of one row find 6 or 7 blocks an SM.
template <int DP, typename T, int NT>
struct FoldTc {
  static constexpr bool QUANT = KvRow<T>::QUANT;
  static constexpr int ROWS = 8 * NT;
  static constexpr int PITCH = DP + 8;                        // bf16 elements a tile row
  static constexpr int TILE = FTC_KEYS * PITCH;               // bf16 elements of a K or V tile
  static constexpr int RAW_ROW = KvRow<T>::U4 ? DP / 2 : DP;  // bytes a staged s8/int4 row
  static constexpr int STAGES = QUANT ? (RAW_ROW >= 64 ? 2 : 3) : (DP <= 64 ? 3 : 2);
  static constexpr int STAGE = QUANT ? 2 * FTC_KEYS * RAW_ROW + 2 * FTC_KEYS * 4 : 2 * TILE * 2;
  static constexpr int VGAP = QUANT ? FTC_KEYS * RAW_ROW : TILE * 2;  // V after K, bytes
  static constexpr int WIDE = QUANT ? TILE * 2 : 0;
  static constexpr int WARP = STAGES * STAGE + WIDE;
  static constexpr int Q_BYTES = 3 * ROWS * PITCH * 2;
  static constexpr int MERGE = FOLD_WARPS * ROWS * DP * 4;
  static constexpr int SMEM = Q_BYTES + (FOLD_WARPS * WARP > MERGE ? FOLD_WARPS * WARP : MERGE);
  static constexpr int QPT = ROWS * DP / (FOLD_WARPS * 32);  // q elements a thread stages
  static_assert(STAGE % 16 == 0 && Q_BYTES % 16 == 0 && WIDE % 16 == 0, "alignment");
  static_assert(QPT * FOLD_WARPS * 32 == ROWS * DP, "whole q rows");
};

// A warp's copy of a tile's 16 rows: row u from src + (key0 + u) * sj (bytes)
// to dst + u * dpitch, ``row_bytes`` of it, keys past ``last`` zero-filled
// and not read. ``fast``: 16-byte words (rows 16-byte aligned whole words),
// by cp.async (the caller commits and waits) or, ``sync``, by loads and
// stores; otherwise element loads and stores of ``ES`` bytes. Loads and
// stores are complete when they return. CPR > 0: row_bytes is CPR 16-byte
// words, known at compile time (no division, the loop unrolled).
template <int ES, int CPR = 0>
__device__ __forceinline__ void ftc_rows(unsigned char* dst, int dpitch,
                                         const unsigned char* src, long long sj, int key0,
                                         int last, int row_bytes, bool fast, bool sync,
                                         int lane) {
  if (CPR > 0 || fast) {
    const int cpr = CPR > 0 ? CPR : row_bytes >> 4;
#pragma unroll
    for (int i = lane; i < FTC_KEYS * cpr; i += 32) {
      const int u = i / cpr, c = i - u * cpr;
      const bool in = key0 + u <= last;
      unsigned char* d = dst + u * dpitch + 16 * c;
      const unsigned char* s = in ? src + (key0 + u) * sj + 16 * c : src;
      if (sync)
        *reinterpret_cast<uint4*>(d) = in ? *reinterpret_cast<const uint4*>(s) : make_uint4(0u, 0u, 0u, 0u);
      else
        cp_async16(d, s, in);
    }
  } else {
    using E = typename std::conditional<ES == 2, uint16_t, uint8_t>::type;
    const int per = row_bytes / ES;
    for (int i = lane; i < FTC_KEYS * per; i += 32) {
      const int u = i / per, c = i - u * per;
      const bool in = key0 + u <= last;
      reinterpret_cast<E*>(dst + u * dpitch)[c] =
          in ? reinterpret_cast<const E*>(src + (key0 + u) * sj)[c] : E(0);
    }
  }
}

// The last block's merge of R rows' split states (row r of head hg0 + r / S
// at position r % S, its states at index (u0 + r) * splits + z), V dims a
// thread at a time, online in split order: M, L and the output rescaled as
// each split arrives (2^(m - M): the states are in base 2).
template <int V>
__device__ __forceinline__ void ftc_merge(const float* ws, long long ml0, float* out,
                                          long long u0, int hg0, int S, int R, int D, int splits,
                                          long long o_sh, long long o_ss, int tid) {
  using Vec = typename std::conditional<V == 4, float4, float2>::type;
  const int per = D / V;
  for (int i = tid; i < R * per; i += FOLD_WARPS * 32) {
    const int r = i / per, d = V * (i % per);
    const long long st0 = (u0 + r) * splits;
    float M = -INFINITY, L = 0.f, o[V];
#pragma unroll
    for (int x = 0; x < V; ++x) o[x] = 0.f;
#pragma unroll 4
    for (int zz = 0; zz < splits; ++zz) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(ws + ml0 + 2 * (st0 + zz)));
      const Vec oz = __ldcg(reinterpret_cast<const Vec*>(ws + (st0 + zz) * D + d));
      const float* of = reinterpret_cast<const float*>(&oz);
      const float mn = fmaxf(M, ml.x);
      const float mu = mn == -INFINITY ? 0.f : mn;
      const float a = fast_exp2(M - mu), c = fast_exp2(ml.x - mu);
      L = L * a + ml.y * c;
#pragma unroll
      for (int x = 0; x < V; ++x) o[x] = o[x] * a + of[x] * c;
      M = mn;
    }
    float* dst = out + (long long)(hg0 + r / S) * o_sh + (long long)(r % S) * o_ss + d;
#pragma unroll
    for (int x = 0; x < V; ++x) dst[x] = L > 0.f ? o[x] / L : 0.f;
  }
}

template <int DP, typename T, int NT>
__global__ void __launch_bounds__(FOLD_WARPS * 32, NT == 1 && DP <= 64 ? 6 : 1)
    decode_fold_tc_kernel(
    const float* __restrict__ q, long long q_sb, long long q_sh, long long q_ss,
    const T* __restrict__ kc, const T* __restrict__ vc, long long kv_sb, long long kv_sh,
    long long kv_sj, const float* __restrict__ ks, const float* __restrict__ vs,
    long long sc_sb, long long sc_sh, long long sc_sj, const int32_t* __restrict__ lens,
    float* __restrict__ out, long long o_sb, long long o_sh, long long o_ss, int H, int Hkv,
    int S, int D, int cap, int window, float scale, int vec, RecentWindow rw, SplitArgs sp) {
  using F = FoldTc<DP, T, NT>;
  constexpr bool QUANT = F::QUANT;
  constexpr int ROWS = F::ROWS, P = F::PITCH, STAGES = F::STAGES, DT = DP / 16;
  constexpr int NTHREADS = FOLD_WARPS * 32;
  extern __shared__ __align__(16) unsigned char ftc_smem[];
  unsigned char* smem = ftc_smem;
  __shared__ float m_s[FOLD_WARPS][ROWS], l_s[FOLD_WARPS][ROWS], c_s[ROWS][FOLD_WARPS];
  __shared__ float row_s[ROWS][2];
  __shared__ bool last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3, lm = lane >> 3, lr = lane & 7;
  const int b = blockIdx.x, hk = blockIdx.y, splits = gridDim.z, z = blockIdx.z;
  const int group = H / Hkv, R = group * S;
  // lens and the step first, then the loads that need neither (q; the
  // deferred step's new row): everything else waits on them. q row r = g' *
  // S + s: head hk * group + g', position len + s; zeros past R and D.
  const int len = __ldg(lens + b);
  const bool deferred = rw.W > 0;
  const int t = deferred ? __ldg(rw.t) : 0;
  float qx[F::QPT];
#pragma unroll
  for (int k = 0; k < F::QPT; ++k) {
    const int i = tid + k * NTHREADS, r = i / DP, d = i % DP;
    qx[k] = r < R && d < D ? __ldg(q + (long long)b * q_sb + (long long)(hk * group + r / S) * q_sh +
                                   (long long)(r % S) * q_ss + d)
                           : 0.f;
  }
  const bool win_block = deferred && z == splits - 1;  // the window's tiles are its alone
  const bool new_row = win_block && rw.kn != nullptr && tid < D;  // D <= 128: a dim a thread
  float kn_d = 0.f, vn_d = 0.f;
  if (new_row) {
    kn_d = __ldg(rw.kn + (long long)b * rw.n_sb + (long long)hk * rw.n_sh + tid);
    vn_d = __ldg(rw.vn + (long long)b * rw.n_sb + (long long)hk * rw.n_sh + tid);
  }

  // The block's tiles: (the last split of a deferred step) the window rows
  // [0, wlast] first, then its cache columns [blo, bhi] from kstart.
  const int hi = deferred ? min(len - 1, cap - 1) : min(len + S - 1, cap - 1);
  const int lo = window > 0 && !deferred ? max(0, len - window + 1) : 0;
  const int c0 = z * sp.chunk;
  const int blo = max(lo, c0), bhi = min(hi, c0 + sp.chunk - 1);
  const int kstart = blo & ~(FTC_KEYS - 1);
  const int wlast = win_block ? min(t, rw.W - 1) : -1;
  const int nwin = wlast >= 0 ? wlast / FTC_KEYS + 1 : 0;
  const int ntile = nwin + (bhi >= blo ? (bhi - kstart) / FTC_KEYS + 1 : 0);
  const int mine_n = warp < ntile ? (ntile - 1 - warp) / FOLD_WARPS + 1 : 0;  // the warp's tiles

  const long long kvoff = (long long)b * kv_sb + (long long)hk * kv_sh;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(kc + kvoff);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(vc + kvoff);
  const long long sj = kv_sj * (long long)sizeof(T);  // bytes between key rows
  const long long scoff = (long long)b * sc_sb + (long long)hk * sc_sh;
  const int row_bytes = KvRow<T>::U4 ? D / 2 : D * (int)sizeof(T);
  unsigned char* mine = smem + F::Q_BYTES + warp * F::WARP;
  __nv_bfloat16* wide = reinterpret_cast<__nv_bfloat16*>(mine + STAGES * F::STAGE);

  // bf16 tiles: the dims past D stay zero (no copy writes them).
  if (D < DP) {
    for (int i = lane; i < F::WARP / 16; i += 32)
      reinterpret_cast<uint4*>(mine)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
  }

  // The warp's i-th tile into stage i % STAGES: cache tiles only (the
  // window's are read when their turn comes, after the barrier that
  // follows the new row's write); an empty group otherwise.
  auto issue = [&](int i) {
    const int ti = warp + i * FOLD_WARPS;
    if (i < mine_n && ti >= nwin) {
      const int key0 = kstart + (ti - nwin) * FTC_KEYS;
      unsigned char* st = mine + (i % STAGES) * F::STAGE;
      constexpr int DPITCH = QUANT ? F::RAW_ROW : 2 * P;
      constexpr int ES = QUANT ? 1 : 2;
      constexpr int CPR = (QUANT ? F::RAW_ROW : 2 * DP) / 16;  // 16-byte words a row, D == DP
      if (vec && D == DP) {
        ftc_rows<ES, CPR>(st, DPITCH, kb, sj, key0, bhi, row_bytes, true, false, lane);
        ftc_rows<ES, CPR>(st + F::VGAP, DPITCH, vb, sj, key0, bhi, row_bytes, true, false, lane);
      } else {
        ftc_rows<ES>(st, DPITCH, kb, sj, key0, bhi, row_bytes, vec != 0, false, lane);
        ftc_rows<ES>(st + F::VGAP, DPITCH, vb, sj, key0, bhi, row_bytes, vec != 0, false, lane);
      }
      if constexpr (QUANT) {  // lane u < 16: K's scale of key u; 16 + u: V's
        const int u = lane & 15, key = key0 + u;
        const bool in = key <= bhi;
        float* dsc = reinterpret_cast<float*>(st + 2 * F::VGAP) + lane;
        cp_async4(dsc, (lane < 16 ? ks : vs) + scoff + (in ? key : 0) * sc_sj, in);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES; ++s) issue(s);

  // q's rows as three bf16 parts, the new row into the window, while the
  // copies fly.
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
  for (int k = 0; k < F::QPT; ++k) {
    const int i = tid + k * NTHREADS, r = i / DP, d = i % DP;
    float x = qx[k];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const __nv_bfloat16 hp = __float2bfloat16_rn(x);
      qs[(p * ROWS + r) * P + d] = hp;
      x -= __bfloat162float(hp);
    }
  }
  if (new_row) {  // row min(max(t, 0), W - 1), clamped like dynamic_update_slice
    const long long w = (long long)b * rw.r_sb + (long long)hk * rw.r_sh +
                        (long long)min(max(t, 0), rw.W - 1) * rw.r_sj + tid;
    reinterpret_cast<__nv_bfloat16*>(rw.rk)[w] = __float2bfloat16_rn(kn_d);
    reinterpret_cast<__nv_bfloat16*>(rw.rv)[w] = __float2bfloat16_rn(vn_d);
  }
  __syncthreads();  // q staged; the window's new row written

  // The columns each of the thread's query rows attends (rows nt * 8 + 2 tg
  // + e): cache columns [clo, chi]; window rows [0, wlast] for every live
  // row. Rows past R attend nothing.
  int clo[NT][2], chi[NT][2];
  bool rlive[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = nt * 8 + 2 * tg + e;
      const int pos = len + r % S;
      rlive[nt][e] = r < R;
      chi[nt][e] = r >= R ? -1 : deferred ? bhi : min(pos, bhi);
      clo[nt][e] = window > 0 && !deferred ? pos - window + 1 : 0;
    }
  }
  const float scale2 = scale * 1.4426950408889634f;
  float m[NT][2], l[NT][2], acc[NT][DT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    m[nt][0] = m[nt][1] = -INFINITY;
    l[nt][0] = l[nt][1] = 0.f;
#pragma unroll
    for (int mt = 0; mt < DT; ++mt) acc[nt][mt][0] = acc[nt][mt][1] = acc[nt][mt][2] = acc[nt][mt][3] = 0.f;
  }
  // P^T's B fragment comes from the lanes whose score fragment holds keys
  // 2 tg and 2 tg + 1 of row g.
  const int srcA = 8 * tg + (g >> 1), srcB = srcA + 4;
  const unsigned sel = g & 1 ? 0x7632u : 0x5410u;

  for (int i = 0; i < mine_n; ++i) {
    const int ti = warp + i * FOLD_WARPS;
    const bool wtile = ti < nwin;
    const int key0 = wtile ? ti * FTC_KEYS : kstart + (ti - nwin) * FTC_KEYS;
    unsigned char* st = mine + (i % STAGES) * F::STAGE;
    const long long woff = (long long)b * rw.r_sb + (long long)hk * rw.r_sh;
    const unsigned char* wk = reinterpret_cast<const unsigned char*>(
        reinterpret_cast<const __nv_bfloat16*>(rw.rk) + woff);
    const unsigned char* wv = reinterpret_cast<const unsigned char*>(
        reinterpret_cast<const __nv_bfloat16*>(rw.rv) + woff);
    const __nv_bfloat16* Kt;
    float ksc[2] = {1.f, 1.f}, vsc[2] = {1.f, 1.f};
    if (wtile) {
      // A window tile (bf16 rows), read now by loads (the cache tiles'
      // copies stay in flight): K and V into the stage the ring left empty
      // (bf16 caches), or K into the warp's widened tile (s8/int4; V once
      // the scores are taken).
      __syncwarp();
      unsigned char* dst = QUANT ? reinterpret_cast<unsigned char*>(wide) : st;
      ftc_rows<2>(dst, 2 * P, wk, rw.r_sj * 2, key0, wlast, 2 * D, rw.wvec != 0, true, lane);
      if constexpr (!QUANT)
        ftc_rows<2>(dst + F::TILE * 2, 2 * P, wv, rw.r_sj * 2, key0, wlast, 2 * D, rw.wvec != 0,
                    true, lane);
      __syncwarp();
      Kt = reinterpret_cast<const __nv_bfloat16*>(dst);
    } else {
      cp_async_wait<STAGES - 1>();  // this thread's copies of tile i
      __syncwarp();                 // ... and every lane's
      if constexpr (QUANT) {
        const float* sc = reinterpret_cast<const float*>(st + 2 * F::VGAP);
        ksc[0] = sc[g];
        ksc[1] = sc[g + 8];
        vsc[0] = sc[16 + g];
        vsc[1] = sc[16 + g + 8];
        widen_tile<DP, T, FTC_KEYS>(st, wide, D, lane, 32);
        __syncwarp();
        Kt = wide;
      } else {
        Kt = reinterpret_cast<const __nv_bfloat16*>(st);
      }
    }

    // S^T = K . (q_hi + q_mid + q_lo)^T, one accumulator a part (three
    // short chains, summed after): keys g, g + 8 of row 2 tg + e.
    float sc[NT][4];
    {
      float part[3][NT][4];
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          part[p][nt][0] = part[p][nt][1] = part[p][nt][2] = part[p][nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DT; ++kk) {
        if (kk * 16 >= D) continue;
        uint32_t a[4];  // K[key0 + 16 keys][16 dims] as the row-major A
        ldmatrix_x4(a, Kt + ((lm & 1) * 8 + lr) * P + kk * 16 + (lm >> 1) * 8);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const __nv_bfloat16* qr = qs + (p * ROWS + nt * 8 + g) * P + kk * 16 + 2 * tg;
            mma_bf16(part[p][nt], a, *reinterpret_cast<const uint32_t*>(qr),
                     *reinterpret_cast<const uint32_t*>(qr + 8));
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = part[2][nt][e] + part[1][nt][e] + part[0][nt][e];
    }
    // Scale (base 2), mask, the online softmax of each row; p * vs in three
    // parts, moved into P^T's B fragments.
    const int kA = key0 + g, kB = key0 + g + 8;
    uint32_t pb[NT][3][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float w[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bool okA, okB;
        if (wtile) {
          okA = rlive[nt][e] && kA <= wlast;
          okB = rlive[nt][e] && kB <= wlast;
        } else {
          okA = kA >= clo[nt][e] && kA <= chi[nt][e];
          okB = kB >= clo[nt][e] && kB <= chi[nt][e];
        }
        const float s0 = okA ? sc[nt][e] * scale2 * ksc[0] : -INFINITY;
        const float s1 = okB ? sc[nt][2 + e] * scale2 * ksc[1] : -INFINITY;
        float mx = fmaxf(s0, s1);
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 16));
        const float m_new = fmaxf(m[nt][e], mx);
        const float mu = m_new == -INFINITY ? 0.f : m_new;  // no column yet: every p is 0
        const float alpha = fast_exp2(m[nt][e] - mu);       // 0 while m is -inf
        const float p0 = fast_exp2(s0 - mu), p1 = fast_exp2(s1 - mu);
        l[nt][e] = l[nt][e] * alpha + (p0 + p1);
        m[nt][e] = m_new;
#pragma unroll
        for (int mt = 0; mt < DT; ++mt) {
          acc[nt][mt][e] *= alpha;
          acc[nt][mt][2 + e] *= alpha;
        }
        w[e] = p0 * vsc[0];
        w[2 + e] = p1 * vsc[1];
      }
      uint32_t lo3[3], hi3[3];  // rows 2 tg, 2 tg + 1 of keys g, g + 8, in parts
      split3_bf16x2(w[0], w[1], lo3);
      split3_bf16x2(w[2], w[3], hi3);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        pb[nt][p][0] = __byte_perm(__shfl_sync(FULL, lo3[p], srcA), __shfl_sync(FULL, lo3[p], srcB), sel);
        pb[nt][p][1] = __byte_perm(__shfl_sync(FULL, hi3[p], srcA), __shfl_sync(FULL, hi3[p], srcB), sel);
      }
    }
    // s8/int4: V into the widened tile, now that K's reads are done.
    const __nv_bfloat16* Vt = Kt + F::TILE;
    if constexpr (QUANT) {
      __syncwarp();
      if (wtile)
        ftc_rows<2>(reinterpret_cast<unsigned char*>(wide), 2 * P, wv, rw.r_sj * 2, key0, wlast,
                    2 * D, rw.wvec != 0, true, lane);
      else
        widen_tile<DP, T, FTC_KEYS>(st + F::VGAP, wide, D, lane, 32);
      __syncwarp();
      Vt = wide;
    }
    // O^T += V^T . (p vs)^T, 16 dims a step, the three parts.
#pragma unroll
    for (int mt = 0; mt < DT; ++mt) {
      if (mt * 16 >= D) continue;
      uint32_t a[4];  // V^T[16 dims][16 keys] as the row-major A
      ldmatrix_x4_trans(a, Vt + ((lm >> 1) * 8 + lr) * P + mt * 16 + (lm & 1) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int p = 0; p < 3; ++p) mma_bf16(acc[nt][mt], a, pb[nt][p][0], pb[nt][p][1]);
      }
    }
    __syncwarp();  // every lane is done with the stage
    issue(i + STAGES);
  }
  cp_async_wait<0>();

  // The warps' states (each row's l summed over its 8 lanes) into shared
  // memory (the rings' space), merged in warp order: M = max m_w, c_w =
  // 2^(m_w - M), L = sum c_w l_w, acc = sum c_w acc_w.
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[nt][e] += __shfl_xor_sync(FULL, l[nt][e], 4);
      l[nt][e] += __shfl_xor_sync(FULL, l[nt][e], 8);
      l[nt][e] += __shfl_xor_sync(FULL, l[nt][e], 16);
    }
  }
  float* os = reinterpret_cast<float*>(smem + F::Q_BYTES);  // [WARPS][ROWS][DP]
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = nt * 8 + 2 * tg + e;
      float* orow = os + (warp * ROWS + row) * DP;
#pragma unroll
      for (int mt = 0; mt < DT; ++mt) {
        orow[mt * 16 + g] = acc[nt][mt][e];
        orow[mt * 16 + g + 8] = acc[nt][mt][2 + e];
      }
      if (g == 0) {
        m_s[warp][row] = m[nt][e];
        l_s[warp][row] = l[nt][e];
      }
    }
  }
  __syncthreads();
  if (tid < R) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < FOLD_WARPS; ++w) M = fmaxf(M, m_s[w][tid]);
    const float mu = M == -INFINITY ? 0.f : M;
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < FOLD_WARPS; ++w) {
      const float c = fast_exp2(m_s[w][tid] - mu);
      c_s[tid][w] = c;
      L += c * l_s[w][tid];
    }
    row_s[tid][0] = M;
    row_s[tid][1] = L;
  }
  __syncthreads();
  // Row r's state: index ((b * Hkv + hk) * R + r) * splits + z; its acc at
  // ws + index * D, its (m, l) at ws + NU * splits * D + 2 * index.
  const long long u0 = ((long long)b * Hkv + hk) * R;
  const long long ml0 = (long long)gridDim.x * Hkv * R * splits * D;
  for (int i = tid; i < R * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < FOLD_WARPS; ++w) o += c_s[r][w] * os[(w * ROWS + r) * DP + d];
    if (splits == 1) {
      const float L = row_s[r][1];
      out[(long long)b * o_sb + (long long)(hk * group + r / S) * o_sh + (long long)(r % S) * o_ss +
          d] = L > 0.f ? o / L : 0.f;
    } else {
      const long long st = (u0 + r) * splits + z;
      sp.ws[st * D + d] = o;
      if (d == 0) {
        sp.ws[ml0 + 2 * st] = row_s[r][0];
        sp.ws[ml0 + 2 * st + 1] = row_s[r][1];
      }
    }
  }
  if (splits == 1) return;
  // Arrive: the barrier orders the block's state stores before thread 0's
  // acquire-release increment, which makes them visible to the block that
  // finds the count complete.
  __syncthreads();
  if (tid == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> cnt(sp.count[b * Hkv + hk]);
    last = cnt.fetch_add(1u, cuda::memory_order_acq_rel) == (unsigned)(splits - 1);
  }
  __syncthreads();
  if (!last) return;
  // The last block merges every row's states in split order (read from
  // L2), online: M, L and the output dims rescaled as each split arrives;
  // every split's loads of a row are independent of the running state.
  if (D % 4 == 0) {
    ftc_merge<4>(sp.ws, ml0, out + (long long)b * o_sb, u0, hk * group, S, R, D, splits, o_sh,
                 o_ss, tid);
  } else {
    ftc_merge<2>(sp.ws, ml0, out + (long long)b * o_sb, u0, hk * group, S, R, D, splits, o_sh,
                 o_ss, tid);
  }
  if (tid == 0) sp.count[b * Hkv + hk] = 0u;  // ready for the next call on this workspace
}

// Launches an instance with its dynamic shared memory; the first launch of
// an instance on a device allows it those bytes (past 48 KB).
template <int DP, typename T, int NT, typename... Args>
cudaError_t launch_fold_tc_kernel(dim3 grid, cudaStream_t stream, Args... args) {
  auto* kernel = decode_fold_tc_kernel<DP, T, NT>;
  constexpr int bytes = FoldTc<DP, T, NT>::SMEM;
  static std::atomic<unsigned long long> allowed{0};  // bit d: set on device d
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(allowed.load(std::memory_order_acquire) & bit)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    allowed.fetch_or(bit, std::memory_order_release);
  }
  kernel<<<grid, FOLD_WARPS * 32, bytes, stream>>>(args...);
  return cudaSuccess;
}

}  // namespace
