// The fold form of decode attention, shared by decode_mha.cu,
// decode_mha_bf16.cu, decode_mha_u4.cu and decode_mha_wide.cu (slot-major
// caches), paged_decode_mha.cu and paged_decode_mha_bf16.cu (block pools
// read through a block table) and flash_attention.cu (the block-table
// append's attention over s8 cat-layout pools: the same strides, rows of
// Hkv * D; over f32/bf16 cat pools the append attends through the paged
// entry point with those strides).
//
// One 128-thread block per (slot, kv head) holds the group * S query rows
// that share the head in shared memory and reads each K/V row once for all
// of them. Its four warps split the 32-key tiles of the live range
// [lo, min(lens + S - 1, cap - 1)] and stop there; a lane scores one key
// against every row (16-byte vector loads of its K row, unrolled up to
// D 128, a loop over them beyond), the warp reduces
// each row's tile max and sum with shuffles, each lane accumulates DP / 32
// output dims of P.V for every row (the V values of 4 or 8 keys loaded
// together, so their latencies overlap), and the warps' online-softmax
// states merge in shared memory.
//
// Query row s of slot b, head h, sits at position lens[b] + s and reads KV
// head h / (H / Hkv) (kv-major GQA). It attends columns j with
// j <= lens[b] + s, j < cap and, when window > 0, j > lens[b] + s - window.
// A row with no such column gives 0. The K scale multiplies the score and
// the V scale the probability: s = (q . k_int) * scale * ks[j],
// out = sum_j p_j vs[j] v_int[j] / sum_j p_j.
//
// Cache elements T: s8 codes, or u8 bytes of two int4 codes (KV_U4), with
// per-position f32 scales; or f32 or bf16 values read as they are (no
// scales; the K scale is 1). An int4 row of D values is D / 2 bytes packed
// split-half: byte i holds dim i in its low nibble and dim i + D / 2 in its
// high nibble, each biased by 8 (code = nibble - 8).
//
// Head dims: the kernel is built for DP = 64, 128, 256 or 512 and takes any
// even D <= DP; dims past D are zero in shared memory and never read from
// the cache. D 64 and 128 run instances with D fixed at compile time
// (EXACT), which leave the masked tail's code out. K rows load 16 bytes at a time when every row starts 16-byte
// aligned and its length is a multiple of 16 bytes (``vec``); otherwise one
// element at a time.
//
// Deferred KV (the recent window, W > 0; flat caches only): the big cache
// holds the rows committed before this dispatch, valid strictly below
// lens[b] (here lens is the dispatch's lens0), and the window rw [B, Hkv, W,
// D] (f32 or bf16, the same strides as a cache) holds the rows of the
// dispatch's steps so far, row r valid when r <= t for every slot (t = the
// step, from device memory). Every query row attends the same columns. With
// the new row (kn/vn [B, Hkv, 1, D] f32), the block first writes it, rounded
// to the window's type, into window row min(max(t, 0), W - 1) of its own
// (slot, kv head) and then scores it as the window holds it (read back after
// a barrier; no other block reads that row). The window's tiles follow the
// cache's in the warps' round robin.
//
// Addressing (all strides in elements; bytes for int4 rows):
// * PAGED = false: row j of slot b, kv head hk at kc + b * kv_sb + hk * kv_sh
//   + j * kv_sj, its scale at ks[b * sc_sb + hk * sc_sh + j * sc_sj].
// * PAGED = true: the pools hold blocks of BS rows and slot b's position j
//   lives in block blk = bt[b * MB + j / BS], row r = j % BS: the K row at
//   kc + blk * kv_sb + hk * kv_sh + r * kv_sj, its scale at
//   ks[blk * sc_sb + hk * sc_sh + r * sc_sj]; cap = MB * BS. Each lane
//   resolves the table entry of its own key (the row is in L1 after the
//   first lane), and the P.V loop takes key u's row offset from lane u by a
//   shuffle, so no address is computed twice.
// Built without --use_fast_math (IEEE expf and division).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// The cache element types, by the code the wrappers pass
// (kernels/flash_attention.py, KV_KINDS). RTEN_BY_KIND covers the first
// three (the cat-layout kernels); decode_mha's and paged_decode_mha's entry
// points name the kinds they were built for.
enum KvKind { KV_S8 = 0, KV_F32 = 1, KV_BF16 = 2, KV_U4 = 3 };

// Expands M(T) for the element type of ``kind``; any other kind returns
// cudaErrorInvalidValue from the enclosing entry point.
#define RTEN_BY_KIND(kind, M)                                                    \
  switch (kind) {                                                                \
    case KV_S8: M(int8_t); break;                                                \
    case KV_F32: M(float); break;                                                \
    case KV_BF16: M(__nv_bfloat16); break;                                       \
    default: return (int)cudaErrorInvalidValue;                                  \
  }

// The instance a head dim runs in: the smallest DP of 64, 128, 256 and 512
// that holds it; 0 for an odd D or one past 512.
static inline int rten_dp_of(int D) {
  if (D < 2 || D % 2 || D > 512) return 0;
  return D <= 64 ? 64 : D <= 128 ? 128 : D <= 256 ? 256 : 512;
}

// The instance of the cat kernels that a head dim runs in: the smallest DP
// of 32, 64, 128, 256 (and 512 for the append) that holds it; 0 for an odd
// D or a larger one.
static inline int rten_cat_dp_of(int D, int max_dp) {
  if (D < 2 || D % 2 || D > max_dp) return 0;
  return D <= 32 ? 32 : rten_dp_of(D);
}

// Expands M(DP, T) for the instance of head dim D (32, 64, 128, 256, and
// 512 in RTEN_BY_DP512); any other D returns cudaErrorInvalidValue.
#define RTEN_BY_DP256(TT, M)                                                     \
  switch (rten_cat_dp_of(D, 256)) {                                              \
    case 32: M(32, TT); break;                                                   \
    case 64: M(64, TT); break;                                                   \
    case 128: M(128, TT); break;                                                 \
    case 256: M(256, TT); break;                                                 \
    default: return (int)cudaErrorInvalidValue;                                  \
  }
#define RTEN_BY_DP512(TT, M)                                                     \
  switch (rten_cat_dp_of(D, 512)) {                                              \
    case 32: M(32, TT); break;                                                   \
    case 64: M(64, TT); break;                                                   \
    case 128: M(128, TT); break;                                                 \
    case 256: M(256, TT); break;                                                 \
    case 512: M(512, TT); break;                                                 \
    default: return (int)cudaErrorInvalidValue;                                  \
  }

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int INT4_BIAS = 8;

template <typename T>
struct KvRow {
  static constexpr bool U4 = std::is_same<T, uint8_t>::value;
  static constexpr bool QUANT = U4 || std::is_same<T, int8_t>::value;
  static constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16-byte load
};

__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// A value as an f32 or bf16 cache element; bf16 rounds to nearest, ties to
// even, as jnp.astype(bfloat16) and torch's .to(torch.bfloat16) do.
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Element d of a row of D values (``half`` = D / 2): s8, f32 and bf16 rows
// hold it at d; an int4 row in the low nibble of byte d (d < half) or the
// high nibble of byte d - half.
template <typename T>
__device__ __forceinline__ float row_elem(const T* row, int d, int half) {
  if constexpr (KvRow<T>::U4) {
    const bool lo = d < half;
    const int byte = row[lo ? d : d - half];
    return (float)((lo ? (byte & 15) : (byte >> 4)) - INT4_BIAS);
  } else {
    (void)half;
    return to_f32(row[d]);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// 16 bytes of a cache row as floats: 16 s8, 4 f32 or 8 bf16 values.
__device__ __forceinline__ void load16(const int8_t* p, float* out) {
  const int4 w = *reinterpret_cast<const int4*>(p);
  const int8_t* e = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
  for (int u = 0; u < 16; ++u) out[u] = (float)e[u];
}

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  out[0] = w.x;
  out[1] = w.y;
  out[2] = w.z;
  out[3] = w.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 f = __bfloat1622float2(e[u]);
    out[2 * u] = f.x;
    out[2 * u + 1] = f.y;
  }
}

// The dot of two shared-memory rows of DP values: unrolled up to 128, in
// unrolled runs of 64 beyond (a shorter build, the same sums).
template <int DP>
__device__ __forceinline__ float row_dot(const float* a, const float* b) {
  constexpr int RUN = DP <= 128 ? DP : 64;
  float dot = 0.f;
#pragma unroll 1
  for (int d0 = 0; d0 < DP; d0 += RUN) {
#pragma unroll
    for (int d = 0; d < RUN; ++d) dot += a[d0 + d] * b[d0 + d];
  }
  return dot;
}

constexpr int FOLD_WARPS = 4;

// The most query rows one fold block holds at a head-dim instance: its
// shared memory (q and the warps' partial outputs) stays at 40 KB, under
// the 48 KB of static shared memory, and each lane keeps 64 accumulators.
template <int DP>
struct FoldRows {
  static constexpr int value = DP <= 128 ? 16 : (DP == 256 ? 8 : 4);
};

// One 16-byte chunk c of key row ``krow`` (elements [c * CW, c * CW + CW),
// CW = 16 bytes of T) dotted with every query row held in q_s, into sc:
// a 16-byte load when ``vec``, else one element at a time up to the row's
// end. int4 chunk c holds bytes [16c, 16c + 16): dims 16c + u (low nibbles)
// and D/2 + 16c + u (high nibbles); a byte past the row reads as 0x88,
// codes 0 and 0.
template <int DP, typename T, int MAXR>
__device__ __forceinline__ void fold_chunk(const float (*q_s)[DP], const T* krow, int c, int R,
                                           int D, bool vec, float (&sc)[MAXR]) {
  constexpr int VEC = KvRow<T>::VEC;
  if constexpr (KvRow<T>::U4) {
    const int half = D / 2;
    uint8_t by[16];
    if (vec) {
      const uint4 w = *reinterpret_cast<const uint4*>(krow + 16 * c);
      const uint8_t* e = reinterpret_cast<const uint8_t*>(&w);
#pragma unroll
      for (int u = 0; u < 16; ++u) by[u] = e[u];
    } else {
#pragma unroll
      for (int u = 0; u < 16; ++u) by[u] = 16 * c + u < half ? krow[16 * c + u] : 0x88;
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const float lo = (float)((by[u] & 15) - INT4_BIAS);
      const float hi = (float)((by[u] >> 4) - INT4_BIAS);
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < R) sc[r] += q_s[r][16 * c + u] * lo + q_s[r][half + 16 * c + u] * hi;
      }
    }
  } else {
    float kv[VEC];
    if (vec) {
      load16(krow + c * VEC, kv);
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u) kv[u] = c * VEC + u < D ? to_f32(krow[c * VEC + u]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < R) {
#pragma unroll
        for (int u = 0; u < VEC; ++u) sc[r] += q_s[r][c * VEC + u] * kv[u];
      }
    }
  }
}

// The dot of key row ``krow`` with every query row held in q_s, into sc.
// UNROLL: a 16-byte aligned row as wide as the instance (D == DP) is read
// by unrolled, unguarded 16-byte loads, all issued before their products
// (the cache's rows up to D 128); otherwise (a masked tail, wider rows,
// unaligned rows, the recent window) one chunk's code runs in a loop, which
// keeps the build short and the registers few.
template <int DP, typename T, int MAXR, bool UNROLL>
__device__ __forceinline__ void fold_scores(const float (*q_s)[DP], const T* krow, int R,
                                            int D, bool vec, float (&sc)[MAXR]) {
  // Chunks of 16 bytes in a row of DP values, and the row's elements.
  constexpr int NCH = KvRow<T>::U4 ? DP / 32 : DP / KvRow<T>::VEC;
  constexpr int CW = KvRow<T>::U4 ? 16 : KvRow<T>::VEC;
  const int row = KvRow<T>::U4 ? D / 2 : D;
  if (UNROLL && vec && row == NCH * CW) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) fold_chunk<DP, T, MAXR>(q_s, krow, c, R, D, true, sc);
  } else {
#pragma unroll 1
    for (int c = 0; c * CW < row; ++c) fold_chunk<DP, T, MAXR>(q_s, krow, c, R, D, vec, sc);
  }
}

// One warp's 32-key tile: keys j0 + lane (live when j0 + lane is within the
// range), scored against the R query rows, merged into the warp's online
// softmax state (m, l, acc). kb/vb: the (slot, kv head)'s K/V rows of type
// T; roff: this lane's key's row offset (PAGED) — otherwise key u's row is
// (j0 + u) * sj; ks/vs: the scales (QUANT rows), soff this lane's; causal:
// mask column j per row (j <= qpos, the window), else every live key counts
// for every row.
template <int DP, typename T, int MAXR, bool PAGED, bool UNROLL>
__device__ __forceinline__ void fold_tile(
    const float (*q_s)[DP], int R, int S, int D, bool vec, const T* kb, const T* vb,
    long long roff, long long sj, int j0, int nk, const float* ks, const float* vs,
    long long soff, bool causal, int len, int window, float scale, int lane,
    float (&m)[MAXR], float (&l)[MAXR], float (&acc)[MAXR][DP / 32]) {
  constexpr bool QUANT = KvRow<T>::QUANT;
  constexpr int DPL = DP / 32;  // output dims per lane
  // V keys whose loads are in flight together (fewer when the
  // accumulators already take most of the registers).
  constexpr int VB = MAXR * DPL >= 64 ? 4 : 8;
  const int j = j0 + lane;
  const bool live = lane < nk;
  const long long koff = PAGED ? roff : (long long)j * sj;
  float sc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) sc[r] = 0.f;
  float vsc = 1.f;
  if (live) {
    fold_scores<DP, T, MAXR, UNROLL>(q_s, kb + koff, R, D, vec, sc);
    if constexpr (QUANT) {
      const float ksc = ks[soff];
      vsc = vs[soff];
#pragma unroll
      for (int r = 0; r < MAXR; ++r) sc[r] = sc[r] * scale * ksc;
    } else {
#pragma unroll
      for (int r = 0; r < MAXR; ++r) sc[r] *= scale;
    }
  }
  // Online softmax per row (R is uniform, so every lane takes the same
  // branches and the shuffles stay converged).
  float pv[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    pv[r] = 0.f;
    if (r < R) {
      const int qpos = len + r % S;
      const bool ok = live && (!causal || (j <= qpos && (window <= 0 || j > qpos - window)));
      const float s = ok ? sc[r] : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(s));
      if (m_new != -INFINITY) {
        const float alpha = expf(m[r] - m_new);  // 0 while m[r] is -inf
        const float p = ok ? expf(s - m_new) : 0.f;
        l[r] = l[r] * alpha + warp_sum(p);
        m[r] = m_new;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
        pv[r] = p * vsc;
      }
    }
  }
  // P.V: lane owns output dims lane + 32 i of every row. The V values of
  // VB keys are loaded before any is used, so their global-memory
  // latencies overlap instead of adding up key by key.
  const int half = D / 2;
  for (int u0 = 0; u0 < nk; u0 += VB) {
    float vv[VB][DPL];
#pragma unroll
    for (int uu = 0; uu < VB; ++uu) {
      long long voff;
      if constexpr (PAGED) {
        voff = __shfl_sync(FULL, roff, (u0 + uu) & 31);
      } else {
        voff = (long long)(j0 + u0 + uu) * sj;
      }
      const T* vrow = vb + voff;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        vv[uu][i] = u0 + uu < nk && d < D ? row_elem(vrow, d, half) : 0.f;
      }
    }
#pragma unroll
    for (int uu = 0; uu < VB; ++uu) {
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < R) {
          // pv is 0 on lanes past nk, and so is vv.
          const float pt = __shfl_sync(FULL, pv[r], u0 + uu);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] += pt * vv[uu][i];
        }
      }
    }
  }
}

// The recent window of deferred KV (flat folds only): W rows of type f32
// (wbf16 == 0) or bf16, strides r_sb, r_sh, r_sj; t the step (device
// memory); kn/vn the new row (f32, strides n_sb, n_sh) or null; wvec:
// 16-byte loads of its rows.
struct RecentWindow {
  void* rk;
  void* rv;
  long long r_sb, r_sh, r_sj;
  int W, wbf16, wvec;
  const int32_t* t;
  const float* kn;
  const float* vn;
  long long n_sb, n_sh;
};

template <typename TW>
__device__ __forceinline__ void write_new_row(const RecentWindow& rw, int b, int hk, int D,
                                              int tw, int tid) {
  TW* rk = reinterpret_cast<TW*>(rw.rk) + b * rw.r_sb + hk * rw.r_sh + tw * rw.r_sj;
  TW* rv = reinterpret_cast<TW*>(rw.rv) + b * rw.r_sb + hk * rw.r_sh + tw * rw.r_sj;
  const float* kn = rw.kn + b * rw.n_sb + hk * rw.n_sh;
  const float* vn = rw.vn + b * rw.n_sb + hk * rw.n_sh;
  for (int d = tid; d < D; d += FOLD_WARPS * 32) {
    rk[d] = from_f32<TW>(kn[d]);
    rv[d] = from_f32<TW>(vn[d]);
  }
}

// WIN: the instance reads the recent window (flat folds of deferred KV;
// others never pay for its code and registers). EXACT: D == DP, known at
// compile time (the masked tail and its bounds fold away).
template <int DP, typename T, int MAXR, bool PAGED, bool WIN, bool EXACT>
__global__ void __launch_bounds__(FOLD_WARPS * 32) decode_mha_fold_kernel(
    const float* __restrict__ q, long long q_sb, long long q_sh, long long q_ss,
    const T* __restrict__ kc, const T* __restrict__ vc,
    long long kv_sb, long long kv_sh, long long kv_sj,
    const float* __restrict__ ks, const float* __restrict__ vs,
    long long sc_sb, long long sc_sh, long long sc_sj,
    const int32_t* __restrict__ bt, int MB, int BS,
    const int32_t* __restrict__ lens, float* __restrict__ out,
    long long o_sb, long long o_sh, long long o_ss,
    int H, int Hkv, int S, int D, int cap, int window, float scale, int vec,
    RecentWindow rw) {
  static_assert(!(PAGED && WIN), "the recent window exists in flat folds only");
  constexpr bool QUANT = KvRow<T>::QUANT;
  constexpr int DPL = DP / 32;
  if constexpr (EXACT) D = DP;
  __shared__ float q_s[MAXR][DP];
  __shared__ float part_m[FOLD_WARPS][MAXR], part_l[FOLD_WARPS][MAXR];
  __shared__ float part_acc[FOLD_WARPS][MAXR][DP];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x, hk = blockIdx.y;
  const int group = H / Hkv;
  const int R = group * S;  // row r = g * S + s: head hk * group + g, position lens[b] + s
  const int len = lens[b];
  const bool deferred = WIN && rw.W > 0;
  // The slot's last live column: for deferred KV the last committed row.
  const int hi = deferred ? min(len - 1, cap - 1) : min(len + S - 1, cap - 1);
  const int lo = window > 0 && !deferred ? max(0, len - window + 1) : 0;
  const long long slot_kv = PAGED ? 0 : b * kv_sb;
  const T* kb = kc + slot_kv + hk * kv_sh;
  const T* vb = vc + slot_kv + hk * kv_sh;
  const long long sc_base = (PAGED ? 0 : b * sc_sb) + hk * sc_sh;
  const float* ksb = QUANT ? ks + sc_base : nullptr;
  const float* vsb = QUANT ? vs + sc_base : nullptr;

  int t = 0;
  if constexpr (WIN) {
    if (deferred) {
      t = *rw.t;
      if (rw.kn != nullptr) {
        const int tw = min(max(t, 0), rw.W - 1);  // clamped like dynamic_update_slice
        if (rw.wbf16) write_new_row<__nv_bfloat16>(rw, b, hk, D, tw, tid);
        else write_new_row<float>(rw, b, hk, D, tw, tid);
      }
    }
  }
  for (int idx = tid; idx < MAXR * DP; idx += FOLD_WARPS * 32) {
    const int r = idx / DP, d = idx % DP;
    float x = 0.f;
    if (r < R && d < D) {
      const int g = r / S, s = r % S;
      x = q[b * q_sb + (long long)(hk * group + g) * q_sh + s * q_ss + d];
    }
    q_s[r][d] = x;
  }
  __syncthreads();  // q in shared memory; the new window row written

  float m[MAXR], l[MAXR], acc[MAXR][DPL];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  const int ntiles = hi >= lo ? (hi - lo) / 32 + 1 : 0;
  // Window rows 0..wlast are valid for every query row.
  const int wlast = deferred ? min(t, rw.W - 1) : -1;
  const int nwt = wlast >= 0 ? wlast / 32 + 1 : 0;
  for (int tt = warp; tt < ntiles + nwt; tt += FOLD_WARPS) {
    if (tt < ntiles) {
      const int j0 = lo + 32 * tt;
      const int j = j0 + lane;
      const int nk = min(32, hi - j0 + 1);
      // This lane's key: its row offset in kc/vc and its scale's in ks/vs.
      long long roff = 0, soff = 0;
      if (j <= hi) {
        if constexpr (PAGED) {
          const long long blk = bt[(long long)b * MB + j / BS];
          const int r = j % BS;
          roff = blk * kv_sb + r * kv_sj;
          soff = blk * sc_sb + r * sc_sj;
        } else {
          soff = j * sc_sj;
        }
      }
      fold_tile<DP, T, MAXR, PAGED, (DP <= 128)>(q_s, R, S, D, vec != 0, kb, vb, roff, kv_sj,
                                                 j0, nk,
                                    ksb, vsb, soff, !deferred, len, window, scale, lane,
                                    m, l, acc);
    } else if constexpr (WIN) {
      // A tile of the recent window (rows as the window holds them; no
      // scales).
      const int j0 = 32 * (tt - ntiles);
      const int nk = min(32, wlast - j0 + 1);
      const long long off = b * rw.r_sb + hk * rw.r_sh;
      if (rw.wbf16) {
        const __nv_bfloat16* w_k = reinterpret_cast<const __nv_bfloat16*>(rw.rk) + off;
        const __nv_bfloat16* w_v = reinterpret_cast<const __nv_bfloat16*>(rw.rv) + off;
        fold_tile<DP, __nv_bfloat16, MAXR, false, false>(q_s, R, S, D, rw.wvec != 0, w_k, w_v, 0, rw.r_sj,
                                                  j0, nk, nullptr, nullptr, 0, false, len, 0,
                                                  scale, lane, m, l, acc);
      } else {
        const float* w_k = reinterpret_cast<const float*>(rw.rk) + off;
        const float* w_v = reinterpret_cast<const float*>(rw.rv) + off;
        fold_tile<DP, float, MAXR, false, false>(q_s, R, S, D, rw.wvec != 0, w_k, w_v, 0, rw.r_sj, j0, nk,
                                          nullptr, nullptr, 0, false, len, 0, scale, lane,
                                          m, l, acc);
      }
    }
  }

  // Merge the warps' partial states.
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r < R) {
      if (lane == 0) {
        part_m[warp][r] = m[r];
        part_l[warp][r] = l[r];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) part_acc[warp][r][lane + 32 * i] = acc[r][i];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < R * D; idx += FOLD_WARPS * 32) {
    const int r = idx / D, d = idx % D;
    float mx = part_m[0][r];
#pragma unroll
    for (int w = 1; w < FOLD_WARPS; ++w) mx = fmaxf(mx, part_m[w][r]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < FOLD_WARPS; ++w) {
      const float c = part_m[w][r] == -INFINITY ? 0.f : expf(part_m[w][r] - mx);
      lsum += part_l[w][r] * c;
      o += part_acc[w][r][d] * c;
    }
    const int g = r / S, s = r % S;
    out[b * o_sb + (long long)(hk * group + g) * o_sh + s * o_ss + d] =
        lsum > 0.f ? o / lsum : 0.f;
  }
}

}  // namespace

// The paged form's C entry point (paged_decode_mha.cu and
// paged_decode_mha_bf16.cu): q [B, H, 1, D] f32 against pools read through
// the table bt [B, MB] with the strides given, out [B, 1, H*D] at strides
// (o_sb, o_sh); cap = MB * BS; group H / Hkv up to FoldRows (16 at D <= 128,
// 8 at D <= 256, 4 at D <= 512); any even D up to 512; vec: 16-byte K loads.
#define RTEN_PAGED_PARAMS                                                        \
  const void *q, long long q_sb, long long q_sh, const void *k, const void *v,   \
      long long kv_sb, long long kv_sh, long long kv_sj, const void *ks,         \
      const void *vs, long long sc_sb, long long sc_sh, long long sc_sj,         \
      const void *bt, int MB, int BS, const void *lens, void *out,               \
      long long o_sb, long long o_sh, int B, int H, int Hkv, int D, int window,  \
      float scale, int vec, void *stream
#define RTEN_PAGED_NAMES                                                         \
  q, q_sb, q_sh, k, v, kv_sb, kv_sh, kv_sj, ks, vs, sc_sb, sc_sh, sc_sj, bt, MB, \
      BS, lens, out, o_sb, o_sh, B, H, Hkv, D, window, scale, vec, stream

template <typename T, int DP, int RR, bool EXACT>
void launch_paged_fold(RTEN_PAGED_PARAMS) {
  const dim3 grid(B, Hkv);
  decode_mha_fold_kernel<DP, T, RR, true, false, EXACT>
      <<<grid, FOLD_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)q, q_sb, q_sh, 0, (const T*)k, (const T*)v, kv_sb, kv_sh, kv_sj,
      (const float*)ks, (const float*)vs, sc_sb, sc_sh, sc_sj, (const int32_t*)bt, MB, BS,
      (const int32_t*)lens, (float*)out, o_sb, o_sh, 0, H, Hkv, 1, D, MB * BS, window, scale,
      vec, RecentWindow{});
}

// Instances: D 64 and 128 exactly (EXACT), any other even D up to 128 in
// the masked DP 128 instance, then DP 256 and 512.
template <typename T>
int launch_paged_decode_mha(RTEN_PAGED_PARAMS) {
  const int rows = H / Hkv, dp = rten_dp_of(D);
  if (rows < 1 || dp == 0 || MB < 1 || BS < 1) return (int)cudaErrorInvalidValue;
  if (rows > FoldRows<256>::value && dp == 256) return (int)cudaErrorInvalidValue;
  if (rows > FoldRows<512>::value && dp == 512) return (int)cudaErrorInvalidValue;
  if (rows > 16) return (int)cudaErrorInvalidValue;
#define RTEN_PAGED_ROWS(DD, EX)                                                    if (rows <= 8) launch_paged_fold<T, DD, 8, EX>(RTEN_PAGED_NAMES);                else launch_paged_fold<T, DD, 16, EX>(RTEN_PAGED_NAMES)
  if (D == 64) {
    RTEN_PAGED_ROWS(64, true);
  } else if (D == 128) {
    RTEN_PAGED_ROWS(128, true);
  } else if (dp <= 128) {
    RTEN_PAGED_ROWS(128, false);
  } else if (dp == 256) {
    launch_paged_fold<T, 256, 8, false>(RTEN_PAGED_NAMES);
  } else {
    launch_paged_fold<T, 512, 4, false>(RTEN_PAGED_NAMES);
  }
#undef RTEN_PAGED_ROWS
  return (int)cudaGetLastError();
}
