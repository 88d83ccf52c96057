// The fold form of decode attention on CUDA cores, shared by
// decode_mha{,_f32,_bf16,_u4_win,_wide}.cu (slot-major caches: f32 caches,
// f32 recent windows and D 129-512; decode_fold_tc.cuh holds the others),
// paged_decode_mha{,_f32,_bf16}.cu (block pools read through a
// block table, head-major or, for the block-table append, cat-layout rows
// of Hkv * D) and decode_append{,_f32,_bf16}.cu (the flat append of a
// decode step's row, cat or head-major caches).
//
// A 128-thread block holds the group * S query rows that share a kv head
// in shared memory and reads each K/V row once for all of them. Its four
// warps split the 32-key tiles of its columns and stop at the slot's last
// live one; where a split block has fewer live tiles than warps, the warps
// of a tile take disjoint runs of the query rows instead (each reads the
// tile's rows, L2 serving the repeats). A tile's K and V rows stream into
// the warp's shared-memory stage with cp.async (V still in flight while K
// is scored); a lane scores one key against every row of its warp from
// the stage, the warp reduces every row's tile max and sum with shuffles
// interleaved across the rows, and each lane accumulates DP / 32 output
// dims of P.V for every row, the probabilities read back from shared
// memory. The warps' online-softmax states merge in shared memory (a
// block whose warps hold whole rows writes them directly).
//
// Split-K (every instance): the grid is
// (slots, kv heads, splits) and block z takes the columns [z * chunk,
// (z + 1) * chunk) of the slot's range (kernels/flash_attention.py,
// decode_split_plan, sizes chunk from the shapes alone so that the card's
// SMs all get a block). A block whose chunk holds no live column reads
// nothing. With one split the block writes the output. With more, each
// block writes its rows' states (m, l, acc[D]) to the workspace ws, bumps
// its (slot, kv head)'s counter after a barrier (one acquire-release atomic
// by thread 0), and the block
// that arrives last merges the states in split order, writes the output
// and resets the counter: the result does not depend on which block ends
// last, so two calls give the same bits.
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
// (EXACT), which leave the masked tail's code out. K and V rows stream by
// 16-byte cp.async when every row starts 16-byte aligned and its length
// is a multiple of 16 bytes (``vec``); otherwise one element at a time.
//
// The append (APPEND instances, S == 1): the block whose chunk holds the
// write row wpos = min(max(lens[b], 0), cap - 1) quantizes (s8: scale
// max(absmax / 127, 1e-8), round half to even) or rounds (f32/bf16) the
// step's new K/V row of its kv head, writes it and its scale there, and
// reads it back after a barrier like any other row: it is the only block
// that reads or writes that row. Groups larger than FoldRows run in passes
// of FoldRows query rows, each re-reading the block's columns.
//
// Deferred KV (the recent window, W > 0; flat folds only): the big cache
// holds the rows committed before this dispatch, valid strictly below
// lens[b] (here lens is the dispatch's lens0), and the window rw [B, Hkv, W,
// D] (f32 or bf16, the same strides as a cache) holds the rows of the
// dispatch's steps so far, row r valid when r <= t for every slot (t = the
// step, from device memory). Every query row attends the same columns. With
// the new row (kn/vn [B, Hkv, 1, D] f32), the block first writes it, rounded
// to the window's type, into window row min(max(t, 0), W - 1) of its own
// (slot, kv head) and then scores it as the window holds it (read back after
// a barrier; no other block reads that row). The window's tiles follow the
// cache's in the warps' round robin, in the last split only: its block alone
// writes the new row and scores the window.
//
// Addressing (all strides in elements; bytes for int4 rows):
// * PAGED = false: row j of slot b, kv head hk at kc + b * kv_sb + hk * kv_sh
//   + j * kv_sj, its scale at ks[b * sc_sb + hk * sc_sh + j * sc_sj].
// * PAGED = true: the pools hold blocks of BS rows and slot b's position j
//   lives in block blk = bt[b * MB + j / BS], row r = j % BS: the K row at
//   kc + blk * kv_sb + hk * kv_sh + r * kv_sj, its scale at
//   ks[blk * sc_sb + hk * sc_sh + r * sc_sj]; cap = MB * BS. Each lane
//   resolves the table entry of its own key (the first tile's ahead of
//   lens), the stage copy takes key u's row offset from lane u by a
//   shuffle, and no pool row past the slot's last live column is read
//   (its table entry may be 0, the garbage sink).
// Built without --use_fast_math (IEEE expf and division, rintf).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <cuda/atomic>
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
// of 32, 64, 128, 256 that holds it; 0 for an odd D or a larger one.
static inline int rten_cat_dp_of(int D, int max_dp) {
  if (D < 2 || D % 2 || D > max_dp) return 0;
  return D <= 32 ? 32 : rten_dp_of(D);
}

// Expands M(DP, T) for the instance of head dim D (32, 64, 128, 256); any
// other D returns cudaErrorInvalidValue.
#define RTEN_BY_DP256(TT, M)                                                     \
  switch (rten_cat_dp_of(D, 256)) {                                              \
    case 32: M(32, TT); break;                                                   \
    case 64: M(64, TT); break;                                                   \
    case 128: M(128, TT); break;                                                 \
    case 256: M(256, TT); break;                                                 \
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

// The dot of key row ``krow`` (staged in shared memory) with every query
// row held in q_s, into sc: one 16-byte chunk's code in a short loop, which
// keeps the code small and the registers few.
template <int DP, typename T, int MAXR>
__device__ __forceinline__ void fold_scores(const float (*q_s)[DP], const T* krow, int R,
                                            int D, bool vec, float (&sc)[MAXR]) {
  constexpr int CW = KvRow<T>::U4 ? 16 : KvRow<T>::VEC;  // a chunk's elements
  const int row = KvRow<T>::U4 ? D / 2 : D;
#pragma unroll 2
  for (int c = 0; c * CW < row; ++c) fold_chunk<DP, T, MAXR>(q_s, krow, c, R, D, vec, sc);
}

// --- the stage ------------------------------------------------------------------

// Bytes of shared memory a warp stages K and V rows in: 32 bf16 rows of
// D 128 each (the K rows padded by 16 bytes); wider rows go in batches.
constexpr int FOLD_STAGE_BUDGET = 32 * (2 * 256 + 16);

// Bytes of a staged row at instance DP (an int4 row packs two dims a byte).
template <int DP, typename T>
struct StageRow {
  static constexpr int BYTES = KvRow<T>::U4 ? DP / 2 : DP * (int)sizeof(T);
};

// A warp's K and V stage for rows of T: K rows at a stride of BYTES + 16
// (so that the lanes' 16-byte reads of their own rows fall in distinct
// banks), then V rows, KEYS keys of each at once.
template <int DP, typename T, int SB>
struct Stage {
  static constexpr int RB = StageRow<DP, T>::BYTES;
  static constexpr int RBK = RB + 16;
  static constexpr int KEYS = SB / (RB + RBK) < 32 ? SB / (RB + RBK) : 32;
  static_assert(KEYS >= 1, "the stage holds a key");
};

// The fold kernel's shared memory beyond its fixed arrays: the warps'
// stages, each followed by its tile's probabilities p * vs [MAXR][32],
// which the block's partial outputs overlay after the tiles.
template <int DP, typename T, int MAXR, bool WIN>
struct FoldSmem {
  static constexpr int RB_T = StageRow<DP, T>::BYTES;
  // The widest row a tile stages: the cache's, or a bf16 recent window's
  // (an f32 window goes in batches).
  static constexpr int RB = WIN && DP * 2 > RB_T ? DP * 2 : RB_T;
  static constexpr int FULL = 32 * (2 * RB + 16);
  static constexpr int SB = FULL < FOLD_STAGE_BUDGET ? FULL : FOLD_STAGE_BUDGET;  // a warp's stage
  static constexpr int WARP = SB + MAXR * 32 * (int)sizeof(float);  // and its tile's p
  static constexpr int ACC = FOLD_WARPS * MAXR * DP * (int)sizeof(float);
  static constexpr int POOL = ACC > FOLD_WARPS * WARP ? ACC : FOLD_WARPS * WARP;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Streams the rows of a tile's keys [u0, u0 + n) (n <= VK <= 32) into
// dst, key u0 + u at dst + u * STRIDE: 16-byte cp.async when ``vec`` (the
// caller commits and waits), else element by element. Key u's row is src
// + the row offset of lane u (PAGED) or src + (j0 + u) * sj.
template <int DP, typename T, bool PAGED, int VK, int STRIDE>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const T* src, long long roff,
                                           long long sj, int j0, int u0, int n, int D,
                                           bool vec, int lane) {
  constexpr int RB = StageRow<DP, T>::BYTES;
  constexpr int CPR = RB / 16;  // 16-byte chunks of a row as wide as the instance
  const int row = KvRow<T>::U4 ? D / 2 : D * (int)sizeof(T);  // bytes a row holds
  __syncwarp();  // every lane is done with the stage's last contents
  if (vec && row == RB) {
    // Chunk k * 32 + lane is key (k * 32 + lane) / CPR, piece % CPR.
#pragma unroll
    for (int k = 0; k < (VK * CPR + 31) / 32; ++k) {
      const int c = k * 32 + lane;
      const int u = c / CPR, e = c % CPR;
      long long off;
      if constexpr (PAGED) {
        off = __shfl_sync(FULL, roff, (u0 + u) & 31);
      } else {
        off = (long long)(j0 + u0 + u) * sj;
      }
      if (u < n) {
        cp_async16(dst + u * STRIDE + 16 * e,
                   reinterpret_cast<const unsigned char*>(src + off) + 16 * e);
      }
    }
  } else {
    // A masked tail or unaligned rows: key by key, a lane a piece.
    const int pieces = vec ? row / 16 : (KvRow<T>::U4 ? row : D);
    for (int u = 0; u < n; ++u) {
      long long off;
      if constexpr (PAGED) {
        off = __shfl_sync(FULL, roff, (u0 + u) & 31);
      } else {
        off = (long long)(j0 + u0 + u) * sj;
      }
      for (int e = lane; e < pieces; e += 32) {
        if (vec) {
          cp_async16(dst + u * STRIDE + 16 * e,
                     reinterpret_cast<const unsigned char*>(src + off) + 16 * e);
        } else {
          reinterpret_cast<T*>(dst + u * STRIDE)[e] = src[off + e];
        }
      }
    }
  }
}

// One warp's 32-key tile: keys j0 + lane (live when lane < nk), scored
// against the warp's R query rows, merged into its online-softmax state
// (m, l, acc). kb/vb: the (slot, kv head)'s K/V rows of type T; roff: this
// lane's key's row offset (PAGED), otherwise key u's row is (j0 + u) * sj;
// ks/vs: the scales (QUANT rows), soff this lane's; causal: mask column j
// per row (j <= qpos, the window; row r of the warp is the block's row0 + r,
// at position len + (row0 + r) % S), else every live key counts for every
// row; stage: the warp's SB bytes of shared memory; p_s: its [MAXR][32]
// floats for the tile's p * vs, which P.V reads back (a shared-memory
// broadcast, not a shuffle: the rows' guards then hold no convergent
// instruction, whose reconvergence cost more than the products).
//
// The tile's K and V rows stream into the stage together (two cp.async
// groups; K first, so the scores start when K has landed while V is still
// in flight); each lane then scores its own key from the stage in a short
// loop over its row's 16-byte chunks, and P.V reads V from the stage. Rows
// too wide for 32 keys of both in the stage go in batches of KEYS keys, K
// then (after the softmax) V. Short loops keep the code that a tile runs
// small: the instruction fetch of long unrolled bodies, not the
// arithmetic, bounded the first split kernels.
template <int DP, typename T, int MAXR, bool PAGED, int SB>
__device__ __forceinline__ void fold_tile(
    const float (*q_s)[DP], int R, int S, int D, bool vec, const T* kb, const T* vb,
    long long roff, long long sj, int j0, int nk, const float* ks, const float* vs,
    long long soff, bool causal, int len, int row0, int window, float scale, int lane,
    unsigned char* stage, float* p_s, float (&m)[MAXR], float (&l)[MAXR],
    float (&acc)[MAXR][DP / 32]) {
  constexpr bool QUANT = KvRow<T>::QUANT;
  constexpr int DPL = DP / 32;  // output dims per lane
  using St = Stage<DP, T, SB>;
  constexpr int VK = St::KEYS;
  unsigned char* kst = stage;
  unsigned char* vst = stage + VK * St::RBK;
  const int j = j0 + lane;
  const bool live = lane < nk;
  float ksc = 1.f, vsc = 1.f;
  if (QUANT && live) {
    ksc = ks[soff];
    vsc = vs[soff];
  }
  float sc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) sc[r] = 0.f;
  for (int u0 = 0; u0 < nk; u0 += VK) {
    const int n = min(VK, nk - u0);
    stage_rows<DP, T, PAGED, VK, St::RBK>(kst, kb, roff, sj, j0, u0, n, D, vec, lane);
    cp_async_commit();
    if (VK == 32) {  // one batch: V streams in behind K
      stage_rows<DP, T, PAGED, VK, St::RB>(vst, vb, roff, sj, j0, 0, n, D, vec, lane);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    if (live && lane >= u0 && lane < u0 + n) {
      const T* krow = reinterpret_cast<const T*>(kst + (lane - u0) * St::RBK);
      fold_scores<DP, T, MAXR>(q_s, krow, R, D, vec, sc);
    }
  }
#pragma unroll
  for (int r = 0; r < MAXR; ++r) sc[r] = QUANT ? sc[r] * scale * ksc : sc[r] * scale;
  // Online softmax, the rows' shuffle reductions interleaved and taken for
  // every row of the instance (rows past R carry -inf and change nothing;
  // a guard around a shuffle costs more than the shuffle). sc becomes the
  // masked scores, then p * vsc; red the rows' maxima, then their sums.
  float red[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    const int qpos = len + (row0 + r) % S;
    const bool ok = r < R && live &&
                    (!causal || (j <= qpos && (window <= 0 || j > qpos - window)));
    sc[r] = ok ? sc[r] : -INFINITY;
    red[r] = sc[r];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < MAXR; ++r) red[r] = fmaxf(red[r], __shfl_xor_sync(FULL, red[r], off));
  }
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    const float m_new = fmaxf(m[r], red[r]);
    const float alpha = m_new == -INFINITY ? 1.f : expf(m[r] - m_new);  // 0 while m[r] is -inf
    const float p = sc[r] == -INFINITY ? 0.f : expf(sc[r] - m_new);
    l[r] *= alpha;
    m[r] = m_new;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
    sc[r] = p * vsc;
    red[r] = p;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < MAXR; ++r) red[r] += __shfl_xor_sync(FULL, red[r], off);
  }
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    l[r] += red[r];
    if (r < R) p_s[r * 32 + lane] = sc[r];
  }
  // P.V from the stage: lane owns output dims lane + 32 i of every row.
  const int half = D / 2;
  const T* vt = reinterpret_cast<const T*>(vst);
  for (int u0 = 0; u0 < nk; u0 += VK) {
    const int n = min(VK, nk - u0);
    if (VK < 32) {
      stage_rows<DP, T, PAGED, VK, St::RB>(vst, vb, roff, sj, j0, u0, n, D, vec, lane);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncwarp();  // the V rows and p_s are in shared memory
    // Past n the V values read as 0 (the stage there holds stale rows).
#pragma unroll 4
    for (int u = 0; u < VK; ++u) {
      const bool in = u < n;
      float vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        vv[i] = in && d < D ? row_elem(vt + u * (St::RB / (int)sizeof(T)), d, half) : 0.f;
      }
      const float* pu = p_s + ((u0 + u) & 31);
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < R) {
          const float pt = pu[r * 32];
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] += pt * vv[i];
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

// --- the append's new row -------------------------------------------------------

__device__ __forceinline__ int8_t quantize_s8(float x, float s) {
  return (int8_t)fminf(fmaxf(rintf(x / s), -127.f), 127.f);
}

// Slot b's new K and V rows of kv head hk, as the cache holds them: thread
// tid of a 128-thread block owns elements tid + 128 e (e < EPT) of kn/vn.
// s8: quantized with the scale max(absmax / 127, 1e-8) of the row (the
// block's max through red_s); f32/bf16: rounded to T. Returns the codes or
// rounded values (as floats) in kq/vq and the scales in ks_new/vs_new (1 for
// f32/bf16). Every thread of the block must call it.
template <int DP, typename T>
__device__ __forceinline__ void new_row(const float* kn, const float* vn, int D, int tid,
                                        float (&red_s)[2][FOLD_WARPS],
                                        float (&kq)[(DP + 127) / 128],
                                        float (&vq)[(DP + 127) / 128], float& ks_new,
                                        float& vs_new) {
  constexpr int EPT = (DP + 127) / 128;
  constexpr int THREADS = FOLD_WARPS * 32;
  float kx[EPT], vx[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int d = tid + THREADS * e;
    kx[e] = d < D ? kn[d] : 0.f;
    vx[e] = d < D ? vn[d] : 0.f;
  }
  if constexpr (std::is_same<T, int8_t>::value) {
    const int warp = tid / 32, lane = tid % 32;
    float kam = 0.f, vam = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      kam = fmaxf(kam, fabsf(kx[e]));
      vam = fmaxf(vam, fabsf(vx[e]));
    }
    kam = warp_max(kam);
    vam = warp_max(vam);
    if (lane == 0) {
      red_s[0][warp] = kam;
      red_s[1][warp] = vam;
    }
    __syncthreads();
    kam = red_s[0][0];
    vam = red_s[1][0];
#pragma unroll
    for (int w = 1; w < FOLD_WARPS; ++w) {
      kam = fmaxf(kam, red_s[0][w]);
      vam = fmaxf(vam, red_s[1][w]);
    }
    ks_new = fmaxf(kam / 127.0f, 1e-8f);
    vs_new = fmaxf(vam / 127.0f, 1e-8f);
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      kq[e] = (float)quantize_s8(kx[e], ks_new);
      vq[e] = (float)quantize_s8(vx[e], vs_new);
    }
  } else {
    ks_new = vs_new = 1.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      kq[e] = to_f32(from_f32<T>(kx[e]));
      vq[e] = to_f32(from_f32<T>(vx[e]));
    }
  }
}

// The float of a new-row value as the cache element T (exact: s8 codes and
// rounded values round-trip).
template <typename T>
__device__ __forceinline__ T as_elem(float x) {
  if constexpr (std::is_same<T, int8_t>::value) return (int8_t)x;
  else return from_f32<T>(x);
}

// --- the fold kernel -------------------------------------------------------------

// Split-K: splits = gridDim.z blocks per (slot, kv head),
// block z taking columns [z * chunk, (z + 1) * chunk). With splits > 1 the
// states of (slot b, kv head hk, block row r, split z), st = ((b * Hkv +
// hk) * R + r) * splits + z (R = group * S; with S == 1, (b * H + h) *
// splits + z), sit in ws: acc[D] at ws + st * D, then (m, l) at ws + B *
// Hkv * R * splits * D + 2 * st; count holds one arrival counter per
// (slot, kv head), 0 between calls. A deferred step's recent window
// belongs to the last split: that block alone writes the new row and
// scores the window's tiles.
struct SplitArgs {
  int chunk;
  float* ws;
  unsigned* count;
};

// The append (APPEND instances): the step's new rows kn/vn [B, Hkv, 1, D]
// f32 through strides, and the caches and scales it writes (the kernel's
// kc, vc, ks and vs, writable), addressed like the rows it reads.
struct AppendArgs {
  const float* kn;
  long long kn_sb, kn_sh;
  const float* vn;
  long long vn_sb, vn_sh;
  void* kc;
  void* vc;
  float* ks;
  float* vs;
};

// The last block's merge of RR rows (block rows r0, r0 + 1, ...; row r of
// head hg0 + r / S at position s = r % S, its states at index (u0 + r -
// r0) * splits + z), V dims a thread at a time: out = sum_z w[r][z] acc_z /
// lsum[r] in split order, the splits' acc read from L2 (every split's
// loads in flight together).
template <int V>
__device__ __forceinline__ void merge_dims(const float* ws, const float* w_s,
                                           const float* lsum_s, float* out, long long u0, int r0,
                                           int hg0, int S, int RR, int splits, int D,
                                           long long o_sh, long long o_ss, int tid) {
  using Vec = typename std::conditional<V == 4, float4, float2>::type;
  const int per = D / V;
  for (int idx = tid; idx < RR * per; idx += FOLD_WARPS * 32) {
    const int r = idx / per, d = V * (idx % per);
    const float* a = ws + (u0 + r) * splits * D + d;
    float o[V];
#pragma unroll
    for (int x = 0; x < V; ++x) o[x] = 0.f;
#pragma unroll 8
    for (int z = 0; z < splits; ++z) {
      const float c = w_s[r * splits + z];
      const Vec v = __ldcg(reinterpret_cast<const Vec*>(a + (long long)z * D));
      const float* vf = reinterpret_cast<const float*>(&v);
#pragma unroll
      for (int x = 0; x < V; ++x) o[x] += c * vf[x];
    }
    const float lsum = lsum_s[r];
    float* dst = out + (long long)(hg0 + (r0 + r) / S) * o_sh + (long long)((r0 + r) % S) * o_ss + d;
#pragma unroll
    for (int x = 0; x < V; ++x) dst[x] = lsum > 0.f ? o[x] / lsum : 0.f;
  }
}

// WIN: the instance reads the recent window (flat folds of deferred KV;
// others never pay for its code and registers; with few accumulators it
// keeps to 128 registers, so that GPT-2's 1440 blocks fill the card four a
// SM). EXACT: D == DP, known at
// compile time (the masked tail and its bounds fold away). APPEND: the
// block writes the step's row first (S == 1, flat caches). Every instance
// splits the key range over gridDim.z blocks.
template <int DP, typename T, int MAXR, bool PAGED, bool WIN, bool EXACT, bool APPEND = false>
__global__ void __launch_bounds__(FOLD_WARPS * 32, WIN && MAXR * DP <= 256 ? 4 : 1)
    decode_mha_fold_kernel(
    const float* __restrict__ q, long long q_sb, long long q_sh, long long q_ss,
    const T* __restrict__ kc, const T* __restrict__ vc,
    long long kv_sb, long long kv_sh, long long kv_sj,
    const float* __restrict__ ks, const float* __restrict__ vs,
    long long sc_sb, long long sc_sh, long long sc_sj,
    const int32_t* __restrict__ bt, int MB, int BS,
    const int32_t* __restrict__ lens, float* __restrict__ out,
    long long o_sb, long long o_sh, long long o_ss,
    int H, int Hkv, int S, int D, int cap, int window, float scale, int vec,
    RecentWindow rw, SplitArgs sp, AppendArgs ap) {
  static_assert(!(PAGED && WIN), "the recent window exists in flat folds only");
  static_assert(!APPEND || (!PAGED && !WIN), "the append is a flat fold");
  constexpr bool QUANT = KvRow<T>::QUANT;
  constexpr int DPL = DP / 32;
  constexpr int THREADS = FOLD_WARPS * 32;
  // The warps' stages and, after the tiles, their partial outputs share
  // the dynamic shared memory (FoldSmem::POOL bytes, the launch's).
  constexpr int SB = FoldSmem<DP, T, MAXR, WIN>::SB;
  constexpr int WARP_BYTES = FoldSmem<DP, T, MAXR, WIN>::WARP;
  if constexpr (EXACT) D = DP;
  __shared__ float q_s[MAXR][DP];
  __shared__ float part_m[FOLD_WARPS][MAXR], part_l[FOLD_WARPS][MAXR];
  extern __shared__ __align__(16) unsigned char pool[];
  __shared__ float red_s[2][FOLD_WARPS];
  __shared__ float wt_s[MAXR][FOLD_WARPS], row_s[MAXR][2];  // a pass's merge weights, (m, l)
  __shared__ bool last;
  float (*part_acc)[MAXR][DP] = reinterpret_cast<float (*)[MAXR][DP]>(pool);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  unsigned char* stage = pool + warp * WARP_BYTES;
  float* p_s = reinterpret_cast<float*>(stage + SB);
  const int b = blockIdx.x, hk = blockIdx.y;
  const int group = H / Hkv;
  const int R = group * S;  // row r = g * S + s: head hk * group + g, position lens[b] + s
  const int len = lens[b];
  const bool deferred = WIN && rw.W > 0;
  const int wpos = min(max(len, 0), cap - 1);  // the append's row, clamped as the reference
  // The slot's live columns: for deferred KV up to the last committed row.
  int hi = deferred ? min(len - 1, cap - 1) : min(len + S - 1, cap - 1);
  int lo = window > 0 && !deferred ? max(0, len - window + 1) : 0;
  const int splits = gridDim.z, split = blockIdx.z;
  const int c0 = split * sp.chunk;  // this block's first column
  lo = max(lo, c0);
  hi = min(hi, c0 + sp.chunk - 1);
  // The append writes row wpos and reads it back, so it reads the caches
  // through the pointers it writes (no read-only loads).
  const long long slot_kv = PAGED ? 0 : b * kv_sb;
  const T* kb = (APPEND ? static_cast<const T*>(ap.kc) : kc) + slot_kv + hk * kv_sh;
  const T* vb = (APPEND ? static_cast<const T*>(ap.vc) : vc) + slot_kv + hk * kv_sh;
  const long long sc_base = (PAGED ? 0 : b * sc_sb) + hk * sc_sh;
  const float* ksb = QUANT ? (APPEND ? ap.ks : ks) + sc_base : nullptr;
  const float* vsb = QUANT ? (APPEND ? ap.vs : vs) + sc_base : nullptr;

  int t = 0;
  const bool win_block = deferred && split == splits - 1;  // the window is the last split's
  if constexpr (WIN) {
    if (win_block) {
      t = *rw.t;
      if (rw.kn != nullptr) {
        const int tw = min(max(t, 0), rw.W - 1);  // clamped like dynamic_update_slice
        if (rw.wbf16) write_new_row<__nv_bfloat16>(rw, b, hk, D, tw, tid);
        else write_new_row<float>(rw, b, hk, D, tw, tid);
      }
    }
  }
  if constexpr (APPEND) {
    if (wpos >= c0 && wpos < c0 + sp.chunk) {  // the one block whose chunk holds wpos
      constexpr int EPT = (DP + 127) / 128;
      float kq[EPT], vq[EPT], ks_new, vs_new;
      new_row<DP, T>(ap.kn + b * ap.kn_sb + hk * ap.kn_sh, ap.vn + b * ap.vn_sb + hk * ap.vn_sh,
                     D, tid, red_s, kq, vq, ks_new, vs_new);
      T* kw = static_cast<T*>(ap.kc) + slot_kv + hk * kv_sh + wpos * kv_sj;
      T* vw = static_cast<T*>(ap.vc) + slot_kv + hk * kv_sh + wpos * kv_sj;
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const int d = tid + THREADS * e;
        if (d < D) {
          kw[d] = as_elem<T>(kq[e]);
          vw[d] = as_elem<T>(vq[e]);
        }
      }
      if (QUANT && tid == 0) {
        ap.ks[sc_base + wpos * sc_sj] = ks_new;
        ap.vs[sc_base + wpos * sc_sj] = vs_new;
      }
    }
  }

  // PAGED: the table entry of this lane's key in the warp's first tile of
  // the chunk, read without waiting for lens (its pool row is read only
  // once the key is known to be live).
  int blk0 = 0;
  const int j_first = c0 + 32 * warp + lane;
  if constexpr (PAGED) {
    if (j_first < cap && j_first < c0 + sp.chunk)
      blk0 = bt[(long long)b * MB + j_first / BS];
  }
  const int ntiles = hi >= lo ? (hi - lo) / 32 + 1 : 0;
  // Window rows 0..wlast are valid for every query row.
  const int wlast = win_block ? min(t, rw.W - 1) : -1;
  const int nwt = wlast >= 0 ? wlast / 32 + 1 : 0;
  // The warps' work: KW tile groups take the block's tiles in turn; with
  // fewer live tiles than warps, the RW = 4 / KW
  // warps of a tile group take disjoint runs of RPW query rows, so that
  // every warp works and none carries every row.
  const int live_tiles = ntiles + nwt;
  const int KW = live_tiles >= FOLD_WARPS ? FOLD_WARPS : live_tiles >= 2 ? 2 : 1;
  const int kw = warp % KW, rw_i = warp / KW;
  // Passes of MAXR query rows (more than one only for the append's large
  // groups, S == 1).
  for (int r0 = 0; r0 < R; r0 += MAXR) {
    const int RR = min(MAXR, R - r0);
    const int RW = min(FOLD_WARPS / KW, RR);      // row groups
    const int RPW = (RR + RW - 1) / RW;           // rows a group
    const int rbase = rw_i * RPW;                 // this warp's first row
    const int Rw = rw_i < RW ? max(0, min(RPW, RR - rbase)) : 0;
    if (r0 > 0) __syncthreads();  // the last pass's rows and partial outputs are consumed
    if (live_tiles > 0) {         // a block with no column reads nothing
      constexpr int QN = (MAXR * DP + THREADS - 1) / THREADS;
#pragma unroll
      for (int k = 0; k < QN; ++k) {
        const int idx = tid + k * THREADS;
        const int r = idx / DP, d = idx % DP;
        float x = 0.f;
        if (r < RR && d < D) {
          const int g = (r0 + r) / S, s = (r0 + r) % S;
          x = q[b * q_sb + (long long)(hk * group + g) * q_sh + s * q_ss + d];
        }
        if (idx < MAXR * DP) q_s[r][d] = x;
      }
    }
    __syncthreads();  // q in shared memory; the new window or append row written

    float m[MAXR], l[MAXR], acc[MAXR][DPL];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
    }
    const float (*qw)[DP] = q_s + rbase;  // this warp's rows
    for (int tt = Rw > 0 ? kw : live_tiles; tt < live_tiles; tt += KW) {
      if (tt < ntiles) {
        const int j0 = lo + 32 * tt;
        const int j = j0 + lane;
        const int nk = min(32, hi - j0 + 1);
        // This lane's key: its row offset in kc/vc and its scale's in ks/vs.
        long long roff = 0, soff = 0;
        if (j <= hi) {
          if constexpr (PAGED) {
            const long long blk = j == j_first ? blk0 : bt[(long long)b * MB + j / BS];
            const int r = j % BS;
            roff = blk * kv_sb + r * kv_sj;
            soff = blk * sc_sb + r * sc_sj;
          } else {
            soff = j * sc_sj;
          }
        }
        fold_tile<DP, T, MAXR, PAGED, SB>(qw, Rw, S, D, vec != 0, kb, vb, roff, kv_sj, j0, nk,
                                          ksb, vsb, soff, !deferred, len, r0 + rbase, window,
                                          scale, lane,
                                          stage, p_s, m, l, acc);
      } else if constexpr (WIN) {
        // A tile of the recent window (rows as the window holds them; no
        // scales).
        const int j0 = 32 * (tt - ntiles);
        const int nk = min(32, wlast - j0 + 1);
        const long long off = b * rw.r_sb + hk * rw.r_sh;
        if (rw.wbf16) {
          const __nv_bfloat16* w_k = reinterpret_cast<const __nv_bfloat16*>(rw.rk) + off;
          const __nv_bfloat16* w_v = reinterpret_cast<const __nv_bfloat16*>(rw.rv) + off;
          fold_tile<DP, __nv_bfloat16, MAXR, false, SB>(
              qw, Rw, S, D, rw.wvec != 0, w_k, w_v, 0, rw.r_sj, j0, nk, nullptr, nullptr, 0,
              false, len, r0 + rbase, 0, scale, lane, stage, p_s, m, l, acc);
        } else {
          const float* w_k = reinterpret_cast<const float*>(rw.rk) + off;
          const float* w_v = reinterpret_cast<const float*>(rw.rv) + off;
          fold_tile<DP, float, MAXR, false, SB>(
              qw, Rw, S, D, rw.wvec != 0, w_k, w_v, 0, rw.r_sj, j0, nk, nullptr, nullptr, 0,
              false, len, r0 + rbase, 0, scale, lane, stage, p_s, m, l, acc);
        }
      }
    }
    if (KW == 1) {
      // Each warp holds whole rows (uniform: KW is the block's): it writes
      // them, or their states, itself. The same numbers as the merge below,
      // whose weights are 1 for a single warp.
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < Rw) {
          const int g = (r0 + rbase + r) / S, s = (r0 + rbase + r) % S;
          const int h = hk * group + g;
          const long long st = (((long long)b * Hkv + hk) * R + r0 + rbase + r) * splits + split;
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int d = lane + 32 * i;
            if (d < D) {
              if (splits == 1) {
                out[b * o_sb + (long long)h * o_sh + s * o_ss + d] =
                    l[r] > 0.f ? acc[r][i] / l[r] : 0.f;
              } else {
                sp.ws[st * D + d] = acc[r][i];
              }
            }
          }
          if (splits > 1 && lane == 0) {
            float* ml = sp.ws + (long long)gridDim.x * Hkv * R * splits * D + 2 * st;
            ml[0] = m[r];
            ml[1] = l[r];
          }
        }
      }
      continue;
    }
    __syncthreads();  // every warp is done with its stage, which part_acc overlays

    // The warps' partial states, then each row's weights over the KW warps
    // that hold it (one thread a row), then the output (one split) or this
    // split's state.
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < Rw) {
        if (lane == 0) {
          part_m[warp][r] = m[r];
          part_l[warp][r] = l[r];
        }
#pragma unroll
        for (int i = 0; i < DPL; ++i) part_acc[warp][r][lane + 32 * i] = acc[r][i];
      }
    }
    __syncthreads();
    if (tid < RR) {
      const int w0 = (tid / RPW) * KW, lr = tid % RPW;
      float mx = -INFINITY;
      for (int k = 0; k < KW; ++k) mx = fmaxf(mx, part_m[w0 + k][lr]);
      float lsum = 0.f;
      for (int k = 0; k < KW; ++k) {
        const float c = part_m[w0 + k][lr] == -INFINITY ? 0.f : expf(part_m[w0 + k][lr] - mx);
        wt_s[tid][k] = c;
        lsum += part_l[w0 + k][lr] * c;
      }
      row_s[tid][0] = mx;
      row_s[tid][1] = lsum;
    }
    __syncthreads();
    for (int idx = tid; idx < RR * D; idx += THREADS) {
      const int r = idx / D, d = idx % D;
      const int w0 = (r / RPW) * KW, lr = r % RPW;
      float o = 0.f;
      for (int k = 0; k < KW; ++k) o += part_acc[w0 + k][lr][d] * wt_s[r][k];
      const float mx = row_s[r][0], lsum = row_s[r][1];
      const int g = (r0 + r) / S, s = (r0 + r) % S;
      const int h = hk * group + g;
      if (splits == 1) {
        out[b * o_sb + (long long)h * o_sh + s * o_ss + d] = lsum > 0.f ? o / lsum : 0.f;
      } else {
        const long long st = (((long long)b * Hkv + hk) * R + r0 + r) * splits + split;
        sp.ws[st * D + d] = o;
        if (d == 0) {
          float* ml = sp.ws + (long long)gridDim.x * Hkv * R * splits * D + 2 * st;
          ml[0] = mx;
          ml[1] = lsum;
        }
      }
    }
  }
  if (splits == 1) return;
  // Arrive: the barrier orders the block's state stores before thread 0's
  // acquire-release increment, which makes them visible to the block that
  // finds the count complete (no fence in every thread).
  __syncthreads();
  if (tid == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> cnt(sp.count[b * Hkv + hk]);
    last = cnt.fetch_add(1u, cuda::memory_order_acq_rel) == (unsigned)(splits - 1);
  }
  __syncthreads();
  if (!last) return;
  // The last block merges every row's states in split order (read from
  // L2: other blocks wrote them): the rows' (m, l) staged in shared
  // memory, one thread a row turns them into weights and the row's sum,
  // then every thread takes four output dims at a time (two where D is
  // not a multiple of 4).
  const long long ml_base = (long long)gridDim.x * Hkv * R * splits * D;
  const long long u_base = ((long long)b * Hkv + hk) * R;
  float* w_s = reinterpret_cast<float*>(pool);  // [MAXR][splits] m, then weights
  float* l_s = w_s + MAXR * splits;              // [MAXR][splits] l
  float* lsum_s = &part_l[0][0];                 // [MAXR] each row's sum
  for (int r0 = 0; r0 < R; r0 += MAXR) {
    const int RR = min(MAXR, R - r0);
    __syncthreads();
    for (int idx = tid; idx < RR * splits; idx += THREADS) {
      const int r = idx / splits, z = idx % splits;
      const long long st = (u_base + r0 + r) * splits + z;
      w_s[idx] = __ldcg(sp.ws + ml_base + 2 * st);
      l_s[idx] = __ldcg(sp.ws + ml_base + 2 * st + 1);
    }
    __syncthreads();
    if (tid < RR) {
      float mx = -INFINITY;
      for (int z = 0; z < splits; ++z) mx = fmaxf(mx, w_s[tid * splits + z]);
      float lsum = 0.f;
      for (int z = 0; z < splits; ++z) {
        const float mz = w_s[tid * splits + z];
        const float c = mz == -INFINITY ? 0.f : expf(mz - mx);
        w_s[tid * splits + z] = c;
        lsum += l_s[tid * splits + z] * c;
      }
      lsum_s[tid] = lsum;
    }
    __syncthreads();
    if (D % 4 == 0) {
      merge_dims<4>(sp.ws, w_s, lsum_s, out + b * o_sb, u_base + r0, r0, hk * group, S, RR,
                    splits, D, o_sh, o_ss, tid);
    } else {
      merge_dims<2>(sp.ws, w_s, lsum_s, out + b * o_sb, u_base + r0, r0, hk * group, S, RR,
                    splits, D, o_sh, o_ss, tid);
    }
  }
  if (tid == 0) sp.count[b * Hkv + hk] = 0u;  // ready for the next call on this workspace
}

// Launches an instance of decode_mha_fold_kernel with its dynamic shared
// memory (FoldSmem::POOL bytes). Where they and the kernel's static shared
// memory pass 48 KB, the kernel must be allowed them on each device it runs
// on, so the first launch of the instance on a device sets the attribute
// (whatever the size), and its error is returned without a launch. A
// refused launch shows in cudaGetLastError.
template <int DP, typename T, int MAXR, bool PAGED, bool WIN, bool EXACT, bool APPEND,
          typename... Args>
cudaError_t launch_fold_kernel(dim3 grid, cudaStream_t stream, Args... args) {
  auto* kernel = decode_mha_fold_kernel<DP, T, MAXR, PAGED, WIN, EXACT, APPEND>;
  constexpr int bytes = FoldSmem<DP, T, MAXR, WIN>::POOL;
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

// The error of a launcher's call: the first refusal, else the launch's
// (cudaGetLastError, which also clears a refusal's record).
static inline int rten_launch_error(cudaError_t refused) {
  const cudaError_t last = cudaGetLastError();
  return (int)(refused != cudaSuccess ? refused : last);
}

// The split's checks: 1 <= splits <= FOLD_MAX_SPLITS, chunk a multiple of
// 32 whose splits cover [0, cap) with none empty, and a workspace when
// there is more than one.
constexpr int FOLD_MAX_SPLITS = 64;

static inline bool rten_split_ok(int splits, int chunk, int cap, const void* ws,
                                 const void* count) {
  if (splits < 1 || splits > FOLD_MAX_SPLITS || chunk < 32 || chunk % 32) return false;
  if ((long long)(splits - 1) * chunk >= cap || (long long)splits * chunk < cap) return false;
  return splits == 1 || (ws != nullptr && count != nullptr);
}

}  // namespace

// The paged form's C entry point (paged_decode_mha{,_f32,_bf16}.cu): q
// [B, H, 1, D] f32 against pools read through the table bt [B, MB] with
// the strides given, out [B, 1, H*D] at strides (o_sb, o_sh); cap = MB *
// BS; group H / Hkv up to FoldRows (16 at D <= 128, 8 at D <= 256, 4 at
// D <= 512); any even D up to 512; vec: 16-byte K/V loads; the split
// (splits, chunk, the workspace ws and counters count: SplitArgs).
#define RTEN_PAGED_PARAMS                                                        \
  const void *q, long long q_sb, long long q_sh, const void *k, const void *v,   \
      long long kv_sb, long long kv_sh, long long kv_sj, const void *ks,         \
      const void *vs, long long sc_sb, long long sc_sh, long long sc_sj,         \
      const void *bt, int MB, int BS, const void *lens, void *out,               \
      long long o_sb, long long o_sh, int B, int H, int Hkv, int D, int window,  \
      float scale, int vec, int splits, int chunk, void *ws, void *count,        \
      void *stream
#define RTEN_PAGED_NAMES                                                         \
  q, q_sb, q_sh, k, v, kv_sb, kv_sh, kv_sj, ks, vs, sc_sb, sc_sh, sc_sj, bt, MB, \
      BS, lens, out, o_sb, o_sh, B, H, Hkv, D, window, scale, vec, splits, chunk, \
      ws, count, stream

template <typename T, int DP, int RR, bool EXACT>
cudaError_t launch_paged_fold(RTEN_PAGED_PARAMS) {
  return launch_fold_kernel<DP, T, RR, true, false, EXACT, false>(
      dim3(B, Hkv, splits), (cudaStream_t)stream, (const float*)q, q_sb, q_sh, 0, (const T*)k,
      (const T*)v, kv_sb, kv_sh, kv_sj, (const float*)ks, (const float*)vs, sc_sb, sc_sh, sc_sj,
      (const int32_t*)bt, MB, BS, (const int32_t*)lens, (float*)out, o_sb, o_sh, 0, H, Hkv, 1,
      D, MB * BS, window, scale, vec, RecentWindow{},
      SplitArgs{chunk, (float*)ws, (unsigned*)count}, AppendArgs{});
}

// Instances: D 64 and 128 exactly (EXACT), any other even D up to 128 in
// the masked DP 128 instance, then DP 256 and 512; rows per block 1 (no
// GQA: GPT-2's 1440 blocks keep few registers, so more fit an SM), 8 or 16.
template <typename T>
int launch_paged_decode_mha(RTEN_PAGED_PARAMS) {
  const int rows = H / Hkv, dp = rten_dp_of(D);
  if (rows < 1 || dp == 0 || MB < 1 || BS < 1) return (int)cudaErrorInvalidValue;
  if (!rten_split_ok(splits, chunk, MB * BS, ws, count)) return (int)cudaErrorInvalidValue;
  if (rows > FoldRows<256>::value && dp == 256) return (int)cudaErrorInvalidValue;
  if (rows > FoldRows<512>::value && dp == 512) return (int)cudaErrorInvalidValue;
  if (rows > 16) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
#define RTEN_PAGED_ROWS(DD, EX)                                                  \
  if (rows == 1) e = launch_paged_fold<T, DD, 1, EX>(RTEN_PAGED_NAMES);          \
  else if (rows <= 8) e = launch_paged_fold<T, DD, 8, EX>(RTEN_PAGED_NAMES);     \
  else e = launch_paged_fold<T, DD, 16, EX>(RTEN_PAGED_NAMES)
  if (D == 64) {
    RTEN_PAGED_ROWS(64, true);
  } else if (D == 128) {
    RTEN_PAGED_ROWS(128, true);
  } else if (dp <= 128) {
    RTEN_PAGED_ROWS(128, false);
  } else if (dp == 256) {
    if (rows == 1) e = launch_paged_fold<T, 256, 1, false>(RTEN_PAGED_NAMES);
    else e = launch_paged_fold<T, 256, 8, false>(RTEN_PAGED_NAMES);
  } else {
    if (rows == 1) e = launch_paged_fold<T, 512, 1, false>(RTEN_PAGED_NAMES);
    else e = launch_paged_fold<T, 512, 4, false>(RTEN_PAGED_NAMES);
  }
#undef RTEN_PAGED_ROWS
  return rten_launch_error(e);
}

// The split append's C entry point (decode_append{,_f32,_bf16}.cu): one
// decode step with the in-kernel row write on caches of either layout,
// addressed through (slot, kv head, row) strides (cat [B, cap, Hkv*D]:
// cap * Hkv * D, D, Hkv * D; head-major [B, Hkv, cap, D]: its own), s8
// scales through (slot, kv head, row) strides; out [B, 1, H*D]; any group
// (passes of FoldRows rows), any even D up to 512; the split as above.
#define RTEN_APPEND_PARAMS                                                       \
  const void *q, long long q_sb, long long q_sh, const void *kn, long long kn_sb, \
      long long kn_sh, const void *vn, long long vn_sb, long long vn_sh, void *kc, \
      void *vc, long long kv_sb, long long kv_sh, long long kv_sj, void *ks,      \
      void *vs, long long sc_sb, long long sc_sh, long long sc_sj,                \
      const void *lens, void *out, int B, int H, int Hkv, int D, int cap,         \
      int window, float scale, int vec, int splits, int chunk, void *ws,          \
      void *count, void *stream
#define RTEN_APPEND_NAMES                                                        \
  q, q_sb, q_sh, kn, kn_sb, kn_sh, vn, vn_sb, vn_sh, kc, vc, kv_sb, kv_sh, kv_sj, \
      ks, vs, sc_sb, sc_sh, sc_sj, lens, out, B, H, Hkv, D, cap, window, scale,   \
      vec, splits, chunk, ws, count, stream

template <typename T, int DP, int RR, bool EXACT>
cudaError_t launch_append_fold(RTEN_APPEND_PARAMS) {
  return launch_fold_kernel<DP, T, RR, false, false, EXACT, true>(
      dim3(B, Hkv, splits), (cudaStream_t)stream, (const float*)q, q_sb, q_sh, 0, (const T*)kc,
      (const T*)vc, kv_sb, kv_sh, kv_sj, (const float*)ks, (const float*)vs, sc_sb, sc_sh, sc_sj,
      nullptr, 0, 0, (const int32_t*)lens, (float*)out, (long long)H * D, D, 0, H, Hkv, 1, D,
      cap, window, scale, vec, RecentWindow{}, SplitArgs{chunk, (float*)ws, (unsigned*)count},
      AppendArgs{(const float*)kn, kn_sb, kn_sh, (const float*)vn, vn_sb, vn_sh, kc, vc,
                 (float*)ks, (float*)vs});
}

// Instances as the paged fold's; rows per pass: 1 (group 1), 8, or
// FoldRows (16 up to D 128, 8 at D 256, 4 at D 512).
template <typename T>
int launch_decode_append(RTEN_APPEND_PARAMS) {
  const int rows = H / Hkv, dp = rten_dp_of(D);
  if (B < 1 || Hkv < 1 || rows < 1 || H % Hkv || cap < 1 || dp == 0)
    return (int)cudaErrorInvalidValue;
  if (!rten_split_ok(splits, chunk, cap, ws, count)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
#define RTEN_APPEND_ROWS(DD, EX)                                                 \
  if (rows == 1) e = launch_append_fold<T, DD, 1, EX>(RTEN_APPEND_NAMES);        \
  else if (rows <= 8) e = launch_append_fold<T, DD, 8, EX>(RTEN_APPEND_NAMES);   \
  else e = launch_append_fold<T, DD, 16, EX>(RTEN_APPEND_NAMES)
  if (D == 64) {
    RTEN_APPEND_ROWS(64, true);
  } else if (D == 128) {
    RTEN_APPEND_ROWS(128, true);
  } else if (dp <= 128) {
    RTEN_APPEND_ROWS(128, false);
  } else if (dp == 256) {
    if (rows == 1) e = launch_append_fold<T, 256, 1, false>(RTEN_APPEND_NAMES);
    else e = launch_append_fold<T, 256, 8, false>(RTEN_APPEND_NAMES);
  } else {
    if (rows == 1) e = launch_append_fold<T, 512, 1, false>(RTEN_APPEND_NAMES);
    else e = launch_append_fold<T, 512, 4, false>(RTEN_APPEND_NAMES);
  }
#undef RTEN_APPEND_ROWS
  return rten_launch_error(e);
}
