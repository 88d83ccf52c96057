// Attention over cat-layout KV caches, for Hopper (sm_90a).
//
// Caches are [B, cap, Hkv*D] ("cat layout": one row per position, the kv
// heads side by side) of one element type T (KvKind, decode_fold.cuh):
// s8 with per-position scales [B, Hkv, cap] f32, where row j of head hk
// dequantizes as kc[b, j, hk*D:(hk+1)*D] * ks[b, hk, j]; or f32 or bf16
// values with no scales (kv_quant=False, kv_dtype=BFloat16 graphs). Every
// kernel is a template on T; the s8 instances compile to the code they had
// before the template (the unquantized branches are `if constexpr`).
//
// 1. decode_append_kernel replaces rten_tpu/kernels/flash_attention.py,
//    decode_mha_append_cat (Pallas bodies _append_cat_fold_vec_kernel,
//    _append_cat_fold_kernel, _append_cat_kernel) and, on head-major caches
//    [B, Hkv, cap, D] with scales [B, Hkv, cap], decode_mha_append (:1442,
//    Pallas body _append_kernel): one decode step (S == 1). The caches and
//    scales are addressed through (slot, kv head, row) strides, so the two
//    layouts are one kernel.
//    It quantizes the new K/V row per head (scale max(absmax / 127, 1e-8),
//    round half to even, clip to [-127, 127]) and writes it and its scale,
//    or (f32/bf16) writes the row rounded to T, in place at row
//    min(lens[b], cap - 1), then attends rows
//    (lens[b] - window, lens[b]] with the online softmax, taking the new row
//    from shared memory / registers instead of re-reading it. The new
//    column is scored from the row as the cache holds it (s8 codes and
//    scale, or the bf16-rounded values), as the reference attends the
//    written cache.
//    Bound on the H100: bytes — the call reads each live cache row once
//    (2 * B * lens * Hkv * D elements plus s8 scales, up to ~47 MB per
//    layer at 120 slots x cap 256 in s8, twice that in bf16) and does ~4
//    flops per s8 byte.
//    Design: one 128-thread block per (slot, kv head). The block quantizes
//    the head's new row once (each thread owns D / 128 of its elements,
//    rounded up) and keeps it in shared memory; then, for each
//    query head of the group, its four warps split the 32-key tiles of the
//    cache. A lane scores one key of a tile (16-byte vector loads of the
//    row), the warp reduces the tile's max and sum with shuffles, each lane
//    accumulates D/32 output dims of P.V, and the four warps' partial
//    softmax states merge in shared memory. The block is the only writer
//    of its row and never reads it back from memory, so there is no race.
//    Reads are not yet pipelined (cp.async/TMA) and the query heads of a
//    GQA group each re-read the keys (from L2): later work.
//    Block-table mode (the TPU kernel's block_table= form): the caches are
//    pools [NB, BS, Hkv*D] shared by all slots, with scale pools
//    [NB, Hkv, 1, BS], and row j of slot b lives at pool row
//    bt[b, j / BS] * BS + j % BS; the new row goes to position
//    min(lens[b], cap - 1), cap = MB * BS. Idle slots all point at block
//    0, so several slots can write the same row, and the reference writes
//    every slot's row, the last slot winning, before any slot reads. A
//    block that wrote and attended at once would race with the other
//    writers of its row, so this mode is two launches on one stream:
//    append_cat_write_kernel (a block skips its write when a later slot
//    targets the same row), then the attention, which reads every row, the
//    new one included, from the pool through the table: decode_mha's fold
//    (decode_fold.cuh) with table addressing, which reads each K/V row once
//    for the whole GQA group. Same bound (bytes). s8 pools attend here; f32
//    and bf16 pools through paged_decode_mha.cu's and
//    paged_decode_mha_bf16.cu's entry point (the same fold on the cat
//    pools' strides), so that their instances build in those translation
//    units, in parallel with this one.
//
// 2. prefill_mha_cat is in prefill_cat.cu (a library of its own, built in
//    parallel with this one).
//
// Division and rounding must match the plain version bit for bit in the
// quantizer and the bf16 rounding (__float2bfloat16_rn), so this file is
// built without --use_fast_math (IEEE division, rintf).
//
// Head dims: every kernel is built for DP = 32, 64, 128 and 256 (the append
// also 512) and takes any even D <= DP in the smallest instance that holds
// it: dims past D are zero in shared memory and never read from the cache
// (a masked tail). K rows load 16 bytes at a time when every row starts
// 16-byte aligned and its length is a multiple of 16 bytes (``vec``), else
// one element at a time. The block-table mode attends at D <= 256.

#include "decode_fold.cuh"

namespace {

__device__ __forceinline__ int8_t quantize_s8(float x, float s) {
  return (int8_t)fminf(fmaxf(rintf(x / s), -127.f), 127.f);
}

constexpr int DEC_WARPS = 4;  // warps per decode block, splitting the keys
constexpr int DEC_THREADS = DEC_WARPS * 32;

// Slot b's new K and V rows of kv head hk, as the cache holds them: thread
// tid owns elements tid + 128 e (e < EPT) of kn/vn. s8: quantized with the
// scale max(absmax / 127, 1e-8) of the row (the block's max through red_s);
// f32/bf16: rounded to T. Returns the codes or rounded values (as floats)
// in kq/vq and the scales in ks_new/vs_new (1 for f32/bf16).
template <int DP, typename T>
__device__ __forceinline__ void new_row(const float* kn, const float* vn, int D, int tid,
                                        float (&red_s)[2][DEC_WARPS], float (&kq)[(DP + 127) / 128],
                                        float (&vq)[(DP + 127) / 128], float& ks_new,
                                        float& vs_new) {
  constexpr int EPT = (DP + 127) / 128;
  float kx[EPT], vx[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int d = tid + DEC_THREADS * e;
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
    for (int w = 1; w < DEC_WARPS; ++w) {
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

// EXACT: D == DP, known at compile time (D 64 and 128; the masked tail's
// bounds fold away). At D 64 exactly the kernel keeps to 40 registers, so
// that twelve blocks fit an SM and GPT-2's 120 slots x 12 heads run in one
// wave of 132 SMs (its masked instances would spill there).
template <int DP, typename T, bool EXACT>
__global__ void __launch_bounds__(DEC_THREADS, EXACT && DP == 64 ? 12 : 1) decode_append_kernel(
    const float* __restrict__ q, long long q_sb, long long q_sh,
    const float* __restrict__ kn, long long kn_sb, long long kn_sh,
    const float* __restrict__ vn, long long vn_sb, long long vn_sh,
    T* kc, T* vc, long long kv_sb, long long kv_sh, long long kv_sj,
    float* ks, float* vs, long long sc_sb, long long sc_sh, long long sc_sj,
    const int32_t* __restrict__ lens, float* __restrict__ out,
    int H, int Hkv, int D, int cap, int window, float scale, int vec) {
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  constexpr int DPL = DP / 32;          // output dims per lane
  constexpr int EPT = (DP + 127) / 128;  // new-row elements per thread
  if constexpr (EXACT) D = DP;
  __shared__ float q_s[DP];
  __shared__ float kq_s[DP], vq_s[DP];  // the new row as the cache holds it
  __shared__ float red_s[2][DEC_WARPS];
  __shared__ float part_m[DEC_WARPS], part_l[DEC_WARPS];
  __shared__ float part_acc[DEC_WARPS][DP];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x, hk = blockIdx.y;
  const int group = H / Hkv;
  const int len = lens[b];
  const int wpos = min(max(len, 0), cap - 1);  // clamped like dynamic_update_slice
  const int hi = wpos;                          // last attended row
  const int lo = window > 0 ? max(0, len - window + 1) : 0;
  T* kb = kc + b * kv_sb + hk * kv_sh;
  T* vb = vc + b * kv_sb + hk * kv_sh;
  const long long sc_base = b * sc_sb + hk * sc_sh;

  // 1. The new K and V rows of kv head hk: s8 quantized with their scales,
  //    or rounded to T; written in place at row wpos. This block is the
  //    only writer of that row of head hk, and no block reads it back.
  float kq[EPT], vq[EPT], ks_new, vs_new;
  new_row<DP, T>(kn + b * kn_sb + hk * kn_sh, vn + b * vn_sb + hk * vn_sh, D, tid, red_s,
                 kq, vq, ks_new, vs_new);
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int d = tid + DEC_THREADS * e;
    if (d < DP) {
      kq_s[d] = kq[e];  // 0 past D
      vq_s[d] = vq[e];
    }
    if (d < D) {
      kb[wpos * kv_sj + d] = as_elem<T>(kq[e]);
      vb[wpos * kv_sj + d] = as_elem<T>(vq[e]);
    }
  }
  if (QUANT && tid == 0) {
    ks[sc_base + wpos * sc_sj] = ks_new;
    vs[sc_base + wpos * sc_sj] = vs_new;
  }

  // 2. For each query head of the group: the warps split the key tiles
  //    (tile t goes to warp t % DEC_WARPS), each keeping its own online
  //    softmax; the partial results merge through shared memory.
  const int ntiles = hi >= lo ? (hi - lo) / 32 + 1 : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    __syncthreads();  // the new row is in shared memory; the last head is merged
    for (int d = tid; d < DP; d += DEC_THREADS) q_s[d] = d < D ? q[b * q_sb + h * q_sh + d] : 0.f;
    __syncthreads();

    float m = -INFINITY, l = 0.f;
    float acc[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

    for (int t = warp; t < ntiles; t += DEC_WARPS) {
      const int j0 = lo + 32 * t;
      const int j = j0 + lane;
      const bool valid = j <= hi;
      float s = -INFINITY, vsc = 0.f;
      if (valid) {
        float dot = 0.f, ksc = 1.f;
        vsc = 1.f;
        if (j == wpos) {
          dot = row_dot<DP>(q_s, kq_s);
          ksc = ks_new;
          vsc = vs_new;
        } else {
          // The fold's row dot with one query row (16-byte loads, unrolled
          // up to D 128).
          float sc[1] = {0.f};
          fold_scores<DP, T, 1, (DP <= 128)>(reinterpret_cast<const float (*)[DP]>(q_s),
                                             kb + j * kv_sj, 1, D, vec != 0, sc);
          dot = sc[0];
          if constexpr (QUANT) {
            ksc = ks[sc_base + j * sc_sj];
            vsc = vs[sc_base + j * sc_sj];
          }
        }
        s = dot * ksc * scale;
      }
      // Lane 0 is always valid, so m_new is finite.
      const float m_new = fmaxf(m, warp_max(s));
      const float alpha = expf(m - m_new);
      const float p = valid ? expf(s - m_new) : 0.f;
      l = l * alpha + warp_sum(p);
      const float pv = p * vsc;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
      const int nk = min(32, hi - j0 + 1);
      for (int u = 0; u < nk; ++u) {
        const float pt = __shfl_sync(FULL, pv, u);
        const int jj = j0 + u;
        if (jj == wpos) {
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[i] += pt * vq_s[lane + 32 * i];
        } else {
          const T* vrow = vb + jj * kv_sj;
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int d = lane + 32 * i;
            acc[i] += d < D ? pt * to_f32(vrow[d]) : 0.f;
          }
        }
      }
      m = m_new;
    }
    if (lane == 0) {
      part_m[warp] = m;
      part_l[warp] = l;
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) part_acc[warp][lane + 32 * i] = acc[i];
    __syncthreads();
    for (int d = tid; d < D; d += DEC_THREADS) {
      float mx = part_m[0];
#pragma unroll
      for (int w = 1; w < DEC_WARPS; ++w) mx = fmaxf(mx, part_m[w]);
      float lsum = 0.f, o = 0.f;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) {
        const float c = part_m[w] == -INFINITY ? 0.f : expf(part_m[w] - mx);
        lsum += part_l[w] * c;
        o += part_acc[w][d] * c;
      }
      out[((long long)b * H + h) * D + d] = lsum > 0.f ? o / lsum : 0.f;
    }
  }
}

// The pool row (blk * BS + r) that slot c's decode row lands in: position
// min(lens[c], cap - 1) through the block table (the reference clamps the
// write row before it looks the block up).
__device__ __forceinline__ long long append_row(const int32_t* __restrict__ bt,
                                                const int32_t* __restrict__ lens,
                                                int c, int MB, int BS) {
  const int w = min(max(lens[c], 0), MB * BS - 1);
  return (long long)bt[(long long)c * MB + w / BS] * BS + w % BS;
}

// Block-table mode, launch 1 of 2: slot b's new K/V row of kv head hk (the
// same arithmetic as the flat kernel: s8 quantized with its scales, or
// rounded to T) written into the pools, unless a later slot targets the
// same pool row: the reference's in-order writes leave the last slot's.
template <int DP, typename T>
__global__ void __launch_bounds__(DEC_THREADS) append_cat_write_kernel(
    const float* __restrict__ kn, long long kn_sb, long long kn_sh,
    const float* __restrict__ vn, long long vn_sb, long long vn_sh,
    T* kc, T* vc, float* ks, float* vs, const int32_t* __restrict__ bt,
    int MB, int BS, const int32_t* __restrict__ lens, int B, int Hkv, int D) {
  constexpr int EPT = (DP + 127) / 128;
  __shared__ float red_s[2][DEC_WARPS];
  const int tid = threadIdx.x;
  const int b = blockIdx.x, hk = blockIdx.y;
  const long long row = append_row(bt, lens, b, MB, BS);
  int later = 0;
  for (int c = b + 1 + tid; c < B; c += DEC_THREADS)
    later |= append_row(bt, lens, c, MB, BS) == row;
  if (__syncthreads_or(later)) return;  // the same answer in every thread
  float kq[EPT], vq[EPT], ks_new, vs_new;
  new_row<DP, T>(kn + b * kn_sb + hk * kn_sh, vn + b * vn_sb + hk * vn_sh, D, tid, red_s,
                 kq, vq, ks_new, vs_new);
  const long long off = row * Hkv * D + (long long)hk * D;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int d = tid + DEC_THREADS * e;
    if (d < D) {
      kc[off + d] = as_elem<T>(kq[e]);
      vc[off + d] = as_elem<T>(vq[e]);
    }
  }
  if (std::is_same<T, int8_t>::value && tid == 0) {
    const long long s = ((row / BS) * Hkv + hk) * BS + row % BS;
    ks[s] = ks_new;
    vs[s] = vs_new;
  }
}

}  // namespace

// One decode step with the in-kernel row write, on any layout: the caches
// kc/vc through (slot, kv head, row) strides (cat [B, cap, Hkv*D]: cap *
// Hkv * D, D, Hkv * D; head-major [B, Hkv, cap, D]: its own), s8 scales
// through (slot, kv head, row) strides; out [B, 1, H*D].
extern "C" int rten_decode_append(
    int kind, const void* q, long long q_sb, long long q_sh,
    const void* kn, long long kn_sb, long long kn_sh,
    const void* vn, long long vn_sb, long long vn_sh,
    void* kc, void* vc, long long kv_sb, long long kv_sh, long long kv_sj,
    void* ks, void* vs, long long sc_sb, long long sc_sh, long long sc_sj,
    const void* lens, void* out, int B, int H, int Hkv, int D, int cap, int window,
    float scale, int vec, void* stream) {
  if (B < 1 || Hkv < 1 || H % Hkv || cap < 1) return (int)cudaErrorInvalidValue;
  dim3 grid(B, Hkv);
  cudaStream_t st = (cudaStream_t)stream;
#define RTEN_DECODE_EX(DD, TT, EX)                                               \
  decode_append_kernel<DD, TT, EX><<<grid, DEC_THREADS, 0, st>>>(                \
      (const float*)q, q_sb, q_sh, (const float*)kn, kn_sb, kn_sh,               \
      (const float*)vn, vn_sb, vn_sh, (TT*)kc, (TT*)vc, kv_sb, kv_sh, kv_sj,     \
      (float*)ks, (float*)vs, sc_sb, sc_sh, sc_sj, (const int32_t*)lens,         \
      (float*)out, H, Hkv, D, cap, window, scale, vec)
  // D 64 and 128 run their EXACT instances; any other D its masked one.
#define RTEN_DECODE(DD, TT)                                                      \
  if ((DD == 64 || DD == 128) && D == DD) RTEN_DECODE_EX(DD, TT, (DD == 64 || DD == 128)); \
  else RTEN_DECODE_EX(DD, TT, false)
#define RTEN_DECODE_T(TT) RTEN_BY_DP512(TT, RTEN_DECODE)
  RTEN_BY_KIND(kind, RTEN_DECODE_T)
#undef RTEN_DECODE_T
#undef RTEN_DECODE
#undef RTEN_DECODE_EX
  return (int)cudaGetLastError();
}

// Block-table mode, launch 1 of 2 (any element type): every slot's new row
// written into the pools kc/vc [NB, BS, Hkv*D] (and, s8, its scales into
// ks/vs [NB, Hkv, 1, BS]), the last slot winning a shared row.
extern "C" int rten_append_cat_write(
    int kind, const void* kn, long long kn_sb, long long kn_sh,
    const void* vn, long long vn_sb, long long vn_sh,
    void* kc, void* vc, void* ks, void* vs, const void* bt, int MB, int BS,
    const void* lens, int B, int Hkv, int D, void* stream) {
  if (MB < 1 || BS < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, Hkv);
  cudaStream_t st = (cudaStream_t)stream;
#define RTEN_WRITE(DD, TT)                                                       \
  append_cat_write_kernel<DD, TT><<<grid, DEC_THREADS, 0, st>>>(                 \
      (const float*)kn, kn_sb, kn_sh, (const float*)vn, vn_sb, vn_sh,            \
      (TT*)kc, (TT*)vc, (float*)ks, (float*)vs, (const int32_t*)bt, MB, BS,      \
      (const int32_t*)lens, B, Hkv, D)
#define RTEN_WRITE_T(TT) RTEN_BY_DP256(TT, RTEN_WRITE)
  RTEN_BY_KIND(kind, RTEN_WRITE_T)
#undef RTEN_WRITE_T
#undef RTEN_WRITE
  return (int)cudaGetLastError();
}

// Block-table mode on s8 pools: kc/vc are pools [NB, BS, Hkv*D], ks/vs
// scale pools [NB, Hkv, 1, BS], bt [B, MB]; out [B, 1, H*D]. Two launches
// on the stream: every slot's row is written (the last slot winning a
// shared row), then every slot attends through the table (the fold: group
// up to 16 at D <= 128, 8 at D <= 256).
extern "C" int rten_decode_append_cat_paged(
    const void* q, long long q_sb, long long q_sh,
    const void* kn, long long kn_sb, long long kn_sh,
    const void* vn, long long vn_sb, long long vn_sh,
    void* kc, void* vc, void* ks, void* vs, const void* bt, int MB, int BS,
    const void* lens, void* out, int B, int H, int Hkv, int D, int window,
    float scale, int vec, void* stream) {
  const int rows = H / Hkv, dp = rten_cat_dp_of(D, 256);
  if (rows < 1 || dp == 0 || rows > (dp == 256 ? 8 : 16)) return (int)cudaErrorInvalidValue;
  const int err = rten_append_cat_write(KV_S8, kn, kn_sb, kn_sh, vn, vn_sb, vn_sh, kc, vc,
                                        ks, vs, bt, MB, BS, lens, B, Hkv, D, stream);
  if (err) return err;
  // Strides of the cat pools (rows of Hkv * D) and the scale pools.
  const long long HkvD = (long long)Hkv * D;
#define RTEN_ATTEND(DD, RR, EX)                                                  \
  launch_paged_fold<int8_t, DD, RR, EX>(q, q_sb, q_sh, kc, vc, BS * HkvD, D, HkvD, ks, vs, \
                                    (long long)Hkv * BS, BS, 1, bt, MB, BS, lens, out, \
                                    (long long)H * D, D, B, H, Hkv, D, window, scale, vec, \
                                    stream)
#define RTEN_ATTEND_R(DD, EX)                                                    \
  if (rows == 1) RTEN_ATTEND(DD, 1, EX);                                         \
  else if (rows <= 8) RTEN_ATTEND(DD, 8, EX);                                    \
  else RTEN_ATTEND(DD, 16, EX)
  // D 64 and 128 exactly; any other D up to 128 in the masked DP 128
  // instance; then DP 256.
  if (D == 64) {
    RTEN_ATTEND_R(64, true);
  } else if (D == 128) {
    RTEN_ATTEND_R(128, true);
  } else if (dp <= 128) {
    RTEN_ATTEND_R(128, false);
  } else if (rows == 1) {
    RTEN_ATTEND(256, 1, false);
  } else {
    RTEN_ATTEND(256, 8, false);
  }
#undef RTEN_ATTEND_R
#undef RTEN_ATTEND
  return (int)cudaGetLastError();
}
