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
// 1. decode_append_cat_kernel replaces rten_tpu/kernels/flash_attention.py,
//    decode_mha_append_cat (Pallas bodies _append_cat_fold_vec_kernel,
//    _append_cat_fold_kernel, _append_cat_kernel): one decode step (S == 1).
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
//    the head's new row once and keeps it in shared memory; then, for each
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
// 2. prefill_cat_kernel replaces rten_tpu/kernels/flash_attention.py,
//    prefill_mha_cat (Pallas body _prefill_cat_kernel): S > 1 prefill off
//    caches that already hold the chunk's rows; query row r of slot b
//    attends columns <= lens[b] + r (and > lens[b] + r - window).
//    Bound on the H100: operations at admission sizes (4 * S * keys * D
//    flops per head against S * D * 4 + keys * D bytes).
//    Design: one 128-thread block per (q-tile of 32 rows, head, slot); key
//    tiles of 32 columns (16 at D 128, which keeps static shared memory at
//    35 KB, under 48 KB) are dequantized (s8 x scale) or widened (f32,
//    bf16) into shared memory, four threads share a query row (scores for
//    a quarter of the tile's columns each, then D / 4 output dims each),
//    and the online softmax runs in registers. f32 on CUDA cores: tensor
//    cores (mma/wgmma) are later work.
//
// Division and rounding must match the plain version bit for bit in the
// quantizer and the bf16 rounding (__float2bfloat16_rn), so this file is
// built without --use_fast_math (IEEE division, rintf).
//
// Head dims: s8 caches D 32, 64 and 128; f32 and bf16 caches D 64 and 128
// (the block-table mode likewise).

#include "decode_fold.cuh"

namespace {

__device__ __forceinline__ int8_t quantize_s8(float x, float s) {
  return (int8_t)fminf(fmaxf(rintf(x / s), -127.f), 127.f);
}

constexpr int DEC_WARPS = 4;  // warps per decode block, splitting the keys

template <int D, typename T>
__global__ void __launch_bounds__(DEC_WARPS * 32) decode_append_cat_kernel(
    const float* __restrict__ q, long long q_sb, long long q_sh,
    const float* __restrict__ kn, long long kn_sb, long long kn_sh,
    const float* __restrict__ vn, long long vn_sb, long long vn_sh,
    T* kc, T* vc, float* ks, float* vs,
    const int32_t* __restrict__ lens, float* __restrict__ out,
    int H, int Hkv, int cap, int window, float scale) {
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  constexpr int DPL = D / 32;          // output dims per lane
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  // The new row as the cache holds it: s8 codes (beside their scale), or
  // the values of the row rounded to T.
  using RowT = typename std::conditional<QUANT, int8_t, float>::type;
  __shared__ float q_s[D];
  __shared__ RowT kq_s[D], vq_s[D];
  __shared__ float red_s[2][DEC_WARPS];
  __shared__ float part_m[DEC_WARPS], part_l[DEC_WARPS];
  __shared__ float part_acc[DEC_WARPS][D];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x, hk = blockIdx.y;
  const int group = H / Hkv;
  const long long HkvD = (long long)Hkv * D;
  const int len = lens[b];
  const int wpos = min(max(len, 0), cap - 1);  // clamped like dynamic_update_slice
  const int hi = wpos;                          // last attended row
  const int lo = window > 0 ? max(0, len - window + 1) : 0;
  const long long sc_base = ((long long)b * Hkv + hk) * cap;
  const long long row_off = ((long long)b * cap + wpos) * HkvD + (long long)hk * D;

  // 1. The new K and V rows of kv head hk (thread d owns element d): s8
  //    quantized with their scales, or rounded to T; written in place at
  //    row wpos. This block is the only writer of that row of head hk, and
  //    no block reads it back.
  float kx = 0.f, vx = 0.f;
  if (tid < D) {
    kx = kn[b * kn_sb + hk * kn_sh + tid];
    vx = vn[b * vn_sb + hk * vn_sh + tid];
  }
  float ks_new = 1.f, vs_new = 1.f;
  if constexpr (QUANT) {
    float kam = warp_max(fabsf(kx)), vam = warp_max(fabsf(vx));
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
    if (tid < D) {
      const int8_t kq = quantize_s8(kx, ks_new), vq = quantize_s8(vx, vs_new);
      kq_s[tid] = kq;
      vq_s[tid] = vq;
      kc[row_off + tid] = kq;
      vc[row_off + tid] = vq;
    }
    if (tid == 0) {
      ks[sc_base + wpos] = ks_new;
      vs[sc_base + wpos] = vs_new;
    }
  } else {
    if (tid < D) {
      const T kt = from_f32<T>(kx), vt = from_f32<T>(vx);
      kq_s[tid] = to_f32(kt);
      vq_s[tid] = to_f32(vt);
      kc[row_off + tid] = kt;
      vc[row_off + tid] = vt;
    }
  }

  // 2. For each query head of the group: the warps split the key tiles
  //    (tile t goes to warp t % DEC_WARPS), each keeping its own online
  //    softmax; the partial results merge through shared memory.
  const int ntiles = hi >= lo ? (hi - lo) / 32 + 1 : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    __syncthreads();  // the new row is in shared memory; the last head is merged
    if (tid < D) q_s[tid] = q[b * q_sb + h * q_sh + tid];
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
#pragma unroll
          for (int d = 0; d < D; ++d) dot += q_s[d] * (float)kq_s[d];
          ksc = ks_new;
          vsc = vs_new;
        } else {
          const T* row = kc + ((long long)b * cap + j) * HkvD + (long long)hk * D;
#pragma unroll
          for (int c = 0; c < D / VEC; ++c) {
            float e[VEC];
            load16(row + c * VEC, e);
#pragma unroll
            for (int u = 0; u < VEC; ++u) dot += q_s[c * VEC + u] * e[u];
          }
          if constexpr (QUANT) {
            ksc = ks[sc_base + j];
            vsc = vs[sc_base + j];
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
          for (int i = 0; i < DPL; ++i) acc[i] += pt * (float)vq_s[lane + 32 * i];
        } else {
          const T* vrow = vc + ((long long)b * cap + jj) * HkvD + (long long)hk * D;
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[i] += pt * to_f32(vrow[lane + 32 * i]);
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
    if (tid < D) {
      float mx = part_m[0];
#pragma unroll
      for (int w = 1; w < DEC_WARPS; ++w) mx = fmaxf(mx, part_m[w]);
      float lsum = 0.f, o = 0.f;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) {
        const float c = part_m[w] == -INFINITY ? 0.f : expf(part_m[w] - mx);
        lsum += part_l[w] * c;
        o += part_acc[w][tid] * c;
      }
      out[((long long)b * H + h) * D + tid] = lsum > 0.f ? o / lsum : 0.f;
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

// Block-table mode, launch 1 of 2: slot b's new K/V row of kv head hk
// (thread d owns element d; the same arithmetic as the flat kernel: s8
// quantized with its scales, or rounded to T) written into the pools,
// unless a later slot targets the same pool row: the reference's in-order
// writes leave the last slot's.
template <int D, typename T>
__global__ void __launch_bounds__(DEC_WARPS * 32) append_cat_write_kernel(
    const float* __restrict__ kn, long long kn_sb, long long kn_sh,
    const float* __restrict__ vn, long long vn_sb, long long vn_sh,
    T* kc, T* vc, float* ks, float* vs, const int32_t* __restrict__ bt,
    int MB, int BS, const int32_t* __restrict__ lens, int B, int Hkv) {
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  __shared__ float red_s[2][DEC_WARPS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x, hk = blockIdx.y;
  const long long row = append_row(bt, lens, b, MB, BS);
  int later = 0;
  for (int c = b + 1 + tid; c < B; c += DEC_WARPS * 32)
    later |= append_row(bt, lens, c, MB, BS) == row;
  if (__syncthreads_or(later)) return;  // the same answer in every thread
  float kx = 0.f, vx = 0.f;
  if (tid < D) {
    kx = kn[b * kn_sb + hk * kn_sh + tid];
    vx = vn[b * vn_sb + hk * vn_sh + tid];
  }
  const long long off = row * Hkv * D + (long long)hk * D + tid;
  if constexpr (QUANT) {
    float kam = warp_max(fabsf(kx)), vam = warp_max(fabsf(vx));
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
    const float ks_new = fmaxf(kam / 127.0f, 1e-8f);
    const float vs_new = fmaxf(vam / 127.0f, 1e-8f);
    if (tid < D) {
      kc[off] = quantize_s8(kx, ks_new);
      vc[off] = quantize_s8(vx, vs_new);
    }
    if (tid == 0) {
      const long long s = ((row / BS) * Hkv + hk) * BS + row % BS;
      ks[s] = ks_new;
      vs[s] = vs_new;
    }
  } else {
    if (tid < D) {
      kc[off] = from_f32<T>(kx);
      vc[off] = from_f32<T>(vx);
    }
  }
}

constexpr int PBQ = 32;  // query rows per block
constexpr int PBK = 32;  // key columns per tile (16 at D 128)

template <int D, typename T>
__global__ void __launch_bounds__(128) prefill_cat_kernel(
    const float* __restrict__ q, long long q_sb, long long q_sh, long long q_ss,
    const T* __restrict__ kc, const T* __restrict__ vc,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int32_t* __restrict__ lens, float* __restrict__ out,
    long long o_sb, long long o_sh, long long o_ss,
    int H, int Hkv, int S, int cap, int window, float scale) {
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  constexpr int BK = D == 128 ? 16 : PBK;  // static shared memory under 48 KB
  constexpr int DPT = D / 4;               // output dims per thread
  constexpr int CPT = BK / 4;              // score columns per thread
  __shared__ float Qs[PBQ][D + 1];
  __shared__ float Ks[BK][D + 1];
  __shared__ float Vs[BK][D + 1];
  __shared__ float Ps[PBQ][BK + 1];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, row = tid / 4, sub = tid % 4;
  const int group = H / Hkv, hk = h / group;
  const long long HkvD = (long long)Hkv * D;
  const long long sc_base = ((long long)b * Hkv + hk) * cap;
  const int len = lens[b];
  const int r0 = qt * PBQ;

  for (int idx = tid; idx < PBQ * D; idx += 128) {
    const int r = idx / D, d = idx % D, s = r0 + r;
    Qs[r][d] = s < S ? q[b * q_sb + h * q_sh + s * q_ss + d] : 0.f;
  }
  const int last_row = min(S - 1, r0 + PBQ - 1);
  const int kmax = min(len + last_row, cap - 1);
  const int kmin = window > 0 ? max(0, len + r0 - window + 1) : 0;
  const int s_row = r0 + row;
  const bool row_valid = s_row < S;
  const int qpos = len + s_row;

  float m = -INFINITY, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int k0 = (kmin / BK) * BK; k0 <= kmax; k0 += BK) {
    __syncthreads();  // Qs ready / previous tile consumed
    for (int idx = tid; idx < BK * D; idx += 128) {
      const int c = idx / D, d = idx % D, col = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (col < cap) {
        const long long off = ((long long)b * cap + col) * HkvD + (long long)hk * D + d;
        if constexpr (QUANT) {
          kv = (float)kc[off] * ks[sc_base + col];
          vv = (float)vc[off] * vs[sc_base + col];
        } else {
          kv = to_f32(kc[off]);
          vv = to_f32(vc[off]);
        }
      }
      Ks[c][d] = kv;
      Vs[c][d] = vv;
    }
    __syncthreads();

    float sc[CPT];
    float mt = -INFINITY;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = sub + 4 * i, col = k0 + c;
      const bool ok = row_valid && col <= qpos && col < cap &&
                      (window <= 0 || col > qpos - window);
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += Qs[row][d] * Ks[c][d];
      sc[i] = ok ? dot * scale : -INFINITY;
      mt = fmaxf(mt, sc[i]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float alpha = m == -INFINITY ? 0.f : expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const float p = sc[i] == -INFINITY ? 0.f : expf(sc[i] - m_new);
      Ps[row][sub + 4 * i] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(FULL, psum, 1);
    psum += __shfl_xor_sync(FULL, psum, 2);
    l = l * alpha + psum;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    for (int c = 0; c < BK; ++c) {
      const float p = Ps[row][c];
      if (p != 0.f) {
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] += p * Vs[c][sub + 4 * i];
      }
    }
    m = m_new;
  }
  if (row_valid) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      out[b * o_sb + h * o_sh + s_row * o_ss + sub + 4 * i] = acc[i] * inv;
  }
}

}  // namespace

// The head dims each element type takes: D 32, 64, 128 for s8, 64 and 128
// for f32 and bf16. Expands M(D, T) for the call's D; any other D returns
// cudaErrorInvalidValue.
#define RTEN_BY_D(TT, M)                                                         \
  if (D == 64) { M(64, TT); }                                                    \
  else if (D == 128) { M(128, TT); }                                             \
  else if (D == 32 && std::is_same<TT, int8_t>::value) { M(32, int8_t); }        \
  else return (int)cudaErrorInvalidValue

extern "C" int rten_decode_append_cat(
    int kind, const void* q, long long q_sb, long long q_sh,
    const void* kn, long long kn_sb, long long kn_sh,
    const void* vn, long long vn_sb, long long vn_sh,
    void* kc, void* vc, void* ks, void* vs, const void* lens, void* out,
    int B, int H, int Hkv, int D, int cap, int window, float scale,
    void* stream) {
  dim3 grid(B, Hkv);
  cudaStream_t st = (cudaStream_t)stream;
#define RTEN_DECODE(DD, TT)                                                      \
  decode_append_cat_kernel<DD, TT><<<grid, DEC_WARPS * 32, 0, st>>>(             \
      (const float*)q, q_sb, q_sh, (const float*)kn, kn_sb, kn_sh,               \
      (const float*)vn, vn_sb, vn_sh, (TT*)kc, (TT*)vc, (float*)ks, (float*)vs,  \
      (const int32_t*)lens, (float*)out, H, Hkv, cap, window, scale)
#define RTEN_DECODE_T(TT) RTEN_BY_D(TT, RTEN_DECODE)
  RTEN_BY_KIND(kind, RTEN_DECODE_T)
#undef RTEN_DECODE_T
#undef RTEN_DECODE
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
  append_cat_write_kernel<DD, TT><<<grid, DEC_WARPS * 32, 0, st>>>(              \
      (const float*)kn, kn_sb, kn_sh, (const float*)vn, vn_sb, vn_sh,            \
      (TT*)kc, (TT*)vc, (float*)ks, (float*)vs, (const int32_t*)bt, MB, BS,      \
      (const int32_t*)lens, B, Hkv)
#define RTEN_WRITE_T(TT) RTEN_BY_D(TT, RTEN_WRITE)
  RTEN_BY_KIND(kind, RTEN_WRITE_T)
#undef RTEN_WRITE_T
#undef RTEN_WRITE
  return (int)cudaGetLastError();
}

// Block-table mode on s8 pools: kc/vc are pools [NB, BS, Hkv*D], ks/vs
// scale pools [NB, Hkv, 1, BS], bt [B, MB]; out [B, 1, H*D]. Two launches
// on the stream: every slot's row is written (the last slot winning a
// shared row), then every slot attends through the table.
extern "C" int rten_decode_append_cat_paged(
    const void* q, long long q_sb, long long q_sh,
    const void* kn, long long kn_sb, long long kn_sh,
    const void* vn, long long vn_sb, long long vn_sh,
    void* kc, void* vc, void* ks, void* vs, const void* bt, int MB, int BS,
    const void* lens, void* out, int B, int H, int Hkv, int D, int window,
    float scale, void* stream) {
  const int rows = H / Hkv;
  if (rows < 1 || rows > 16) return (int)cudaErrorInvalidValue;
  const int err = rten_append_cat_write(KV_S8, kn, kn_sb, kn_sh, vn, vn_sb, vn_sh, kc, vc,
                                        ks, vs, bt, MB, BS, lens, B, Hkv, D, stream);
  if (err) return err;
  const dim3 grid(B, Hkv);
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* table = (const int32_t*)bt;
  // Strides of the cat pools (rows of Hkv * D) and the scale pools.
  const long long HkvD = (long long)Hkv * D;
#define RTEN_ATTEND(DD, RR)                                                      \
  decode_mha_fold_kernel<DD, int8_t, RR, true><<<grid, FOLD_WARPS * 32, 0, st>>>( \
      (const float*)q, q_sb, q_sh, 0, (const int8_t*)kc, (const int8_t*)vc,     \
      BS * HkvD, DD, HkvD, (const float*)ks, (const float*)vs,                 \
      (long long)Hkv * BS, BS, 1, table, MB, BS, (const int32_t*)lens,         \
      (float*)out, (long long)H * DD, DD, 0, H, Hkv, 1, MB * BS, window, scale)
#define RTEN_ATTEND_R(DD)                                                        \
  if (rows == 1) RTEN_ATTEND(DD, 1);                                             \
  else if (rows <= 8) RTEN_ATTEND(DD, 8);                                        \
  else RTEN_ATTEND(DD, 16)
  switch (D) {
    case 32: RTEN_ATTEND_R(32); break;
    case 64: RTEN_ATTEND_R(64); break;
    default: RTEN_ATTEND_R(128); break;
  }
#undef RTEN_ATTEND_R
#undef RTEN_ATTEND
  return (int)cudaGetLastError();
}

extern "C" int rten_prefill_cat(
    int kind, const void* q, long long q_sb, long long q_sh, long long q_ss,
    const void* kc, const void* vc, const void* ks, const void* vs,
    const void* lens, void* out, long long o_sb, long long o_sh, long long o_ss,
    int B, int H, int Hkv, int S, int D, int cap, int window, float scale,
    void* stream) {
  dim3 grid((S + PBQ - 1) / PBQ, H, B);
  cudaStream_t st = (cudaStream_t)stream;
#define RTEN_PREFILL(DD, TT)                                                     \
  prefill_cat_kernel<DD, TT><<<grid, 128, 0, st>>>(                              \
      (const float*)q, q_sb, q_sh, q_ss, (const TT*)kc, (const TT*)vc,           \
      (const float*)ks, (const float*)vs, (const int32_t*)lens, (float*)out,     \
      o_sb, o_sh, o_ss, H, Hkv, S, cap, window, scale)
#define RTEN_PREFILL_T(TT) RTEN_BY_D(TT, RTEN_PREFILL)
  RTEN_BY_KIND(kind, RTEN_PREFILL_T)
#undef RTEN_PREFILL_T
#undef RTEN_PREFILL
  return (int)cudaGetLastError();
}
