// decode_mha for Hopper (sm_90a): attention of S query rows per serving
// slot over head-major KV caches [B, Hkv, cap, D], either s8 with
// per-position scales [B, Hkv, cap] f32 or f32 with no scales.
//
// Query row s of slot b, head h, sits at position lens[b] + s and reads KV
// head h / (H / Hkv) (heads are kv-major, as in the TPU kernel's GQA
// fold). It attends columns j with j <= lens[b] + s, j < cap and, when
// window > 0, j > lens[b] + s - window. A row with no such column gives 0.
// The K scale multiplies the score and the V scale the probability, as on
// the TPU: s = (q . k_int) * scale * ks[j], out = sum_j p_j vs[j] v_int[j]
// / sum_j p_j. K, V and the scales are addressed through strides, so the
// same code reads the head-major layout here and could read cat rows.
//
// Two launch forms; the wrapper (kernels/flash_attention.py, decode_mha)
// routes by rows per KV head: the fold when group * S <= 16 (a decode
// step, S == 1, of any model with group <= 16), per head otherwise (an
// admission, S = the bucket).
//
// 1. decode_mha_fold_kernel replaces rten_tpu/kernels/flash_attention.py:772
//    _decode_mha_folded (the S <= 8 pallas_call that folds every head of a
//    slot into one grid step).
//    Bound on the H100: bytes. A decode step reads each live KV row once
//    (2 * lens * Hkv * D bytes per slot, plus scales) and does 4 * group
//    flops per byte of an s8 row.
//    Design (decode_fold.cuh, shared with paged_decode_mha.cu): one
//    128-thread block per (slot, kv head) holds the group * S query rows
//    that share the head and reads each K/V row once for all of them (at
//    TinyLlama's 32 / 4 heads, eight rows read one stream); four warps
//    split the 32-key tiles of the live range. With 64 blocks at slots 16
//    the card is far from full and a call is latency-bound; split-K across
//    blocks is later work.
//
// 2. decode_mha_heads_kernel replaces rten_tpu/kernels/flash_attention.py:935
//    decode_mha (the per-(slot, head, key block) pallas_call for larger S).
//    Bound on the H100: operations at admission sizes (4 * S * keys * D
//    flops per head against S * D * 8 + keys * D bytes).
//    Design: one 128-thread block per (32-row query tile, head, slot). The
//    key loop runs inside the block up to lens[b] + the tile's last row,
//    with K/V tiles converted to f32 in shared memory beside their scales;
//    four threads share a query row (scores for BK / 4 columns each, then
//    D / 4 output dims each), and the online softmax runs in registers.
//    For D = 128 the key tile is 16 columns, keeping static shared memory
//    at 35 KB (< 48 KB).
//
// f32 on CUDA cores; tensor cores, split-K across blocks and cp.async are
// later work. Built without --use_fast_math (IEEE expf and division), like
// the other kernels of the port.

#include "decode_fold.cuh"

namespace {

constexpr int HQ = 32;  // query rows per block of the per-head form

template <int D, typename T>
__global__ void __launch_bounds__(128) decode_mha_heads_kernel(
    const float* __restrict__ q, long long q_sb, long long q_sh, long long q_ss,
    const T* __restrict__ kc, const T* __restrict__ vc,
    long long kv_sb, long long kv_sh, long long kv_sj,
    const float* __restrict__ ks, const float* __restrict__ vs,
    long long sc_sb, long long sc_sh, long long sc_sj,
    const int32_t* __restrict__ lens, float* __restrict__ out,
    long long o_sb, long long o_sh, long long o_ss,
    int H, int Hkv, int S, int cap, int window, float scale) {
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  constexpr int BK = D == 128 ? 16 : 32;  // key columns per tile
  constexpr int DPT = D / 4;               // output dims per thread
  constexpr int CPT = BK / 4;              // score columns per thread
  __shared__ float Qs[HQ][D + 1];
  __shared__ float Ks[BK][D + 1];
  __shared__ float Vs[BK][D + 1];
  __shared__ float Ps[HQ][BK + 1];
  __shared__ float ksc_s[BK], vsc_s[BK];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, row = tid / 4, sub = tid % 4;
  const int hk = h / (H / Hkv);
  const T* kb = kc + b * kv_sb + hk * kv_sh;
  const T* vb = vc + b * kv_sb + hk * kv_sh;
  const long long sc_off = b * sc_sb + hk * sc_sh;
  const int len = lens[b];
  const int r0 = qt * HQ;

  for (int idx = tid; idx < HQ * D; idx += 128) {
    const int r = idx / D, d = idx % D, s = r0 + r;
    Qs[r][d] = s < S ? q[b * q_sb + h * q_sh + s * q_ss + d] : 0.f;
  }
  const int last_row = min(S - 1, r0 + HQ - 1);
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
    __syncthreads();  // Qs ready / the previous tile consumed
    for (int idx = tid; idx < BK * D; idx += 128) {
      const int c = idx / D, d = idx % D, col = k0 + c;
      const bool in = col < cap;
      Ks[c][d] = in ? (float)kb[col * kv_sj + d] : 0.f;
      Vs[c][d] = in ? (float)vb[col * kv_sj + d] : 0.f;
    }
    if (tid < BK) {
      const int col = k0 + tid;
      ksc_s[tid] = QUANT && col < cap ? ks[sc_off + col * sc_sj] : 1.f;
      vsc_s[tid] = QUANT && col < cap ? vs[sc_off + col * sc_sj] : 1.f;
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
      sc[i] = ok ? dot * scale * ksc_s[c] : -INFINITY;
      mt = fmaxf(mt, sc[i]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float alpha = m == -INFINITY ? 0.f : expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = sub + 4 * i;
      const float p = sc[i] == -INFINITY ? 0.f : expf(sc[i] - m_new);
      Ps[row][c] = p * vsc_s[c];
      psum += p;
    }
    psum += __shfl_xor_sync(FULL, psum, 1);
    psum += __shfl_xor_sync(FULL, psum, 2);
    l = l * alpha + psum;
    __syncwarp();  // a row's four threads share a warp
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

#define RTEN_DECODE_MHA_ARGS                                                     \
  int quant, const void *q, long long q_sb, long long q_sh, long long q_ss,      \
      const void *k, const void *v, long long kv_sb, long long kv_sh,            \
      long long kv_sj, const void *ks, const void *vs, long long sc_sb,          \
      long long sc_sh, long long sc_sj, const void *lens, void *out,             \
      long long o_sb, long long o_sh, long long o_ss, int B, int H, int Hkv,     \
      int S, int D, int cap, int window, float scale, void *stream

#define RTEN_KV_ARGS(TT)                                                         \
  (const float*)q, q_sb, q_sh, q_ss, (const TT*)k, (const TT*)v, kv_sb, kv_sh,   \
      kv_sj, (const float*)ks, (const float*)vs, sc_sb, sc_sh, sc_sj
#define RTEN_OUT_ARGS                                                            \
  (const int32_t*)lens, (float*)out, o_sb, o_sh, o_ss, H, Hkv, S, cap, window,   \
      scale

extern "C" int rten_decode_mha_folded(RTEN_DECODE_MHA_ARGS) {
  const int rows = (H / Hkv) * S;
  if (rows < 1 || rows > 16 || (D != 64 && D != 128)) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, Hkv);
  cudaStream_t st = (cudaStream_t)stream;
#define RTEN_FOLD(DD, TT, RR)                                                    \
  decode_mha_fold_kernel<DD, TT, RR, false><<<grid, FOLD_WARPS * 32, 0, st>>>( \
      RTEN_KV_ARGS(TT), nullptr, 0, 0, RTEN_OUT_ARGS)
#define RTEN_FOLD_R(DD, TT)                                                      \
  if (rows <= 8) RTEN_FOLD(DD, TT, 8); else RTEN_FOLD(DD, TT, 16)
  if (quant) {
    if (D == 64) { RTEN_FOLD_R(64, int8_t); } else { RTEN_FOLD_R(128, int8_t); }
  } else {
    if (D == 64) { RTEN_FOLD_R(64, float); } else { RTEN_FOLD_R(128, float); }
  }
#undef RTEN_FOLD_R
#undef RTEN_FOLD
  return (int)cudaGetLastError();
}

extern "C" int rten_decode_mha_heads(RTEN_DECODE_MHA_ARGS) {
  if (S < 1 || (D != 64 && D != 128)) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + HQ - 1) / HQ, H, B);
  cudaStream_t st = (cudaStream_t)stream;
#define RTEN_HEADS(DD, TT)                                                       \
  decode_mha_heads_kernel<DD, TT><<<grid, 128, 0, st>>>(RTEN_KV_ARGS(TT), RTEN_OUT_ARGS)
  if (quant) {
    if (D == 64) RTEN_HEADS(64, int8_t); else RTEN_HEADS(128, int8_t);
  } else {
    if (D == 64) RTEN_HEADS(64, float); else RTEN_HEADS(128, float);
  }
#undef RTEN_HEADS
  return (int)cudaGetLastError();
}
