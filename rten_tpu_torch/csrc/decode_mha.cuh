// decode_mha's two launch forms for one cache element type T, shared by
// decode_mha.cu (s8 and f32 caches) and decode_mha_bf16.cu (bf16 caches),
// which nvcc builds in parallel. decode_mha.cu says what each form replaces
// and how it is designed.

#pragma once

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
      Ks[c][d] = in ? to_f32(kb[col * kv_sj + d]) : 0.f;
      Vs[c][d] = in ? to_f32(vb[col * kv_sj + d]) : 0.f;
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

// The C entry points' parameters after the element kind, and their names.
#define RTEN_DECODE_MHA_PARAMS                                                   \
  const void *q, long long q_sb, long long q_sh, long long q_ss, const void *k,  \
      const void *v, long long kv_sb, long long kv_sh, long long kv_sj,          \
      const void *ks, const void *vs, long long sc_sb, long long sc_sh,          \
      long long sc_sj, const void *lens, void *out, long long o_sb,              \
      long long o_sh, long long o_ss, int B, int H, int Hkv, int S, int D,       \
      int cap, int window, float scale, void *stream
#define RTEN_DECODE_MHA_NAMES                                                    \
  q, q_sb, q_sh, q_ss, k, v, kv_sb, kv_sh, kv_sj, ks, vs, sc_sb, sc_sh, sc_sj,   \
      lens, out, o_sb, o_sh, o_ss, B, H, Hkv, S, D, cap, window, scale, stream

#define RTEN_KV_ARGS(TT)                                                         \
  (const float*)q, q_sb, q_sh, q_ss, (const TT*)k, (const TT*)v, kv_sb, kv_sh,   \
      kv_sj, (const float*)ks, (const float*)vs, sc_sb, sc_sh, sc_sj
#define RTEN_OUT_ARGS                                                            \
  (const int32_t*)lens, (float*)out, o_sb, o_sh, o_ss, H, Hkv, S, cap, window,   \
      scale

template <typename T>
int launch_decode_mha_folded(RTEN_DECODE_MHA_PARAMS) {
  const int rows = (H / Hkv) * S;
  if (rows < 1 || rows > 16 || (D != 64 && D != 128)) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, Hkv);
  cudaStream_t st = (cudaStream_t)stream;
#define RTEN_FOLD(DD, RR)                                                        \
  decode_mha_fold_kernel<DD, T, RR, false><<<grid, FOLD_WARPS * 32, 0, st>>>(    \
      RTEN_KV_ARGS(T), nullptr, 0, 0, RTEN_OUT_ARGS)
#define RTEN_FOLD_R(DD)                                                          \
  if (rows <= 8) RTEN_FOLD(DD, 8); else RTEN_FOLD(DD, 16)
  if (D == 64) { RTEN_FOLD_R(64); } else { RTEN_FOLD_R(128); }
#undef RTEN_FOLD_R
#undef RTEN_FOLD
  return (int)cudaGetLastError();
}

template <typename T>
int launch_decode_mha_heads(RTEN_DECODE_MHA_PARAMS) {
  if (S < 1 || (D != 64 && D != 128)) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + HQ - 1) / HQ, H, B);
  cudaStream_t st = (cudaStream_t)stream;
#define RTEN_HEADS(DD)                                                           \
  decode_mha_heads_kernel<DD, T><<<grid, 128, 0, st>>>(RTEN_KV_ARGS(T), RTEN_OUT_ARGS)
  if (D == 64) RTEN_HEADS(64); else RTEN_HEADS(128);
#undef RTEN_HEADS
  return (int)cudaGetLastError();
}
