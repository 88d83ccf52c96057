// Flash attention (prefill-sized query blocks) for Hopper (sm_90a):
// q [B, Hq, Tq, D] against k, v [B, Hkv, Tk, D] -> out [B, Hq, Tq, D], f32
// or bf16 (loaded, and accumulated, in f32; out in q's type).
//
// Replaces: rten_tpu/kernels/flash_attention.py:139, mha_pallas (Pallas body
// _kernel). Same function: s = q.k * scale, then softcap * tanh(s /
// softcap) when softcap > 0, then + mask[row, col] (an optional additive f32
// mask [Tq, Tk], read through strides, so a [1, Tk] mask broadcast to every
// row costs nothing), and columns outside the causal band (col <= row + Tk -
// Tq when causal) or past Tk become NEG_INF = -1e30. The online softmax
// keeps the TPU kernel's guards: a probability is 0 while the running max
// is <= NEG_INF / 2, and a row whose every column is masked (the padding
// rows of a left-padded prompt) comes out 0 (l == 0 -> 1). GQA is kv-major:
// query head h reads KV head h / (Hq / Hkv).
//
// Bound on the H100: operations. 4 * Tq * Tk * D flops per head (half that
// with causal) against (2 Tq + 2 Tk) * D * 4 bytes; at GPT-2's prefill of
// 128 tokens (12 heads of D 64) the f32 FMAs bound it at 0.75 us, at 1024
// tokens 48 us (causal: 24) at 67 TFLOP/s on CUDA cores.
//
// Design: the TPU grid (batch, head, q block, k block) walks k blocks in
// order on one core; here one 128-thread block per (32-row query tile,
// head, batch) runs the key loop itself, so the online softmax state (m, l
// and the row's slice of the output) stays in registers for the whole row.
// The query tile is staged in shared memory once; each key tile (32 keys
// for D <= 64, 16 for D = 128, keeping static shared memory under 48 KB) is
// staged as f32 K and V. Four threads share a query row: each scores a
// quarter of the tile's columns and accumulates a quarter of the output
// dims. Key tiles wholly above the causal diagonal of the block's last row
// are never loaded. D comes from the shapes (32, 64 or 128; no padding to
// 128). f32 FMAs on CUDA cores: no TF32, no wgmma, no cp.async; each is
// later work. Built without --use_fast_math (IEEE expf, tanhf, division).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;
constexpr int QT = 32;  // query rows per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D, typename T>
__global__ void __launch_bounds__(128) mha_kernel(
    const T* __restrict__ q, long long q_sb, long long q_sh, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_sh, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_sh, long long v_st,
    const float* __restrict__ mask, long long m_sq, long long m_sk,
    T* __restrict__ out, long long o_sb, long long o_sh, long long o_st,
    int Hq, int Hkv, int Tq, int Tk, int causal, float softcap, float scale) {
  constexpr int BK = D == 128 ? 16 : 32;  // key columns per tile
  constexpr int DPT = D / 4;               // output dims per thread
  constexpr int CPT = BK / 4;              // score columns per thread
  __shared__ float Qs[QT][D + 1];
  __shared__ float Ks[BK][D + 1];
  __shared__ float Vs[BK][D + 1];
  __shared__ float Ps[QT][BK + 1];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid / 4, sub = tid % 4;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  const int r0 = qt * QT;
  const int offset = Tk - Tq;  // the causal band is anchored at the KV end

  for (int idx = tid; idx < QT * D; idx += 128) {
    const int rr = idx / D, d = idx % D, row = r0 + rr;
    Qs[rr][d] = row < Tq ? to_f32(qb[row * q_st + d]) : 0.f;
  }
  const int last_row = min(Tq - 1, r0 + QT - 1);
  const int kmax = causal ? min(Tk - 1, last_row + offset) : Tk - 1;
  const int row = r0 + r;
  const bool row_valid = row < Tq;

  float m = NEG_INF, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 <= kmax; k0 += BK) {
    __syncthreads();  // Qs ready / the previous tile consumed
    for (int idx = tid; idx < BK * D; idx += 128) {
      const int c = idx / D, d = idx % D, col = k0 + c;
      const bool in = col < Tk;
      Ks[c][d] = in ? to_f32(kb[col * k_st + d]) : 0.f;
      Vs[c][d] = in ? to_f32(vb[col * v_st + d]) : 0.f;
    }
    __syncthreads();

    float sc[CPT];
    float mt = NEG_INF;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = sub + 4 * i, col = k0 + c;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(Qs[r][d], Ks[c][d], dot);
      float s = dot * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const bool ok = row_valid && col < Tk && (!causal || col <= row + offset);
      if (ok && mask) s += mask[row * m_sq + col * m_sk];
      sc[i] = ok ? s : NEG_INF;
      mt = fmaxf(mt, sc[i]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 2));
    const float m_new = fmaxf(m, mt);
    const bool empty = m_new <= NEG_INF / 2;
    const float alpha = m <= NEG_INF / 2 ? 0.f : expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const float p = empty ? 0.f : expf(sc[i] - m_new);
      Ps[r][sub + 4 * i] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(FULL, psum, 1);
    psum += __shfl_xor_sync(FULL, psum, 2);
    l = l * alpha + psum;
    __syncwarp();  // a row's four threads share a warp
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    for (int c = 0; c < BK; ++c) {
      const float p = Ps[r][c];
      if (p != 0.f) {
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, Vs[c][sub + 4 * i], acc[i]);
      }
    }
    m = m_new;
  }
  if (row_valid) {
    const float denom = l == 0.f ? 1.f : l;
    T* o = out + b * o_sb + h * o_sh + row * o_st;
#pragma unroll
    for (int i = 0; i < DPT; ++i) store(o + sub + 4 * i, acc[i] / denom);
  }
}

}  // namespace

// q, k, v, out: unit-stride rows of D elements (dtype 0 = f32, 1 = bf16),
// addressed through batch, head and row strides (in elements). mask: an
// additive f32 [Tq, Tk] through strides (0 broadcasts), or null. Returns the
// launch's CUDA error code (0 on success).
extern "C" int rten_mha(int dtype, const void* q, long long q_sb, long long q_sh,
                        long long q_st, const void* k, long long k_sb, long long k_sh,
                        long long k_st, const void* v, long long v_sb, long long v_sh,
                        long long v_st, const void* mask, long long m_sq, long long m_sk,
                        void* out, long long o_sb, long long o_sh, long long o_st,
                        int B, int Hq, int Hkv, int Tq, int Tk, int D, int causal,
                        float softcap, float scale, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || Hkv < 1 || Hq % Hkv || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Tq + QT - 1) / QT, Hq, B);
  cudaStream_t st = (cudaStream_t)stream;
#define RTEN_MHA(DD, TT)                                                              \
  mha_kernel<DD, TT><<<grid, 128, 0, st>>>(                                           \
      (const TT*)q, q_sb, q_sh, q_st, (const TT*)k, k_sb, k_sh, k_st, (const TT*)v,   \
      v_sb, v_sh, v_st, (const float*)mask, m_sq, m_sk, (TT*)out, o_sb, o_sh, o_st,   \
      Hq, Hkv, Tq, Tk, causal, softcap, scale)
#define RTEN_MHA_D(TT)                                                                \
  if (D == 32) RTEN_MHA(32, TT);                                                      \
  else if (D == 64) RTEN_MHA(64, TT);                                                 \
  else if (D == 128) RTEN_MHA(128, TT);                                               \
  else return (int)cudaErrorInvalidValue
  if (dtype == 0) { RTEN_MHA_D(float); } else { RTEN_MHA_D(__nv_bfloat16); }
#undef RTEN_MHA_D
#undef RTEN_MHA
  return (int)cudaGetLastError();
}
