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
// order on one core; here one 128-thread block per (query tile, head,
// batch) runs the key loop itself, so the online softmax state (m, l and
// the row's slice of the output) stays in registers for the whole row. The
// query tile is staged in shared memory once; each key tile (32 keys for
// D <= 64, 16 above) is staged as f32 K and V in dynamic shared memory (35
// KB at D 128, 49 KB at D 256, above 48 KB after cudaFuncSetAttribute).
// Four threads share a query row up to D 128, eight at D 256 (query tiles
// of 32 and 16 rows): each scores its share of the tile's columns and
// accumulates its share of the output dims. Key tiles wholly above the
// causal diagonal of the block's last row are never loaded. Instances for
// DP = 32, 64, 128 and 256: any even D up to 256 runs in the smallest that
// holds it, the dims past D zero in shared memory (a masked tail; the TPU
// kernel pads D to a multiple of 128). f32 FMAs on CUDA cores: no TF32, no
// wgmma, no cp.async; each is later work. Built without --use_fast_math
// (IEEE expf, tanhf, division).

#include "decode_fold.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// The tiling at head-dim instance DP: TPR threads share a query row (4 up to
// D 128, 8 beyond), QT = 128 / TPR query rows a block, BK key columns a
// tile; shared memory holds the query tile and one K and V tile as f32,
// padded by one column, beside the tile's probabilities.
template <int DP>
struct MhaTile {
  static constexpr int TPR = DP <= 128 ? 4 : 8;
  static constexpr int QT = 128 / TPR;
  static constexpr int BK = DP <= 64 ? 32 : 16;
  static constexpr int SMEM =
      (int)sizeof(float) * (QT * (DP + 1) + 2 * BK * (DP + 1) + QT * (BK + 1));
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int DP, typename T>
__global__ void __launch_bounds__(128) mha_kernel(
    const T* __restrict__ q, long long q_sb, long long q_sh, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_sh, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_sh, long long v_st,
    const float* __restrict__ mask, long long m_sq, long long m_sk,
    T* __restrict__ out, long long o_sb, long long o_sh, long long o_st,
    int Hq, int Hkv, int Tq, int Tk, int D, int causal, float softcap, float scale) {
  constexpr int TPR = MhaTile<DP>::TPR, QT = MhaTile<DP>::QT;
  constexpr int BK = MhaTile<DP>::BK;  // key columns per tile
  constexpr int DPT = DP / TPR;        // output dims per thread
  constexpr int CPT = BK / TPR;        // score columns per thread
  extern __shared__ float smem[];
  float (*Qs)[DP + 1] = reinterpret_cast<float (*)[DP + 1]>(smem);
  float (*Ks)[DP + 1] = reinterpret_cast<float (*)[DP + 1]>(smem + QT * (DP + 1));
  float (*Vs)[DP + 1] = reinterpret_cast<float (*)[DP + 1]>(smem + (QT + BK) * (DP + 1));
  float (*Ps)[BK + 1] = reinterpret_cast<float (*)[BK + 1]>(smem + (QT + 2 * BK) * (DP + 1));

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid / TPR, sub = tid % TPR;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  const int r0 = qt * QT;
  const int offset = Tk - Tq;  // the causal band is anchored at the KV end

  for (int idx = tid; idx < QT * DP; idx += 128) {
    const int rr = idx / DP, d = idx % DP, row = r0 + rr;
    Qs[rr][d] = row < Tq && d < D ? to_f32(qb[row * q_st + d]) : 0.f;
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
    for (int idx = tid; idx < BK * DP; idx += 128) {
      const int c = idx / DP, d = idx % DP, col = k0 + c;
      const bool in = col < Tk && d < D;
      Ks[c][d] = in ? to_f32(kb[col * k_st + d]) : 0.f;
      Vs[c][d] = in ? to_f32(vb[col * v_st + d]) : 0.f;
    }
    __syncthreads();

    float sc[CPT];
    float mt = NEG_INF;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = sub + TPR * i, col = k0 + c;
      float s = row_dot<DP>(Qs[r], Ks[c]) * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const bool ok = row_valid && col < Tk && (!causal || col <= row + offset);
      if (ok && mask) s += mask[row * m_sq + col * m_sk];
      sc[i] = ok ? s : NEG_INF;
      mt = fmaxf(mt, sc[i]);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1) mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, off));
    const float m_new = fmaxf(m, mt);
    const bool empty = m_new <= NEG_INF / 2;
    const float alpha = m <= NEG_INF / 2 ? 0.f : expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const float p = empty ? 0.f : expf(sc[i] - m_new);
      Ps[r][sub + TPR * i] = p;
      psum += p;
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1) psum += __shfl_xor_sync(FULL, psum, off);
    l = l * alpha + psum;
    __syncwarp();  // a row's four threads share a warp
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    for (int c = 0; c < BK; ++c) {
      const float p = Ps[r][c];
      if (p != 0.f) {
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, Vs[c][sub + TPR * i], acc[i]);
      }
    }
    m = m_new;
  }
  if (row_valid) {
    const float denom = l == 0.f ? 1.f : l;
    T* o = out + b * o_sb + h * o_sh + row * o_st;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      if (sub + TPR * i < D) store(o + sub + TPR * i, acc[i] / denom);
    }
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
  cudaStream_t st = (cudaStream_t)stream;
#define RTEN_MHA(DD, TT)                                                              \
  {                                                                                   \
    constexpr int smem = MhaTile<DD>::SMEM;                                           \
    const dim3 grid((Tq + MhaTile<DD>::QT - 1) / MhaTile<DD>::QT, Hq, B);            \
    if (smem > 48 * 1024) {                                                           \
      const cudaError_t e = cudaFuncSetAttribute(                                     \
          mha_kernel<DD, TT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);     \
      if (e != cudaSuccess) return (int)e;                                            \
    }                                                                                 \
    mha_kernel<DD, TT><<<grid, 128, smem, st>>>(                                      \
        (const TT*)q, q_sb, q_sh, q_st, (const TT*)k, k_sb, k_sh, k_st, (const TT*)v, \
        v_sb, v_sh, v_st, (const float*)mask, m_sq, m_sk, (TT*)out, o_sb, o_sh, o_st, \
        Hq, Hkv, Tq, Tk, D, causal, softcap, scale);                                  \
  }
#define RTEN_MHA_D(TT)                                                                \
  if (D < 2 || D % 2 || D > 256) return (int)cudaErrorInvalidValue;                   \
  else if (D <= 32) RTEN_MHA(32, TT)                                                  \
  else if (D <= 64) RTEN_MHA(64, TT)                                                  \
  else if (D <= 128) RTEN_MHA(128, TT)                                                \
  else RTEN_MHA(256, TT)
  if (dtype == 0) { RTEN_MHA_D(float); } else { RTEN_MHA_D(__nv_bfloat16); }
#undef RTEN_MHA_D
#undef RTEN_MHA
  return (int)cudaGetLastError();
}
