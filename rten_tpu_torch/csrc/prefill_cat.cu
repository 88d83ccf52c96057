// prefill_mha_cat for Hopper (sm_90a): attention of S > 1 query rows per
// slot over cat-layout KV caches [B, cap, Hkv*D] that already hold the
// chunk's rows, s8 with per-position scales [B, Hkv, cap] f32 or f32 or
// bf16 with none (the layout flash_attention.cu describes).
//
// prefill_cat_kernel replaces rten_tpu/kernels/flash_attention.py,
//    prefill_mha_cat (Pallas body _prefill_cat_kernel): S > 1 prefill off
//    caches that already hold the chunk's rows; query row r of slot b
//    attends columns <= lens[b] + r (and > lens[b] + r - window).
//    Bound on the H100: operations at admission sizes (4 * S * keys * D
//    flops per head against S * D * 4 + keys * D bytes).
//    Design: one 128-thread block per (q-tile, head, slot); key tiles of 32
//    columns (16 at D 128 and 256) are dequantized (s8 x scale) or widened
//    (f32, bf16) into dynamic shared memory (35 KB at D 128, 49 KB at D
//    256: above 48 KB after cudaFuncSetAttribute); four threads share a
//    query row up to D 128, eight at D 256 (q-tiles of 32 and 16 rows:
//    scores for a quarter or an eighth of the tile's columns each, then the
//    same share of the output dims), and the online softmax runs in
//    registers. f32 on CUDA cores: tensor
//    cores (mma/wgmma) are later work.
//
// Head dims: instances DP = 32, 64, 128 and 256; any even D <= 256 runs in
// the smallest that holds it, the dims past D zero in shared memory.
// Built without --use_fast_math (IEEE expf and division).

#include "decode_fold.cuh"

namespace {

// The prefill's tiling at head-dim instance DP: TPR threads share a query
// row (4 up to D 128, 8 beyond), HQ = 128 / TPR query rows a block, BK key
// columns a tile; shared memory holds the query tile and one K and V tile
// as f32, padded by one column, beside the tile's probabilities.
template <int DP>
struct PrefillTile {
  static constexpr int TPR = DP <= 128 ? 4 : 8;
  static constexpr int HQ = 128 / TPR;
  static constexpr int BK = DP <= 64 ? 32 : 16;
  static constexpr int SMEM =
      (int)sizeof(float) * (HQ * (DP + 1) + 2 * BK * (DP + 1) + HQ * (BK + 1));
};

template <int DP, typename T>
__global__ void __launch_bounds__(128) prefill_cat_kernel(
    const float* __restrict__ q, long long q_sb, long long q_sh, long long q_ss,
    const T* __restrict__ kc, const T* __restrict__ vc,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int32_t* __restrict__ lens, float* __restrict__ out,
    long long o_sb, long long o_sh, long long o_ss,
    int H, int Hkv, int S, int D, int cap, int window, float scale) {
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  constexpr int TPR = PrefillTile<DP>::TPR, PBQ = PrefillTile<DP>::HQ;
  constexpr int BK = PrefillTile<DP>::BK;
  constexpr int DPT = DP / TPR;  // output dims per thread
  constexpr int CPT = BK / TPR;  // score columns per thread
  extern __shared__ float smem[];
  float (*Qs)[DP + 1] = reinterpret_cast<float (*)[DP + 1]>(smem);
  float (*Ks)[DP + 1] = reinterpret_cast<float (*)[DP + 1]>(smem + PBQ * (DP + 1));
  float (*Vs)[DP + 1] = reinterpret_cast<float (*)[DP + 1]>(smem + (PBQ + BK) * (DP + 1));
  float (*Ps)[BK + 1] = reinterpret_cast<float (*)[BK + 1]>(smem + (PBQ + 2 * BK) * (DP + 1));

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, row = tid / TPR, sub = tid % TPR;
  const int group = H / Hkv, hk = h / group;
  const long long HkvD = (long long)Hkv * D;
  const long long sc_base = ((long long)b * Hkv + hk) * cap;
  const int len = lens[b];
  const int r0 = qt * PBQ;

  for (int idx = tid; idx < PBQ * DP; idx += 128) {
    const int r = idx / DP, d = idx % DP, s = r0 + r;
    Qs[r][d] = s < S && d < D ? q[b * q_sb + h * q_sh + s * q_ss + d] : 0.f;
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
    for (int idx = tid; idx < BK * DP; idx += 128) {
      const int c = idx / DP, d = idx % DP, col = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (col < cap && d < D) {
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
      const int c = sub + TPR * i, col = k0 + c;
      const bool ok = row_valid && col <= qpos && col < cap &&
                      (window <= 0 || col > qpos - window);
      const float dot = row_dot<DP>(Qs[row], Ks[c]);
      sc[i] = ok ? dot * scale : -INFINITY;
      mt = fmaxf(mt, sc[i]);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1) mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, off));
    const float m_new = fmaxf(m, mt);
    const float alpha = m == -INFINITY ? 0.f : expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const float p = sc[i] == -INFINITY ? 0.f : expf(sc[i] - m_new);
      Ps[row][sub + TPR * i] = p;
      psum += p;
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1) psum += __shfl_xor_sync(FULL, psum, off);
    l = l * alpha + psum;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    for (int c = 0; c < BK; ++c) {
      const float p = Ps[row][c];
      if (p != 0.f) {
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] += p * Vs[c][sub + TPR * i];
      }
    }
    m = m_new;
  }
  if (row_valid) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = sub + TPR * i;
      if (d < D) out[b * o_sb + h * o_sh + s_row * o_ss + d] = acc[i] * inv;
    }
  }
}

}  // namespace

extern "C" int rten_prefill_cat(
    int kind, const void* q, long long q_sb, long long q_sh, long long q_ss,
    const void* kc, const void* vc, const void* ks, const void* vs,
    const void* lens, void* out, long long o_sb, long long o_sh, long long o_ss,
    int B, int H, int Hkv, int S, int D, int cap, int window, float scale,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RTEN_PREFILL(DD, TT)                                                     \
  {                                                                              \
    constexpr int smem = PrefillTile<DD>::SMEM;                                  \
    const dim3 grid((S + PrefillTile<DD>::HQ - 1) / PrefillTile<DD>::HQ, H, B);  \
    if (smem > 48 * 1024) {                                                      \
      const cudaError_t e = cudaFuncSetAttribute(                                \
          prefill_cat_kernel<DD, TT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem); \
      if (e != cudaSuccess) return (int)e;                                       \
    }                                                                            \
    prefill_cat_kernel<DD, TT><<<grid, 128, smem, st>>>(                         \
        (const float*)q, q_sb, q_sh, q_ss, (const TT*)kc, (const TT*)vc,         \
        (const float*)ks, (const float*)vs, (const int32_t*)lens, (float*)out,   \
        o_sb, o_sh, o_ss, H, Hkv, S, D, cap, window, scale);                     \
  }
#define RTEN_PREFILL_T(TT) RTEN_BY_DP256(TT, RTEN_PREFILL)
  RTEN_BY_KIND(kind, RTEN_PREFILL_T)
#undef RTEN_PREFILL_T
#undef RTEN_PREFILL
  return (int)cudaGetLastError();
}
