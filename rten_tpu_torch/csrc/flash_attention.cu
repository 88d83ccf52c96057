// The block-table append's write launch, for Hopper (sm_90a).
//
// Caches are [B, cap, Hkv*D] ("cat layout": one row per position, the kv
// heads side by side) of one element type T (KvKind, decode_fold.cuh):
// s8 with per-position scales [B, Hkv, cap] f32, where row j of head hk
// dequantizes as kc[b, j, hk*D:(hk+1)*D] * ks[b, hk, j]; or f32 or bf16
// values with no scales (kv_quant=False, kv_dtype=BFloat16 graphs).
//
// rten_tpu/kernels/flash_attention.py, decode_mha_append_cat, has two
// forms. The flat one (cat caches, and decode_mha_append's head-major
// caches at :1442) is the split fold of decode_fold.cuh, built in
// decode_append{,_f32,_bf16}.cu. The block-table one (the TPU kernel's
// block_table= form) is here: the caches are pools [NB, BS, Hkv*D] shared
// by all slots, with scale pools [NB, Hkv, 1, BS], and row j of slot b
// lives at pool row bt[b, j / BS] * BS + j % BS; the new row goes to
// position min(lens[b], cap - 1), cap = MB * BS. Idle slots all point at
// block 0, so several slots can write the same row, and the reference
// writes every slot's row, the last slot winning, before any slot reads.
// A block that wrote and attended at once would race with the other
// writers of its row, so this mode is two launches on one stream:
// append_cat_write_kernel (here: a block skips its write when a later slot
// targets the same row), then the attention, which reads every row, the
// new one included, from the pool through the table: paged_decode_mha's
// split fold (paged_decode_mha{,_f32,_bf16}.cu) on the cat pools' strides.
// Bound on the H100: bytes.
//
// The write quantizes the new K/V row per head (scale max(absmax / 127,
// 1e-8), round half to even, clip to [-127, 127]) and writes it with its
// scale, or (f32/bf16) writes the row rounded to T (new_row, as the flat
// append does). Division and rounding must match the plain version bit for
// bit (__float2bfloat16_rn), so this file is built without
// --use_fast_math (IEEE division, rintf). Any even D up to 256.
//
// prefill_mha_cat runs decode_mha's per-head kernels on the cat caches'
// head-major views (decode_mha.cu, decode_heads_tc.cuh).

#include "decode_fold.cuh"

namespace {

constexpr int DEC_WARPS = FOLD_WARPS;  // warps per write block (new_row's reductions)
constexpr int DEC_THREADS = DEC_WARPS * 32;

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
// same arithmetic as the flat append: s8 quantized with its scales, or
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
