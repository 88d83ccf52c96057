// paged_decode_mha for Hopper (sm_90a): one decode step (S == 1) of
// attention over paged KV block pools.
//
// Replaces rten_tpu/kernels/flash_attention.py:3425 paged_decode_mha (the
// pallas_call whose K/V index maps DMA pool block bt[slot, j] at grid step
// (slot, j), with the block table in scalar prefetch).
//
// q [B, H, 1, D] f32 against pools [NB, Hkv, BS, D], either s8 with scale
// pools [NB, Hkv, 1, BS] f32 (positions lane-major per block) or f32 with
// no scales. Slot b's logical position p lives at
// pool[bt[b, p / BS], :, p % BS] (bt [B, MB] int32), so cap = MB * BS. The
// query of slot b sits at position lens[b] (its row already written) and
// attends columns j <= lens[b] (every column once lens[b] >= cap) and,
// with a window, j > lens[b] - window; a row with no column gives 0. GQA
// is kv-major. These are decode_mha's fold semantics at cap = MB * BS.
//
// Bound on the H100: bytes. A call reads each live K/V row once
// (2 * (min(lens, cap - 1) + 1) * Hkv * (D + 4) bytes per slot with s8
// rows and their scales) and does 4 * group flops per byte of an s8 row.
//
// Design: decode_mha's fold (decode_fold.cuh) with table addressing. One
// 128-thread block per (slot, kv head) reads each live K/V row once for
// the group's query rows; the block reads the table itself: each lane
// resolves the table entry of the key it scores (16-byte K loads from the
// pool row), and the P.V loop takes each key's row offset from the lane
// that resolved it by a shuffle. Dead blocks past the slot's last live
// column are never read, so their table entries may be 0 (the garbage
// sink). Rows of one pool block are contiguous in the head-major pool, so
// a warp's 32 keys touch at most two blocks when BS >= 32; a table entry
// per row covers any BS (a multiple of 8 is all the builders guarantee).
// Its own source, so that nvcc builds it in parallel with decode_mha.cu.

#include "decode_fold.cuh"

extern "C" int rten_paged_decode_mha(
    int quant, const void* q, long long q_sb, long long q_sh,
    const void* k, const void* v, long long kv_sb, long long kv_sh, long long kv_sj,
    const void* ks, const void* vs, long long sc_sb, long long sc_sh, long long sc_sj,
    const void* bt, int MB, int BS, const void* lens, void* out,
    long long o_sb, long long o_sh, int B, int H, int Hkv, int D, int window,
    float scale, void* stream) {
  const int rows = H / Hkv;
  if (rows < 1 || rows > 16 || (D != 64 && D != 128) || MB < 1 || BS < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B, Hkv);
  cudaStream_t st = (cudaStream_t)stream;
#define RTEN_PAGED(DD, TT, RR)                                                   \
  decode_mha_fold_kernel<DD, TT, RR, true><<<grid, FOLD_WARPS * 32, 0, st>>>(    \
      (const float*)q, q_sb, q_sh, 0, (const TT*)k, (const TT*)v, kv_sb, kv_sh,  \
      kv_sj, (const float*)ks, (const float*)vs, sc_sb, sc_sh, sc_sj,            \
      (const int32_t*)bt, MB, BS, (const int32_t*)lens, (float*)out, o_sb, o_sh, \
      0, H, Hkv, 1, MB * BS, window, scale)
#define RTEN_PAGED_R(DD, TT)                                                     \
  if (rows <= 8) RTEN_PAGED(DD, TT, 8); else RTEN_PAGED(DD, TT, 16)
  if (quant) {
    if (D == 64) { RTEN_PAGED_R(64, int8_t); } else { RTEN_PAGED_R(128, int8_t); }
  } else {
    if (D == 64) { RTEN_PAGED_R(64, float); } else { RTEN_PAGED_R(128, float); }
  }
#undef RTEN_PAGED_R
#undef RTEN_PAGED
  return (int)cudaGetLastError();
}
