// decode_mha's two launch forms on int4 head-major caches (KV_U4): u8
// [B, Hkv, cap, D / 2], each byte two split-half codes biased by 8 (dims i
// and i + D / 2), with per-position f32 scales [B, Hkv, cap], at D <= 128.
// The same kernels as decode_mha.cu (decode_mha.cuh), which says what they
// replace and how they are designed, built as a library of their own so
// that nvcc compiles them in parallel with decode_mha.cu. This library
// holds the tensor-core fold (decode_fold_tc.cuh: no window or a bf16 one,
// any even D up to 128) and the per-head form; decode_mha_u4_win.cu the
// CUDA-core fold (f32 windows).
//
// Replaces the int4 paths of rten_tpu/kernels/flash_attention.py:772
// _decode_mha_folded (its bits == 4 NT body, with the recent window of
// deferred KV) and :935 decode_mha (the per-head grid at Dkv = D / 2, the
// admissions). Bound on the H100: bytes, as for s8, at half the row bytes
// (D / 2 + 4 scale bytes a row per kv head).

#define RTEN_FOLD_FAST 0
#define RTEN_FOLD_GENERAL 0
#include "decode_mha.cuh"

#define RTEN_CASES(M) M(KV_U4, uint8_t, 64) M(KV_U4, uint8_t, 128)
RTEN_DECODE_MHA_ENTRIES(RTEN_CASES)
