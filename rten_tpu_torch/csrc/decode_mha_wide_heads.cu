// decode_mha's per-head form at head dims 129-512 (instances DP 256 and
// 512) on s8, int4 and bf16 caches: the tensor-core kernel of
// decode_heads_wide.cuh (three bf16 parts), which says what it replaces and
// how it is designed, built as a library of its own so that nvcc compiles
// it in parallel with the others. f32 caches are in
// decode_mha_wide_heads_f32.cu, the folds at these head dims in
// decode_mha_wide.cu.

#define RTEN_FOLD_FAST 0
#define RTEN_FOLD_GENERAL 0
#define RTEN_FOLD_TC 0
#include "decode_mha.cuh"

#define RTEN_CASES(M)                                                          \
  M(KV_S8, int8_t, 256) M(KV_S8, int8_t, 512) M(KV_BF16, __nv_bfloat16, 256)   \
  M(KV_BF16, __nv_bfloat16, 512) M(KV_U4, uint8_t, 256) M(KV_U4, uint8_t, 512)
RTEN_DECODE_MHA_ENTRIES(RTEN_CASES)
