// decode_mha's two launch forms at head dims 129-512 (instances DP 256 and
// 512; Gemma's D 256 among them) for every cache kind: s8, int4, f32, bf16.
// The same kernels as decode_mha.cu (decode_mha.cuh, decode_fold.cuh), which
// says what they replace and how they are designed, built as a library of
// their own so that nvcc compiles them in parallel with the others. The fold
// holds 8 query rows a kv head at DP 256 and 4 at DP 512 (its shared memory
// stays at 40 KB); the per-head form runs 16-row query tiles, eight threads
// a row, in 49 KB and 65 KB of dynamic shared memory.

#include "decode_mha.cuh"

#define RTEN_CASES(M)                                                          \
  M(KV_S8, int8_t, 256) M(KV_S8, int8_t, 512) M(KV_F32, float, 256)            \
  M(KV_F32, float, 512) M(KV_BF16, __nv_bfloat16, 256)                         \
  M(KV_BF16, __nv_bfloat16, 512) M(KV_U4, uint8_t, 256) M(KV_U4, uint8_t, 512)
RTEN_DECODE_MHA_ENTRIES(RTEN_CASES)
