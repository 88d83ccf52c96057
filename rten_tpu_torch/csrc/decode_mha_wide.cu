// decode_mha's fold at head dims 129-512 (instances DP 256 and 512; Gemma's
// D 256 among them) for every cache kind: s8, int4, f32, bf16. The same
// kernel as decode_mha.cu's CUDA-core fold (decode_fold.cuh), which says
// what it replaces and how it is designed, built as a library of its own
// so that nvcc compiles it in parallel with the others. It holds 8 query
// rows a kv head at DP 256 and 4 at DP 512 (its shared memory stays at 40
// KB). The per-head form at these head dims is in decode_mha_wide_heads.cu
// and decode_mha_wide_heads_f32.cu.

#define RTEN_HEADS 0
#include "decode_mha.cuh"

#define RTEN_CASES(M)                                                          \
  M(KV_S8, int8_t, 256) M(KV_S8, int8_t, 512) M(KV_F32, float, 256)            \
  M(KV_F32, float, 512) M(KV_BF16, __nv_bfloat16, 256)                         \
  M(KV_BF16, __nv_bfloat16, 512) M(KV_U4, uint8_t, 256) M(KV_U4, uint8_t, 512)
RTEN_DECODE_MHA_ENTRIES(RTEN_CASES)
