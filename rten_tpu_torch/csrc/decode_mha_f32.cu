// decode_mha's two launch forms on f32 head-major caches [B, Hkv, cap, D]
// (no scales) at D <= 128: the same kernels as decode_mha.cu
// (decode_mha.cuh), which says what they replace and how they are designed,
// built as a library of its own so that nvcc compiles them in parallel with
// decode_mha.cu. The entry points take only KV_F32.

#include "decode_mha.cuh"

#define RTEN_CASES(M) M(KV_F32, float, 64) M(KV_F32, float, 128)
RTEN_DECODE_MHA_ENTRIES(RTEN_CASES)
