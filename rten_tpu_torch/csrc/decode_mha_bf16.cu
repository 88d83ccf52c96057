// decode_mha's two launch forms on bf16 head-major caches [B, Hkv, cap, D]
// (no scales) at D <= 128: the same kernels as decode_mha.cu
// (decode_mha.cuh), which says what they replace and how they are designed,
// built as a library of its own so that nvcc compiles them in parallel with
// decode_mha.cu. The entry points take only KV_BF16.

#define RTEN_FOLD_FAST 0  // no window or a bf16 one: the tensor-core fold
#include "decode_mha.cuh"

#define RTEN_CASES(M) M(KV_BF16, __nv_bfloat16, 64) M(KV_BF16, __nv_bfloat16, 128)
RTEN_DECODE_MHA_ENTRIES(RTEN_CASES)
