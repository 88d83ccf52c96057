// decode_mha's per-head form at head dims 129-512 (instances DP 256 and
// 512) on f32 caches: the tensor-core kernel of decode_heads_wide.cuh in
// 3xTF32, which says what it replaces and how it is designed, built as a
// library of its own so that nvcc compiles it in parallel with the others.

#define RTEN_FOLD_FAST 0
#define RTEN_FOLD_GENERAL 0
#define RTEN_FOLD_TC 0
#include "decode_mha.cuh"

#define RTEN_CASES(M) M(KV_F32, float, 256) M(KV_F32, float, 512)
RTEN_DECODE_MHA_ENTRIES(RTEN_CASES)
